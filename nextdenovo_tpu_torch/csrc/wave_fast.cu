// Fixed-cadence anti-diagonal wavefront aligner (band of 128 cells):
// forward pass and traceback of the narrow R = 1 tier.
//
// Replaces the Pallas kernels _fwd_kernel_fast and _tb_onehot_kernel of
// nextdenovo_tpu/ops/align.py.
//
// wave_fast_fwd: one block of 128 threads per pair, one thread per band
// cell.  Inside a word of 16 anti-diagonals the band start follows the
// schedule lo(s) = base + (s + 1) / 2 for every pair, so the neighbours are
// static: on even steps UP is lane - 1 and LEFT the same lane, on odd steps
// UP is the same lane and LEFT lane + 1, DIAG is always the same lane two
// steps back.  A thread keeps its own cell of wavefronts a-1 and a-2 in
// registers; only wavefront a-1 goes through shared memory (two buffers
// with an INF guard on each side, one barrier per anti-diagonal).  Once per
// word the block reduces wavefront a-1 to its (min, lowest lane), thread 0
// turns that into the re-centring shift delta (clamped so that (m, n) stays
// reachable), and every thread re-reads both wavefronts delta lanes over:
// the two shared buffers hold exactly wavefronts a-1 and a-2 at that point.
// Each thread ORs its 16 two-bit decisions into one int32; the block stores
// them as one contiguous 512 B row, and the word's base beside it.
//
// wave_fast_tb: the reference walks a one-hot lane vector; what that
// computes is a serial walk, so one thread per pair steps (word, step, lane)
// back from (m, n), moving the lane by base[w+1] - base[w] - 8 at each word
// boundary.
//
// Bound on this card: operations for wave_fast_fwd (~35 int32 operations
// for each of the 128 cells of an anti-diagonal, ahead of the 32 B of
// decisions it must write); latency for wave_fast_tb (dependent loads).  A
// block stops after the word that holds its pair's last anti-diagonal.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FW = 128;          // band cells per pair
constexpr int PACK = 16;         // anti-diagonals per traceback word
constexpr int INF = 1 << 28;
constexpr int T_FRONT = 24;      // front pad of the reversed-target buffer
constexpr int OP_DIAG = 0, OP_UP = 1, OP_LEFT = 2, OP_NONE = 3;

__global__ void __launch_bounds__(FW) wave_fast_fwd_kernel(
    const int32_t* __restrict__ qpad,    // (B, QP): sentinel, then query
    const int32_t* __restrict__ rtpad,   // (B, TP): T_FRONT sentinels, rev. t
    const int32_t* __restrict__ mn,      // (B, 2)
    int32_t* __restrict__ tb,            // (B, n_words, FW) packed decisions
    int32_t* __restrict__ base_out,      // (B, n_words) band start per word
    int32_t* __restrict__ stats,         // (B, 2) dist, done
    int QP, int TP, int n_words) {
    const int b = blockIdx.x;
    const int w = threadIdx.x;
    const int m = mn[2 * b], n = mn[2 * b + 1];
    const int end = m + n;
    const int32_t* q = qpad + (size_t)b * QP;
    const int32_t* rt = rtpad + (size_t)b * TP;

    // sv[1] holds wavefront a-1 and sv[0] wavefront a-2 at each word start
    __shared__ int sv[2][FW + 2];
    __shared__ int red_v[FW / 32], red_i[FW / 32];
    __shared__ int s_delta, s_lo_base, s_lo_prev, s_dist;

    for (int k = 0; k < 2; ++k) {
        sv[k][w + 1] = INF;
        if (w == 0) {
            sv[k][0] = INF;
            sv[k][FW + 1] = INF;
        }
    }
    if (w == 0) {
        s_lo_prev = 0;
        s_dist = INF;
    }
    int a_cur = INF, b_cur = INF;
    __syncthreads();

    const int last_word = min(end / PACK, n_words - 1);
    for (int word = 0; word <= last_word; ++word) {
        const int a0 = word * PACK;
        // ---- (min, lowest lane) of wavefront a-1
        int bv = a_cur, bi = w;
#pragma unroll
        for (int d = 16; d >= 1; d >>= 1) {
            const int ov = __shfl_down_sync(0xFFFFFFFFu, bv, d);
            const int oi = __shfl_down_sync(0xFFFFFFFFu, bi, d);
            if (ov < bv || (ov == bv && oi < bi)) {
                bv = ov;
                bi = oi;
            }
        }
        if ((w & 31) == 0) {
            red_v[w >> 5] = bv;
            red_i[w >> 5] = bi;
        }
        __syncthreads();
        if (w == 0) {
            int best_v = red_v[0], best_w = red_i[0];
            for (int k = 1; k < FW / 32; ++k) {
                if (red_v[k] < best_v) {
                    best_v = red_v[k];
                    best_w = red_i[k];
                }
            }
            const int lo_prev = s_lo_prev;
            int delta = min(max(best_w - FW / 2, -8), 8);
            if (best_v >= INF) delta = 0;
            delta = max(delta, (a0 + PACK - 1) - n - (lo_prev + 8));
            delta = min(delta, m - (lo_prev + 8));
            delta = max(delta, -lo_prev);
            if (s_dist < INF) delta = 0;
            s_delta = delta;
            s_lo_base = lo_prev + delta;
            s_lo_prev = lo_prev + delta + 8;
            base_out[(size_t)b * n_words + word] = lo_prev + delta;
        }
        __syncthreads();
        // ---- shift both wavefronts by delta lanes
        const int delta = s_delta;
        const int lo_base = s_lo_base;
        const int src = w + delta;
        const bool in = (src >= 0) && (src < FW);
        a_cur = in ? sv[1][src + 1] : INF;
        b_cur = in ? sv[0][src + 1] : INF;
        __syncthreads();
        sv[1][w + 1] = a_cur;
        __syncthreads();

        uint32_t bits = 0u;
        for (int s = 0; s < PACK; ++s) {
            const int a = a0 + s;
            const int cur = s & 1, prev = cur ^ 1;
            const bool done = s_dist < INF;
            int up, left;
            if ((s & 1) == 0) {          // up: lane - 1; left: same lane
                up = sv[prev][w];
                left = a_cur;
            } else {                     // up: same lane; left: lane + 1
                up = a_cur;
                left = sv[prev][w + 2];
            }
            const int i = lo_base + ((s + 1) >> 1) + w;
            const int j = a - i;
            const int qi = min(max(i, 0), QP - 1);
            const int ti = min(max(T_FRONT + n - j, 0), TP - 1);
            const int sub = (q[qi] == rt[ti]) ? 0 : 1;
            const int cd = b_cur + sub, cu = up + 1, cl = left + 1;
            int vnew = min(cd, min(cu, cl));
            int op = (vnew == cd) ? OP_DIAG : ((vnew == cu) ? OP_UP : OP_LEFT);
            if (i == 0) {
                vnew = j;
                op = OP_LEFT;
            }
            if (j == 0) {
                vnew = i;
                op = OP_UP;
            }
            if (i < 0 || i > m || j < 0 || j > n) vnew = INF;
            if (done) vnew = a_cur;
            bits |= (uint32_t)op << (2 * s);
            __syncthreads();             // every thread has read s_dist
            if (i == m && j == n) s_dist = min(s_dist, vnew);
            b_cur = a_cur;
            a_cur = vnew;
            sv[cur][w + 1] = vnew;
            __syncthreads();
        }
        tb[((size_t)b * n_words + word) * FW + w] = (int32_t)bits;
    }
    if (w == 0) {
        stats[2 * b] = s_dist;
        stats[2 * b + 1] = (s_dist < INF) ? 1 : 0;
    }
}

__global__ void wave_fast_tb_kernel(
    const int32_t* __restrict__ tb,      // (B, n_words, FW)
    const int32_t* __restrict__ base,    // (B, n_words)
    const int32_t* __restrict__ mn,      // (B, 2)
    uint8_t* __restrict__ ops,           // (B, a_max) prefilled with OP_NONE
    uint8_t* __restrict__ ok_out,        // (B)
    int B, int n_words, int a_max) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int m = mn[2 * b];
    const int end = m + mn[2 * b + 1];
    const int32_t* tbp = tb + (size_t)b * n_words * FW;
    const int32_t* bp = base + (size_t)b * n_words;
    uint8_t* out = ops + (size_t)b * a_max;

    int word = end / PACK;
    int base_cur = bp[word];
    int lane = m - base_cur - ((end % PACK) + 1) / 2;
    bool alive = (lane >= 0) && (lane < FW);
    bool pend = false;
    for (int t = end; t >= 1 && alive; --t) {
        const int s = t % PACK;
        if (s == PACK - 1 && t != end) {
            // crossing into this word from the one above it
            word -= 1;
            const int base_new = bp[word];
            const int corr = min(max(base_cur - base_new - 8, -FW + 1), FW - 1);
            base_cur = base_new;
            lane += corr;
            if (lane < 0 || lane >= FW) {
                alive = false;
                break;
            }
        }
        if (pend) {                      // second tick of a DIAG move
            pend = false;
            continue;
        }
        const uint32_t bits = (uint32_t)tbp[(size_t)word * FW + lane];
        const int op = (int)((bits >> (2 * s)) & 3u);
        out[t] = (uint8_t)op;
        if (op == OP_DIAG) {
            pend = true;
        } else if (op == OP_UP) {
            if ((s & 1) == 0) lane -= 1;
        } else if (op == OP_LEFT) {
            if ((s & 1) == 1) lane += 1;
        } else {
            alive = false;
        }
        if (lane < 0 || lane >= FW) alive = false;
    }
    ok_out[b] = (alive && lane == -bp[0]) ? 1 : 0;
}

}  // namespace

extern "C" {

int ndt_wave_fast_fwd(const void* qpad, const void* rtpad, const void* mn,
                      void* tb, void* base, void* stats, int B, int QP,
                      int TP, int n_words, void* stream) {
    if (B <= 0) return 0;
    wave_fast_fwd_kernel<<<B, FW, 0, (cudaStream_t)stream>>>(
        (const int32_t*)qpad, (const int32_t*)rtpad, (const int32_t*)mn,
        (int32_t*)tb, (int32_t*)base, (int32_t*)stats, QP, TP, n_words);
    return (int)cudaGetLastError();
}

int ndt_wave_fast_tb(const void* tb, const void* base, const void* mn,
                     void* ops, void* ok, int B, int n_words, int a_max,
                     void* stream) {
    if (B <= 0) return 0;
    const int threads = 32;
    wave_fast_tb_kernel<<<(B + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)tb, (const int32_t*)base, (const int32_t*)mn,
        (uint8_t*)ops, (uint8_t*)ok, B, n_words, a_max);
    return (int)cudaGetLastError();
}

}  // extern "C"
