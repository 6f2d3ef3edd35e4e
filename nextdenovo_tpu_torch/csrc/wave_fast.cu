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
// computes is a serial walk.  One warp walks one pair, one pair a block
// (four a block measured slower).  The walk only moves down through the
// word rows, so each warp streams them ahead of itself through a ring of
// TB_S words in shared memory (a word: its 512 B row of decisions, one
// cp.async of 16 B a lane, and its base, 4 B by lane 0), and a step waits on
// a shared load, not on device memory.  The ring runs TB_S - 2 words ahead;
// a word's refill is issued after the walk's first load from the new word,
// not before it.  Under the fixed cadence the lane moves are static (UP:
// lane - 1 on even steps, LEFT: lane + 1 on odd ones, DIAG: the same lane),
// so a step needs no band-start lookup, and a ring row holds an all-ones
// (OP_NONE) sentinel word on each side of its 128 lanes: a walk that steps
// out of the band reads OP_NONE at its next step and stops, so the step
// tests no lane bound.  Its chain is one broadcast shared load of the
// decision word, a mask and a compare that test the op's two bits in place,
// and a pick among the next word addresses.  A step is about 19
// instructions in SASS, the load and the loop's branch among them; they
// issue in order, so most wait for the load.  All 32 lanes walk the same
// pair redundantly, so every shared load is a broadcast and no shuffle sits
// on the chain.  The warp keeps the current word's ops in one register
// (one bit-select a step) and writes its 16 op bytes when the walk leaves
// it; rows the walk does not reach are written OP_NONE 16 bytes a lane, so
// the kernel writes every byte of ops.  The only dynamic lane move, the
// correction at a word crossing, is formed a word ahead from the bases in
// the ring; the crossing also tests the lane bounds the steps leave out.
//
// wave_fast_tb, what must survive exactly (wave_fast_tb_plain): the walk
// starts at word end / 16, lane m - base[word] - ((end % 16) + 1) / 2,
// where end = m + n, and is dead at once if that lane lies outside
// [0, 128).  Each step at anti-diagonal t > 0 (s = t % 16) writes its op at
// slot t and moves: DIAG to t - 2 with the same lane (slot t - 1 stays
// OP_NONE), UP to t - 1 and lane - 1 if s is even, LEFT to t - 1 and
// lane + 1 if s is odd; OP_NONE or a lane outside the band ends the walk.
// Whenever the walk enters word w from w + 1 -- also on the skipped tick of
// a DIAG: a DIAG from s = 0 lands on s = 14 of the word below, one from
// s = 1 on s = 15, the correction applied between -- the lane moves by
// clamp(base[w+1] - base[w] - 8, -127, 127), and a lane outside [0, 128)
// ends the walk.  It ends at t <= 0 (a DIAG from t = 1 ends at -1).
// ok = alive && lane == -base[0]; end == 0 takes no step, so ok tells
// whether lane m - base[0] lies in the band and equals -base[0].  The
// precondition is wave_fast_fwd's, m + n < n_words * 16: no word above
// (m + n) / 16 is read (wave_fast_fwd leaves those rows undefined), and a
// pair outside it gets no op and ok = 0.
//
// Bound on this card: operations for wave_fast_fwd (~35 int32 operations
// for each of the 128 cells of an anti-diagonal, ahead of the 32 B of
// decisions it must write).  For wave_fast_tb, the walk's chain (one op a
// step, each waiting on the last, at one warp's issue rate), which its
// bytes bound does not see.  A block of wave_fast_fwd stops after the word
// that holds its pair's last anti-diagonal; a warp of wave_fast_tb stops
// where its own walk ends.
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

constexpr int TB_WARPS = 1;      // pairs (one warp each) a block (4: slower)
constexpr int TB_S = 8;          // ring stages (words) a warp

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A 32-bit load from shared memory, written out so that it stays where it
// is written.
__device__ __forceinline__ int lds32(unsigned addr) {
    int v;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
    return v;
}

// A ring row: word 3 is the lane -1 sentinel (words 0-2 keep the band 16 B
// aligned), the band's 128 decision words follow, then the lane 128
// sentinel (word 132).  A sentinel is all ones (OP_NONE at every step), so
// a walk that steps out of the band reads OP_NONE next and stops there.
constexpr int ROW = FW + 8;      // 32-bit words a ring row
constexpr int LEAD = 4;          // words before lane 0

__global__ void __launch_bounds__(TB_WARPS * 32) wave_fast_tb_kernel(
    const int32_t* __restrict__ tb,      // (B, n_words, FW)
    const int32_t* __restrict__ base,    // (B, n_words)
    const int32_t* __restrict__ mn,      // (B, 2)
    uint8_t* __restrict__ ops,           // (B, a_max), every byte written
    uint8_t* __restrict__ ok_out,        // (B)
    int B, int n_words, int a_max) {
    __shared__ __align__(16) int32_t ring_tb[TB_WARPS][TB_S * ROW];
    __shared__ __align__(16) int32_t ring_base[TB_WARPS][TB_S];
    const int lane = threadIdx.x & 31;
    const int wp = threadIdx.x >> 5;
    const int b = blockIdx.x * TB_WARPS + wp;
    if (b >= B) return;                  // the whole warp
    const int m = mn[2 * b];
    const int end = m + mn[2 * b + 1];
    uint8_t* out = ops + (size_t)b * a_max;
    const uint4 none4 = make_uint4(0x03030303u, 0x03030303u, 0x03030303u,
                                   0x03030303u);
    if (end < 0 || end >= a_max) {
        for (int k = lane; k < n_words; k += 32)
            *(uint4*)(out + k * PACK) = none4;
        if (lane == 0) ok_out[b] = 0;
        return;
    }
    const int32_t* tbp = tb + (size_t)b * n_words * FW;
    const int32_t* bp = base + (size_t)b * n_words;
    const int top = end >> 4;
    // rows above the walk's first word hold no op
    for (int k = top + 1 + lane; k < n_words; k += 32)
        *(uint4*)(out + k * PACK) = none4;
    // the two sentinels of every stage
    if (lane < 2 * TB_S)
        ring_tb[wp][(lane >> 1) * ROW + ((lane & 1) ? LEAD + FW : LEAD - 1)] =
            -1;
    // word k into its stage k % TB_S: one commit group, empty for k < 0
    auto fetch = [&](int k) {
        if (k >= 0) {
            cp_async16(ring_tb[wp] + (k & (TB_S - 1)) * ROW + LEAD + lane * 4,
                       tbp + (size_t)k * FW + lane * 4);
            if (lane == 0)
                cp_async4(ring_base[wp] + (k & (TB_S - 1)), bp + k);
        }
        cp_async_commit();
    };
    for (int s = 0; s < TB_S; ++s) fetch(top - s);
    const int base0 = __ldg(bp);
    cp_async_wait<TB_S - 2>();           // words top and top - 1 landed
    __syncwarp();

    const unsigned rt_s = (unsigned)__cvta_generic_to_shared(ring_tb[wp]);
    const unsigned rb_s = (unsigned)__cvta_generic_to_shared(ring_base[wp]);
    // shared address of lane 0's decision word of word k
    auto row_of = [&](int k) {
        return rt_s + (unsigned)(((k & (TB_S - 1)) * ROW + LEAD) * 4);
    };
    auto base_of = [&](int k) {
        return lds32(rb_s + (unsigned)((k & (TB_S - 1)) * 4));
    };
    // the lane correction when the walk enters word k - 1 from word k
    auto corr_into = [&](int base_k, int base_below) {
        return min(max(base_k - base_below - 8, -FW + 1), FW - 1);
    };
    // The walk's state: t, wa = the address of its decision word (its lane
    // is (wa - row_of(cur)) / 4, a sentinel's when it stepped out of the
    // band), m3 = the two bits of anti-diagonal t in a word (3 << 2 (t %
    // 16)), corr = the correction of the next crossing.
    int cur = top, t = end;
    const int base_top = base_of(top);
    int base_nxt = base_of(top - 1);     // unused when top == 0
    int corr = corr_into(base_top, base_nxt);
    const int lane0 = m - base_top - ((end & (PACK - 1)) + 1) / 2;
    bool alive = lane0 >= 0 && lane0 < FW;
    unsigned wa = row_of(cur) + 4u * (unsigned)(alive ? lane0 : 0);
    uint32_t m3 = 3u << (2 * (t & (PACK - 1)));
    // the ops of the current word, in place (slot s at bits 2s, 2s+1),
    // the same on every lane; NONE (3) until the walk records one
    uint32_t rec = 0xFFFFFFFFu;
    // one step; `refill` issues the copies of word cur - (TB_S - 1) after
    // the step's own load.  The op picks the next word address among UP's,
    // LEFT's and DIAG's (its own); a lane outside the band is a sentinel's.
    auto step = [&](bool refill) {
        const uint32_t word = (uint32_t)lds32(wa);
        if (refill) fetch(cur - (TB_S - 1));
        const unsigned aL = wa + ((t & 1) << 2), aU = aL - 4u;
        rec = (rec & ~m3) | (word & m3);
        // the op's two bits tested in place: no shift on the chain
        const uint32_t x = word & m3;
        const bool diag = x == 0u;                      // OP_DIAG = 0b00
        const bool left = x == (m3 & 0xAAAAAAAAu);      // OP_LEFT = 0b10
        alive = x != m3;                                // OP_NONE = 0b11
        t -= diag ? 2 : 1;
        m3 = __funnelshift_r(m3, m3, diag ? 4 : 2);
        wa = diag ? wa : (left ? aL : aU);
    };
    auto flush = [&]() {
        if (lane < PACK)
            out[cur * PACK + lane] = (uint8_t)((rec >> (2 * lane)) & 3u);
        rec = 0xFFFFFFFFu;
    };
    while (alive && t > 0) {
        // the steps of word cur; t falls by 1 or 2, so it never skips a word
        const int t_floor = max(cur * PACK, 1);
#pragma unroll 2
        while (alive && t >= t_floor) step(false);
        if (!alive || t <= 0) break;
        // the walk enters word cur - 1, if its lane is in the band, and its
        // lane moves by corr
        int l4 = (int)(wa - row_of(cur));
        flush();
        cur -= 1;
        alive = (unsigned)l4 < 4u * FW;  // not on a sentinel
        l4 += 4 * corr;
        alive = alive && (unsigned)l4 < 4u * FW;
        if (!alive) break;
        // words cur and cur - 1 landed: the base of the latter gives the
        // next crossing's correction
        cp_async_wait<TB_S - 3>();
        __syncwarp();
        const int base_cur = base_nxt;
        base_nxt = base_of(cur - 1);
        corr = corr_into(base_cur, base_nxt);
        // the stage of the word just left is free: refill it TB_S words down
        wa = row_of(cur) + (unsigned)l4;
        step(true);
    }
    // the word the walk stopped in, and every word below it
    flush();
    for (int k = lane; k < cur; k += 32)
        *(uint4*)(out + k * PACK) = none4;
    const int l_end = (int)(wa - row_of(cur)) >> 2;
    if (lane == 0)
        ok_out[b] = (alive && l_end >= 0 && l_end < FW && l_end == -base0);
    cp_async_wait<0>();                  // no copy outlives the warp
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
    // rows move 16 bytes a piece (tb in, ops out)
    if (a_max != n_words * PACK || (uintptr_t)tb % 16 || (uintptr_t)base % 16
        || (uintptr_t)ops % 16)
        return (int)cudaErrorInvalidValue;
    wave_fast_tb_kernel<<<(B + TB_WARPS - 1) / TB_WARPS, TB_WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)tb, (const int32_t*)base, (const int32_t*)mn,
        (uint8_t*)ops, (uint8_t*)ok, B, n_words, a_max);
    return (int)cudaGetLastError();
}

}  // extern "C"
