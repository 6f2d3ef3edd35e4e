// Adaptive-band anti-diagonal wavefront aligner (band of 256 cells):
// forward pass and traceback.
//
// Replaces the Pallas kernels _fwd_kernel and _tb_kernel (R = 2) of
// nextdenovo_tpu/ops/align.py.  wave_fwd: one block of 256 threads per pair,
// one thread per band cell.  The last three wavefronts rotate through
// shared memory (neighbour reads are w-1 / w / w+1), so one barrier per
// anti-diagonal suffices.  Once per 16 anti-diagonals the block reduces the
// wavefront to its (min, lowest index) and thread 0 plans the next 16 band
// starts; every thread ORs its 16 two-bit decisions into one int32 and the
// block stores them as one contiguous 1 KB row.
//
// wave_tb: one warp per pair, four pairs a block, so a launch of 64 pairs
// spreads over 16 SMs and every warp has a scheduler of its own.  The walk
// only moves down through the word rows, so each warp streams them ahead of
// itself through a ring of TB_S words in shared memory (a word: 1 KB of
// decisions tb[b][k][0..255] plus 64 B of lo[b][16k..16k+15]), filled by
// cp.async of 16 B a lane: a row is two copies a lane, its lo goes into two
// copies of the lo ring on eight lanes.  The ring runs TB_S - 2 words ahead;
// a word's refill is issued after the walk's first load from the new word,
// not before it (copies queued ahead of a load hold it up).  All 32 lanes
// walk the same pair redundantly: every shared load is a broadcast and the
// warp stays convergent, with no shuffle on the chain.  The step's chain is
// one shared load of the decision word, a mask and a compare that test the
// op's two bits in place, and two selects: the next step's lane and word
// address are formed for each of the three ops while the word is in flight,
// from lo(a-1), lo(a-2) loaded a step earlier.  The rest of a step (about
// thirty instructions, each taking two issue cycles on the 16-lane integer
// pipes of a sub-partition) is what the chain waits on.
// Lane l < 16 keeps the op of slot 16k + l of the current word and the warp
// writes the word's 16 op bytes at once when the walk leaves it; rows the
// walk does not reach are written OP_NONE 16 bytes a lane, so the kernel
// writes every byte of ops.
//
// What must survive exactly (wave_tb_plain): the walk starts at
// (i, a) = (m, m + n); w = i - lo[a], read at a lane inside [0, 255]; the
// step writes inband ? op : OP_NONE at slot a; i -= 1 unless the op is LEFT,
// a -= 2 for DIAG and 1 otherwise; the walk stops after the step that left
// the band, or at a <= 0; ok = alive && a == 0 && i == 0.  The op read at a
// step that leaves the band decides nothing (the walk ends and ok is 0), so
// the kernel reads lane w & 255 there.  No word above (m + n) / 16 is read:
// wave_fwd leaves those rows undefined.  The precondition is wave_fwd's,
// m + n < n_words * 16; a pair outside it gets no op and ok = 0.
//
// Bound on this card: operations for wave_fwd (~40 int32 operations for
// each of the 256 cells of an anti-diagonal, ahead of the 64 B of decisions
// it must write); the walk's chain for wave_tb (one op a step, each step
// waiting on the last, at one warp's issue rate), which its bytes bound does
// not see.  A block of
// wave_fwd, and a warp of wave_tb, stops at its own pair's end, so pairs of
// different length cost what they need.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 256;           // band cells per pair
constexpr int PACK = 16;         // anti-diagonals per traceback word
constexpr int INF = 1 << 28;
constexpr int OP_DIAG = 0, OP_UP = 1, OP_LEFT = 2, OP_NONE = 3;

__global__ void __launch_bounds__(W) wave_fwd_kernel(
    const int32_t* __restrict__ qpad,    // (B, QP): sentinel, then query
    const int32_t* __restrict__ rtpad,   // (B, TP): sentinel, reversed target
    const int32_t* __restrict__ mn,      // (B, 2)
    int32_t* __restrict__ tb,            // (B, n_words, W) packed decisions
    int32_t* __restrict__ lo_out,        // (B, a_max) band start per anti-diag
    int32_t* __restrict__ stats,         // (B, 2) dist, reached
    int QP, int TP, int n_words, int a_max) {
    const int b = blockIdx.x;
    const int w = threadIdx.x;
    const int m = mn[2 * b], n = mn[2 * b + 1];
    const int end = m + n;
    const int32_t* q = qpad + (size_t)b * QP;
    const int32_t* rt = rtpad + (size_t)b * TP;

    // three wavefront buffers with an INF guard cell on each side
    __shared__ int vbuf[3][W + 2];
    __shared__ int plan_lo[PACK], plan_s1[PACK], plan_s2[PACK];
    __shared__ int red_v[W / 32], red_i[W / 32];
    __shared__ int carry_lo[2];          // lo(a-1), lo(a-2) across words
    __shared__ int out_stats[2];

    for (int k = 0; k < 3; ++k) {
        vbuf[k][w + 1] = INF;
        if (w == 0) {
            vbuf[k][0] = INF;
            vbuf[k][W + 1] = INF;
        }
    }
    if (w == 0) {
        carry_lo[0] = 0;
        carry_lo[1] = 0;
        out_stats[0] = INF;
        out_stats[1] = 0;
    }
    int i1 = 0, i2 = 1, inew = 2;        // buffer roles: a-1, a-2, a
    __syncthreads();

    const int last_word = min(end / PACK, n_words - 1);
    for (int word = 0; word <= last_word; ++word) {
        const int a0 = word * PACK;
        // ---- (min, lowest index) of the newest wavefront
        int bv = vbuf[i1][w + 1], bi = w;
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
            for (int k = 1; k < W / 32; ++k) {
                if (red_v[k] < best_v) {
                    best_v = red_v[k];
                    best_w = red_i[k];
                }
            }
            int s_total = min(max(best_w - W / 2, 0), PACK);
            if (best_v >= INF) s_total = 0;
            int lo_m1 = carry_lo[0], lo_m2 = carry_lo[1];
            for (int s = 0; s < PACK; ++s) {
                const int a = a0 + s;
                const int s_ad = (s_total > s) ? 1 : 0;
                int lo_a = max(max(lo_m1 + s_ad, a - n), 0);
                lo_a = min(min(lo_a, m), lo_m1 + 1);
                plan_lo[s] = lo_a;
                plan_s1[s] = lo_a - lo_m1;
                plan_s2[s] = lo_a - lo_m2;
                lo_m2 = lo_m1;
                lo_m1 = lo_a;
            }
            carry_lo[0] = lo_m1;
            carry_lo[1] = lo_m2;
        }
        __syncthreads();
        if (w < PACK && a0 + w < a_max)
            lo_out[(size_t)b * a_max + a0 + w] = plan_lo[w];

        uint32_t bits = 0u;
        for (int s = 0; s < PACK; ++s) {
            const int a = a0 + s;
            const int lo_a = plan_lo[s];
            const int s1 = plan_s1[s], s2 = plan_s2[s];
            const int* v1 = vbuf[i1];
            const int* v2 = vbuf[i2];
            // predecessors: diag at w + s2 - 1 of wavefront a-2; up at
            // w + s1 - 1 and left at w + s1 of wavefront a-1 (+1: guard)
            const int diag = (s2 >= 0 && s2 <= 2) ? v2[w + s2] : INF;
            const int up = (s1 >= 0 && s1 <= 1) ? v1[w + s1] : INF;
            const int left = (s1 >= 0 && s1 <= 1) ? v1[w + s1 + 1] : INF;
            const int i = lo_a + w;
            const int j = a - i;
            const int qi = min(max(i, 0), QP - 1);
            const int ti = min(max(n - j + 1, 0), TP - 1);
            const int sub = (q[qi] == rt[ti]) ? 0 : 1;
            const int cd = diag + sub, cu = up + 1, cl = left + 1;
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
            bits |= (uint32_t)op << (2 * s);
            if (a == end) {
                const int w_t = m - lo_a;
                if (w == w_t) out_stats[0] = vnew;
                if (w == 0) out_stats[1] = 1;
            }
            vbuf[inew][w + 1] = vnew;
            __syncthreads();
            const int t = i2;
            i2 = i1;
            i1 = inew;
            inew = t;
        }
        tb[((size_t)b * n_words + word) * W + w] = (int32_t)bits;
    }
    __syncthreads();
    if (w < 2) stats[2 * b + w] = out_stats[w];
}

constexpr int TB_WARPS = 4;      // pairs (one warp each) a block
constexpr int TB_S = 8;          // ring stages (words) a warp
constexpr int TB_LO = TB_S * PACK;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The next step's three candidate lanes and addresses are formed before the
// op is known; this keeps the compiler from folding them back into one
// computation after the op.
__device__ __forceinline__ unsigned opaque(unsigned v) {
    asm("" : "+r"(v));
    return v;
}

// A 32-bit load from shared memory.  Written out, so that the compiler
// cannot turn `diag ? lo4 : lo3` into one load from the chosen address
// issued after the op is known.
__device__ __forceinline__ int lds32(unsigned addr) {
    int v;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
    return v;
}

__global__ void __launch_bounds__(TB_WARPS * 32) wave_tb_kernel(
    const int32_t* __restrict__ tb,      // (B, n_words, W)
    const int32_t* __restrict__ lo,      // (B, a_max), a_max = n_words * 16
    const int32_t* __restrict__ mn,      // (B, 2)
    uint8_t* __restrict__ ops,           // (B, a_max), every byte written
    uint8_t* __restrict__ ok_out,        // (B)
    int B, int n_words, int a_max) {
    // a decision row is 1 KB aligned, so a lane's word lies at row | 4 lane;
    // the lo ring is held twice over and read in its second copy, so
    // lo(a - 4) .. lo(a) lie at fixed offsets below lo(a), never wrapping
    __shared__ __align__(1024) int32_t ring_tb[TB_WARPS][TB_S * W];
    __shared__ __align__(16) int32_t ring_lo[TB_WARPS][2 * TB_LO];
    const int lane = threadIdx.x & 31;
    const int wp = threadIdx.x >> 5;
    const int b = blockIdx.x * TB_WARPS + wp;
    if (b >= B) return;                  // the whole warp
    const int m = mn[2 * b], n = mn[2 * b + 1];
    const int end = m + n;
    uint8_t* out = ops + (size_t)b * a_max;
    const uint4 none4 = make_uint4(0x03030303u, 0x03030303u, 0x03030303u,
                                   0x03030303u);
    if (m < 0 || n < 0 || end >= a_max) {
        for (int k = lane; k < n_words; k += 32)
            *(uint4*)(out + k * PACK) = none4;
        if (lane == 0) ok_out[b] = 0;
        return;
    }
    const int32_t* tbp = tb + (size_t)b * n_words * W;
    const int32_t* lop = lo + (size_t)b * a_max;
    const int top = end >> 4;
    // rows above the walk's first word hold no op
    for (int k = top + 1 + lane; k < n_words; k += 32)
        *(uint4*)(out + k * PACK) = none4;
    // word k into its stage k % TB_S: one commit group, empty for k < 0.
    // Lanes 0-3 copy its lo into the first copy of the ring, 4-7 into the
    // second.
    auto fetch = [&](int k) {
        if (k >= 0) {
            const int32_t* src = tbp + (size_t)k * W + lane * 4;
            int32_t* dst = ring_tb[wp] + (k & (TB_S - 1)) * W + lane * 4;
            cp_async16(dst, src);
            cp_async16(dst + W / 2, src + W / 2);
            if (lane < PACK / 2)
                cp_async16(ring_lo[wp] + (k & (TB_S - 1)) * PACK
                           + (lane >> 2) * TB_LO + (lane & 3) * 4,
                           lop + k * PACK + (lane & 3) * 4);
        }
        cp_async_commit();
    };
    for (int s = 0; s < TB_S; ++s) fetch(top - s);
    cp_async_wait<TB_S - 2>();           // words top and top - 1 landed
    __syncwarp();

    const unsigned rt_s = (unsigned)__cvta_generic_to_shared(ring_tb[wp]);
    const unsigned rl_s =
        (unsigned)__cvta_generic_to_shared(ring_lo[wp] + TB_LO);
    auto row_of = [&](int k) {
        return rt_s + (unsigned)((k & (TB_S - 1)) * W * 4);
    };
    // byte address of lo(x) in the second copy of the lo ring
    auto lo_addr = [&](int x) {
        return rl_s + (unsigned)((x & (TB_LO - 1)) * 4);
    };
    const unsigned lane_mask = 4u * W - 4u;   // byte offset of lane w & 255
    // The walk's state, in the units its step uses: i4 = 4 i, w4 = 4 (i -
    // lo(a)), wa = the address of its decision word, lo1, lo2 = lo(a - 1),
    // lo(a - 2), m3 = the two bits of anti-diagonal a in a word (3 << 2 (a %
    // 16)), la = lo_addr(a).  4 i and 4 w hold for |i|, |lo| < 2^29.
    int a = end, cur = top;
    int i4 = 4 * m;
    unsigned la = lo_addr(a);
    int w4 = i4 - 4 * lds32(la);
    unsigned wa = row_of(cur) | ((unsigned)w4 & lane_mask);
    int lo1 = lds32(la - 4u), lo2 = lds32(la - 8u);
    uint32_t m3 = 3u << (2 * (a & (PACK - 1)));
    bool alive = true;
    // lane l < 16 keeps the op of slot 16 cur + l in place, as bits 2l, 2l+1
    // of `mine`; NONE (3) until the walk records one
    const uint32_t mym = lane < PACK ? 3u << (2 * lane) : 0u;
    uint32_t mine = mym;
    // one step in word cur, whose decisions start at shared address `row`;
    // `refill` issues the copies of word cur - (TB_S - 1) after the step's
    // own loads.  The next step's lane and word address are formed for each
    // of the three ops from lo values already in registers, while the
    // decision word is in flight; the op only picks one, so the chain is:
    // load, mask, compare, two selects.  lo(a - 3) and lo(a - 4) are loaded
    // for the step after.
    auto step = [&](unsigned row, bool refill) {
        const uint32_t word = (uint32_t)lds32(wa);
        const int lo3 = lds32(la - 12u), lo4 = lds32(la - 16u);
        if (refill) fetch(cur - (TB_S - 1));
        const int wU4 = i4 - 4 - 4 * lo1, wL4 = i4 - 4 * lo1,
                  wD4 = i4 - 4 - 4 * lo2;
        const unsigned aU = opaque(row | ((unsigned)wU4 & lane_mask)),
                       aL = opaque(row | ((unsigned)wL4 & lane_mask)),
                       aD = opaque(row | ((unsigned)wD4 & lane_mask));
        // the op's two bits tested in place: no shift on the chain
        const uint32_t x = word & m3;
        const bool diag = x == 0u;                      // OP_DIAG = 0b00
        const bool left = x == (m3 & 0xAAAAAAAAu);      // OP_LEFT = 0b10
        const bool inband = (unsigned)w4 < 4u * W;
        if (m3 == mym) mine = inband ? x : mym;
        if (!left) i4 -= 4;
        a -= diag ? 2 : 1;
        m3 = __funnelshift_r(m3, m3, diag ? 4 : 2);
        la = lo_addr(a);
        w4 = diag ? wD4 : (left ? wL4 : wU4);
        wa = diag ? aD : (left ? aL : aU);
        lo1 = diag ? lo3 : lo2;
        lo2 = diag ? lo4 : lo3;
        alive = inband;
    };
    while (a > 0) {
        // the steps of word cur; a falls by 1 or 2, so it never skips a word
        const unsigned row = row_of(cur);
        const int a_floor = max(cur * PACK, 1);
#pragma unroll 2
        while (alive && a >= a_floor) step(row, false);
        if (!alive || a <= 0) break;
        // the walk enters word cur - 1
        if (lane < PACK)
            out[cur * PACK + lane] = (uint8_t)(mine >> (2 * lane));
        mine = mym;
        cur -= 1;
        // words cur and cur - 1 landed: lo(a - 4) may lie in the latter
        cp_async_wait<TB_S - 3>();
        __syncwarp();
        // the stage of the word just left is free: refill it TB_S words down
        wa = row_of(cur) | ((unsigned)w4 & lane_mask);
        step(row_of(cur), true);
        if (!alive) break;
    }
    // the word the walk stopped in, and every word below it
    if (lane < PACK)
        out[cur * PACK + lane] = (uint8_t)(mine >> (2 * lane));
    for (int k = lane; k < cur; k += 32)
        *(uint4*)(out + k * PACK) = none4;
    if (lane == 0) ok_out[b] = (alive && a == 0 && i4 == 0) ? 1 : 0;
    cp_async_wait<0>();                  // no copy outlives the warp
}

}  // namespace

extern "C" {

int ndt_wave_fwd(const void* qpad, const void* rtpad, const void* mn,
                 void* tb, void* lo, void* stats, int B, int QP, int TP,
                 int n_words, int a_max, void* stream) {
    if (B <= 0) return 0;
    wave_fwd_kernel<<<B, W, 0, (cudaStream_t)stream>>>(
        (const int32_t*)qpad, (const int32_t*)rtpad, (const int32_t*)mn,
        (int32_t*)tb, (int32_t*)lo, (int32_t*)stats, QP, TP, n_words, a_max);
    return (int)cudaGetLastError();
}

int ndt_wave_tb(const void* tb, const void* lo, const void* mn, void* ops,
                void* ok, int B, int n_words, int a_max, void* stream) {
    if (B <= 0) return 0;
    // rows move 16 bytes a piece (tb, lo in; ops out)
    if (a_max != n_words * PACK || (uintptr_t)tb % 16 || (uintptr_t)lo % 16
        || (uintptr_t)ops % 16)
        return (int)cudaErrorInvalidValue;
    wave_tb_kernel<<<(B + TB_WARPS - 1) / TB_WARPS, TB_WARPS * 32, 0,
                     (cudaStream_t)stream>>>(
        (const int32_t*)tb, (const int32_t*)lo, (const int32_t*)mn,
        (uint8_t*)ops, (uint8_t*)ok, B, n_words, a_max);
    return (int)cudaGetLastError();
}

}  // extern "C"
