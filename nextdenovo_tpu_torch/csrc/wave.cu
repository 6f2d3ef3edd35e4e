// Adaptive-band anti-diagonal wavefront aligner (band of 256 cells):
// forward pass and traceback.
//
// Replaces the Pallas kernels _fwd_kernel and _tb_kernel (R = 2) of
// nextdenovo_tpu/ops/align.py.
//
// wave_fwd: one warp per pair, one pair a block (four a block measured the
// same), warps finish on their own, no block barrier.  Lane l keeps band
// cells 8l .. 8l+7 of wavefront a-1 in registers, and of a-2 the nine
// values its step formed as `L`.  The band start lo never falls and rises by
// s1 in {0, 1} a step (lo(a) = min(max(lo(a-1) + s_ad, a - n, 0), m,
// lo(a-1) + 1) with lo(a-1) <= m), so cell w reads up / left at w + s1 - 1 /
// w + s1 of a-1 and diag at w + s1 + s1(a-1) - 1 of a-2: one cell of a-1
// crosses each lane edge a step (one shuffle), and a-2's crossing cell is
// already in the previous step's L.  Once per word of 16 anti-diagonals
// every lane plans the band itself: its 8 cells' (min, lowest index), five
// xor-shuffle rounds, s_total = clip(argmin - 128, 0, 16).  A word whose
// steps all lie inside 1 <= i <= m, 1 <= j <= n (known from lo(a0-1) alone)
// has no clamp in its plan: s1 = 1 for its first s_total steps and 0 after,
// so it runs as two loops with s1 fixed at compile time (no select on the
// band shift, no edge test), during which one of the two code windows
// stands still.  Other words take the general step (s1 read at run time,
// the edge tests of the reference).  The codes a word reads are staged a
// word ahead as bytes in a per-warp shared window (q from lo(a0-1), rt from
// n - a0 + lo(a0-1) - 15, 384 each, clamped as the reference clamps); a
// step reads a lane's 8 codes as three words and two funnel shifts, and
// finds equal codes four at a time (byte_eq) and per cell by prmt's sign
// mode.  Each cell shifts its 2-bit decision into its own bit-word, so a
// lane stores its 8 words of a row as two 16-byte stores and the warp
// writes the 1 KB row in one pass; lanes 0-15 store the word's lo, and lo
// past the pair's last word is written 0.
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
// wave_fwd, what must survive exactly (wave_fwd_plain, on every defined
// word of tb, all of lo, stats): values are int32 and grow past INF (a cell
// fed only by INF reads INF + 1, ...), so nothing is packed narrower; a
// cell outside the matrix (i > m, j < 0, j > n) still writes the op its
// three candidates give, on the codes at the clamped indices, before its
// value becomes INF; codes compare as bytes, which tells apart any two of
// pad_for_align's codes (int8 values); the plan takes the lowest index on
// ties and s_total = 0 when the minimum is >= INF; a warp stops after its
// own pair's last word, min((m + n) / 16, n_words - 1).
//
// Bound on this card: operations for wave_fwd (8 int32 operations a band
// cell -- compare the codes, add to diag, min(up, left), add the gap, min,
// two compares for the decision, insert its two bits -- for each of the 256
// cells of an anti-diagonal, ahead of the 64 B of decisions it must write);
// it issues ~107 instructions an anti-diagonal a lane in an inner word, at
// two issue cycles each on a sub-partition's 16-lane integer pipes, and one
// warp a pair leaves the card's other schedulers idle.  The walk's chain
// for wave_tb (one op a step, each step waiting on the last, at one warp's
// issue rate), which its bytes bound does not see.  A warp of either
// kernel stops at its own pair's end, so pairs of different length cost
// what they need.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int W = 256;           // band cells per pair
constexpr int PACK = 16;         // anti-diagonals per traceback word
constexpr int INF = 1 << 28;
constexpr int OP_DIAG = 0, OP_UP = 1, OP_LEFT = 2, OP_NONE = 3;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int CPL = W / 32;      // band cells a lane: lane l owns 8l .. 8l+7
constexpr int WIN_WORDS = 96;    // 32-bit words (384 codes) of a code window

// four codes (0..255 after truncation to a byte) into one word, first lowest
__device__ __forceinline__ uint32_t pack4(int c0, int c1, int c2, int c3) {
    return __byte_perm(__byte_perm(c0, c1, 0x0040),
                       __byte_perm(c2, c3, 0x0040), 0x5410);
}

// the lane's 8 codes from byte offset `off` of a window: two words
__device__ __forceinline__ void codes8(const uint32_t* win, int off,
                                       uint32_t& lo, uint32_t& hi) {
    const uint32_t* p = win + (off >> 2);
    const unsigned sh = (unsigned)(off & 3) * 8u;
    const uint32_t w0 = p[0], w1 = p[1], w2 = p[2];
    lo = __funnelshift_r(w0, w1, sh);
    hi = __funnelshift_r(w1, w2, sh);
}

// -1 where byte K of x has its top bit set, else 0 (prmt's sign mode)
template <int K>
__device__ __forceinline__ int byte_sign(uint32_t x) {
    int r;
    asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(x), "n"(0x8888 | 0x1111 * K));
    return r;
}

// the top bit of each byte of a ^ b set where the bytes are equal
__device__ __forceinline__ uint32_t byte_eq(uint32_t a, uint32_t b) {
    const uint32_t x = a ^ b;
    return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x);
}

// One anti-diagonal a for the lane's 8 cells.  s1 = lo(a) - lo(a-1) in
// {0, 1}: fixed by S1 = 0 or 1, read at run time for S1 < 0.  v1 =
// wavefront a-1 (replaced by a); P[k+1] = wavefront a-2 at cell k +
// s1(a-1), k = -1 .. 7, as the step before formed it (its L).  The step
// forms L[k+1] = v1[k + s1] (one cell across the lane edge by shuffle, INF
// at the band's ends): up = L[k], left = L[k+1], and diag = wavefront a-2 at
// k + s1 + s1(a-1) - 1 = P[k + s1].  eq_lo / eq_hi hold the top bit of byte
// k where cell k's codes are equal.  EDGE keeps the matrix edge tests;
// without it every cell lies inside 1 <= i <= m, 1 <= j <= n.
template <int S1, bool EDGE>
__device__ __forceinline__ void fwd_step(
    int s1, int (&v1)[CPL], int (&P)[CPL + 1], uint32_t (&bits)[CPL],
    uint32_t eq_lo, uint32_t eq_hi, int lane, int i0, int a, int m, int n) {
    const bool sh = S1 < 0 ? s1 != 0 : S1 == 1;
    int nb;
    if (S1 == 1) {
        nb = __shfl_down_sync(FULL, v1[0], 1);
        if (lane == 31) nb = INF;
    } else if (S1 == 0) {
        nb = __shfl_up_sync(FULL, v1[CPL - 1], 1);
        if (lane == 0) nb = INF;
    } else {
        nb = __shfl_sync(FULL, sh ? v1[0] : v1[CPL - 1],
                         sh ? lane + 1 : lane - 1);
        if (lane == (sh ? 31 : 0)) nb = INF;
    }
    int L[CPL + 1];
    L[0] = sh ? v1[0] : nb;
#pragma unroll
    for (int k = 0; k < CPL - 1; ++k) L[k + 1] = sh ? v1[k + 1] : v1[k];
    L[CPL] = sh ? nb : v1[CPL - 1];
    int sm1[CPL];                        // sub - 1: -1 where the codes match
    sm1[0] = byte_sign<0>(eq_lo);
    sm1[1] = byte_sign<1>(eq_lo);
    sm1[2] = byte_sign<2>(eq_lo);
    sm1[3] = byte_sign<3>(eq_lo);
    sm1[4] = byte_sign<0>(eq_hi);
    sm1[5] = byte_sign<1>(eq_hi);
    sm1[6] = byte_sign<2>(eq_hi);
    sm1[7] = byte_sign<3>(eq_hi);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
        const int up = L[k], left = L[k + 1];
        const int diag = sh ? P[k + 1] : P[k];
        // v = min(diag + sub, up + 1, left + 1); ties DIAG > UP > LEFT
        const int cdm = diag + sm1[k];
        const bool pu = up <= left;
        const int ul = pu ? up : left;
        const bool pd = cdm <= ul;
        int v = (pd ? cdm : ul) + 1;
        uint32_t op = pd ? OP_DIAG : (pu ? OP_UP : OP_LEFT);
        if (EDGE) {
            const int i = i0 + k, j = a - i;
            if (i == 0) {
                v = j;
                op = OP_LEFT;
            }
            if (j == 0) {
                v = i;
                op = OP_UP;
            }
            if (i < 0 || i > m || j < 0 || j > n) v = INF;
        }
        // step s of the word lands in bits 2s, 2s+1 after its 16 steps
        bits[k] = __funnelshift_r(bits[k], op, 2);
        v1[k] = v;
    }
#pragma unroll
    for (int k = 0; k <= CPL; ++k) P[k] = L[k];
}

// Stage the codes a word reads: q[clamp(qb + p)] and rt[clamp(tb + p)] for
// p in [0, 384), as bytes, lane l holding words l, l + 32, l + 64.
struct Window {
    int q[3][4], t[3][4];
};

__device__ __forceinline__ void window_load(
    Window& w, const int32_t* __restrict__ q, const int32_t* __restrict__ rt,
    int qb, int tb, int QP, int TP, int lane) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int p = 4 * (lane + 32 * r) + e;
            w.q[r][e] = __ldg(q + min(max(qb + p, 0), QP - 1));
            w.t[r][e] = __ldg(rt + min(max(tb + p, 0), TP - 1));
        }
    }
}

__device__ __forceinline__ void window_store(const Window& w, uint32_t* wq,
                                             uint32_t* wt, int lane) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        wq[lane + 32 * r] = pack4(w.q[r][0], w.q[r][1], w.q[r][2], w.q[r][3]);
        wt[lane + 32 * r] = pack4(w.t[r][0], w.t[r][1], w.t[r][2], w.t[r][3]);
    }
}

__global__ void __launch_bounds__(32) wave_fwd_kernel(
    const int32_t* __restrict__ qpad,    // (B, QP): sentinel, then query
    const int32_t* __restrict__ rtpad,   // (B, TP): sentinel, reversed target
    const int32_t* __restrict__ mn,      // (B, 2)
    int32_t* __restrict__ tb,            // (B, n_words, W) packed decisions
    int32_t* __restrict__ lo_out,        // (B, a_max) band start per anti-diag
    int32_t* __restrict__ stats,         // (B, 2) dist, reached
    int QP, int TP, int n_words, int a_max) {
    // two code windows (the word's, the next one's), q then rt
    __shared__ __align__(16) uint32_t win[2][2][WIN_WORDS];
    const int lane = threadIdx.x;
    const int b = blockIdx.x;
    const int m = mn[2 * b], n = mn[2 * b + 1];
    const int end = m + n;
    const int32_t* q = qpad + (size_t)b * QP;
    const int32_t* rt = rtpad + (size_t)b * TP;
    int32_t* lop = lo_out + (size_t)b * a_max;

    int A[CPL], P[CPL + 1];              // wavefront a-1; a-2 as L of a-1
#pragma unroll
    for (int k = 0; k < CPL; ++k) A[k] = INF;
#pragma unroll
    for (int k = 0; k <= CPL; ++k) P[k] = INF;
    int lo1 = 0;                         // lo(a-1)
    int dist = INF, reached = 0;

    // word 0 reads q from 0 and rt from n - 15 on
    int qb = 0, tbase = n - 15;
    {
        Window w0;
        window_load(w0, q, rt, qb, tbase, QP, TP, lane);
        window_store(w0, win[0][0], win[0][1], lane);
    }
    __syncwarp();

    const int last_word = min(end / PACK, n_words - 1);
    for (int word = 0; word <= last_word; ++word) {
        const int a0 = word * PACK;
        const uint32_t* wq = win[word & 1][0];
        const uint32_t* wt = win[word & 1][1];
        // ---- the word's plan: (min, lowest index) of wavefront a0-1
        int bv = A[0], bi = 0;
#pragma unroll
        for (int k = 1; k < CPL; ++k) {
            if (A[k] < bv) {
                bv = A[k];
                bi = k;
            }
        }
        bi += CPL * lane;
#pragma unroll
        for (int d = 16; d >= 1; d >>= 1) {
            const int ov = __shfl_xor_sync(FULL, bv, d);
            const int oi = __shfl_xor_sync(FULL, bi, d);
            if (ov < bv || (ov == bv && oi < bi)) {
                bv = ov;
                bi = oi;
            }
        }
        const int s_total = bv >= INF ? 0 : min(max(bi - W / 2, 0), PACK);
        // ---- the next word's codes, from lo(a0-1): its band starts lie in
        // [lo1, lo1 + 32) and its anti-diagonals 16 further on
        Window nxt;
        const int qb_n = lo1, tb_n = n - (a0 + PACK) + lo1 - 15;
        if (word < last_word)
            window_load(nxt, q, rt, qb_n, tb_n, QP, TP, lane);

        uint32_t bits[CPL];
#pragma unroll
        for (int k = 0; k < CPL; ++k) bits[k] = 0u;
        int my_lo = 0;
        uint32_t q_lo, q_hi, t_lo, t_hi;
        // every step of the word lies inside 1 <= i <= m, 1 <= j <= n: its
        // band starts lie in [lo1, lo1 + 16]
        const bool inner = lo1 >= 1 && lo1 + PACK + (W - 1) <= m
                           && a0 - lo1 - W >= 1 && a0 + PACK - 1 - lo1 <= n;
        if (inner) {
            // no clamp of the plan acts: s1 = 1 for s < s_total, then 0.
            // While s1 = 1 the query window moves a byte a step and the
            // target's stands; then the other way round.
            const int L0 = lo1;
            const int oq = L0 + 1 - qb + CPL * lane;
            const int ot = n - a0 + L0 + 2 - tbase + CPL * lane;
            auto run = [&](int s, auto s1c) {
                constexpr int S1 = decltype(s1c)::value;
                if (S1)
                    codes8(wq, oq + s, q_lo, q_hi);
                else
                    codes8(wt, ot - 1 + s_total - s, t_lo, t_hi);
                fwd_step<S1, false>(S1, A, P, bits, byte_eq(q_lo, t_lo),
                                    byte_eq(q_hi, t_hi), lane, 0, 0, m, n);
            };
            using one = std::integral_constant<int, 1>;
            using zero = std::integral_constant<int, 0>;
            int s = 0;
            codes8(wt, ot, t_lo, t_hi);
            for (; s + 2 <= s_total; s += 2) {
                run(s, one());
                run(s + 1, one());
            }
            if (s < s_total) run(s++, one());
            codes8(wq, oq + s_total - 1, q_lo, q_hi);
            for (; s + 2 <= PACK; s += 2) {
                run(s, zero());
                run(s + 1, zero());
            }
            if (s < PACK) run(s, zero());
            lo1 = L0 + s_total;
            my_lo = L0 + min(lane + 1, s_total);
        } else {
#pragma unroll 1
            for (int s = 0; s < PACK; ++s) {
                // one anti-diagonal: plan lo(a), read the codes, step
                const int a = a0 + s;
                int lo_a = max(max(lo1 + (s_total > s ? 1 : 0), a - n), 0);
                lo_a = min(min(lo_a, m), lo1 + 1);
                codes8(wq, lo_a - qb + CPL * lane, q_lo, q_hi);
                codes8(wt, n - a + lo_a + 1 - tbase + CPL * lane, t_lo, t_hi);
                fwd_step<-1, true>(lo_a - lo1, A, P, bits,
                                   byte_eq(q_lo, t_lo), byte_eq(q_hi, t_hi),
                                   lane, lo_a + CPL * lane, a, m, n);
                if (lane == s) my_lo = lo_a;
                if (a == end) {
                    const int w_t = m - lo_a;
                    int cand = INF;
#pragma unroll
                    for (int k = 0; k < CPL; ++k)
                        if (k == (w_t & (CPL - 1))) cand = A[k];
                    cand = __shfl_sync(FULL, cand, (w_t >> 3) & 31);
                    dist = (w_t >= 0 && w_t < W) ? cand : INF;
                    reached = 1;
                }
                lo1 = lo_a;
            }
        }
        // ---- the word's 1 KB of decisions, 32 bytes a lane, and its lo
        uint4* dst = (uint4*)(tb + ((size_t)b * n_words + word) * W + CPL * lane);
        dst[0] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
        dst[1] = make_uint4(bits[4], bits[5], bits[6], bits[7]);
        if (lane < PACK) lop[a0 + lane] = my_lo;
        if (word < last_word) {
            window_store(nxt, win[(word + 1) & 1][0], win[(word + 1) & 1][1],
                         lane);
            qb = qb_n;
            tbase = tb_n;
        }
        __syncwarp();
    }
    // lo past the last word is 0, as the plain version leaves it
    for (int k = (last_word + 1) * (PACK / 4) + lane; k < a_max / 4; k += 32)
        ((int4*)lop)[k] = make_int4(0, 0, 0, 0);
    if (lane == 0) {
        stats[2 * b] = dist;
        stats[2 * b + 1] = reached;
    }
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
    // decisions leave 16 bytes a store, lo rows are zero-filled the same way
    if (a_max != n_words * PACK || (uintptr_t)tb % 16 || (uintptr_t)lo % 16)
        return (int)cudaErrorInvalidValue;
    wave_fwd_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
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
