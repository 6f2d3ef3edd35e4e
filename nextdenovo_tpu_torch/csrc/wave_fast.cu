// Fixed-cadence anti-diagonal wavefront aligner (band of 128 cells):
// forward pass and traceback of the narrow R = 1 tier.
//
// Replaces the Pallas kernels _fwd_kernel_fast and _tb_onehot_kernel of
// nextdenovo_tpu/ops/align.py.
//
// wave_fast_fwd: one warp per pair, one pair a block, no block barrier.
// Lane l keeps band cells 4l .. 4l+3 of wavefronts a-1 and a-2 in
// registers.  Inside a word of 16 anti-diagonals the band start follows the
// schedule lo(s) = base + (s + 1) / 2 for every pair, so the neighbours are
// static: on even steps UP is cell w - 1 and LEFT cell w of a-1, on odd
// steps UP is cell w and LEFT cell w + 1, DIAG is always cell w of a-2.  A
// step takes one cell across a lane edge (one shuffle: __shfl_up of the
// lane's last cell on even steps, __shfl_down of its first on odd ones, INF
// at the band's ends), and a-2 is a register rename.  The 16 steps of a word
// are unrolled, so the even/odd pattern and the code offsets are constants.
// Once a word every lane plans the re-centring itself: its 4 cells' (min,
// lowest index), the warp's minimum (__reduce_min_sync), the lowest lane
// holding it (a ballot) and that lane's index (one shuffle), then the clip
// and the three clamps.  It shifts both wavefronts by delta through a
// per-warp shared buffer with 8 INF guard cells on each side.  A word's
// codes are staged a word ahead as bytes in two per-warp shared windows of
// 160 bytes (q from the band start of the word before, rt from the matching
// index; the word's band start lies 0-16 codes on, so every code it reads
// lies in them): the loads, five a lane a side and coalesced, are issued
// at the start of the word before and stored at its end, so no device load
// waits on the re-centring.  After delta a lane reads its 12 q and 12 rt
// code bytes from byte delta + 8 + 4l of the windows (four shared loads, a
// funnel shift); step s takes its 4 q codes at byte (s + 1) / 2 and its 4
// rt codes at byte 7 + (s + 1) / 2 - s of those words (a funnel shift by a
// constant), finds differing codes four at a time (byte_ne) and per cell
// by prmt's sign mode.  A cell is min(min(up, left) + 1, diag + sub) in one
// fused add-min, DIAG where that equals diag + sub.  A word whose cells all
// lie inside 1 <= i <= m, 1 <= j <= n runs the step with no edge and no
// done test; every other word runs the general step.  Each cell ORs its
// 2-bit decision into its own bit-word, so a lane writes its 4 words as one
// 16-byte store and the warp writes the 512 B row in one pass; lane 0
// writes the word's base, and base past the pair's last word is written 0.
//
// wave_fast_fwd, what must survive exactly (wave_fast_fwd_plain, on every
// defined word of tb, all of base, stats): once a word the lowest-lane
// argmin of wavefront a0 - 1 gives delta = clip(argmin - 64, -8, 8), 0 when
// the minimum is >= INF; then delta = max(delta, a0 + 15 - n - (lo_prev +
// 8)), delta = min(delta, m - (lo_prev + 8)), delta = max(delta, -lo_prev),
// in that order, and delta = 0 once done; the word's base is lo_prev +
// delta, and lo_prev becomes base + 8.  delta lies in [-8, 8]: the clip
// gives that; the j-side clamp cannot lift it above 8, because the last
// word's j-side clamp left lo_prev >= a0 - n - 1, and where the m-side clamp
// overrode that one, lo_prev >= m and a0 <= m + n; the m-side clamp and
// -lo_prev cannot take it below -8, because they left base <= m - 8 or
// base = 0.  So 8 INF guards on each side of the shift buffer give INF for
// every cell whose source lies outside [0, 128).  Cell w of step s has
// i = base + (s + 1) / 2 + w, j = a0 + s - i and the codes
// q[clamp(i, 0, QP - 1)], rt[clamp(T_FRONT + n - j, 0, TP - 1)], compared as
// bytes (which tells apart any two of pad_for_align's codes, int8 values);
// ties go DIAG before UP before LEFT; i == 0 gives (j, LEFT), then j == 0
// gives (i, UP); a cell outside the matrix still writes the op its
// candidates give and then takes INF; values are int32 and grow past INF,
// so nothing is packed narrower; done = dist < INF, read before the step,
// keeps the cell's value of a-1 and still writes the op; dist takes the
// value at (m, n) after that override.  A warp stops after its pair's word
// min((m + n) / 16, n_words - 1).
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
// Bound on this card: operations for wave_fast_fwd (8 int32 operations a
// band cell -- compare the codes, add to diag, min(up, left), add the gap,
// min, two compares for the decision, insert its two bits -- for each of the
// 128 cells of an anti-diagonal, ahead of the 32 B of decisions it must
// write); one warp a pair issues its ~42 SASS instructions a step (and ~8
// more an anti-diagonal for the word's re-centring, windows and stores) on
// one scheduler, at about two cycles each, and at 64 pairs most of the
// card's schedulers are idle.  For wave_fast_tb,
// the walk's chain (one op a step, each waiting on the last, at one warp's
// issue rate), which its bytes bound does not see.  A warp of either kernel
// stops at its own pair's end.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int FW = 128;          // band cells per pair
constexpr int PACK = 16;         // anti-diagonals per traceback word
constexpr int INF = 1 << 28;
constexpr int T_FRONT = 24;      // front pad of the reversed-target buffer
constexpr int OP_DIAG = 0, OP_UP = 1, OP_LEFT = 2, OP_NONE = 3;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int CPL = FW / 32;     // band cells a lane: lane l owns 4l .. 4l+3
constexpr int GUARD = 8;         // INF cells each side of the shift buffer
constexpr int WIN = 160;         // code bytes a window: >= 16 + 124 + 12

// v unchanged, but opaque to the compiler, which then tests DIAG on v
// itself and keeps v's add and min fused, where it would otherwise test it
// on a separate min(up, left) + 1
__device__ __forceinline__ int opaque(int v) {
    asm("" : "+r"(v));
    return v;
}

// -1 where byte K of x has its top bit set, else 0 (prmt's sign mode)
template <int K>
__device__ __forceinline__ int byte_sign(uint32_t x) {
    int r;
    asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(x), "n"(0x8888 | 0x1111 * K));
    return r;
}

// the top bit of each byte of a ^ b set where the bytes differ
__device__ __forceinline__ uint32_t byte_ne(uint32_t a, uint32_t b) {
    const uint32_t x = a ^ b;
    return ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
}

// the four codes from byte OFF on of a lane's three code words
template <int OFF>
__device__ __forceinline__ uint32_t codes4(const uint32_t (&w)[3]) {
    if (OFF % 4 == 0) return w[OFF / 4];
    return __funnelshift_r(w[OFF / 4], w[OFF / 4 + 1], 8 * (OFF % 4));
}

// A word's codes, staged a word ahead as bytes in a per-warp shared window:
// byte p holds q[clamp(qs + p)] (rt[clamp(ts + p)] in the rt window), p <
// WIN, where qs is the band start of the word before.  The word's band
// start lies in [qs, qs + 16], so a lane's 12 q codes (11 rt codes) start at
// byte base - qs + 4 lane, and every byte a lane reads lies in the window.
// Lane l loads the codes at p = l + 32 r; SAFE: every index lies inside
// both buffers, so the loads take constant offsets and no clamp.
struct Window {
    int q[WIN / 32], t[WIN / 32];
};

template <bool SAFE>
__device__ __forceinline__ void window_load(
    Window& w, const int32_t* __restrict__ q, const int32_t* __restrict__ rt,
    int qs, int ts, int QP, int TP, int lane) {
    const int32_t* qp = q + (SAFE ? qs + lane : 0);
    const int32_t* tp = rt + (SAFE ? ts + lane : 0);
#pragma unroll
    for (int r = 0; r < WIN / 32; ++r) {
        const int p = lane + 32 * r;
        w.q[r] = __ldg(qp + (SAFE ? 32 * r : min(max(qs + p, 0), QP - 1)));
        w.t[r] = __ldg(tp + (SAFE ? 32 * r : min(max(ts + p, 0), TP - 1)));
    }
}

__device__ __forceinline__ void window_store(const Window& w, uint8_t* wq,
                                             uint8_t* wt, int lane) {
#pragma unroll
    for (int r = 0; r < WIN / 32; ++r) {
        wq[lane + 32 * r] = (uint8_t)w.q[r];
        wt[lane + 32 * r] = (uint8_t)w.t[r];
    }
}

// the lane's 12 codes from byte `off` of a window: three words
__device__ __forceinline__ void codes12(const uint32_t* win, int off,
                                        uint32_t (&w)[3]) {
    const uint32_t* p = win + (off >> 2);
    const unsigned sh = (unsigned)(off & 3) * 8u;
    const uint32_t w0 = p[0], w1 = p[1], w2 = p[2], w3 = p[3];
    w[0] = __funnelshift_r(w0, w1, sh);
    w[1] = __funnelshift_r(w1, w2, sh);
    w[2] = __funnelshift_r(w2, w3, sh);
}

// Step S of a word for the lane's 4 cells: A = wavefront a-1 (replaced by
// a), Bv = a-2 (replaced by a-1).  EDGE keeps the reference's edge tests and
// the done freeze; without it every cell lies inside 1 <= i <= m,
// 1 <= j <= n.  i0 = base + 4 lane, so cell k has i = i0 + (S + 1) / 2 + k.
template <int S, bool EDGE>
__device__ __forceinline__ void fast_step(
    int (&A)[CPL], int (&Bv)[CPL], uint32_t (&bits)[CPL],
    const uint32_t (&qw)[3], const uint32_t (&tw)[3], int lane, int i0,
    int a0, int m, int n, bool done) {
    constexpr int H = (S + 1) / 2;
    int nb;
    if (S % 2 == 0) {                    // UP of cell 0: lane l - 1's cell 3
        nb = __shfl_up_sync(FULL, A[CPL - 1], 1);
        if (lane == 0) nb = INF;
    } else {                             // LEFT of cell 3: lane l + 1's cell 0
        nb = __shfl_down_sync(FULL, A[0], 1);
        if (lane == 31) nb = INF;
    }
    const uint32_t ne = byte_ne(codes4<H>(qw), codes4<7 + H - S>(tw));
    int msub[CPL];                       // -sub: -1 where the codes differ
    msub[0] = byte_sign<0>(ne);
    msub[1] = byte_sign<1>(ne);
    msub[2] = byte_sign<2>(ne);
    msub[3] = byte_sign<3>(ne);
    int V[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
        const int up = S % 2 ? A[k] : (k ? A[k - 1] : nb);
        const int left = S % 2 ? (k < CPL - 1 ? A[k + 1] : nb) : A[k];
        // v = min(diag + sub, up + 1, left + 1); ties DIAG > UP > LEFT:
        // DIAG where diag + sub <= min(up, left) + 1, else UP if up <= left
        const int cd = Bv[k] - msub[k];
        const bool pu = up <= left;
        int v = opaque(min(min(up, left) + 1, cd));
        const bool pd = v == cd;
        uint32_t op = pd ? OP_DIAG : (pu ? OP_UP : OP_LEFT);
        if (EDGE) {
            const int i = i0 + H + k, j = a0 + S - i;
            if (i == 0) {
                v = j;
                op = OP_LEFT;
            }
            if (j == 0) {
                v = i;
                op = OP_UP;
            }
            if (i < 0 || i > m || j < 0 || j > n) v = INF;
            if (done) v = A[k];
        }
        if (EDGE || !pd) bits[k] |= op << (2 * S);
        V[k] = v;
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
        Bv[k] = A[k];
        A[k] = V[k];
    }
}

// f(integral_constant<int, S>) for S = 0 .. PACK - 1, unrolled
template <typename F, int... S>
__device__ __forceinline__ void for_steps(F&& f,
                                          std::integer_sequence<int, S...>) {
    (f(std::integral_constant<int, S>()), ...);
}

__global__ void __launch_bounds__(32) wave_fast_fwd_kernel(
    const int32_t* __restrict__ qpad,    // (B, QP): sentinel, then query
    const int32_t* __restrict__ rtpad,   // (B, TP): T_FRONT sentinels, rev. t
    const int32_t* __restrict__ mn,      // (B, 2)
    int32_t* __restrict__ tb,            // (B, n_words, FW) packed decisions
    int32_t* __restrict__ base_out,      // (B, n_words) band start per word
    int32_t* __restrict__ stats,         // (B, 2) dist, done
    int QP, int TP, int n_words) {
    // wavefronts a-1 and a-2 between GUARD INF cells on each side
    __shared__ __align__(16) int sbuf[2][FW + 2 * GUARD];
    // the code windows of the next word, q then rt
    __shared__ __align__(16) uint32_t win[2][WIN / 4];
    const int lane = threadIdx.x;
    const int b = blockIdx.x;
    const int m = mn[2 * b], n = mn[2 * b + 1];
    const int end = m + n;
    const int32_t* q = qpad + (size_t)b * QP;
    const int32_t* rt = rtpad + (size_t)b * TP;
    int32_t* bp = base_out + (size_t)b * n_words;

    if (lane < GUARD) {
        sbuf[0][lane] = sbuf[1][lane] = INF;
        sbuf[0][GUARD + FW + lane] = sbuf[1][GUARD + FW + lane] = INF;
    }
    int A[CPL], Bv[CPL];                 // wavefronts a-1, a-2
#pragma unroll
    for (int k = 0; k < CPL; ++k) A[k] = Bv[k] = INF;
    int lo_prev = 0, dist = INF;

    // a window from the band start qs of the word before and its rt start
    // ts = T_FRONT + n - a0 - 23 + qs (word 0: the start -8 of a word -1)
    Window nxt;
    auto load = [&](int qs, int ts) {
        if (qs >= 0 && qs + WIN <= QP && ts >= 0 && ts + WIN <= TP)
            window_load<true>(nxt, q, rt, qs, ts, QP, TP, lane);
        else
            window_load<false>(nxt, q, rt, qs, ts, QP, TP, lane);
    };
    load(-8, T_FRONT + n - 15);
    window_store(nxt, (uint8_t*)win[0], (uint8_t*)win[1], lane);

    const int last_word = min(end / PACK, n_words - 1);
    for (int word = 0; word <= last_word; ++word) {
        const int a0 = word * PACK;
        __syncwarp();                    // the word's windows are stored
        // ---- the re-centring: (min, lowest index) of wavefront a0-1
        int bv = A[0], bi = 0;
#pragma unroll
        for (int k = 1; k < CPL; ++k) {
            if (A[k] < bv) {
                bv = A[k];
                bi = k;
            }
        }
        {
            // the warp's minimum, the lowest lane holding it, its index
            const int gv = __reduce_min_sync(FULL, bv);
            const int src = __ffs(__ballot_sync(FULL, bv == gv)) - 1;
            bi = __shfl_sync(FULL, bi, src) + CPL * src;
            bv = gv;
        }
        int delta = bv >= INF ? 0 : min(max(bi - FW / 2, -8), 8);
        delta = max(delta, (a0 + PACK - 1) - n - (lo_prev + 8));
        delta = min(delta, m - (lo_prev + 8));
        delta = max(delta, -lo_prev);
        if (dist < INF) delta = 0;
        const int base = lo_prev + delta;
        lo_prev = base + 8;
        // ---- the word's codes from its windows (q from base + 4 lane, rt
        // from T_FRONT + n - a0 + base - 7 + 4 lane: byte delta + 8 + 4 lane
        // of each), then the loads of the next word's windows
        uint32_t qw[3], tw[3];
        codes12(win[0], delta + 8 + CPL * lane, qw);
        codes12(win[1], delta + 8 + CPL * lane, tw);
        if (word < last_word) load(base, T_FRONT + n - a0 - 23 + base);
        const bool inner = base >= 1 && base + (FW - 1) + PACK / 2 <= m
                           && a0 - base - (FW - 1) >= 1
                           && a0 + PACK / 2 - 1 - base <= n;
        // ---- shift both wavefronts by delta cells
        if (delta != 0) {
            __syncwarp();                // the last shift's reads are done
            *(int4*)&sbuf[0][GUARD + CPL * lane] =
                make_int4(A[0], A[1], A[2], A[3]);
            *(int4*)&sbuf[1][GUARD + CPL * lane] =
                make_int4(Bv[0], Bv[1], Bv[2], Bv[3]);
            __syncwarp();
            const int src = GUARD + CPL * lane + delta;
#pragma unroll
            for (int k = 0; k < CPL; ++k) {
                A[k] = sbuf[0][src + k];
                Bv[k] = sbuf[1][src + k];
            }
        }
        if (lane == 0) bp[word] = base;

        uint32_t bits[CPL];
#pragma unroll
        for (int k = 0; k < CPL; ++k) bits[k] = 0u;
        const int i0 = base + CPL * lane;
        using steps = std::make_integer_sequence<int, PACK>;
        if (inner) {
            for_steps([&](auto sc) {
                fast_step<decltype(sc)::value, false>(A, Bv, bits, qw, tw, lane,
                                                      i0, a0, m, n, false);
            }, steps());
        } else {
            bool done = dist < INF;
            for_steps([&](auto sc) {
                constexpr int S = decltype(sc)::value;
                fast_step<S, true>(A, Bv, bits, qw, tw, lane, i0, a0, m, n,
                                   done);
                if (a0 + S == end) {
                    // (m, n) is cell m - base - (S + 1) / 2 of wavefront a
                    const int w_t = m - base - (S + 1) / 2;
                    int cand = A[0];
#pragma unroll
                    for (int k = 1; k < CPL; ++k)
                        if ((w_t & (CPL - 1)) == k) cand = A[k];
                    cand = __shfl_sync(FULL, cand, (w_t / CPL) & 31);
                    if (w_t >= 0 && w_t < FW) dist = min(dist, cand);
                    done = dist < INF;
                }
            }, steps());
        }
        // ---- the word's 512 B of decisions, 16 bytes a lane
        *(uint4*)(tb + ((size_t)b * n_words + word) * FW + CPL * lane) =
            make_uint4(bits[0], bits[1], bits[2], bits[3]);
        if (word < last_word) {
            __syncwarp();                // every lane has read its codes
            window_store(nxt, (uint8_t*)win[0], (uint8_t*)win[1], lane);
        }
    }
    // base past the last word is 0, as the plain version leaves it
    for (int k = last_word + 1 + lane; k < n_words; k += 32) bp[k] = 0;
    if (lane == 0) {
        stats[2 * b] = dist;
        stats[2 * b + 1] = (dist < INF) ? 1 : 0;
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
    // decisions leave 16 bytes a store
    if ((uintptr_t)tb % 16) return (int)cudaErrorInvalidValue;
    wave_fast_fwd_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
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
