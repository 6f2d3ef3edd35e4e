// Banded bit-parallel Myers alignment: forward pass and traceback.
//
// Replaces the two lax.scan programs of nextdenovo_tpu/ops/myers.py
// (myers_fwd and myers_tb).
//
// What bounds them on an NVIDIA H100.  Both kernels are one dependent chain
// per pair and column: the next column's VP/VN (forward) or band position
// (traceback) needs this column's.  A launch of up to ~2500 pairs leaves the
// card's 528 warp schedulers with at most one warp each, so its time is
//     columns x (time of one column on a lone warp),
// whatever the bytes and however many pairs: 640 and 1280 pairs cost the
// same.  Above that the schedulers fill up and the bound becomes the integer
// operations executed (an int32 operation of a warp takes a scheduler two
// cycles) and then the planes' bytes: 64 B per pair and column, written
// once by the forward pass and read once by the traceback.
//
// What the design does about the chain.
//   * Eight lanes of a warp share one pair, one 32-bit band word a lane, so
//     a warp holds four pairs.  A lane's state is VP, VN and the four match
//     windows of its own word: a column is ~55 operations, ~20 of them
//     dependent, instead of an 8-word ripple of ~500 inside one thread.
//     (Four lanes a pair with two words a lane as one 64-bit word were
//     measured too and lost: the 64-bit words double the chain's integer
//     work.)
//   * The multiword add (X & VP) + VP is a per-lane add plus a carry
//     look-ahead across the group: every lane reports generate (its add
//     overflowed) and propagate (its sum is all ones) through two
//     __ballot_sync; with the warp's bits G and P the carries into all
//     words are ((G << 1) + P) ^ P, one integer add.  The top lane of a
//     group reports neither, so no carry crosses into the next group.  The
//     sum equals the ripple chain's, also when a carry crosses several
//     all-ones words.
//   * D0 >> 1 takes bit 0 of the next lane's D0 by one __shfl_down_sync.
//   * The match windows do not shift column by column.  A lane keeps each
//     window as its own word plus the 32 band bits above it and reads column
//     t of a 32-column chunk with one funnel shift by t; once a chunk it
//     takes the next lane's word by shuffle, and the top lane the chunk's 32
//     incoming query characters.  The per-column characters are turned into
//     bit planes (bit u = column c0 + u) by ballots once a chunk.
//   * Nothing on the chain waits for device memory.  Forward: the group's
//     lanes load tch/qtop a chunk of 32 columns ahead (lane l takes columns
//     c0 + l, c0 + 8 + l, ...); plane words go to shared memory and leave a
//     stage of 8 columns later.  Traceback: the plane addresses depend on
//     (column, word, pair) only, never on the walk, so a block streams the
//     planes of its pairs high column -> low through a ring of 4 stages x 8
//     columns in shared memory with cp.async, 24 columns ahead of the walk;
//     the up-move masks of a stage's 8 columns are formed before its walk,
//     and the walk itself is: mask at or below pos, ballot, find the highest
//     lane, one shuffle that brings that lane's finished answer (next
//     position and event byte).
//
// What it does about the bytes.  A warp's own four pairs give runs of 16 B,
// half a sector: at 5120 pairs that version took 15 ms where this
// one takes 3 (H100, 700 W).  So a block of PB pairs stages whole columns in
// shared memory and moves rows of 4 * PB bytes, 16 B a thread: the forward pass
// double-buffers two stages (one barrier a stage), the traceback refills its
// ring the same way.  Plane rows are PITCH >= B words apart with PITCH a
// multiple of 32 (the wrapper pads), so every piece is aligned whatever B;
// the traceback takes the planes as the forward pass leaves them and the
// entry points refuse rows that are not 16-byte aligned.
//
// The bulk (TMA) form of the copies was not taken: cp.async.bulk moves one
// contiguous run, and in the (column, plane, word, pair) layout a run is
// 4 * PB bytes, so a stage would be 128 copies of 32-64 B started by one
// thread in a lone warp's own stream, where 4 cp.async (or 4 vector
// stores) a thread do the same with no mbarrier.
//
// No work nobody reads: a pair's lanes count its score and freeze its final
// state at column nv, a block stops at the last column of its longest pair,
// the forward pass leaves plane rows above a pair's own nv unspecified
// (myers_fwd_defined in ops/myers.py) and the traceback fills the idle event
// rows above nv before it walks.  Every lane of a warp takes part in every
// collective up to the block's last column: groups whose pair is out of
// range or finished idle, they do not return.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;               // 32-bit words per bit-vector
constexpr int MOVE_DIAG = 0;
constexpr int MOVE_LEFT = 2;
constexpr int EV_FAIL = 255;
constexpr int EV_IDLE = 254;
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr int L = 8;                // lanes a pair: one band word a lane
constexpr int G = 32 / L;           // pairs a warp
constexpr unsigned LMASK = (1u << L) - 1u;

// bits >= lo_bit of a lane's word (lo_bit relative to the word's bit 0)
__device__ __forceinline__ uint32_t mask_from(int lo_bit) {
    if (lo_bit <= 0) return FULL;
    if (lo_bit >= 32) return 0u;
    return FULL << lo_bit;
}

// the top n bits of a word (n <= 0: none, n >= 32: all), two operations
__device__ __forceinline__ uint32_t top_bits(int n) {
    return __funnelshift_rc(0u, FULL, (unsigned)max(n, 0));
}

// the low n bits of a word, likewise
__device__ __forceinline__ uint32_t low_bits(int n) {
    return __funnelshift_lc(FULL, 0u, (unsigned)max(n, 0));
}

// A block holds PB pairs (PB * L threads): its warps run their pairs'
// chains on their own and move the planes together, as rows of 4 * PB bytes.
// Measured on an H100 at 640 .. 5120 pairs of 12288 columns: the forward pass
// is fastest with 8 pairs a block (two warps, whole 32-byte sectors), the
// traceback with 16 (64-byte runs; 8 halves its rate at 5120 pairs, 32 slows
// both kernels at 640 pairs, where two warps then share a scheduler).
constexpr int FWD_PB = 8;
constexpr int TB_PB = 16;
constexpr int ROWS = 2 * NW;          // plane rows a column: DV words, VP words
constexpr int ST_T = 8;               // columns a stage of planes in shared memory
// a staged row holds the block's PB pairs; 4 words of padding keep its
// 16-byte alignment and send lane (pair p, word k) to bank 4k + p: no conflict
__host__ __device__ constexpr int stage_pitch(int pb) { return pb + 4; }
__host__ __device__ constexpr int stage_words(int pb) {
    return ST_T * ROWS * stage_pitch(pb);
}
constexpr int TB_S = 4;               // ring stages of the traceback

// the largest v of the block (every thread calls it)
__device__ __forceinline__ int block_max(int v) {
    __shared__ int red[32];
    v = __reduce_max_sync(FULL, v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    int r = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = max(r, red[w]);
    return r;
}

__global__ void __launch_bounds__(FWD_PB * L) myers_fwd_kernel(
    const uint32_t* __restrict__ win0,   // (4, NW, B)
    const int32_t* __restrict__ qtop,    // (n_steps, B)
    const int32_t* __restrict__ tch,     // (n_steps, B)
    const int32_t* __restrict__ nvec,    // (B)
    const int32_t* __restrict__ offv,    // (B)
    int32_t* __restrict__ score_out,     // (B)
    uint32_t* __restrict__ planes,       // (n_steps, 2, NW, B), rows pp apart
    uint32_t* __restrict__ final_out,    // (2, NW, B)
    int n_steps, int B, int pp) {
    constexpr int PB = FWD_PB;
    constexpr int NT = PB * L;               // threads a block
    constexpr int RP = stage_pitch(PB);
    constexpr int ST_WORDS = stage_words(PB);
    constexpr int CH = 32;                   // columns a chunk of the streams
    constexpr int R = CH / L;                // stream registers a lane
    // two stages of plane rows: one is written while the other leaves
    __shared__ __align__(16) uint32_t stage[2 * ST_WORDS];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int l = lane % L;
    const int gsh = lane - l;                // the group's first lane
    const bool top = l == L - 1;
    const int pb = (tid >> 5) * G + lane / L;    // the pair's place in the block
    const int b0 = blockIdx.x * PB;
    const int b = b0 + pb;
    const bool valid = b < B;
    const int bs = valid ? b : B - 1;        // a pair out of range idles
    const size_t pitch = (size_t)B;
    const int off = offv[bs];
    const int nv = valid ? min(max(nvec[bs], 0), n_steps) : 0;
    const int jb = block_max(nv);            // the block's last column
    const int base = l * 32;                 // band bit of the word's bit 0
    const size_t row0 = (size_t)l * pitch + bs;

    uint32_t VP = mask_from(off - base), VN = 0;
    uint32_t VPf = VP, VNf = 0;              // the state after column nv
    // four match windows: the lane's own word and the 32 band bits above it
    uint32_t wl[4], wn[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        wl[c] = win0[(size_t)c * NW * pitch + row0];
        wn[c] = __shfl_down_sync(FULL, wl[c], 1, L);
    }
    // the score bit: band bit `off` of D0, counted by the lane that owns it
    const bool has_owner = off >= 0 && off < 32 * NW;
    const bool owner = has_owner && off / 32 == l;
    const int obit = off & 31;
    int ones = 0;
    const unsigned lane_bit = 1u << lane;
    const int mk0 = 32 + base - off;         // row mask: top j + mk0 bits

    // columns c0 .. c0 + CH - 1 (0-based): lane l holds c0 + r * L + l as
    // text char | incoming query char << 4, both 0..3 or 4 (none)
    auto load_chunk = [&](int c0, int (&buf)[R]) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int c = c0 + r * L + l;
            int v = 0x44;
            if (c < nv) {
                const unsigned t = (unsigned)tch[(size_t)c * pitch + bs];
                const unsigned q = (unsigned)qtop[(size_t)c * pitch + bs];
                v = (int)((t > 3u ? 4u : t) | ((q > 3u ? 4u : q) << 4));
            }
            buf[r] = v;
        }
    };
    // bit `bit` of the chunk's 32 stream values as one word, bit u = column
    // c0 + u, the same in every lane of the group
    auto plane = [&](const int (&buf)[R], int bit) {
        unsigned w = 0u;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const unsigned bal = __ballot_sync(FULL, (buf[r] >> bit) & 1);
            w |= ((bal >> gsh) & LMASK) << (r * L);
        }
        return w;
    };
    // a finished stage leaves for device memory in whole rows, 16 bytes a
    // thread and piece: piece i of a thread is row prow + i * 4L of the
    // stage's ST_T * ROWS rows, pairs pbb .. pbb + 3 of the block.  Rows
    // above the block's last column stay behind.
    constexpr int PPR = PB / 4;              // pieces a row
    constexpr int NP = ST_T * ROWS * PPR / NT;   // pieces a thread and stage
    const int prow = tid / PPR;
    const int pbb = (tid % PPR) * 4;
    const bool pin = b0 + pbb < pp;          // inside the padded row
    uint32_t* gout = planes + (size_t)prow * pp + b0 + pbb;
    const uint32_t* const sin = stage + prow * RP + pbb;
    auto copy_out = [&](int buf, int cf) {
        const int rows_left = (jb - cf) * ROWS;
        uint4 v[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i)
            v[i] = *reinterpret_cast<const uint4*>(
                sin + buf * ST_WORDS + i * 4 * L * RP);
#pragma unroll
        for (int i = 0; i < NP; ++i)
            if (pin && prow + i * 4 * L < rows_left)
                *reinterpret_cast<uint4*>(gout + (size_t)(i * 4 * L) * pp) = v[i];
        gout += (size_t)ST_T * ROWS * pp;
    };

    int cur[R];
    load_chunk(0, cur);
    uint32_t nm = top_bits(mk0);
    uint32_t* const srow = stage + l * RP + pb;      // the lane's DV word, slot 0
    for (int c0 = 0; c0 < jb; c0 += CH) {
        // one-hot planes of the chunk's text characters (bit u = column
        // c0 + u); the top lane takes the incoming query characters,
        // likewise, as the band bits above its word
        unsigned tp[4];
        {
            const unsigned t0 = plane(cur, 0), t1 = plane(cur, 1);
            const unsigned tv = ~plane(cur, 2);
            tp[0] = ~t0 & ~t1 & tv;
            tp[1] = t0 & ~t1 & tv;
            tp[2] = ~t0 & t1 & tv;
            tp[3] = t0 & t1 & tv;
            const unsigned q0 = plane(cur, 4), q1 = plane(cur, 5);
            const unsigned qv = ~plane(cur, 6);
            if (top) {
                wn[0] = ~q0 & ~q1 & qv;
                wn[1] = q0 & ~q1 & qv;
                wn[2] = ~q0 & q1 & qv;
                wn[3] = q0 & q1 & qv;
            }
        }
        load_chunk(c0 + CH, cur);            // lands during this chunk
        // unrolled over the chunk: every shift below has a constant count
#pragma unroll
        for (int t = 0; t < CH; ++t) {
            const int j = c0 + t + 1;
            uint32_t e = 0;
#pragma unroll
            for (int c = 0; c < 4; ++c)
                if ((tp[c] >> t) & 1u) e |= __funnelshift_r(wl[c], wn[c], t);
            e &= nm;
            nm = top_bits(j + mk0);
            const uint32_t X = e | VN;
            const uint32_t a = X & VP;
            uint32_t s = a + VP;
            // carry look-ahead over the group's lanes: the top lane neither
            // generates nor propagates (its carry leaves the band), so no
            // carry crosses into the next group of the warp
            const unsigned Gb = __ballot_sync(FULL, !top && s < a);
            const unsigned Pb = __ballot_sync(FULL, !top && s == FULL);
            const unsigned C = ((Gb << 1) + Pb) ^ Pb;
            if (C & lane_bit) s += 1;
            const uint32_t D0 = (s ^ VP) | X;
            // D0 >> 1 takes bit 0 of the next lane's D0
            const unsigned upb = __shfl_down_sync(FULL, D0, 1, L);
            uint32_t Xs = D0 >> 1;
            if (!top && (upb & 1u)) Xs |= 1u << 31;
            const uint32_t HN = VP & D0;
            const uint32_t HP = VN | ~(VP | D0);
            VN = Xs & HP & nm;
            VP = (HN | ~(Xs | HP)) & nm;
            // rows above a pair's nv carry whatever its idle lanes compute
            uint32_t* const sdst =
                srow + ((t / ST_T) & 1) * ST_WORDS + (t % ST_T) * ROWS * RP;
            sdst[0] = ~(D0 ^ e);
            sdst[NW * RP] = VP;
            if (owner && j <= nv) ones += (int)((D0 >> obit) & 1u);
            if (j == nv) {
                VPf = VP;
                VNf = VN;
            }
            if (t % ST_T == ST_T - 1) {
                // the stage is full; the barrier also says that the other
                // stage, written next, has left
                __syncthreads();
                copy_out((t / ST_T) & 1, c0 + t + 1 - ST_T);
            }
        }
        // the windows slide 32 rows down
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            wl[c] = wn[c];
            wn[c] = __shfl_down_sync(FULL, wl[c], 1, L);
        }
    }
    if (valid) {
        final_out[row0] = VPf;
        final_out[(size_t)NW * pitch + row0] = VNf;
        if (owner) score_out[b] = nv - ones;
        if (!has_owner && l == 0) score_out[b] = nv;
    }
}

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

__global__ void __launch_bounds__(TB_PB * L) myers_tb_kernel(
    const uint32_t* __restrict__ planes,  // (n_max, 2, NW, B), rows pp apart
    const int32_t* __restrict__ mvec, const int32_t* __restrict__ nvec,
    const int32_t* __restrict__ offv,
    uint8_t* __restrict__ evs,            // (n_max, B), row 0 = column n_max
    int32_t* __restrict__ i_final, uint8_t* __restrict__ ok_out,
    int n_max, int B, int pp) {
    constexpr int PB = TB_PB;
    constexpr int NT = PB * L;
    constexpr int RP = stage_pitch(PB);
    constexpr int ST_WORDS = stage_words(PB);
    // TB_S stages of ST_T columns: slot t of a stage, row r, pair p
    extern __shared__ __align__(16) uint32_t ring[];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int l = lane % L;
    const unsigned gmask = LMASK << (lane - l);
    const unsigned glow = 1u << (lane - l);    // the group's lowest lane
    const int pb = (tid >> 5) * G + lane / L;
    const int b0 = blockIdx.x * PB;
    const int b = b0 + pb;
    const bool valid = b < B;
    const int bs = valid ? b : B - 1;
    const size_t pitch = (size_t)B;
    const int m = mvec[bs];
    const int off = offv[bs];
    const int nvr = nvec[bs];
    // a pair walks from its own last column; one that has none never starts
    const int nv = (valid && nvr >= 1 && nvr <= n_max) ? nvr : 0;
    const int jb = block_max(nv);
    const int base = l * 32;

    if (valid)
        for (int j = n_max - l; j > nv; j -= L)
            evs[(size_t)(n_max - j) * pitch + b] = (uint8_t)EV_IDLE;
    if (jb < 1) {
        if (valid && l == 0) {
            i_final[b] = 0;
            ok_out[b] = 0;
        }
        return;                           // the whole block
    }

    // stages are cut from column 1 up, so the last one ends on column 1:
    // stage s holds columns s * T + 1 + u in slots u = 0 .. T - 1; the walk
    // takes the stages from s_top down to 0, iteration `it` takes s_top - it,
    // and each stage's slots from T - 1 down to 0.  The pieces are those of
    // the forward pass: row prow + i * 4L of the stage, pairs pbb .. pbb + 3.
    const int s_top = (jb - 1) / ST_T;
    constexpr int PPR = PB / 4;
    constexpr int NP = ST_T * ROWS * PPR / NT;
    const int prow = tid / PPR;
    const int pbb = (tid % PPR) * 4;
    const bool pin = b0 + pbb < pp;
    const uint32_t* gin = planes + ((size_t)s_top * ST_T * ROWS + prow) * pp
                          + b0 + pbb;
    auto fetch = [&](int it) {
        const int s = s_top - it;
        uint32_t* dst = ring + (it % TB_S) * ST_WORDS;
        if (s >= 0) {
            const int rows_in = (n_max - s * ST_T) * ROWS;   // rows that exist
#pragma unroll
            for (int i = 0; i < NP; ++i)
                if (pin && prow + i * 4 * L < rows_in)
                    cp_async16(dst + (prow + i * 4 * L) * RP + pbb,
                               gin + (size_t)(i * 4 * L) * pp);
            gin -= (size_t)ST_T * ROWS * pp;
        }
        cp_async_commit();
    };

    for (int it = 0; it < TB_S - 1; ++it) fetch(it);
    // every lane of a group keeps the walk's state; while a pair walks,
    // icur - pos = j - off at the top of column j, so only pos is carried
    // a first position outside 0 .. 0x7FFF fails at the first column like
    // any position 63 cells above the band
    const int pos_mn = m - nv + off;
    const int pos0 = (pos_mn < 0 || pos_mn > 0x7FFF) ? 0x7FFF : pos_mn;
    int pos = nv == s_top * ST_T + ST_T ? pos0 : 0, icur = 0;
    bool failed = false;
    // column j's event row; negative only above n_max, where nothing walks
    long long eoff = ((long long)n_max - (s_top * ST_T + ST_T)) * B + bs;
    for (int it = 0; it <= s_top; ++it) {
        cp_async_wait<TB_S - 2>();    // this thread's pieces of the stage landed
        __syncthreads();              // every thread's; the last stage is read
        const uint32_t* src = ring + (it % TB_S) * ST_WORDS + l * RP + pb;
        // off the chain, for the stage's columns at once: the cells that
        // are NOT up-moves (an up-move: not diag-valid and the VP plane has
        // the bit below)
        uint32_t DV[ST_T], NU[ST_T];
#pragma unroll
        for (int t = 0; t < ST_T; ++t) {
            DV[t] = src[(ST_T - 1 - t) * ROWS * RP];
            const uint32_t VPp = src[((ST_T - 1 - t) * ROWS + NW) * RP];
            unsigned dn = __shfl_up_sync(FULL, VPp >> 31, 1, L);
            if (l == 0) dn = 0u;
            NU[t] = DV[t] | ~((VPp << 1) | dn);
        }
        // the slot read a stage ago is free; its copies start after this
        // stage's own loads from shared memory: started before them they hold
        // those loads up, 1.5 against 1.2 ms at 640 pairs of 12288 columns
        fetch(it + TB_S - 1);
        const int jhi = (s_top - it) * ST_T + ST_T;
#pragma unroll
        for (int t = 0; t < ST_T; ++t) {
            const int j = jhi - t;
            const bool walk = j <= nv && !failed;
            // M = cells at or below pos that are not up-moves; the walk
            // lands on the highest of them, bit fb of the highest lane
            const uint32_t M = NU[t] & low_bits(pos - base + 1);
            const unsigned nz = __ballot_sync(FULL, M != 0) & gmask;
            // the highest such lane; the group's lowest if there is none
            const int srcl = 31 - __clz((int)(nz | glow));
            // what the walk does if this lane is that lane, before it knows
            const int fb = (31 - __clz((int)M)) & 31;
            const int f = base + fb;
            const int k_up = pos - f;
            const bool md = ((DV[t] >> fb) & 1u) && (j - off + f > 0);
            const int ev_l = k_up > 63 ? EV_FAIL
                             : (k_up << 2) | (md ? MOVE_DIAG : MOVE_LEFT);
            // a pair that starts at the next column takes its first position
            const int cand = (j - 1 == nv ? pos0 : (md ? f : f + 1))
                             | (ev_l << 16);
            const int sel = __shfl_sync(FULL, cand, srcl);
            const int ev = nz == 0u ? EV_FAIL : (sel >> 16);
            if (walk && ev == EV_FAIL) {
                failed = true;
                icur = j == nv ? m : j - off + pos;
            }
            if (l == 0 && j <= nv)
                evs[eoff] = (uint8_t)(walk ? ev : EV_IDLE);
            pos = sel & 0xFFFF;
            eoff += B;
        }
    }
    if (valid && l == 0) {
        // a walk that reached column 1 ends with icur - pos = -off
        if (nv >= 1 && !failed) icur = pos - off;
        i_final[b] = icur;
        ok_out[b] = (nv >= 1 && !failed && icur >= 0) ? 1 : 0;
    }
}

}  // namespace

extern "C" {

const char* ndt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// pp: words between two rows of `planes` (>= B).  The kernels move the planes
// 16 bytes a piece, so every row must start on a 16-byte boundary.
static bool rows_aligned(const void* planes, int pp) {
    return (pp % 4 == 0) && ((uintptr_t)planes % 16 == 0);
}

int ndt_myers_fwd(const void* win0, const void* qtop, const void* tch,
                  const void* nvec, const void* off, void* score,
                  void* planes, void* final_out, int n_steps, int B, int pp,
                  int nw, void* stream) {
    if (B <= 0) return 0;
    if (nw != NW || pp < B || !rows_aligned(planes, pp))
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + FWD_PB - 1) / FWD_PB;
    cudaStream_t st = (cudaStream_t)stream;
    myers_fwd_kernel<<<blocks, FWD_PB * L, 0, st>>>(
        (const uint32_t*)win0, (const int32_t*)qtop, (const int32_t*)tch,
        (const int32_t*)nvec, (const int32_t*)off, (int32_t*)score,
        (uint32_t*)planes, (uint32_t*)final_out, n_steps, B, pp);
    return (int)cudaGetLastError();
}

int ndt_myers_tb(const void* planes, const void* mvec, const void* nvec,
                 const void* off, void* evs, void* i_final, void* ok,
                 int n_max, int B, int pp, int nw, void* stream) {
    if (B <= 0) return 0;
    if (nw != NW || pp < B || !rows_aligned(planes, pp))
        return (int)cudaErrorInvalidValue;
    const int blocks = (B + TB_PB - 1) / TB_PB;
    cudaStream_t st = (cudaStream_t)stream;
    // with 32 pairs a block the ring would pass the 48 KB a kernel gets unasked
    const int ring_bytes = TB_S * stage_words(TB_PB) * (int)sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        myers_tb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ring_bytes);
    if (err != cudaSuccess) return (int)err;
    myers_tb_kernel<<<blocks, TB_PB * L, ring_bytes, st>>>(
        (const uint32_t*)planes, (const int32_t*)mvec,
        (const int32_t*)nvec, (const int32_t*)off, (uint8_t*)evs,
        (int32_t*)i_final, (uint8_t*)ok, n_max, B, pp);
    return (int)cudaGetLastError();
}

}  // extern "C"
