// The minimizer engine's device program: index lookup and anchor
// expansion, corridor vote, chain scoring and emission.
//
// Replaces the jitted program _match_block / _vote_emit of
// nextdenovo_tpu/overlap/engine.py (:295-502), which XLA fuses into a few
// device programs on the TPU and which the port ran as plain PyTorch ops:
// thousands of small launches a 16-row batch (each segment reduction a
// doubling scan of ceil(log2 A) rounds).  Three kernels take its place; the
// two lexicographic sorts between them stay torch.sort passes, as they are
// lax.sort ops outside any kernel in the JAX package.
//
//   engine_anchor   one thread a query minimizer, one launch.  Its hash's
//                   first index entry (int64, the 0xFFFFFFFF filter rows at
//                   the end) comes from a bucket directory: bucket[i] is the
//                   first entry of hash >= i << (32 - b), so a hash in
//                   [0, 2^32) needs a lower bound within [bucket[i],
//                   bucket[i + 1]) only, a few probes in one or two lines (b
//                   is chosen so that a bucket holds at most ~8 entries on
//                   average; a hash outside [0, 2^32) searches the whole
//                   index).  Its count is the run of equal entries from
//                   there, at most max_occ: 16 entries' hashes and rids
//                   loaded at once, then their qmask entries at once, for
//                   the three gates (no self hit, t_rid >= 0, the pair-once
//                   qmask gate), whose verdicts it keeps as a bit mask.  The
//                   block scans its taken counts and publishes its total;
//                   its first anchor is the sum of the totals of the blocks
//                   before it, each waited for (blocks are numbered by a
//                   ticket in the order they start, so a block waits only on
//                   blocks already running), and the last block's end is A.
//                   The taken anchors go out compacted, with the row's rid
//                   and position bases and the strand bit, in flat
//                   (minimizer, occurrence) order: torch.nonzero's order,
//                   into rows of M * max_occ, the bound of A.  No cumsum,
//                   no second launch; the host reads A once.  (Measured on
//                   the H100 against a count launch and a write launch with
//                   the blocks' totals between them, 1-8 % faster; a whole
//                   small bucket loaded at once instead of searched, no
//                   faster.)
//   vote_corridor   one warp a (key_q, key_t) group of the first sort's
//                   order, warps walking groups g, g + warps, ... of the
//                   starts _vote_emit makes once on the device (the grid is
//                   sized from A; a warp leaves at a start equal to A).  The
//                   group's anchors are sorted by key_b, so each diagonal
//                   bin is a run.  One pass in 32s marks run starts by
//                   comparing neighbours (a shuffle, the previous 32's last
//                   bin carried) and gives each run its count as the next
//                   start's offset less its own (the ballot's next bit, or
//                   the next 32 with a start); each run's argmax key
//                   (count + 1) << 32 | ~offset and its bin less the
//                   group's first go into the warp's tile in shared memory
//                   (TILE runs, 12 B each).  top_k rounds of a warp argmax
//                   over the tile (the first run on a tie, as the key
//                   orders them), a round's bin kept where bc * 2 >=
//                   prim_cnt and bc > 0; the runs within 2 of a round's bin
//                   are blanked in place (count -1) before the next round.
//                   A group of more runs than the tile (or of bins 2^31
//                   apart) takes the loop instead: every round walks its
//                   runs in 32s, a run's end a binary search away.  The
//                   rounds are unrolled over MAX_TOP_K, so their bins stay in
//                   registers (no stack frame).  Then each anchor's nearest
//                   kept corridor within +-width (di < bestd, the earlier
//                   round on a tie), written as key_t2 and qp2_key.
//   chain_emit      one warp a (key_q, key_t) group of the second sort's
//                   order, on the same starts: the second sort permutes
//                   anchors only inside a group.  Within a group the
//                   anchors are sorted by corridor (kt2 less the group's
//                   key_t * (top_k + 1)), so a corridor segment is the run
//                   of one corridor.  One pass over the group in 32s (the
//                   next 32's loads issued before this one is reduced): each
//                   anchor's link to the one before it (a shuffle, or the
//                   previous 32's last), each anchor written zero, and for
//                   each corridor present in the 32 the warp's reductions
//                   (__reduce_*_sync on int32: link sum, near count, query
//                   and target extents) added to lane c's running values of
//                   corridor c.  At the group's end lane c writes corridor
//                   c's record at its segment's last anchor, where it
//                   passes; corridor 0's query extent, shuffled from lane
//                   0, suppresses the others.
//
// The one float step, the link score
//     beta = 0.01*k*dd + 0.5*log2(dd + 1),  round(max(alpha - beta, 0) * 8),
// is written with __fmul_rn / __fadd_rn / __fsub_rn, so that nvcc contracts
// nothing into an FMA: PyTorch's elementwise ops round after every step.
// The constant is (float)(0.01 * k), as PyTorch casts its Python scalar;
// log2f without fast math, rintf for torch.round (half to even).  Integers
// are int64, as in the plain versions (diag may be negative and >> stays
// arithmetic), except that chain_emit reduces the positions of a 32 as
// int32: positions fit the reference's int32 arrays, and I32MAX marks an
// anchor without a corridor.
//
// Bound on this card: bytes.  engine_anchor reads the minimizers, the index
// entries its occurrences touch (the bound counts ~2 log2 H probes a
// minimizer; the directory leaves one load of it and a few probes in one
// line) and writes 40 B an anchor; vote_corridor reads 32 B and writes 16 B
// an anchor; chain_emit reads 32 B and writes 65 B an anchor.  At the main
// path's batch (~4 x 10^4 anchors, groups of 1 to ~200 anchors and 1 to 3
// runs) each is well under a MB, so a launch is latency, not bandwidth: the
// designs keep each group's chain of dependent loads short (one pass over
// key_b, the rounds in shared memory and registers; one pass over the
// corridor segments) and the wrappers free of host syncs.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int64_t POS_MASK = (1LL << 30) - 1;
constexpr int STRAND_BIT = 30;
constexpr int64_t I32MAX = 2147483647LL;
constexpr int64_t INF = 1LL << 30;
constexpr int MAX_TOP_K = 8;
constexpr int WARPS = 4;                  // groups (warps) a block
constexpr int TILE = 256;                // runs a warp's vote tile holds
constexpr int VOTE_SMEM = WARPS * TILE * (8 + 4);  // keys, bins
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int64_t mn(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t mx(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t ab(int64_t a) { return a < 0 ? -a : a; }

__device__ __forceinline__ int64_t lower_bound(const int64_t* a, int64_t lo,
                                               int64_t hi, int64_t x) {
    while (lo < hi) {                     // first i in [lo, hi): a[i] >= x
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (a[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
    const int64_t q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}
__device__ __forceinline__ int64_t warp_min(int64_t v) {
    for (int o = 16; o; o >>= 1) v = mn(v, __shfl_xor_sync(FULL, v, o));
    return v;
}
__device__ __forceinline__ int64_t warp_max(int64_t v) {
    for (int o = 16; o; o >>= 1) v = mx(v, __shfl_xor_sync(FULL, v, o));
    return v;
}
__device__ __forceinline__ unsigned long long warp_max_u(unsigned long long v) {
    for (int o = 16; o; o >>= 1) {
        const unsigned long long w = __shfl_xor_sync(FULL, v, o);
        v = w > v ? w : v;
    }
    return v;
}

// ---------------------------------------------------------------------------
// engine_anchor

constexpr int ANCHOR_THREADS = 256;      // minimizers a block
constexpr int ANCHOR_WARPS = ANCHOR_THREADS / 32;
constexpr int ANCHOR_CHUNK = 16;         // occurrences whose loads go together

// The sum of v over the block, for every thread (one call a kernel: part
// is written once).
__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* part) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    int64_t t = 0;
#pragma unroll
    for (int j = 0; j < ANCHOR_WARPS; ++j) t += part[j];
    return t;
}

// no self hit, no filter row, and the pair-once gate
__device__ __forceinline__ bool anchor_taken(int64_t tr, int64_t qg,
                                             const int8_t* qmask) {
    return tr != qg && tr >= 0 && !(tr < qg && qmask[tr] > 0);
}

// Occurrences o0 .. o0 + ANCHOR_CHUNK - 1 of hash h from entry lo (none at
// max_occ or past hi): their hashes and rids loaded together, then the
// gates' qmask entries together.  Returns how many equal h (the run goes on
// past the chunk only when all do); taken gets bit j for each taken one.
__device__ __forceinline__ int anchor_chunk(
    const int64_t* __restrict__ idx_h, const int32_t* __restrict__ idx_rid,
    const int8_t* __restrict__ qmask, int64_t lo, int64_t hi, int64_t h,
    int64_t qg, int o0, int max_occ, int32_t (&rid)[ANCHOR_CHUNK],
    unsigned& taken) {
    bool eq[ANCHOR_CHUNK];
#pragma unroll
    for (int j = 0; j < ANCHOR_CHUNK; ++j) {
        const int64_t a = lo + o0 + j;
        const bool ok = o0 + j < max_occ && a < hi;
        eq[j] = ok && idx_h[a] == h;
        rid[j] = ok ? idx_rid[a] : -1;
    }
    int n = 0;
    bool run = true;
#pragma unroll
    for (int j = 0; j < ANCHOR_CHUNK; ++j) {
        run = run && eq[j];
        n += run;
    }
    taken = 0;
#pragma unroll
    for (int j = 0; j < ANCHOR_CHUNK; ++j)
        taken |= (unsigned)(j < n && anchor_taken(rid[j], qg, qmask)) << j;
    return n;
}

// stat (blocks + 2) int64, zeroed before the launch: each block's taken
// total + 1 once it is known, A, then the ticket that numbers the blocks in
// the order they start (a block waits only on blocks already running).  out
// (5, stride): qr, t_rid, t_pos, rel, qpos in the first A columns.
__global__ void __launch_bounds__(ANCHOR_THREADS) engine_anchor_kernel(
    const int64_t* __restrict__ qm_rid, const int64_t* __restrict__ qm_pos,
    const int64_t* __restrict__ qm_hash, const int64_t* __restrict__ qm_strand,
    const int64_t* __restrict__ q_rid_base,
    const int64_t* __restrict__ q_pos_base, const int8_t* __restrict__ qmask,
    const int64_t* __restrict__ idx_h, const int32_t* __restrict__ idx_rid,
    const int32_t* __restrict__ idx_pos, const int32_t* __restrict__ bucket,
    int64_t* stat, int64_t* __restrict__ out, int M, int64_t H,
    int64_t stride, int shift, int max_occ) {
    __shared__ int64_t part[ANCHOR_WARPS], part2[ANCHOR_WARPS];
    __shared__ int bid_s;
    if (threadIdx.x == 0)
        bid_s = (int)atomicAdd(reinterpret_cast<unsigned*>(stat + gridDim.x
                                                           + 1), 1u);
    __syncthreads();
    const int bid = bid_s;
    const int m = bid * ANCHOR_THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int64_t lo = 0, qg = 0, strand = 0, qpos = 0;
    int cnt = 0;
    unsigned mask = 0, first = 0;         // taken: of the first 32, chunk
    int32_t rid[ANCHOR_CHUNK], posst[ANCHOR_CHUNK];
    if (m < M) {
        const int64_t h = qm_hash[m];
        const int64_t row = qm_rid[m];
        qg = q_rid_base[row];
        strand = qm_strand[m];
        qpos = qm_pos[m] + q_pos_base[row];
        // h's bucket bounds its lower bound; outside [0, 2^32) the index
        int64_t hi = H;
        if (h >= 0 && h <= (int64_t)FULL) {
            const int64_t i = h >> shift;
            lo = bucket[i];
            hi = bucket[i + 1];
        }
        lo = lower_bound(idx_h, lo, hi, h);
        // the run of h from lo, at most max_occ entries, none past hi (the
        // entry at hi is in a later bucket)
        cnt = anchor_chunk(idx_h, idx_rid, qmask, lo, hi, h, qg, 0, max_occ,
                           rid, first);
        mask = first;
        for (int o0 = ANCHOR_CHUNK; cnt == o0 && o0 < max_occ;
             o0 += ANCHOR_CHUNK) {
            int32_t r[ANCHOR_CHUNK];
            unsigned t;
            cnt += anchor_chunk(idx_h, idx_rid, qmask, lo, hi, h, qg, o0,
                                max_occ, r, t);
            if (o0 < 32) mask |= t << o0;
        }
        // the first chunk's positions, in flight across the wait below
#pragma unroll
        for (int j = 0; j < ANCHOR_CHUNK; ++j)
            posst[j] = (first >> j) & 1 ? idx_pos[lo + j] : 0;
    }
    // the taken count: the first 32 by the mask, the gates again past them
    int take = __popc(mask);
    for (int o = 32; o < cnt; ++o)
        take += anchor_taken(idx_rid[lo + o], qg, qmask);
    // the block's exclusive scan of the taken counts, its total published
    int incl = take;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) part[w] = incl;
    __syncthreads();
    int64_t wpos = incl - take, total = 0;
#pragma unroll
    for (int j = 0; j < ANCHOR_WARPS; ++j) {
        wpos += j < w ? part[j] : 0;
        total += part[j];
    }
    if (threadIdx.x == 0)
        *reinterpret_cast<volatile int64_t*>(stat + bid) = total + 1;
    // the totals of the blocks before this one, each waited for
    int64_t s = 0;
    for (int j = threadIdx.x; j < bid; j += ANCHOR_THREADS) {
        int64_t v;
        do {
            v = *reinterpret_cast<volatile const int64_t*>(stat + j);
        } while (v == 0);
        s += v - 1;
    }
    const int64_t base = block_sum(s, part2);
    if (bid == (int)gridDim.x - 1 && threadIdx.x == 0)
        stat[gridDim.x] = base + total;
    if (!take) return;
    wpos += base;
    auto emit = [&](int64_t tr, int64_t ps) {
        out[wpos] = qg;
        out[stride + wpos] = tr;
        out[2 * stride + wpos] = ps & POS_MASK;
        out[3 * stride + wpos] = (strand ^ (ps >> STRAND_BIT)) & 1;
        out[4 * stride + wpos] = qpos;
        ++wpos;
    };
#pragma unroll
    for (int j = 0; j < ANCHOR_CHUNK; ++j)
        if ((first >> j) & 1) emit(rid[j], posst[j]);
    // the rest of a run longer than a chunk: past the first 32, the gates
    // again
    for (int o = ANCHOR_CHUNK; o < cnt; ++o)
        if (o < 32 ? (mask >> o) & 1
                   : anchor_taken(idx_rid[lo + o], qg, qmask))
            emit(idx_rid[lo + o], idx_pos[lo + o]);
}

// ---------------------------------------------------------------------------
// vote_corridor

// a run's argmax key: the larger count wins, then the smaller offset
__device__ __forceinline__ unsigned long long run_key(int64_t cnt,
                                                      int64_t off) {
    return ((unsigned long long)(cnt + 1) << 32)
           | (unsigned long long)(FULL - (unsigned)off);
}

// The group's runs into the warp's tile: a run's key at its number, its bin
// less the group's first at the same number in tbin.  One pass in 32s; a run
// starts where key_b >> 10 changes, and its count is the next start's offset
// less its own: the next start in the same 32 by the ballot's bits, else the
// run stays open until the next 32 with a start (or the group's end) closes
// it.  Returns the number of runs, or TILE + 1 once they outgrow the tile
// (the pass stops there).
__device__ __forceinline__ int vote_runs(const int64_t* __restrict__ key_b,
                                         int64_t s, int64_t e, int64_t bin0,
                                         unsigned long long* tkey, int* tbin,
                                         int lane) {
    int R = 0;                            // runs so far (warp-uniform)
    int open_idx = 0;                     // the open run: number, offset
    int64_t open_off = 0, carry = 0;      // carry: the last 32's last bin
    int64_t kb_next = s + lane < e ? key_b[s + lane] : 0;
    for (int64_t base = s; base < e; base += 32) {
        const int64_t i = base + lane;
        const bool in = i < e;
        const int64_t d = kb_next >> 10;
        if (base + 32 + lane < e) kb_next = key_b[base + 32 + lane];
        int64_t dp = __shfl_up_sync(FULL, d, 1);
        if (lane == 0) dp = carry;
        const bool st = in && (i == s || d != dp);
        const unsigned m = __ballot_sync(FULL, st);
        if (m) {
            if (base != s && lane == 0 && open_idx < TILE)
                tkey[open_idx] = run_key(base + __ffs(m) - 1 - s - open_off,
                                         open_off);
            if (st) {
                const int idx = R + __popc(m & ((1u << lane) - 1));
                const unsigned later = m & ~((2u << lane) - 1u);
                if (idx < TILE) {
                    tbin[idx] = (int)(d - bin0);
                    if (later)
                        tkey[idx] = run_key(__ffs(later) - 1 - lane, i - s);
                }
            }
            const int hi = 31 - __clz(m);
            open_idx = R + __popc(m) - 1;
            open_off = base + hi - s;
            R += __popc(m);
            if (R > TILE) return TILE + 1;
        }
        carry = __shfl_sync(FULL, d, 31);
    }
    if (lane == 0) tkey[open_idx] = run_key(e - s - open_off, open_off);
    return R;
}

__global__ void __launch_bounds__(WARPS * 32) vote_corridor_kernel(
    const int64_t* __restrict__ key_t, const int64_t* __restrict__ key_b,
    const int64_t* __restrict__ diag, const int64_t* __restrict__ qpos,
    const int64_t* __restrict__ gstart,  // (G + 1,): starts, then A on
    int64_t* __restrict__ key_t2, int64_t* __restrict__ qp2_key,
    int G, int diag_shift, int top_k) {
    extern __shared__ unsigned long long vote_tile[];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    unsigned long long* tkey = vote_tile + w * TILE;
    int* tbin = reinterpret_cast<int*>(vote_tile + WARPS * TILE) + w * TILE;
    const int64_t width = 1LL << diag_shift;
    const int64_t kc = top_k + 1;
    for (int g = blockIdx.x * WARPS + w; g < G; g += gridDim.x * WARPS) {
        const int64_t s = gstart[g], e = gstart[g + 1];
        if (s >= e) break;                // past the last group (warp-uniform)
        const int64_t bin0 = key_b[s] >> 10;
        // bins relative to the first fit 32 bits (positions are < 2^30)
        int R = TILE + 1;
        if ((key_b[e - 1] >> 10) - bin0 <= I32MAX)
            R = vote_runs(key_b, s, e, bin0, tkey, tbin, lane);
        __syncwarp();
        int64_t bb[MAX_TOP_K];
        unsigned ok = 0;                  // bit r: round r's bin is kept
        int64_t prim = 0;
        if (R <= TILE) {
            // top_k rounds of a warp argmax over the tile; a round's bin
            // blanks the runs within 2 of it in place (count -1) before the
            // next round reads them
            int brel = 0;
#pragma unroll
            for (int r = 0; r < MAX_TOP_K; ++r) {
                if (r < top_k) {
                    unsigned long long best = 0;
                    int bbin = 0;
                    for (int j = lane; j < R; j += 32) {
                        unsigned long long kj = tkey[j];
                        const int b = tbin[j];
                        if (r > 0 && abs(b - brel) <= 2 && (kj >> 32)) {
                            kj &= FULL;
                            tkey[j] = kj;
                        }
                        if (kj > best) {
                            best = kj;
                            bbin = b;
                        }
                    }
                    for (int o = 16; o; o >>= 1) {
                        const unsigned long long ob =
                            __shfl_xor_sync(FULL, best, o);
                        const int obin = __shfl_xor_sync(FULL, bbin, o);
                        if (ob > best) {
                            best = ob;
                            bbin = obin;
                        }
                    }
                    const int64_t bc = (int64_t)(best >> 32) - 1;
                    brel = bbin;
                    bb[r] = bin0 + bbin;
                    if (r == 0) prim = bc;
                    ok |= (unsigned)(bc * 2 >= prim && bc > 0) << r;
                }
            }
        } else {
            // more runs than the tile holds: every round walks the group's
            // runs in 32s, each run's end a binary search away
#pragma unroll
            for (int r = 0; r < MAX_TOP_K; ++r) {
                if (r < top_k) {
                    unsigned long long best = 0;
                    for (int64_t i = s + lane; i < e; i += 32) {
                        const int64_t d = key_b[i] >> 10;
                        if (i != s && (key_b[i - 1] >> 10) == d) continue;
                        int64_t cur =
                            lower_bound(key_b, i + 1, e, (d + 1) * 1024) - i;
#pragma unroll
                        for (int j = 0; j < MAX_TOP_K; ++j)
                            if (j < r && ab(d - bb[j]) <= 2) cur = -1;
                        const unsigned long long p = run_key(cur, i - s);
                        best = p > best ? p : best;
                    }
                    best = warp_max_u(best);
                    const int64_t bc = (int64_t)(best >> 32) - 1;
                    bb[r] = key_b[s + (int64_t)(FULL - (unsigned)(best & FULL))]
                            >> 10;
                    if (r == 0) prim = bc;
                    ok |= (unsigned)(bc * 2 >= prim && bc > 0) << r;
                }
            }
        }
        for (int64_t i = s + lane; i < e; i += 32) {
            const int64_t dg = diag[i];
            int corr = top_k;
            int64_t bestd = INF;
#pragma unroll
            for (int r = 0; r < MAX_TOP_K; ++r) {
                if (r < top_k && ((ok >> r) & 1)) {
                    const int64_t di =
                        ab(dg - ((bb[r] - (1LL << 20)) * width + width / 2));
                    if (di <= width && di < bestd) {
                        corr = r;
                        bestd = di;
                    }
                }
            }
            key_t2[i] = key_t[i] * kc + corr;
            qp2_key[i] = corr < top_k ? qpos[i] : I32MAX;
        }
        __syncwarp();                     // the tile is the next group's
    }
}

// ---------------------------------------------------------------------------
// chain_emit

// a link's score, quantised to 1/8, rounded as PyTorch's separate ops round
__device__ __forceinline__ int64_t link_q(int64_t dq, int64_t dt, int k,
                                          float c01k) {
    const float dd = (float)ab(dq - dt);
    const float alpha = (float)mn(mn(dq, dt), k);
    const float beta = __fadd_rn(__fmul_rn(c01k, dd),
                                 __fmul_rn(0.5f, log2f(__fadd_rn(dd, 1.0f))));
    const float sc = fmaxf(__fsub_rn(alpha, beta), 0.0f);
    return (int64_t)rintf(__fmul_rn(sc, 8.0f));
}

__global__ void __launch_bounds__(WARPS * 32) chain_emit_kernel(
    const int64_t* __restrict__ kq2, const int64_t* __restrict__ kt2,
    const int64_t* __restrict__ qp2, const int64_t* __restrict__ tp2,
    const int64_t* __restrict__ gstart,  // (G + 1,): starts, then A on
    uint8_t* __restrict__ emit, int64_t* __restrict__ rec,  // (A,), (8, A)
    int64_t A, int G, int k, int top_k, int min_cnt, int min_span,
    float c01k) {
    const int lane = threadIdx.x & 31;
    const int64_t kc = top_k + 1;
    constexpr int QINF = 1 << 30;         // the plain version's inf
    for (int g = blockIdx.x * WARPS + (threadIdx.x >> 5); g < G;
         g += gridDim.x * WARPS) {
        const int64_t s = gstart[g], e = gstart[g + 1];
        if (s >= e) break;                // past the last group (warp-uniform)
        const int64_t qname = kq2[s];
        const int64_t key_tq = floordiv(kt2[s], kc);
        const int64_t kbase = key_tq * kc;
        // lane c keeps corridor c's segment: link sum, near count, extents,
        // its last anchor and whether that one is near
        int64_t sum = 0, last = -1;
        int cnt = 0, qmin = INT_MAX, qmax = INT_MIN, tmin = INT_MAX,
            tmax = INT_MIN;
        bool lnear = false;
        int64_t cq = I32MAX, ct = 0;      // the previous 32's last anchor
        int cc = -1;
        int64_t nq = s + lane < e ? qp2[s + lane] : I32MAX;
        int64_t nt = s + lane < e ? tp2[s + lane] : 0;
        int64_t nk = s + lane < e ? kt2[s + lane] : kbase;
        for (int64_t base = s; base < e; base += 32) {
            const int64_t i = base + lane;
            const bool in = i < e;
            const int64_t q = nq, t = nt;
            const int c = (int)(nk - kbase);  // the corridor, 0..top_k
            const int64_t j = base + 32 + lane;
            if (j < e) {                  // the next 32's loads in flight
                nq = qp2[j];
                nt = tp2[j];
                nk = kt2[j];
            }
            int64_t pq = __shfl_up_sync(FULL, q, 1);
            int64_t pt = __shfl_up_sync(FULL, t, 1);
            int pc = __shfl_up_sync(FULL, c, 1);
            if (lane == 0) {
                pq = cq;
                pt = ct;
                pc = cc;
            }
            const bool near = in && q != I32MAX;
            int lq = 0;
            if (near && i > s && pc == c && pq != I32MAX && q > pq && t > pt)
                lq = (int)link_q(q - pq, t - pt, k, c01k);
            if (in) {                     // the records go in at the end
                emit[i] = 0;
#pragma unroll
                for (int f = 0; f < 8; ++f) rec[f * A + i] = 0;
            }
            const unsigned nearm = __ballot_sync(FULL, near);
            unsigned present = __reduce_or_sync(FULL, in ? 1u << c : 0u);
            while (present) {             // each corridor in this 32
                const int x = __ffs(present) - 1;
                present &= present - 1;
                const bool mine = in && c == x;
                const unsigned mm = __ballot_sync(FULL, mine);
                const int hi = 31 - __clz(mm);
                const int rsum = __reduce_add_sync(FULL, mine ? lq : 0);
                const int rqmin = __reduce_min_sync(
                    FULL, mine ? (near ? (int)q : QINF) : INT_MAX);
                const int rqmax = __reduce_max_sync(
                    FULL, mine ? (near ? (int)q : -QINF) : INT_MIN);
                const int rtmin = __reduce_min_sync(
                    FULL, mine ? (near ? (int)t : QINF) : INT_MAX);
                const int rtmax = __reduce_max_sync(
                    FULL, mine ? (near ? (int)t : -QINF) : INT_MIN);
                if (lane == x) {
                    sum += rsum;
                    cnt += __popc(mm & nearm);
                    qmin = min(qmin, rqmin);
                    qmax = max(qmax, rqmax);
                    tmin = min(tmin, rtmin);
                    tmax = max(tmax, rtmax);
                    last = base + hi;
                    lnear = (nearm >> hi) & 1;
                }
            }
            cq = __shfl_sync(FULL, q, 31);
            ct = __shfl_sync(FULL, t, 31);
            cc = __shfl_sync(FULL, c, 31);
        }
        // corridor 0's query extent, where it has a near anchor, suppresses
        // the secondary corridors that overlap it by half
        const int cnt0 = __shfl_sync(FULL, cnt, 0);
        const int q0min = __shfl_sync(FULL, qmin, 0);
        const int q0max = __shfl_sync(FULL, qmax, 0);
        const int64_t qs0 = cnt0 > 0 ? q0min : -INF;
        const int64_t qe0 = cnt0 > 0 ? (int64_t)q0max + k : -INF;
        __syncwarp();                     // the zeros before the records
        if (last >= 0) {
            const int64_t qs = qmin, qe = (int64_t)qmax + k;
            const int64_t ts = tmin, te = (int64_t)tmax + k;
            const int64_t oq = mn(qe, qe0) - mx(qs, qs0);
            const bool sec_ok = lane == 0 || oq * 2 < qe - qs;
            const int64_t span = mn(qe - qs, te - ts);
            if (lnear && sec_ok && cnt >= min_cnt && span >= min_span) {
                const int64_t vals[8] = {qname, key_tq & 1, qs, qe,
                                         key_tq >> 1, ts, te,
                                         mn(floordiv(sum, 8) + k, span)};
                emit[last] = 1;
#pragma unroll
                for (int f = 0; f < 8; ++f) rec[f * A + last] = vals[f];
            }
        }
    }
}

// resident blocks of a kernel on the current device: the grid's cap (a warp
// walks groups g, g + warps, ...)
int resident_blocks(const void* kernel, int smem) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, WARPS * 32, smem) != cudaSuccess)
        return 0;
    return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

extern "C" {

// One launch on ceil(M / 256) blocks, stat (blocks + 2 int64) zeroed
// first; out (5, stride) with stride at least A (M * max_occ: the launch
// does not wait for A); shift = 32 - b for a directory of 2^b + 1 starts.
int ndt_engine_anchor(const void* qm_rid, const void* qm_pos,
                      const void* qm_hash, const void* qm_strand,
                      const void* q_rid_base, const void* q_pos_base,
                      const void* qmask, const void* idx_h,
                      const void* idx_rid, const void* idx_pos,
                      const void* bucket, void* stat, void* out, int M,
                      long long H, long long stride, int shift, int max_occ,
                      void* stream) {
    if (M <= 0) return 0;
    const int blocks = (M + ANCHOR_THREADS - 1) / ANCHOR_THREADS;
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t rc =
        cudaMemsetAsync(stat, 0, (blocks + 2) * sizeof(int64_t), st);
    if (rc != cudaSuccess) return (int)rc;
    engine_anchor_kernel<<<blocks, ANCHOR_THREADS, 0, st>>>(
        (const int64_t*)qm_rid, (const int64_t*)qm_pos,
        (const int64_t*)qm_hash, (const int64_t*)qm_strand,
        (const int64_t*)q_rid_base, (const int64_t*)q_pos_base,
        (const int8_t*)qmask, (const int64_t*)idx_h, (const int32_t*)idx_rid,
        (const int32_t*)idx_pos, (const int32_t*)bucket, (int64_t*)stat,
        (int64_t*)out, M, (int64_t)H, (int64_t)stride, shift, max_occ);
    return (int)cudaGetLastError();
}

int ndt_vote_corridor(const void* key_t, const void* key_b, const void* diag,
                      const void* qpos, const void* gstart, void* key_t2,
                      void* qp2_key, int G, int diag_shift, int top_k,
                      void* stream) {
    if (G <= 0) return 0;
    if (top_k < 1 || top_k > MAX_TOP_K) return (int)cudaErrorInvalidValue;
    static int cap = 0;
    if (!cap) {
        if (VOTE_SMEM > 48 * 1024) {
            const cudaError_t rc = cudaFuncSetAttribute(
                vote_corridor_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, VOTE_SMEM);
            if (rc != cudaSuccess) return (int)rc;
        }
        cap = resident_blocks((const void*)vote_corridor_kernel, VOTE_SMEM);
        if (!cap) return (int)cudaGetLastError();
    }
    const int blocks = (int)std::min<int64_t>((G + WARPS - 1) / WARPS, cap);
    vote_corridor_kernel<<<blocks, WARPS * 32, VOTE_SMEM,
                           (cudaStream_t)stream>>>(
        (const int64_t*)key_t, (const int64_t*)key_b, (const int64_t*)diag,
        (const int64_t*)qpos, (const int64_t*)gstart, (int64_t*)key_t2,
        (int64_t*)qp2_key, G, diag_shift, top_k);
    return (int)cudaGetLastError();
}

int ndt_chain_emit(const void* kq2, const void* kt2, const void* qp2,
                   const void* tp2, const void* gstart, void* emit, void* rec,
                   long long A, int G, int k, int top_k, int min_cnt,
                   int min_span, float c01k, void* stream) {
    if (G <= 0) return 0;
    if (top_k < 1 || top_k > MAX_TOP_K) return (int)cudaErrorInvalidValue;
    static int cap = 0;
    if (!cap) {
        cap = resident_blocks((const void*)chain_emit_kernel, 0);
        if (!cap) return (int)cudaGetLastError();
    }
    const int blocks = (int)std::min<int64_t>((G + WARPS - 1) / WARPS, cap);
    chain_emit_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int64_t*)kq2, (const int64_t*)kt2, (const int64_t*)qp2,
        (const int64_t*)tp2, (const int64_t*)gstart, (uint8_t*)emit,
        (int64_t*)rec, (int64_t)A, G, k, top_k, min_cnt, min_span, c01k);
    return (int)cudaGetLastError();
}

}  // extern "C"
