// The mesh path's routing: rows into per-destination buckets
// (mesh.bucketize), and the seed sort's raw records into buckets of their
// seed-keyed views (dist_sort.seed_route).
//
// Replaces the routing of two jitted programs of nextdenovo_tpu/parallel:
// distributed_overlap_step (dist_overlap.py:37; its bucketize, :87-104,
// routes the minimizers to the shard that owns their hash and the anchors
// back to their query's shard) and distributed_seed_sort_step
// (dist_sort.py:34; the records symmetrized to the seed-keyed view, gated
// and routed to shard seed % n).
//
// Bucket d holds, in row order, the first cap valid rows bound for d;
// counts[d] is the number of valid rows bound for d before the cap,
// counts[n] the number bound outside [0, n).  Each source is two kernels
// around the wrapper's one host sync:
//
//   route_count      (one launch) one block a tile of TILE rows.  Each
//                    row's destination and flag are read once and turned
//                    into a 2-byte key (d < n, n = outside, NONE = not
//                    valid), written for the scatter; the tile's keys are
//                    counted (a warp's rows of one key found by
//                    __match_any_sync, one shared atomic a group) and the
//                    tile's counts published.  The last block to take a
//                    ticket (one a stream, set back to 0 by that block, so
//                    no memset precedes a launch) scans the tiles' counts
//                    once: for up to 127 destinations in chunks copied to
//                    shared memory (24 loads a thread in flight), each
//                    column's tiles in groups, one thread a (group,
//                    column); beyond that a thread a column.  It writes
//                    each tile's first rank in each bucket and the totals.
//   route_scatter    (one launch) the wrapper has read the totals and
//                    allocated each bucket at its kept size, (F,
//                    min(counts[d], cap)), and hands their addresses (a
//                    kernel argument up to ARG_DEST destinations, else a
//                    table copied in first).  One block a tile: the first
//                    PREFETCH fields of its rows are sent to L2 first, so
//                    that the memory works while the tile is ranked (every
//                    block of a launch ranks at the same time); its keys
//                    (16 bytes a thread) ranked at once, each warp its rows
//                    in steps of 32 lanes by __match_any_sync with a counter
//                    a destination; the warps' counters scanned into each
//                    row's slot in the tile's runs of one destination; then
//                    field by field each kept row is staged in shared memory
//                    at its slot (loads 16 bytes a thread where aligned) and
//                    each destination's run written straight into its
//                    bucket, consecutive threads on consecutive addresses,
//                    so sectors are written whole but at a run's two ends.
//                    The order is the rows' order, torch.nonzero's, so the
//                    buckets equal the plain version's.
//
// The seed sort's route (seed_route_count, seed_route_scatter: the same two
// kernels with the raw records as their rows, SEED_TILE records a tile, so
// that a shard's few thousand records still fill many blocks) reads the
// shard's records (qname, rev, qs, qe, tname, ts, te, match; exclusive
// ends): view r is record r seen from its query, view R + r from its
// target.  The count kernel makes both views' keys from one read of a
// record (16 bytes a load): the keep gate (q != t, both spans >= 500),
// each view's gate (is_seed and the read length through clamped gathers)
// and its destination, the seed floor-mod n as torch's % gives it; a
// record tile counts into two view tiles.  The scatter loads each kept
// view's record once and stages all eight of its fields (ends made
// inclusive), so a tile takes one round trip to memory, not eight, and no
// (8, 2R) intermediate is ever written.
//
// Bound on this card: bytes.  Every row's destination (8 B) and flag (1 B)
// read once, the F fields of every kept row read once and written once; for
// the seed route every record read once (64 B) and every kept view written
// once (64 B).  Beyond it the kernels move 4 B a row (the key written and
// read back) and, for the seed route, the records of kept views again.
//
// What the design does about the earlier one-launch cooperative kernel
// (a grid barrier, then a scatter 256 rows a round): (1) the
// destination and flag are read once, into the key; (2) the tiles' counts
// are scanned once by the last block (b x (n + 1) loads, not b^2 (n + 1));
// (3) a tile is ranked at once (8 steps a warp, then three barriers for the
// whole tile), not 256 rows behind four barriers; (4) each destination's
// run of a tile is written from shared memory, whole sectors; (5) the
// buckets are written in place, once, so the wrapper copies nothing and no
// (F, N) buffer exists for a bucket's view to hold; (6) up to MAX_DEST
// destinations (shared memory grows by 20 B a destination).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 2048;              // rows a tile of mesh.bucketize
constexpr int SEED_TILE = 512;          // records a tile of the seed route
constexpr int MAX_FIELDS = 8;
constexpr int MAX_DEST = 8192;
constexpr int BATCH = 8;                // loads in flight in the wide scan
constexpr int SCAN_INTS = 6144;         // the last block's table in shared
constexpr int SCAN_LOADS = SCAN_INTS / THREADS;   // its loads a thread
constexpr int PREFETCH = 2;             // fields sent to L2 while ranking
constexpr int SCATTER_BLOCKS = 6;       // blocks an SM, at most 40 registers
constexpr int ARG_DEST = 64;            // buckets' addresses passed by value
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned NONE = 0xFFFFu;      // a key: not valid; a slot: not kept

struct Fields {
    const int64_t* p[MAX_FIELDS];
};

// the buckets' addresses for up to ARG_DEST destinations
struct Dst {
    unsigned long long p[ARG_DEST];
};

// a shard's raw records (R, 8) and the seed gate's tables
struct Records {
    const int64_t* rec;
    const uint8_t* is_seed;
    const int64_t* lens;
    int R;
    int64_t n_reads;
};

// part (THREADS int), then the counts (n + 1 int, twice for records),
// which the last block of a narrow table reuses for its chunks of the
// tiles' counts (SCAN_INTS int)
__host__ __device__ constexpr int count_smem(int n, bool records) {
    return (THREADS + (2 * (n + 1) <= THREADS ? SCAN_INTS
                                              : (records ? 2 : 1) * (n + 1)))
        * (int)sizeof(int);
}

// stage (a field of TILE rows, or all eight of SEED_TILE views: int64),
// the tile's keys, each row's slot, each slot's destination (uint16 a
// row), sbase (n int), the warps' counters (WARPS x n uint16)
__host__ __device__ constexpr int scatter_smem(int n, bool records) {
    return (records ? SEED_TILE * 8 * 8 + 3 * SEED_TILE * 2
                    : TILE * 8 + 3 * TILE * 2)
        + n * 4 + WARPS * n * 2;
}

__device__ __forceinline__ void count_key(int* cnt, unsigned key,
                                          unsigned lt) {
    const unsigned peers = __match_any_sync(FULL, key);
    if (key != NONE && (peers & lt) == 0) atomicAdd(&cnt[key], __popc(peers));
}

__device__ __forceinline__ unsigned seed_key(int64_t seed, int n) {
    int64_t d = seed % n;
    return (unsigned)(d < 0 ? d + n : d);
}

// Warp 0 publishes the block's counts (rows of blk, n1 each, from
// shared memory, after a barrier), fences its own writes only (the other
// threads' keys are read by the next kernel, after the launch's end) and
// takes a ticket: true in the block that takes the last one.  The ticket
// is 0 before a launch; the last block sets it back to 0.
__device__ __forceinline__ bool publish_last(
    const int* cnt, int* const* rows, int nrows, int n1, unsigned* ticket,
    unsigned blocks) {
    __shared__ bool last;
    __syncthreads();
    if (threadIdx.x < 32) {
        for (int r = 0; r < nrows; ++r)
            for (int d = threadIdx.x; d < n1; d += 32)
                rows[r][d] = cnt[r * n1 + d];
        __threadfence();
        __syncwarp();
        if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == blocks - 1;
    }
    __syncthreads();
    if (last) __threadfence();
    return last;
}

// The same entries become run plus the entries before them; returns the
// run after the last.
__device__ __forceinline__ int column_prefix(int* blk, int b0, int b1,
                                             int n1, int d, int run) {
    for (int b = b0; b < b1; b += BATCH) {
        int v[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
            v[k] = b + k < b1 ? __ldcg(blk + (int64_t)(b + k) * n1 + d) : 0;
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            if (b + k < b1) blk[(int64_t)(b + k) * n1 + d] = run;
            run += v[k];
        }
    }
    return run;
}

// The last block: blk (tiles x n1 counts) becomes each tile's exclusive
// prefix in each column, counts the columns' totals.  Narrow tables (n1 <=
// THREADS / 2): chunks of tiles copied into shared memory (tab), each
// column's tiles of a chunk in G groups, one thread a (group, column), the
// column's carry across chunks in thread `column`; a chunk comes in one
// round of loads (SCAN_LOADS a thread); wide ones: one thread a column,
// BATCH loads in flight.
__device__ void scan_tiles(int* blk, int tiles, int n1,
                           int64_t* __restrict__ counts, int* part,
                           int* tab) {
    const int tid = threadIdx.x;
    if (n1 > THREADS / 2) {
        for (int d = tid; d < n1; d += THREADS)
            counts[d] = column_prefix(blk, 0, tiles, n1, d, 0);
        return;
    }
    const int G = THREADS / n1, TB = SCAN_INTS / n1;
    const int d = tid % n1, g = tid / n1;
    int carry = 0;
    for (int c0 = 0; c0 < tiles; c0 += TB) {
        const int nb = min(TB, tiles - c0), m = nb * n1;
        int* src = blk + (int64_t)c0 * n1;
        {
            int v[SCAN_LOADS];
#pragma unroll
            for (int k = 0; k < SCAN_LOADS; ++k) {
                const int i = tid + k * THREADS;
                v[k] = i < m ? __ldcg(src + i) : 0;
            }
#pragma unroll
            for (int k = 0; k < SCAN_LOADS; ++k) {
                const int i = tid + k * THREADS;
                if (i < m) tab[i] = v[k];
            }
        }
        __syncthreads();
        const int seg = (nb + G - 1) / G;
        const int b0 = min(nb, g * seg), b1 = min(nb, b0 + seg);
        if (g < G) {
            int s = 0;
            for (int b = b0; b < b1; ++b) s += tab[b * n1 + d];
            part[tid] = s;
        }
        __syncthreads();
        if (tid < n1) {
            int run = carry;
            for (int k = 0; k < G; ++k) {
                const int v = part[k * n1 + tid];
                part[k * n1 + tid] = run;
                run += v;
            }
            carry = run;
        }
        __syncthreads();
        if (g < G) {
            int run = part[tid];
            for (int b = b0; b < b1; ++b) {
                const int v = tab[b * n1 + d];
                tab[b * n1 + d] = run;
                run += v;
            }
        }
        __syncthreads();
        for (int i = tid; i < m; i += THREADS) src[i] = tab[i];
        __syncthreads();
    }
    if (tid < n1) counts[tid] = carry;
}

// Exclusive scan of a[0..n) in place, a block of THREADS threads, each a
// run of ceil(n / THREADS) entries; returns the total.
__device__ int block_exclusive_scan(int* a, int n, int* wsum) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int per = (n + THREADS - 1) / THREADS;
    const int b0 = min(n, tid * per), b1 = min(n, b0 + per);
    int s = 0;
    for (int i = b0; i < b1; ++i) s += a[i];
    int x = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        if (w < warp) before += wsum[w];
        total += wsum[w];
    }
    int run = before + x - s;
    for (int i = b0; i < b1; ++i) {
        const int c = a[i];
        a[i] = run;
        run += c;
    }
    __syncthreads();
    return total;
}

__global__ void __launch_bounds__(THREADS) route_count_kernel(
    const int64_t* __restrict__ dest, const uint8_t* __restrict__ valid,
    int N, int n, uint16_t* __restrict__ keys, int* blk, unsigned* ticket,
    int64_t* __restrict__ counts) {
    constexpr int STEPS = TILE / THREADS;       // rows a thread
    extern __shared__ int sm[];
    const int n1 = n + 1, tid = threadIdx.x;
    const unsigned lt = (1u << (tid & 31)) - 1u;
    int* cnt = sm + THREADS;
    for (int d = tid; d < n1; d += THREADS) cnt[d] = 0;
    __syncthreads();
    const int64_t lo = (int64_t)blockIdx.x * TILE;
    int64_t dv[STEPS];
    bool ok[STEPS];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
        const int64_t r = lo + j * THREADS + tid;
        ok[j] = r < N && (valid == nullptr || valid[r]);
        dv[j] = r < N ? dest[r] : 0;
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
        const int64_t r = lo + j * THREADS + tid;
        const unsigned key = !ok[j] ? NONE
            : dv[j] >= 0 && dv[j] < n ? (unsigned)dv[j] : (unsigned)n;
        if (r < N) keys[r] = (uint16_t)key;
        count_key(cnt, key, lt);
    }
    int* const rows[1] = {blk + (int64_t)blockIdx.x * n1};
    if (publish_last(cnt, rows, 1, n1, ticket, gridDim.x)) {
        scan_tiles(blk, gridDim.x, n1, counts, sm, sm + THREADS);
        if (tid == 0) *ticket = 0;
    }
}

__global__ void __launch_bounds__(THREADS) seed_route_count_kernel(
    Records s, int n, uint16_t* __restrict__ keys, int* blk,
    unsigned* ticket, int64_t* __restrict__ counts) {
    constexpr int H = SEED_TILE / THREADS;      // records a thread
    extern __shared__ int sm[];
    const int n1 = n + 1, tid = threadIdx.x;
    const unsigned lt = (1u << (tid & 31)) - 1u;
    int* cq = sm + THREADS;
    int* ct = cq + n1;
    for (int d = tid; d < 2 * n1; d += THREADS) cq[d] = 0;
    __syncthreads();
    const int R = s.R;
    const int64_t top = s.n_reads - 1;
    const int64_t lo = (int64_t)blockIdx.x * SEED_TILE;
    // the thread's records at once (16 bytes a load), then their gathers
    int64_t q[H], qs[H], qe[H], t[H], ts[H], te[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
        const int64_t r = lo + k * THREADS + tid;
        q[k] = t[k] = qs[k] = ts[k] = 0;
        qe[k] = te[k] = -1;                      // the keep gate fails
        if (r < R) {
            const longlong2* x =
                reinterpret_cast<const longlong2*>(s.rec + r * 8);
            const longlong2 a = x[0], b = x[1], c = x[2], e = x[3];
            q[k] = a.x; qs[k] = b.x; qe[k] = b.y;
            t[k] = c.x; ts[k] = c.y; te[k] = e.x;
        }
    }
    bool sgq[H], sgt[H];
    int64_t lq[H], lt_[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
        sgq[k] = sgt[k] = false;
        lq[k] = lt_[k] = 0;
        if (q[k] != t[k] && qe[k] - qs[k] >= 500 && te[k] - ts[k] >= 500) {
            const int64_t sq = q[k] < 0 ? 0 : (q[k] > top ? top : q[k]);
            const int64_t st = t[k] < 0 ? 0 : (t[k] > top ? top : t[k]);
            sgq[k] = s.is_seed[sq] != 0;
            lq[k] = s.lens[sq];
            sgt[k] = s.is_seed[st] != 0;
            lt_[k] = s.lens[st];
        }
    }
#pragma unroll
    for (int k = 0; k < H; ++k) {
        const int64_t r = lo + k * THREADS + tid;
        const unsigned kq = sgq[k] && lq[k] >= qe[k] ? seed_key(q[k], n) : NONE;
        const unsigned kt = sgt[k] && lt_[k] >= te[k] ? seed_key(t[k], n) : NONE;
        if (r < R) {
            keys[r] = (uint16_t)kq;
            keys[R + r] = (uint16_t)kt;
        }
        count_key(cq, kq, lt);
        count_key(ct, kt, lt);
    }
    // record tile b counts into view tiles b and gridDim.x + b
    int* const rows[2] = {blk + (int64_t)blockIdx.x * n1,
                          blk + (int64_t)(gridDim.x + blockIdx.x) * n1};
    if (publish_last(cq, rows, 2, n1, ticket, gridDim.x)) {
        scan_tiles(blk, 2 * gridDim.x, n1, counts, sm, sm + THREADS);
        if (tid == 0) *ticket = 0;
    }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One tile: rows [lo, lo + rows) of the keys.  Rows: TILE rows, field by
// field.  Records: view tiles [0, gridDim.x / 2) are the query views, the
// rest the target views, SEED_TILE views a tile, all eight fields at once.
template <bool RECORDS>
__global__ void __launch_bounds__(THREADS, RECORDS ? 2 : SCATTER_BLOCKS)
route_scatter_kernel(
    Fields f, Records s, int F, const uint16_t* __restrict__ keys,
    const int* __restrict__ blk, const int64_t* __restrict__ counts,
    const __grid_constant__ Dst dst,
    const unsigned long long* __restrict__ table, int N, int n, int cap) {
    constexpr int T = RECORDS ? SEED_TILE : TILE;
    constexpr int STEPS = T / THREADS;          // rows a thread
    constexpr int WARP_ROWS = T / WARPS;
    constexpr int STAGE = RECORDS ? 8 * T : T;  // int64 staged at once
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int wsum[WARPS];
    __shared__ const int64_t* fp[MAX_FIELDS];
    int64_t* stage = reinterpret_cast<int64_t*>(smem);
    uint16_t* skey = reinterpret_cast<uint16_t*>(stage + STAGE);
    uint16_t* sslot = skey + T;
    uint16_t* sdest = sslot + T;
    int* sbase = reinterpret_cast<int*>(sdest + T);
    uint16_t* wcnt = reinterpret_cast<uint16_t*>(sbase + n);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;

    int64_t lo, rlo = 0;
    int rows, side = 0;
    if (RECORDS) {
        const int half = gridDim.x / 2;
        side = (int)blockIdx.x >= half;
        rlo = (int64_t)(blockIdx.x - side * half) * T;
        lo = side * (int64_t)s.R + rlo;
        rows = (int)min((int64_t)T, s.R - rlo);
        // the tile's records on their way to L2 while it is ranked
        for (int a = tid * 2; a < rows; a += 2 * THREADS)
            prefetch_l2(s.rec + (rlo + a) * 8);
    } else {
        lo = (int64_t)blockIdx.x * T;
        rows = (int)min((int64_t)T, N - lo);
        // the first PREFETCH fields likewise, a 128-byte line a thread
#pragma unroll
        for (int i = 0; i < PREFETCH; ++i) {
            if (i < F) {
                for (int a = tid * 16; a < rows; a += 16 * THREADS)
                    prefetch_l2(f.p[i] + lo + a);
            }
        }
        if (tid == 0) {
#pragma unroll
            for (int i = 0; i < MAX_FIELDS; ++i) fp[i] = f.p[i];
        }
    }
    // the tile's first rank in each bucket (the count kernel's scan), in
    // flight while the tile is ranked
    const int* first = blk + (int64_t)blockIdx.x * (n + 1);
    const int first0 = tid < n ? __ldg(first + tid) : 0;
    for (int i = tid; i < WARPS * n; i += THREADS) wcnt[i] = 0;
    const uint16_t* kp = keys + lo;
    if (rows == T && (reinterpret_cast<uintptr_t>(kp) & 15) == 0) {
        if (tid < T / 8)
            reinterpret_cast<uint4*>(skey)[tid] =
                reinterpret_cast<const uint4*>(kp)[tid];
    } else {
        for (int i = tid; i < T; i += THREADS)
            skey[i] = i < rows ? kp[i] : (uint16_t)NONE;
    }
    __syncthreads();

    // (1) a row's rank among its warp's rows of its destination: the
    // warp's rows in steps of 32, a counter a destination
    uint16_t* wc = wcnt + warp * n;
    unsigned kr[STEPS];                         // rank << 16 | key
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
        const unsigned k = skey[warp * WARP_ROWS + j * 32 + lane];
        const unsigned peers = __match_any_sync(FULL, k);
        const bool routed = k < (unsigned)n;
        const int base = routed ? wc[k] : 0;
        __syncwarp();
        if (routed && (peers & lt) == 0) wc[k] = (uint16_t)(base + __popc(peers));
        __syncwarp();
        kr[j] = (unsigned)(base + __popc(peers & lt)) << 16 | k;
    }
    __syncthreads();

    // (2) per destination: the rows of the warps before, the tile's count,
    // the slot where its run starts, and sbase = the bucket position of
    // slot 0 (the tiles before, from the count kernel's scan)
    for (int d = tid; d < n; d += THREADS) {
        int run = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const int c = wcnt[w * n + d];
            wcnt[w * n + d] = (uint16_t)run;
            run += c;
        }
        sbase[d] = run;
    }
    __syncthreads();
    const int routed = block_exclusive_scan(sbase, n, wsum);
    for (int d = tid; d < n; d += THREADS) {
        const int t0 = sbase[d];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) wcnt[w * n + d] += (uint16_t)t0;
        sbase[d] = (d == tid ? first0 : __ldg(first + d)) - t0;
    }
    __syncthreads();

    // (3) each row's slot; a row is kept where its bucket position is
    // below cap
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
        const unsigned k = kr[j] & 0xFFFFu;
        unsigned slot = NONE;
        if (k < (unsigned)n) {
            const int sl = wc[k] + (int)(kr[j] >> 16);
            sdest[sl] = (uint16_t)k;
            if (sl + sbase[k] < cap) slot = sl;
        }
        sslot[warp * WARP_ROWS + j * 32 + lane] = (uint16_t)slot;
    }
    __syncthreads();

    // (4) the kept rows staged at their slots, then each destination's run
    // written into its bucket
    if (RECORDS) {
        // a kept view's eight fields from its record: the query view
        // (q, rev, qs, qe - 1, t, ts, te - 1, match), the target view
        // (t, rev, ts, te - 1, q, qs, qe - 1, match)
        longlong2 u[STEPS][4];
#pragma unroll
        for (int j = 0; j < STEPS; ++j) {
            const int a = j * THREADS + tid;
            if (sslot[a] != NONE) {
                const longlong2* x =
                    reinterpret_cast<const longlong2*>(s.rec + (rlo + a) * 8);
#pragma unroll
                for (int k = 0; k < 4; ++k) u[j][k] = x[k];
            }
        }
#pragma unroll
        for (int j = 0; j < STEPS; ++j) {
            const unsigned sl = sslot[j * THREADS + tid];
            if (sl == NONE) continue;
            const longlong2 a = u[j][0], b = u[j][1], c = u[j][2], e = u[j][3];
            const int64_t v[8] = {
                side ? c.x : a.x, a.y, side ? c.y : b.x,
                (side ? e.x : b.y) - 1, side ? a.x : c.x, side ? b.x : c.y,
                (side ? b.y : e.x) - 1, e.y};
#pragma unroll
            for (int i = 0; i < 8; ++i) stage[i * T + sl] = v[i];
        }
        __syncthreads();
        for (int sl = tid; sl < routed; sl += THREADS) {
            const int d = sdest[sl];
            const int pos = sl + sbase[d];
            if (pos < cap) {
                const int64_t c = __ldg(counts + d);
                const int64_t kept = c < cap ? c : cap;
                int64_t* out = reinterpret_cast<int64_t*>(
                    n <= ARG_DEST ? dst.p[d] : __ldg(table + d));
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    out[i * kept + pos] = stage[i * T + sl];
            }
        }
        return;
    }
    constexpr int PAIRS = T / 2 / THREADS;
    for (int i = 0; i < F; ++i) {
        int64_t va[PAIRS], vb[PAIRS];
        unsigned sa[PAIRS], sb[PAIRS];
        const int64_t* p = fp[i] + lo;
        const bool vec = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
            const int a = 2 * (q * THREADS + tid);
            sa[q] = sslot[a];
            sb[q] = sslot[a + 1];
            va[q] = vb[q] = 0;
            if (sa[q] == NONE && sb[q] == NONE) continue;
            if (vec && a + 1 < rows) {
                const longlong2 v =
                    __ldcs(reinterpret_cast<const longlong2*>(p + a));
                va[q] = v.x;
                vb[q] = v.y;
            } else {
                if (sa[q] != NONE) va[q] = p[a];
                if (sb[q] != NONE) vb[q] = p[a + 1];
            }
        }
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
            if (sa[q] != NONE) stage[sa[q]] = va[q];
            if (sb[q] != NONE) stage[sb[q]] = vb[q];
        }
        __syncthreads();
        for (int sl = tid; sl < routed; sl += THREADS) {
            const int d = sdest[sl];
            const int pos = sl + sbase[d];
            if (pos < cap) {
                const int64_t c = __ldg(counts + d);
                const int64_t kept = c < cap ? c : cap;
                int64_t* out = reinterpret_cast<int64_t*>(
                    n <= ARG_DEST ? dst.p[d] : __ldg(table + d));
                out[i * kept + pos] = stage[sl];
            }
        }
        __syncthreads();
    }
}

cudaError_t smem_attr(const void* kernel, int bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int scatter_launch(bool records, const Fields& f, const Records& s, int F,
                   const void* keys, const void* blk, const void* counts,
                   int tiles, int N, int n, int cap,
                   const void* const* dst, void* table, cudaStream_t st) {
    const void* kernel = records
        ? (const void*)route_scatter_kernel<true>
        : (const void*)route_scatter_kernel<false>;
    const int bytes = scatter_smem(n, records);
    cudaError_t err = smem_attr(kernel, bytes);
    Dst d = {};
    if (n <= ARG_DEST)
        for (int i = 0; i < n; ++i) d.p[i] = (unsigned long long)dst[i];
    else if (err == cudaSuccess)
        err = cudaMemcpyAsync(table, dst, (size_t)n * sizeof(void*),
                              cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return (int)err;
    const uint16_t* k = (const uint16_t*)keys;
    const int* b = (const int*)blk;
    const int64_t* c = (const int64_t*)counts;
    const unsigned long long* t = (const unsigned long long*)table;
    if (records)
        route_scatter_kernel<true><<<tiles, THREADS, bytes, st>>>(
            f, s, F, k, b, c, d, t, N, n, cap);
    else
        route_scatter_kernel<false><<<tiles, THREADS, bytes, st>>>(
            f, s, F, k, b, c, d, t, N, n, cap);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the scatter kernel one SM of the current device holds at once
// at n destinations (its shared memory grows with n), or a negative CUDA
// error code; cudaErrorInvalidValue past MAX_DEST.
int ndt_route_resident(int n) {
    if (n < 1 || n > MAX_DEST) return -(int)cudaErrorInvalidValue;
    const void* kernel = (const void*)route_scatter_kernel<false>;
    cudaError_t err = smem_attr(kernel, scatter_smem(n, false));
    int per_sm = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, route_scatter_kernel<false>, THREADS,
            scatter_smem(n, false));
    if (err != cudaSuccess) return -(int)err;
    return per_sm;
}

// The count of N > 0 rows: dest (N,) int64; valid (N,) uint8 or null
// (every row valid); keys (N,) uint16, written; blk: tiles * (n + 1) int32
// (tiles = ceil(N / 2048)); ticket: one uint32, 0 before and after (launches
// that share it must run one after the other: one a stream); counts
// (n + 1,) int64, written.
int ndt_route_count(const void* dest, const void* valid, int N, int n,
                    void* keys, void* blk, void* ticket, void* counts,
                    void* stream) {
    if (N < 1 || n < 1 || n > MAX_DEST) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int tiles = (int)(((int64_t)N + TILE - 1) / TILE);
    const int bytes = count_smem(n, false);
    const cudaError_t err = smem_attr((const void*)route_count_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    route_count_kernel<<<tiles, THREADS, bytes, st>>>(
        (const int64_t*)dest, (const uint8_t*)valid, N, n, (uint16_t*)keys,
        (int*)blk, (unsigned*)ticket, (int64_t*)counts);
    return (int)cudaGetLastError();
}

// The scatter after ndt_route_count on the same keys, blk and counts:
// fields F (<= 8) pointers to (N,) int64; cap >= 0; dst n host-side
// addresses of the buckets, bucket d (F, min(counts[d], cap)) int64, passed
// by value up to 64 destinations, else copied into table (n,) (device
// scratch).
int ndt_route_scatter(const void* const* fields, int F, const void* keys,
                      const void* blk, const void* counts, int N, int n,
                      int cap, const void* const* dst, void* table,
                      void* stream) {
    if (F < 1 || F > MAX_FIELDS || N < 1 || n < 1 || n > MAX_DEST || cap < 0)
        return (int)cudaErrorInvalidValue;
    Fields f;
    for (int i = 0; i < MAX_FIELDS; ++i)
        f.p[i] = i < F ? (const int64_t*)fields[i] : nullptr;
    Records s = {};
    const int tiles = (int)(((int64_t)N + TILE - 1) / TILE);
    return scatter_launch(false, f, s, F, keys, blk, counts, tiles, N, n, cap,
                          dst, table, (cudaStream_t)stream);
}

// The seed sort's count of R > 0 records: rec (R, 8) int64, 16-byte
// aligned; is_seed (n_reads,) uint8; lens (n_reads,) int64; keys (2R,)
// uint16, written; blk: 2 * ceil(R / 512) * (n + 1) int32; ticket as
// ndt_route_count's; counts (n + 1,) int64, written.
int ndt_seed_route_count(const void* rec, const void* is_seed,
                         const void* lens, int R, long long n_reads, int n,
                         void* keys, void* blk, void* ticket, void* counts,
                         void* stream) {
    if (R < 1 || n_reads < 1 || n < 1 || n > MAX_DEST)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int tiles = (int)(((int64_t)R + SEED_TILE - 1) / SEED_TILE);
    const int bytes = count_smem(n, true);
    const cudaError_t err =
        smem_attr((const void*)seed_route_count_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    Records s = {(const int64_t*)rec, (const uint8_t*)is_seed,
                 (const int64_t*)lens, R, (int64_t)n_reads};
    seed_route_count_kernel<<<tiles, THREADS, bytes, st>>>(
        s, n, (uint16_t*)keys, (int*)blk, (unsigned*)ticket,
        (int64_t*)counts);
    return (int)cudaGetLastError();
}

// The seed sort's scatter after ndt_seed_route_count: the buckets' eight
// fields made from rec (R, 8); dst, table as ndt_route_scatter's.
int ndt_seed_route_scatter(const void* rec, int R, const void* keys,
                           const void* blk, const void* counts, int n,
                           int cap, const void* const* dst, void* table,
                           void* stream) {
    if (R < 1 || n < 1 || n > MAX_DEST || cap < 0)
        return (int)cudaErrorInvalidValue;
    Fields f = {};
    Records s = {(const int64_t*)rec, nullptr, nullptr, R, 0};
    const int tiles = 2 * (int)(((int64_t)R + SEED_TILE - 1) / SEED_TILE);
    return scatter_launch(true, f, s, 8, keys, blk, counts, tiles, 2 * R, n,
                          cap, dst, table, (cudaStream_t)stream);
}

}  // extern "C"
