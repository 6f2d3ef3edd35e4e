// The mesh path's routing: rows into per-destination buckets, and the seed
// sort's symmetrize pass that feeds it.
//
// Replaces the routing of two jitted programs of nextdenovo_tpu/parallel:
// distributed_overlap_step (dist_overlap.py:37; its bucketize, :87-104,
// routes the minimizers to the shard that owns their hash and the anchors
// back to their query's shard) and distributed_seed_sort_step
// (dist_sort.py:34; the records symmetrized to the seed-keyed view, gated
// and routed to shard seed % n).  The port ran both as plain PyTorch ops:
// one torch.nonzero, one host sync and one gather a field for each
// destination (n + 1 syncs a call, 9 on the mesh path), and the symmetrize
// pass as some thirty elementwise ops and two concatenations.
//
//   route_buckets    F int64 fields of N rows, a destination and a valid
//                    flag a row.  Bucket d holds, in row order, the first
//                    cap valid rows bound for d; rows bound outside [0, n)
//                    are counted apart.  The buckets lie one after the other
//                    in one (F, N) output (bucket d from the sum of the kept
//                    rows of the buckets before it), and counts[d] is the
//                    number of valid rows bound for d before the cap,
//                    counts[n] the number bound outside: the wrapper's one
//                    host sync reads them, and it copies each bucket out.
//                    One cooperative launch of as many blocks as the card
//                    holds at once, each a contiguous chunk of rows: (1) the
//                    block counts its rows by destination (a warp's rows of
//                    one destination found by __match_any_sync, one shared
//                    atomic a group) and publishes the counts; a grid-wide
//                    barrier; (2) every block sums the counts of the blocks
//                    before it and of all blocks, so it knows each bucket's
//                    start and its own first rank in each; (3) it walks its
//                    rows again, 256 at a time: a row's rank is its rank in
//                    its warp's group, plus the counts of the warps before
//                    it, plus the ranks given so far; a row of rank below
//                    cap writes its F fields.  The order is the rows' order,
//                    torch.nonzero's, so the buckets equal the plain
//                    version's.  (Every block needs every block's counts,
//                    hence the barrier, which the cooperative launch makes
//                    safe: every block is resident.  sketch.cu's
//                    sketch_minimizers needs only the counts before it and
//                    looks them back instead.)
//   seed_symmetrize  one thread a raw record (qname, rev, qs, qe, tname, ts,
//                    te, match; exclusive ends), both of its views at once:
//                    the keep gate (q != t, both spans >= 500), the
//                    seed-keyed view of each side with inclusive ends at rows
//                    r and R + r of the (8, 2R) output, each view's gate
//                    (keep, is_seed and the read length through clamped
//                    gathers) and its destination, the seed floor-mod n, as
//                    torch's % gives it.
//
// Bound on this card: bytes for both.  route_buckets reads the destination
// and flag of every row twice (8 + 1 B, once a pass) and the F fields of
// every kept row once, and writes those once; seed_symmetrize reads 64 B a
// record and writes 2 x 73 B.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_FIELDS = 8;
constexpr int MAX_DEST = 512;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Fields {
    const int64_t* p[MAX_FIELDS];
};

// shared ints of a block for n destinations: cnt, pre, tot (n + 1 each),
// start, base (n each), the warps' counts (WARPS x n)
__host__ __device__ constexpr int route_smem_ints(int n) {
    return 3 * (n + 1) + 2 * n + WARPS * n;
}

// -1: not valid; n: bound outside [0, n); else the destination
__device__ __forceinline__ int route_key(const int64_t* __restrict__ dest,
                                         const uint8_t* __restrict__ valid,
                                         int r, int n) {
    if (valid != nullptr && !valid[r]) return -1;
    const int64_t d = dest[r];
    return d >= 0 && d < n ? (int)d : n;
}

// Every block of the grid arrives before any leaves; the launch is
// cooperative, so all of them are resident.  The writes before it are
// visible after it (each thread's fence, then the block's).
__device__ __forceinline__ void grid_barrier(unsigned* arrived) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicAdd(arrived, 1u);
        while (*reinterpret_cast<volatile unsigned*>(arrived) < gridDim.x)
            __nanosleep(64);
        __threadfence();
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS) route_buckets_kernel(
    Fields f, int F, const int64_t* __restrict__ dest,
    const uint8_t* __restrict__ valid, int N, int n, int cap, int chunk,
    int64_t* __restrict__ out, int64_t stride, int64_t* __restrict__ counts,
    int* blk, unsigned* arrived) {
    extern __shared__ int sm[];
    const int n1 = n + 1;
    int* cnt = sm;
    int* pre = cnt + n1;
    int* tot = pre + n1;
    int* start = tot + n1;
    int* base = start + n;
    int* wcnt = base + n;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned below_mask = (1u << lane) - 1u;
    const int64_t lo64 = (int64_t)blockIdx.x * chunk;
    const int lo = (int)(lo64 < N ? lo64 : N);
    const int hi = (int)(lo + (int64_t)chunk < N ? lo + chunk : N);
    for (int i = tid; i < route_smem_ints(n); i += THREADS) sm[i] = 0;
    __syncthreads();

    // (1) this block's rows by destination, published
    for (int r0 = lo; r0 < hi; r0 += THREADS) {
        const int r = r0 + tid;
        const int key = r < hi ? route_key(dest, valid, r, n) : -1;
        const unsigned same = __match_any_sync(FULL, key);
        if (key >= 0 && (same & below_mask) == 0)
            atomicAdd(&cnt[key], __popc(same));
    }
    __syncthreads();
    for (int d = tid; d < n1; d += THREADS)
        blk[(int64_t)blockIdx.x * n1 + d] = cnt[d];
    grid_barrier(arrived);

    // (2) the rows of the blocks before this one, and of all blocks
    const int64_t all = (int64_t)gridDim.x * n1;
    const int64_t mine = (int64_t)blockIdx.x * n1;
    // a stride of whole rows of blk keeps each thread on one destination,
    // summed in registers first
    const int step = n1 <= THREADS ? THREADS / n1 * n1 : n1;
    for (int d0 = 0; d0 < step; d0 += THREADS) {
        const int e0 = d0 + tid;
        if (e0 >= step) break;
        int s_all = 0, s_pre = 0;
        for (int64_t e = e0; e < all; e += step) {
            const int v = __ldcg(blk + e);
            s_all += v;
            if (e < mine) s_pre += v;
        }
        const int d = e0 % n1;
        if (s_all) atomicAdd(&tot[d], s_all);
        if (s_pre) atomicAdd(&pre[d], s_pre);
    }
    __syncthreads();
    if (tid == 0) {
        int s = 0;
        for (int d = 0; d < n; ++d) {
            start[d] = s;
            s += tot[d] < cap ? tot[d] : cap;
        }
    }
    for (int d = tid; d < n; d += THREADS) base[d] = pre[d];
    if (blockIdx.x == 0)
        for (int d = tid; d < n1; d += THREADS) counts[d] = tot[d];
    __syncthreads();

    // (3) the stable scatter, 256 rows a round
    for (int r0 = lo; r0 < hi; r0 += THREADS) {
        const int r = r0 + tid;
        int key = r < hi ? route_key(dest, valid, r, n) : -1;
        if (key == n) key = -1;               // counted, not routed
        const unsigned same = __match_any_sync(FULL, key);
        const int below = __popc(same & below_mask);
        if (key >= 0 && below == 0) wcnt[warp * n + key] = __popc(same);
        __syncthreads();
        for (int d = tid; d < n; d += THREADS) {
            int run = base[d];
#pragma unroll
            for (int w = 0; w < WARPS; ++w) {
                const int c = wcnt[w * n + d];
                wcnt[w * n + d] = run;
                run += c;
            }
            base[d] = run;
        }
        __syncthreads();
        if (key >= 0) {
            const int rank = wcnt[warp * n + key] + below;
            if (rank < cap) {
                const int64_t o = (int64_t)start[key] + rank;
                for (int i = 0; i < F; ++i) out[i * stride + o] = f.p[i][r];
            }
        }
        __syncthreads();
        for (int i = tid; i < WARPS * n; i += THREADS) wcnt[i] = 0;
        __syncthreads();
    }
}

__global__ void __launch_bounds__(THREADS) seed_symmetrize_kernel(
    const int64_t* __restrict__ rec, const uint8_t* __restrict__ is_seed,
    const int64_t* __restrict__ lens, int64_t R, int64_t n_reads, int n,
    int64_t* __restrict__ cols, uint8_t* __restrict__ valid,
    int64_t* __restrict__ dest) {
    const int64_t r = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (r >= R) return;
    const int64_t* x = rec + r * 8;
    const int64_t q = x[0], rev = x[1], qs = x[2], qe = x[3];
    const int64_t t = x[4], ts = x[5], te = x[6], match = x[7];
    const bool keep = q != t && qe - qs >= 500 && te - ts >= 500;
    const int64_t top = n_reads - 1;
    const int64_t sq = q < 0 ? 0 : (q > top ? top : q);
    const int64_t st = t < 0 ? 0 : (t > top ? top : t);
    const bool vq = keep && is_seed[sq] != 0 && lens[sq] >= qe;
    const bool vt = keep && is_seed[st] != 0 && lens[st] >= te;
    const int64_t R2 = 2 * R;
    const int64_t a = r, b = R + r;
    cols[a] = q;               cols[b] = t;
    cols[R2 + a] = rev;        cols[R2 + b] = rev;
    cols[2 * R2 + a] = qs;     cols[2 * R2 + b] = ts;
    cols[3 * R2 + a] = qe - 1; cols[3 * R2 + b] = te - 1;
    cols[4 * R2 + a] = t;      cols[4 * R2 + b] = q;
    cols[5 * R2 + a] = ts;     cols[5 * R2 + b] = qs;
    cols[6 * R2 + a] = te - 1; cols[6 * R2 + b] = qe - 1;
    cols[7 * R2 + a] = match;  cols[7 * R2 + b] = match;
    valid[a] = vq;
    valid[b] = vt;
    const int64_t dq = q % n, dt = t % n;
    dest[a] = dq < 0 ? dq + n : dq;
    dest[b] = dt < 0 ? dt + n : dt;
}

}  // namespace

extern "C" {

// The blocks of route_buckets that the current device holds at once for n
// destinations (the cooperative launch's largest grid), or a negative CUDA
// error code.
int ndt_route_blocks(int n) {
    if (n < 1 || n > MAX_DEST) return -(int)cudaErrorInvalidValue;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, route_buckets_kernel, THREADS,
            route_smem_ints(n) * sizeof(int));
    if (err != cudaSuccess) return -(int)err;
    return sms * per_sm;
}

// One cooperative launch of `blocks` blocks (at most ndt_route_blocks(n)).
// fields: F (<= 8) pointers to (N,) int64; dest (N,) int64; valid (N,)
// uint8 or null (every row valid); out (F, stride) int64 with stride >= the
// kept rows; counts (n + 1) int64; scratch: 1 + blocks * (n + 1) int32,
// its first word zeroed here.
int ndt_route_buckets(const void* const* fields, int F, const void* dest,
                      const void* valid, int N, int n, int cap, void* out,
                      long long stride, void* counts, void* scratch,
                      int blocks, void* stream) {
    if (F < 1 || F > MAX_FIELDS || n < 1 || n > MAX_DEST || N < 0
        || cap < 0 || blocks < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    Fields f;
    for (int i = 0; i < MAX_FIELDS; ++i)
        f.p[i] = i < F ? (const int64_t*)fields[i] : nullptr;
    unsigned* arrived = (unsigned*)scratch;
    int* blk = (int*)scratch + 1;
    cudaError_t err = cudaMemsetAsync(arrived, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
    const int64_t per = ((int64_t)N + blocks - 1) / blocks;
    int chunk = (int)((per + 31) / 32 * 32);
    if (chunk < 32) chunk = 32;
    const int64_t* d = (const int64_t*)dest;
    const uint8_t* v = (const uint8_t*)valid;
    int64_t* o = (int64_t*)out;
    int64_t s = (int64_t)stride;
    int64_t* c = (int64_t*)counts;
    void* args[] = {&f, &F, &d, &v, &N, &n, &cap, &chunk, &o, &s, &c, &blk,
                    &arrived};
    err = cudaLaunchCooperativeKernel(
        (const void*)route_buckets_kernel, dim3(blocks), dim3(THREADS), args,
        route_smem_ints(n) * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// One launch: rec (R, 8) int64 raw records; is_seed (n_reads,) uint8; lens
// (n_reads,) int64; cols (8, 2R) int64, valid (2R,) uint8, dest (2R,) int64.
int ndt_seed_symmetrize(const void* rec, const void* is_seed,
                        const void* lens, long long R, long long n_reads,
                        int n, void* cols, void* valid, void* dest,
                        void* stream) {
    if (R <= 0) return 0;
    if (n < 1 || n_reads < 1) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (R + THREADS - 1) / THREADS;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    seed_symmetrize_kernel<<<(unsigned)blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const int64_t*)rec, (const uint8_t*)is_seed, (const int64_t*)lens,
        (int64_t)R, (int64_t)n_reads, n, (int64_t*)cols, (uint8_t*)valid,
        (int64_t*)dest);
    return (int)cudaGetLastError();
}

}  // extern "C"
