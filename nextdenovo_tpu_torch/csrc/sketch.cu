// The minimizer sketch's device program: k-mer hashes, window minima,
// selection and compaction in one launch, and homopolymer compression.
//
// Replaces the jitted programs sketch (nextdenovo_tpu/ops/sketch.py:141,
// k <= 31) and sketch_wide (:302, k <= 128, with hpc_compress :281 inside
// it), which XLA fuses into a few device kernels on the TPU and which the
// port ran as plain PyTorch ops on int64 (324 device kernels a call at a
// 16-row batch at k = 15, w = 5, 1288 at k = w = 51, by torch.profiler on
// the H100).  Two kernels take their place:
//
//   sketch_minimizers  one block of 256 threads a tile of a row, its tile
//                   index g taken from an atomic ticket, tiles in (row,
//                   tile) order.  A block hashes np positions, 2 or 4 a
//                   thread (choose_layout: 4 where a launch of 2 a thread
//                   would not fit on the card at once; more past w = 129,
//                   block_positions), and owns the tile of np - 2 (w - 1) of
//                   them between halos of w - 1.  (1) Its codes, masked to 2
//                   bits (N counts as A, and a position outside [0, length)
//                   reads 0: no valid k-mer reaches it), go into shared
//                   memory packed 16 bases to a word from two ballots of a
//                   warp's 32 codes: W MSB first, and RW LSB first and
//                   complemented.  (2) Each position's k-mer takes NB =
//                   ceil(k / 16) lanes (a template parameter), each one
//                   funnel shift of two neighbouring words: the forward
//                   lanes from W, the reverse-complement lanes from RW, the
//                   first lane masked to the 2 (k - 16 (NB - 1)) bits that
//                   carry bases.  The plain version's lanes are N = max(2,
//                   k / 16 + 1); where N = NB + 1 its first lane carries no
//                   base, compares equal and hashes to a constant, which
//                   goes into the hash's seed.  The canonical k-mer is the
//                   lesser (lanes compared from the first); a palindrome
//                   and a position whose k-mer passes the row's end get
//                   0xFFFFFFFF.  The block keeps a (hash, position << 1 |
//                   strand) pair a position.  (3) The window minima by
//                   doubling over shared memory, two levels a pass (four
//                   spans) while two remain: ceil(floor(log2 w) / 2) passes,
//                   each pair the lesser hash of its spans, the leftmost on
//                   a tie; then one pick of two overlapping spans a window
//                   start.  The position order of the spans makes that the
//                   leftmost argmin of the strict-< scan.  A window start
//                   that counts (s >= 0, s + w + k - 1 <= length) marks its
//                   argmin where it lies in the tile.  (4) A marked position
//                   inside the own gate on its position (or its pos_map
//                   entry) is selected.  Each thread takes np / 256
//                   consecutive positions; a ballot a position slot and the
//                   warps' sums give each selected position its rank in the
//                   tile.  (5) The tile's output offset by a decoupled
//                   look-back: thread 0 publishes the tile's count in its
//                   status word (flag and count in one 64-bit store); warp 0
//                   reads its predecessors' words, one a lane, nearest
//                   first, and adds the counts up to the nearest inclusive
//                   one, then publishes its own inclusive count.  A round
//                   that meets an unpublished word before it naps (32 ns,
//                   doubling to 256) and reads again.  A block waits only on
//                   tiles of earlier tickets, which have started.  (6) Each
//                   thread writes its selected positions at the tile's
//                   offset plus their rank: rid, position (pos_map's entry
//                   under hpc), hash and strand as int64, the first
//                   `stride` (the cap) of them; a warp's ranks are
//                   consecutive, so each field's writes are too.  The last
//                   tile writes the total, n_all, into a device scalar: the
//                   wrapper's one host sync reads it.  The C launcher zeroes
//                   the status words and the ticket with a cudaMemsetAsync
//                   on the same stream first.
//   hpc_compress    one block a row.  It walks the row's first `length`
//                   positions in rounds of 1024, keeps a position that
//                   starts a run of the raw codes (N forms runs of its own),
//                   places it by a ballot scan plus the running count, and
//                   then pads the rest of the row with code 4 and position
//                   0.
//
// All hash arithmetic is uint32, wrapping as the plain versions' masked
// int64 arithmetic does; outputs go out as int64 in [0, 2^32).
//
// Bound on this card: bytes for both at the main path's shapes (a code
// byte read a valid position, 32 B written a minimizer; 9 B a position for
// hpc_compress); the hashes come close at k = w = 51 (some 16 int32
// instructions a lane and position, four lanes).  sketch_minimizers keeps
// every intermediate of a tile in shared memory and writes only its
// minimizers: no per-position scratch goes through device memory.  What
// holds it back is latency, not work: a block's chain of the ticket, the
// code loads, eight barriers and the look-back is some 7000-9000 cycles
// (chip_variants.py --kernel sketch_minimizers, a copy with clock64 at
// each phase), and every tile's offset waits for the slowest tile before
// it, so the launch is as long as its slowest block.  Hence one wave where
// the card holds the launch: at the main path's query batch (16 x 9788, k =
// 15, w = 5) tiles of 504, 320 blocks of 8 warps, 2-3 an SM (16-24 warps);
// at the HiFi batch (32 x 16334, k = w = 51) and the main path's index
// batch (32 x 16384) 4 a thread: tiles of 924 and 1016, 576 and 544
// blocks, 4-5 an SM (32-40 warps).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;              // threads a block (minimizers)
constexpr int WARPS = THREADS / 32;
constexpr int HPC_THREADS = 1024;         // threads a block (hpc_compress)
constexpr int W_MAX = 2048;               // the wrapper raises past these
constexpr int NB_MAX = 9;                 // lanes: k <= 16 * 9 - 1
constexpr uint32_t UMAX = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
// a tile's status word: 0 unpublished, else a flag in the top two bits
// over a count
constexpr unsigned long long ST_AGG = 1ull << 62;   // the tile's own count
constexpr unsigned long long ST_INC = 2ull << 62;   // the tiles up to it
constexpr unsigned long long ST_VAL = ST_AGG - 1;

// positions a block hashes at window w: 2 a thread while the tile keeps
// THREADS or more, then as many more as that asks
__host__ __device__ inline int block_positions(int w) {
    const int per = (2 * (w - 1) + 2 * THREADS - 1) / THREADS;
    return THREADS * (per < 2 ? 2 : per);
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x = (x ^ (x >> 16)) * 0x7feb352du;
    x = (x ^ (x >> 15)) * 0x846ca68bu;
    return x ^ (x >> 16);
}

// bit m of a 16-bit x to bit 2m
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
    x = (x | (x << 8)) & 0x00FF00FFu;
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    x = (x | (x << 2)) & 0x33333333u;
    return (x | (x << 1)) & 0x55555555u;
}

// A status word is written and read whole (64-bit, single-copy atomic)
// and carries its count itself: no other data is published through it, so
// relaxed ordering at the card's scope is enough.  Release stores and
// acquire loads cost a fence each: on an H100 they took the look-back's
// median from some 4800 to 7300 cycles a block, the launch at the main
// path's query batch from 8.4 to 9.7 us (chip_variants.py --kernel
// sketch_minimizers --phases).
__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
}

// the lesser hash of two (hash, q << 1 | strand) pairs, a on a tie: a lies
// to the left of b
__device__ __forceinline__ uint2 pick(uint2 a, uint2 b) {
    return b.x < a.x ? b : a;
}

// The exclusive prefix of pred over the block in thread order, and the
// block's total.  Every thread of the block calls it; wsum holds a slot a
// warp.
template <int NT>
__device__ __forceinline__ int block_scan(bool pred, int* wsum, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned m = __ballot_sync(FULL, pred);
    if (lane == 0) wsum[warp] = __popc(m);
    __syncthreads();
    int off = 0, tot = 0;
#pragma unroll
    for (int j = 0; j < NT / 32; ++j) {
        const int s = wsum[j];
        off += j < warp ? s : 0;
        tot += s;
    }
    __syncthreads();                      // wsum is written again next call
    total = tot;
    return off + __popc(m & ((1u << lane) - 1u));
}

template <int NB>
__global__ void __launch_bounds__(THREADS) sketch_minimizers_kernel(
    const int8_t* __restrict__ codes, int64_t pitch,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ own_lo,
    const int32_t* __restrict__ own_hi, const int64_t* __restrict__ pos_map,
    int64_t* __restrict__ out, int64_t stride, int64_t* __restrict__ n_all,
    unsigned long long* status, unsigned int* ticket, int L, int n_tiles,
    int tile, int np, int nw, int k, int w) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* key0 = reinterpret_cast<uint2*>(smem);   // (hash, q << 1 | strand)
    uint2* key1 = key0 + np;
    uint32_t* W = reinterpret_cast<uint32_t*>(key1 + np);
    uint32_t* RW = W + nw;
    uint32_t* markh = RW + nw;            // the hash of a marked position
    uint8_t* mstr = reinterpret_cast<uint8_t*>(markh + tile);
    __shared__ int s_g;
    __shared__ int wsum[WARPS];
    __shared__ long long s_base;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nl = max(2, k / 16 + 1);    // the plain version's lanes
    const int nchunk = nw / 2;            // 32 codes a chunk
    if (tid == 0) s_g = (int)atomicAdd(ticket, 1u);
    {
        // while the ticket comes back: the code lines of the tile of
        // blockIdx.x into L2.  Tickets are not blockIdx, but every tile is
        // some block's blockIdx, and the blocks start together: the loads
        // of the launches of many waves come from L2 more often
        const int gb = blockIdx.x;
        const int64_t p = (int64_t)(gb % n_tiles) * tile - (w - 1) - 16 * nl
                          + 128 * (int64_t)tid;
        if (tid < (nchunk * 32 + 255) / 128 && p >= 0 && p < L)
            asm volatile("prefetch.global.L2 [%0];" ::
                         "l"(codes + (int64_t)(gb / n_tiles) * pitch + p));
    }
    for (int t = tid; t < tile; t += THREADS) markh[t] = UMAX;
    __syncthreads();
    const int g = s_g;
    const int b = g / n_tiles;
    const int64_t t0 = (int64_t)(g % n_tiles) * tile;
    const int64_t base = t0 - (w - 1);    // the first hashed position
    const int64_t P0 = (base - 16 * nl) & ~(int64_t)15;  // the first packed
    const int8_t* row = codes + (int64_t)b * pitch;
    // the length, the gate and the raw codes at once; the length masks the
    // codes after
    const int len = min(max(lengths[b], 0), L);
    const int64_t olo = own_lo != nullptr ? own_lo[b] : 0;
    const int64_t ohi = own_hi != nullptr ? own_hi[b] : 0;
    // (1) the codes, 32 a warp and chunk, R chunks a warp and round, packed
    // by two ballots a chunk; lanes 2r and 2r + 1 write chunk r's words
    constexpr int R = 3;
    for (int c0 = warp; c0 < nchunk; c0 += R * WARPS) {
        uint32_t cd[R], b0[R], b1[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int c = c0 + r * WARPS;
            const int64_t p = P0 + 32 * (int64_t)c + lane;
            cd[r] = (c < nchunk && p >= 0 && p < L) ? (uint32_t)row[p] : 0u;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int64_t p = P0 + 32 * (int64_t)(c0 + r * WARPS) + lane;
            const uint32_t x = p < len ? cd[r] & 3u : 0u;
            b0[r] = __ballot_sync(FULL, x & 1u);
            b1[r] = __ballot_sync(FULL, x & 2u);
        }
        const int r = lane >> 1, half = lane & 1;
        const int c = c0 + r * WARPS;
        if (r < R && c < nchunk) {
            uint32_t y0 = b0[0], y1 = b1[0];
#pragma unroll
            for (int rr = 1; rr < R; ++rr) {
                if (r == rr) {
                    y0 = b0[rr];
                    y1 = b1[rr];
                }
            }
            const uint32_t x0 = (y0 >> (16 * half)) & 0xFFFFu;
            const uint32_t x1 = (y1 >> (16 * half)) & 0xFFFFu;
            W[2 * c + half] = spread16(__brev(x0) >> 16)
                              | spread16(__brev(x1) >> 16) << 1;
            RW[2 * c + half] = ~(spread16(x0) | spread16(x1) << 1);
        }
    }
    __syncthreads();
    // (2) the canonical hash and strand of every hashed position
    const int nb0 = k - 16 * (NB - 1);    // bases of the first lane
    const uint32_t m0 = nb0 >= 16 ? UMAX : (1u << (2 * nb0)) - 1u;
    const uint32_t seed = nl > NB ? mix32(0x9e3779b9u) : 0x9e3779b9u;
    for (int q = tid; q < np; q += THREADS) {
        const int64_t p = base + q;
        uint32_t h = UMAX, st = 1;
        if (p >= 0 && p + k <= len) {
            const int rf = (int)(p + k - 16 * NB - P0), rr = (int)(p - P0);
            const int uf = rf >> 4, ur = (rr >> 4) + NB - 1;
            const int sf = 2 * (rf & 15), sr = 2 * (rr & 15);
            uint32_t f[NB], r[NB];
#pragma unroll
            for (int l = 0; l < NB; ++l) {
                f[l] = __funnelshift_l(W[uf + l + 1], W[uf + l], sf);
                r[l] = __funnelshift_r(RW[ur - l], RW[ur - l + 1], sr);
            }
            f[0] &= m0;
            r[0] &= m0;
            bool less = false, eq = true;
#pragma unroll
            for (int l = 0; l < NB; ++l) {
                if (eq && f[l] != r[l]) {
                    less = f[l] < r[l];
                    eq = false;
                }
            }
            if (!eq) {
                h = seed;
#pragma unroll
                for (int l = 0; l < NB; ++l) h = mix32((less ? f[l] : r[l]) ^ h);
                st = less ? 0u : 1u;
            }
        }
        key0[q] = make_uint2(h, (uint32_t)q << 1 | st);
    }
    __syncthreads();
    // (3) spans of 2^d by doubling, two levels a pass while two remain,
    // then a pick of two spans a window start
    const int p2 = 31 - __clz(w);
    uint2* src = key0;
    uint2* dst = key1;
    for (int d = 0; d < p2;) {
        const int h = 1 << d;
        if (d + 2 <= p2) {
            for (int q = tid; q <= np - 4 * h; q += THREADS)
                dst[q] = pick(pick(src[q], src[q + h]),
                              pick(src[q + 2 * h], src[q + 3 * h]));
            d += 2;
        } else {
            for (int q = tid; q <= np - 2 * h; q += THREADS)
                dst[q] = pick(src[q], src[q + h]);
            d += 1;
        }
        __syncthreads();
        uint2* t = src;
        src = dst;
        dst = t;
    }
    const int off = w - (1 << p2);
    for (int q = tid; q < tile + w - 1; q += THREADS) {
        const int64_t s = base + q;
        if (s >= 0 && s + w + k - 1 <= len) {
            const uint2 m = pick(src[q], src[q + off]);
            const int at = (int)(m.y >> 1) - (w - 1);
            if (m.x != UMAX && at >= 0 && at < tile) {
                markh[at] = m.x;          // all its window starts agree
                mstr[at] = (uint8_t)(m.y & 1u);
            }
        }
    }
    __syncthreads();
    // (4) selection, each thread its `per` consecutive positions; a
    // position's rank from the warps' ballots, a ballot a position slot
    const int per = np / THREADS;
    const int64_t* prow = pos_map != nullptr ? pos_map + (int64_t)b * L
                                             : nullptr;
    const unsigned below = (1u << lane) - 1u;
    unsigned selm = 0;
    int rank = 0, wtot = 0;
    for (int j = 0; j < per; ++j) {
        const int t = tid * per + j;
        const int64_t i = t0 + t;
        bool sel = t < tile && i < L && markh[t] != UMAX;
        if (sel && own_lo != nullptr) {
            const int64_t op = prow != nullptr ? prow[i] : i;
            sel = op >= olo && op < ohi;
        }
        const unsigned m = __ballot_sync(FULL, sel);
        selm |= (unsigned)sel << j;
        rank += __popc(m & below);        // the lanes before, this slot
        wtot += __popc(m);
    }
    if (lane == 0) wsum[warp] = wtot;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
        const int s = wsum[j];
        rank += j < warp ? s : 0;
        total += s;
    }
    if (tid == 0)
        st_status(status + g, (g == 0 ? ST_INC : ST_AGG)
                              | (unsigned long long)total);
    // (5) the decoupled look-back: a status word a lane, nearest first; a
    // round that meets an unpublished word before the nearest inclusive
    // one naps, longer each time, and reads again (every block of the card
    // polls the same few lines: 8 words a lane, or no nap, slowed the
    // launch by half)
    if (warp == 0) {
        long long excl = 0;
        if (g > 0) {
            int end = g - 1;              // the nearest tile of the round
            unsigned nap = 32;
            for (;;) {
                const int j = end - lane;
                const unsigned long long v = j >= 0 ? ld_status(status + j)
                                                    : ST_INC;
                const unsigned f = (unsigned)(v >> 62);
                const unsigned incm = __ballot_sync(FULL, f == 2);
                const unsigned badm = __ballot_sync(FULL, f == 0);
                const int lp = incm ? __ffs(incm) - 1 : 31;
                if (badm & (FULL >> (31 - lp))) {   // lanes 0..lp
                    __nanosleep(nap);
                    nap = min(2 * nap, 256u);
                    continue;
                }
                long long s = lane <= lp ? (long long)(v & ST_VAL) : 0;
#pragma unroll
                for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
                excl += s;
                if (incm) break;
                end -= 32;
            }
        }
        if (lane == 0) {
            const long long inc = excl + total;
            if (g > 0) st_status(status + g, ST_INC | (unsigned long long)inc);
            s_base = excl;
            if (g == (int)gridDim.x - 1) *n_all = inc;
        }
    }
    __syncthreads();
    // (6) each selected position written at the tile's offset plus its
    // rank: a warp's ranks are consecutive, so each field's writes are too
    const long long o0 = s_base + rank;
    int done = 0;
    for (int j = 0; j < per; ++j) {
        if (!(selm >> j & 1u)) continue;
        const long long o = o0 + done++;
        if (o < stride) {
            const int t = tid * per + j;
            const int64_t i = t0 + t;
            out[o] = b;
            out[stride + o] = prow != nullptr ? prow[i] : i;
            out[2 * stride + o] = markh[t];
            out[3 * stride + o] = mstr[t];
        }
    }
}

__global__ void __launch_bounds__(HPC_THREADS) hpc_compress_kernel(
    const int8_t* __restrict__ codes, int64_t pitch,
    const int32_t* __restrict__ lengths, int8_t* __restrict__ codes_hpc,
    int64_t* __restrict__ pos_map, int32_t* __restrict__ lengths_hpc,
    int L) {
    __shared__ int wsum[HPC_THREADS / 32];
    const int b = blockIdx.x, tid = threadIdx.x;
    const int len = min(max(lengths[b], 0), L);
    const int8_t* row = codes + (int64_t)b * pitch;
    int8_t* crow = codes_hpc + (int64_t)b * L;
    int64_t* prow = pos_map + (int64_t)b * L;
    int kept = 0;
    for (int c0 = 0; c0 < len; c0 += HPC_THREADS) {
        const int p = c0 + tid;
        int8_t c = 0;
        bool keep = false;
        if (p < len) {
            c = row[p];
            keep = p == 0 || c != row[p - 1];
        }
        int total;
        const int o = kept + block_scan<HPC_THREADS>(keep, wsum, total);
        if (keep) {
            crow[o] = c;
            prow[o] = p;
        }
        kept += total;
    }
    for (int j = kept + tid; j < L; j += HPC_THREADS) {
        crow[j] = 4;
        prow[j] = 0;
    }
    if (tid == 0) lengths_hpc[b] = kept;
}

// A launch's layout: positions a block hashes (np, a multiple of THREADS),
// its tile (np - 2 (w - 1)), the tiles a row, the blocks, the packed words
// a block and its shared memory.
struct Layout {
    int np, tile, n_tiles, nw;
    long long G;
    size_t smem;
    cudaError_t err;
};

template <int NB>
Layout layout(int B, int L, int w, int np) {
    Layout a;
    a.np = np;
    a.tile = np - 2 * (w - 1);
    a.n_tiles = (L + a.tile - 1) / a.tile;
    a.G = (long long)B * a.n_tiles;
    a.nw = (np + 32 * NB + 64) / 16;      // even: whole chunks
    a.smem = (size_t)np * 16 + (size_t)a.nw * 8 + (size_t)a.tile * 5;
    a.err = cudaSuccess;
    return a;
}

// 2 positions a thread where all the blocks fit on the card at once (one
// wave: the last tile's look-back then waits on no second wave), else 4
// where w lets tiles of 2 a thread exist; past w = 129 as block_positions
// asks.  err holds a failure to read the card.
template <int NB>
Layout choose_layout(int B, int L, int w) {
    Layout a = layout<NB>(B, L, w, block_positions(w));
    if (a.np != 2 * THREADS) return a;
    int dev = 0, sms = 0, per_sm = 0;
    a.err = cudaGetDevice(&dev);
    if (a.err == cudaSuccess)
        a.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
    if (a.err == cudaSuccess)
        a.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, sketch_minimizers_kernel<NB>, THREADS, a.smem);
    if (a.err == cudaSuccess && a.G > (long long)sms * per_sm)
        a = layout<NB>(B, L, w, 4 * THREADS);
    return a;
}

template <int NB>
int launch_minimizers(const void* codes, int64_t pitch, const void* lengths,
                      const void* own_lo, const void* own_hi,
                      const void* pos_map, void* out, int64_t stride,
                      void* n_all, unsigned long long* status,
                      long long n_status, int B, int L, int k, int w,
                      cudaStream_t st) {
    const Layout a = choose_layout<NB>(B, L, w);
    if (a.err != cudaSuccess) return (int)a.err;
    if (a.G + 1 > n_status || a.G > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSuccess;
    if (a.smem > 48 * 1024)               // w past some 700
        e = cudaFuncSetAttribute(sketch_minimizers_kernel<NB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)a.smem);
    if (e == cudaSuccess)
        e = cudaMemsetAsync(status, 0, (size_t)(a.G + 1) * 8, st);
    if (e != cudaSuccess) return (int)e;
    sketch_minimizers_kernel<NB><<<(int)a.G, THREADS, a.smem, st>>>(
        (const int8_t*)codes, pitch, (const int32_t*)lengths,
        (const int32_t*)own_lo, (const int32_t*)own_hi,
        (const int64_t*)pos_map, (int64_t*)out, stride, (int64_t*)n_all,
        status, (unsigned int*)(status + a.G), L, a.n_tiles, a.tile, a.np,
        a.nw, k, w);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One cudaMemsetAsync and one launch on B * ceil(L / tile) blocks (the
// layout of choose_layout).  codes (B, L) int8 with `pitch` bytes between
// rows; lengths, own_lo, own_hi (B,) int32 (own_* both null for no gate);
// pos_map (B, L) int64 or null; out (4, stride) int64 (rid, pos, hash,
// strand), the first `stride` minimizers in (row, position) order; n_all
// one int64, all of them; status n_status int64 of scratch, at least one a
// block of the least positions a block (block_positions) and one more.
int ndt_sketch_minimizers(const void* codes, long long pitch,
                          const void* lengths, const void* own_lo,
                          const void* own_hi, const void* pos_map, void* out,
                          long long stride, void* n_all, void* status,
                          long long n_status, int B, int L, int k, int w,
                          void* stream) {
    if (B <= 0 || L <= 0) return 0;
    const int nb = (k + 15) / 16;
    if (k < 1 || nb > NB_MAX || w < 1 || w > W_MAX || pitch < L
        || (own_lo == nullptr) != (own_hi == nullptr))
        return (int)cudaErrorInvalidValue;
    unsigned long long* stw = (unsigned long long*)status;
    const cudaStream_t st = (cudaStream_t)stream;
#define NDT_MINI(NB_) launch_minimizers<NB_>(codes, pitch, lengths, own_lo, \
        own_hi, pos_map, out, stride, n_all, stw, n_status, B, L, k, w, st)
    switch (nb) {
        case 1: return NDT_MINI(1);
        case 2: return NDT_MINI(2);
        case 3: return NDT_MINI(3);
        case 4: return NDT_MINI(4);
        case 5: return NDT_MINI(5);
        case 6: return NDT_MINI(6);
        case 7: return NDT_MINI(7);
        case 8: return NDT_MINI(8);
        default: return NDT_MINI(9);
    }
#undef NDT_MINI
}

// The positions a block of ndt_sketch_minimizers hashes at this shape on
// the current card (np; its tile is np - 2 (w - 1)), 0 on failure.
int ndt_sketch_layout(int B, int L, int k, int w) {
    if (B <= 0 || L <= 0 || k < 1 || (k + 15) / 16 > NB_MAX || w < 1
        || w > W_MAX)
        return 0;
    Layout a;
    switch ((k + 15) / 16) {
        case 1: a = choose_layout<1>(B, L, w); break;
        case 2: a = choose_layout<2>(B, L, w); break;
        case 3: a = choose_layout<3>(B, L, w); break;
        case 4: a = choose_layout<4>(B, L, w); break;
        case 5: a = choose_layout<5>(B, L, w); break;
        case 6: a = choose_layout<6>(B, L, w); break;
        case 7: a = choose_layout<7>(B, L, w); break;
        case 8: a = choose_layout<8>(B, L, w); break;
        default: a = choose_layout<9>(B, L, w); break;
    }
    return a.err == cudaSuccess ? a.np : 0;
}

// One launch on B blocks: codes (B, L) int8 with `pitch` bytes between
// rows, lengths (B,) int32; codes_hpc (B, L) int8, pos_map (B, L) int64,
// lengths_hpc (B,) int32, every entry written.
int ndt_hpc_compress(const void* codes, long long pitch, const void* lengths,
                     void* codes_hpc, void* pos_map, void* lengths_hpc, int B,
                     int L, void* stream) {
    if (B <= 0 || L <= 0) return 0;
    if (pitch < L) return (int)cudaErrorInvalidValue;
    hpc_compress_kernel<<<B, HPC_THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)codes, (int64_t)pitch, (const int32_t*)lengths,
        (int8_t*)codes_hpc, (int64_t*)pos_map, (int32_t*)lengths_hpc, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
