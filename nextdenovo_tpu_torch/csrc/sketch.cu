// The minimizer sketch's device program: k-mer hashes, window minima,
// selection and compaction, and homopolymer compression.
//
// Replaces the jitted programs sketch (nextdenovo_tpu/ops/sketch.py:141,
// k <= 31) and sketch_wide (:302, k <= 128, with hpc_compress :281 inside
// it), which XLA fuses into a few device kernels on the TPU and which the
// port ran as plain PyTorch ops on int64: k-mers by shift-or doubling, the
// hash through a 16-bit split multiply, the window minima by another
// doubling, a loop of w rounds for the selection and torch.nonzero at the
// end (324 device kernels a call at a 16-row batch at k = 15, w = 5, 1288
// at k = w = 51, by torch.profiler on the H100).  Three kernels take its
// place:
//
//   sketch_select   one block a tile of TILE positions of one row (blocks
//                   in (row, tile) order).  The tile's codes and a halo of
//                   w - 1 positions on the left and w + k - 2 on the right
//                   go into shared memory, masked to 2 bits (N counts as A,
//                   and codes at or past the row's length read as 0: no
//                   valid k-mer reaches them).  Each position of the tile
//                   and of both halos builds its forward and reverse-
//                   complement k-mers by a direct loop over its k bases into
//                   N uint32 lanes, MSB first (N = max(2, k / 16 + 1), a
//                   template parameter: fwd = sum c[i+j] << 2(k-1-j), rc =
//                   sum (c[i+j]^3) << 2j), takes the canonical one (the
//                   lesser, lanes compared from the first; a palindrome and
//                   a position whose k-mer passes the row's end get
//                   0xFFFFFFFF) and hashes it (hash_lanes: for N = 2 the
//                   same as hash_kmer).  Then each window start of the tile
//                   and its left halo that counts (s >= 0, s + w + k - 1 <=
//                   length) takes the leftmost argmin of its w hashes
//                   (strict <) and marks it where it lies in the tile; a
//                   marked position whose hash is not 0xFFFFFFFF, inside the
//                   own gate on its position (or its pos_map entry), is
//                   selected.  It writes a flag byte a position (strand,
//                   selected), the hash of each selected position, and the
//                   tile's count.
//   sketch_emit     the same grid.  A block's first output is the sum of
//                   the counts of the tiles before it, which it adds up
//                   itself; its positions then go out in order in four
//                   rounds of a ballot scan: rid, position (pos_map's entry
//                   under hpc), hash and strand as int64, the first `stride`
//                   (the cap) of them.  The last block writes the total,
//                   n_all, into a device scalar: the wrapper's one host sync
//                   reads it.
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
// Bound on this card: int32 instructions for sketch_select (the direct
// k-base loop costs some 6 instructions a base and lane pass for the fwd and
// rc k-mers, 16 N a position, and the argmin w a window start: at k = w =
// 51 and 4 lanes about 1000 instructions a position), bytes for the other
// two (one code byte read and a flag byte written a position; 32 B an
// emitted minimizer; 9 B a position for hpc_compress).  The design keeps
// every intermediate of a tile in shared memory and makes one pass over the
// codes; making the k-mers rolling (a shift a base) and the minima a
// monotone queue is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;                // positions a block (select, emit)
constexpr int THREADS = 256;              // threads a block (select, emit)
constexpr int HPC_THREADS = 1024;         // threads a block (hpc_compress)
constexpr int W_MAX = 2048;               // the wrapper raises past these
constexpr int N_MAX = 9;                  // lanes: k <= 16 * 9 - 1
constexpr uint32_t UMAX = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x = (x ^ (x >> 16)) * 0x7feb352du;
    x = (x ^ (x >> 15)) * 0x846ca68bu;
    return x ^ (x >> 16);
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

// The forward and reverse-complement k-mers of the k codes at c, as N
// uint32 lanes MSB first: fwd lane l holds bases j = k-1-16(N-1-l)-q and rc
// lane l bases j = 16(N-1-l)+q, each at bit 2q, q = 0..15.
template <int N>
__device__ __forceinline__ void pack(const uint8_t* c, int k,
                                     uint32_t (&f)[N], uint32_t (&r)[N]) {
#pragma unroll
    for (int l = 0; l < N; ++l) {
        uint32_t fv = 0, rv = 0;
        const int jf = k - 1 - 16 * (N - 1 - l);
        const int jr = 16 * (N - 1 - l);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
            const int j1 = jf - q, j2 = jr + q;
            if (j1 >= 0) fv |= (uint32_t)c[j1] << (2 * q);
            if (j2 < k) rv |= (uint32_t)(c[j2] ^ 3) << (2 * q);
        }
        f[l] = fv;
        r[l] = rv;
    }
}

template <int N>
__global__ void __launch_bounds__(THREADS) sketch_select_kernel(
    const int8_t* __restrict__ codes, int64_t pitch,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ own_lo,
    const int32_t* __restrict__ own_hi, const int64_t* __restrict__ pos_map,
    uint32_t* __restrict__ hash, uint8_t* __restrict__ flags,
    int32_t* __restrict__ counts, int L, int n_tiles, int k, int w) {
    extern __shared__ uint32_t smem[];
    const int tid = threadIdx.x;
    const int b = blockIdx.x / n_tiles;
    const int64_t t0 = (int64_t)(blockIdx.x % n_tiles) * TILE;
    const int len = min(max(lengths[b], 0), L);
    const int np = TILE + 2 * (w - 1);    // hashed positions
    const int nc = np + k - 1;            // their codes
    uint32_t* sh = smem;
    uint8_t* sc = (uint8_t*)(sh + np);
    uint8_t* sst = sc + nc;               // the tile's strands
    uint8_t* mark = sst + TILE;           // a window's argmin lies here
    const int64_t p0 = t0 - (w - 1);
    const int8_t* row = codes + (int64_t)b * pitch;
    for (int q = tid; q < nc; q += THREADS) {
        const int64_t p = p0 + q;
        sc[q] = (p >= 0 && p < len) ? (uint8_t)(row[p] & 3) : 0;
    }
    for (int t = tid; t < TILE; t += THREADS) mark[t] = 0;
    __syncthreads();
    for (int q = tid; q < np; q += THREADS) {
        const int64_t p = p0 + q;
        uint32_t h = UMAX;
        uint8_t strand = 1;
        if (p >= 0 && p + k <= len) {
            uint32_t f[N], r[N];
            pack<N>(sc + q, k, f, r);
            bool less = false, eq = true;
#pragma unroll
            for (int l = 0; l < N; ++l) {
                if (eq && f[l] != r[l]) {
                    less = f[l] < r[l];
                    eq = false;
                }
            }
            strand = less ? 0 : 1;
            if (!eq) {
                h = 0x9e3779b9u;
#pragma unroll
                for (int l = 0; l < N; ++l) h = mix32((less ? f[l] : r[l]) ^ h);
            }
        }
        sh[q] = h;
        const int t = q - (w - 1);
        if (t >= 0 && t < TILE) sst[t] = strand;
    }
    __syncthreads();
    for (int qs = tid; qs < TILE + w - 1; qs += THREADS) {
        const int64_t s = p0 + qs;
        if (s >= 0 && s + w + k - 1 <= len) {
            uint32_t best = sh[qs];
            int arg = 0;
            for (int o = 1; o < w; ++o) {
                const uint32_t v = sh[qs + o];
                if (v < best) {
                    best = v;
                    arg = o;
                }
            }
            const int64_t a = s + arg - t0;
            if (a >= 0 && a < TILE) mark[a] = 1;
        }
    }
    __syncthreads();
    int cnt = 0;
    for (int t = tid; t < TILE; t += THREADS) {
        const int64_t i = t0 + t;
        bool sel = false;
        if (i < L) {
            const int64_t at = (int64_t)b * L + i;
            const uint32_t h = sh[w - 1 + t];
            sel = mark[t] && h != UMAX;
            if (sel && own_lo != nullptr) {
                const int64_t op = pos_map != nullptr ? pos_map[at] : i;
                sel = op >= own_lo[b] && op < own_hi[b];
            }
            flags[at] = (uint8_t)(sst[t] | (sel ? 2 : 0));
            if (sel) hash[at] = h;
        }
        cnt += __syncthreads_count(sel);
    }
    if (tid == 0) counts[blockIdx.x] = cnt;
}

__global__ void __launch_bounds__(THREADS) sketch_emit_kernel(
    const uint32_t* __restrict__ hash, const uint8_t* __restrict__ flags,
    const int32_t* __restrict__ counts, const int64_t* __restrict__ pos_map,
    int64_t* __restrict__ out, int64_t* __restrict__ n_all, int L,
    int n_tiles, int64_t stride) {
    __shared__ int64_t part[THREADS / 32];
    __shared__ int wsum[THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = blockIdx.x;
    int64_t before = 0;
    for (int j = tid; j < g; j += THREADS) before += counts[j];
    for (int o = 16; o; o >>= 1) before += __shfl_xor_sync(FULL, before, o);
    if (lane == 0) part[warp] = before;
    __syncthreads();
    int64_t base = 0;
#pragma unroll
    for (int j = 0; j < THREADS / 32; ++j) base += part[j];
    const int b = g / n_tiles;
    const int64_t t0 = (int64_t)(g % n_tiles) * TILE;
    for (int t = tid; t < TILE; t += THREADS) {
        const int64_t i = t0 + t;
        const int64_t at = (int64_t)b * L + i;
        const uint8_t f = i < L ? flags[at] : 0;
        const bool sel = (f & 2) != 0;
        int total;
        const int64_t o = base + block_scan<THREADS>(sel, wsum, total);
        if (sel && o < stride) {
            out[o] = b;
            out[stride + o] = pos_map != nullptr ? pos_map[at] : i;
            out[2 * stride + o] = hash[at];
            out[3 * stride + o] = f & 1;
        }
        base += total;
    }
    if (g == (int)gridDim.x - 1 && tid == 0) *n_all = base;
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

template <int N>
int launch_select(const void* codes, int64_t pitch, const void* lengths,
                  const void* own_lo, const void* own_hi, const void* pos_map,
                  void* hash, void* flags, void* counts, int B, int L, int k,
                  int w, cudaStream_t st) {
    const int n_tiles = (L + TILE - 1) / TILE;
    const int np = TILE + 2 * (w - 1);
    const size_t smem = (size_t)np * 4 + (np + k - 1) + 2 * TILE;
    sketch_select_kernel<N><<<B * n_tiles, THREADS, smem, st>>>(
        (const int8_t*)codes, pitch, (const int32_t*)lengths,
        (const int32_t*)own_lo, (const int32_t*)own_hi,
        (const int64_t*)pos_map, (uint32_t*)hash, (uint8_t*)flags,
        (int32_t*)counts, L, n_tiles, k, w);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on B * ceil(L / 1024) blocks.  codes (B, L) int8 with `pitch`
// bytes between rows; lengths, own_lo, own_hi (B,) int32 (own_* both null
// for no gate); pos_map (B, L) int64 or null; hash (B, L) uint32 and flags
// (B, L) uint8 are scratch for sketch_emit; counts one int32 a block.
int ndt_sketch_select(const void* codes, long long pitch, const void* lengths,
                      const void* own_lo, const void* own_hi,
                      const void* pos_map, void* hash, void* flags,
                      void* counts, int B, int L, int k, int w, void* stream) {
    if (B <= 0 || L <= 0) return 0;
    const int n = k / 16 + 1 > 2 ? k / 16 + 1 : 2;
    if (k < 1 || n > N_MAX || w < 1 || w > W_MAX || pitch < L
        || (own_lo == nullptr) != (own_hi == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (n) {
        case 2: return launch_select<2>(codes, pitch, lengths, own_lo, own_hi, pos_map, hash, flags, counts, B, L, k, w, st);
        case 3: return launch_select<3>(codes, pitch, lengths, own_lo, own_hi, pos_map, hash, flags, counts, B, L, k, w, st);
        case 4: return launch_select<4>(codes, pitch, lengths, own_lo, own_hi, pos_map, hash, flags, counts, B, L, k, w, st);
        case 5: return launch_select<5>(codes, pitch, lengths, own_lo, own_hi, pos_map, hash, flags, counts, B, L, k, w, st);
        case 6: return launch_select<6>(codes, pitch, lengths, own_lo, own_hi, pos_map, hash, flags, counts, B, L, k, w, st);
        case 7: return launch_select<7>(codes, pitch, lengths, own_lo, own_hi, pos_map, hash, flags, counts, B, L, k, w, st);
        case 8: return launch_select<8>(codes, pitch, lengths, own_lo, own_hi, pos_map, hash, flags, counts, B, L, k, w, st);
        default: return launch_select<9>(codes, pitch, lengths, own_lo, own_hi, pos_map, hash, flags, counts, B, L, k, w, st);
    }
}

// One launch on sketch_select's grid: out (4, stride) int64 (rid, pos,
// hash, strand), the first `stride` minimizers in (row, position) order;
// n_all one int64, all of them.
int ndt_sketch_emit(const void* hash, const void* flags, const void* counts,
                    const void* pos_map, void* out, void* n_all, int B, int L,
                    long long stride, void* stream) {
    if (B <= 0 || L <= 0) return 0;
    const int n_tiles = (L + TILE - 1) / TILE;
    sketch_emit_kernel<<<B * n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)hash, (const uint8_t*)flags, (const int32_t*)counts,
        (const int64_t*)pos_map, (int64_t*)out, (int64_t*)n_all, L, n_tiles,
        (int64_t)stride);
    return (int)cudaGetLastError();
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
