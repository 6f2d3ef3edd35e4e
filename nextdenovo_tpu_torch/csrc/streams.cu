// The Myers pair's input streams, built on the card from the pairs as they
// come.
//
// Replaces the jitted program _build_streams of nextdenovo_tpu/ops/myers.py
// (:445), which the port ran as about fifteen PyTorch ops on the card after
// a host loop that copied every pair into two sentinel-padded int8 matrices
// (qpad, tpad) row by row.  The kernel reads the pairs from one flat
// concatenation instead (each pair's query and text found by its start), so
// the host hands over one array and no pad exists anywhere:
//
//   tch[j - 1, b]  = t_b[j - 1], or 4 from column n_b + 1 on;
//   qtop[j - 1, b] = q_b[i] with i = max(j + W - 1 - off_b, 0), or 4 where
//                    i >= m_b (the character that enters the band's bottom
//                    after column j; the reference clamps i at the pad's last
//                    column, which is the sentinel: the same function);
//   win[c, w, b]   bit r of word w set where q_b[32 w + r - off_b] == c, for
//                  32 w + r - off_b in [0, m_b) (the initial windows).
//
// Characters are the pads' int8 values (a byte above 127 reads negative and
// matches no c in 0..3, as in the pads).  Words are the uint32 patterns the
// reference's sums give, which the port keeps as int32.
//
// Work split: a block a tile of 32 pairs x 64 columns.  Its threads first
// read the tile's text and query characters, eight consecutive bytes of one
// pair a thread (a pair's 64 bytes are contiguous in the flat array), into
// shared memory; then each warp writes whole rows of tch and qtop, the pair
// across the lanes, 128 B a row.  One more row of blocks builds the window
// words, one thread a (word, pair), each from its 32 query characters.  One
// launch.
//
// Bound on this card: bytes.  The outputs are 8 B a cell plus 16 words a
// pair, the inputs the texts and the query characters the columns reach.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;                // 32-bit words of the band
constexpr int W = 32 * NW;           // band width
constexpr int THREADS = 256;
constexpr int TP = 32;               // pairs of a tile
constexpr int TC = 64;               // columns of a tile
constexpr int PAD = TC + 4;          // a tile row in shared memory: 17
                                     // words, so a warp's 32 rows fall on
                                     // 32 banks

__global__ void __launch_bounds__(THREADS) myers_streams_kernel(
    const int8_t* __restrict__ qflat, const int8_t* __restrict__ tflat,
    const int64_t* __restrict__ qstart, const int64_t* __restrict__ tstart,
    const int32_t* __restrict__ m, const int32_t* __restrict__ n,
    const int32_t* __restrict__ off, int32_t* __restrict__ qtop,
    int32_t* __restrict__ tch, uint32_t* __restrict__ win, int B, int n_pad,
    int col_tiles) {
    __shared__ int8_t tt[TP * PAD], qq[TP * PAD];
    const int b0 = blockIdx.x * TP;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if ((int)blockIdx.y == col_tiles) {
        // the window words: thread (w, lane) builds word w of pair b0 + lane
        const int b = b0 + lane, w = warp;
        if (b >= B) return;
        const int mb = m[b], k0 = 32 * w - off[b];
        const int8_t* q = qflat + qstart[b];
        uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
        for (int r = 0; r < 32; ++r) {
            const int k = k0 + r;
            const int c = k >= 0 && k < mb ? (int)q[k] : 4;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
                words[cc] |= (uint32_t)(c == cc) << r;
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
            win[((int64_t)cc * NW + w) * B + b] = words[cc];
        return;
    }
    const int64_t c0 = (int64_t)blockIdx.y * TC;
    {
        // eight columns of one pair a thread
        const int p = threadIdx.x >> 3, j0 = (threadIdx.x & 7) * 8;
        const int b = b0 + p;
        if (b < B) {
            const int64_t nb = n[b], mb = m[b];
            const int8_t* t = tflat + tstart[b];
            const int8_t* q = qflat + qstart[b];
            // column j + 1 takes q[max(j + W - off, 0)]
            const int64_t i0 = c0 + j0 + W - off[b];
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                const int64_t j = c0 + j0 + jj;
                const int64_t i = i0 + jj > 0 ? i0 + jj : 0;
                tt[p * PAD + j0 + jj] = j < nb ? t[j] : (int8_t)4;
                qq[p * PAD + j0 + jj] = i < mb ? q[i] : (int8_t)4;
            }
        }
    }
    __syncthreads();
    const int b = b0 + lane;
    if (b >= B) return;
    for (int c = warp; c < TC; c += THREADS / 32) {
        const int64_t j = c0 + c;
        if (j >= n_pad) break;
        tch[j * B + b] = tt[lane * PAD + c];
        qtop[j * B + b] = qq[lane * PAD + c];
    }
}

}  // namespace

extern "C" {

// One launch.  qflat, tflat: int8 characters; qstart, tstart (B,) int64:
// where each pair's query and text begin; m, n, off (B,) int32; qtop, tch
// (n_pad, B) int32; win (4, nw, B) int32, every entry written.
int ndt_myers_streams(const void* qflat, const void* tflat,
                      const void* qstart, const void* tstart, const void* m,
                      const void* n, const void* off, void* qtop, void* tch,
                      void* win, int B, int n_pad, int nw, void* stream) {
    if (B <= 0 || n_pad <= 0) return 0;
    if (nw != NW) return (int)cudaErrorInvalidValue;
    const int col_tiles = (n_pad + TC - 1) / TC;
    if (col_tiles + 1 > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((B + TP - 1) / TP, col_tiles + 1);
    myers_streams_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)qflat, (const int8_t*)tflat, (const int64_t*)qstart,
        (const int64_t*)tstart, (const int32_t*)m, (const int32_t*)n,
        (const int32_t*)off, (int32_t*)qtop, (int32_t*)tch, (uint32_t*)win,
        B, n_pad, col_tiles);
    return (int)cudaGetLastError();
}

}  // extern "C"
