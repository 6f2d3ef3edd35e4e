// Banded affine-gap (Gotoh, ksw2-extz class) extension, score only.
//
// Replaces the Pallas kernel _ext_kernel of nextdenovo_tpu/ops/extend.py.
// One block of 128 threads per pair, one thread per band lane.  The band
// follows the fixed schedule lo(a) = (a + 1) / 2 - 64 over anti-diagonals
// a = i + j, with i = lo(a) + lane and j = a - i.  Because lo advances on
// odd a only, the neighbours of a cell sit at fixed lanes: on even a the
// cell above (and its F) is one lane down and the cell to the left (and
// its E) is the same lane; on odd a the cell to the left is one lane up and
// the cell above is the same lane; the diagonal cell is always the same
// lane two steps back.  A thread therefore keeps its own H(a-1), H(a-2), E,
// F, best, best's anti-diagonal and the score at (m, n) in registers, and
// only H/E/F of the previous anti-diagonal go through shared memory,
// double-buffered with a -inf guard cell on each side: one barrier per
// anti-diagonal.  Sequences are bytes read straight from global memory at
// q[i - 1] and t[j - 1] (neighbouring lanes read neighbouring bytes); cells
// outside the matrix are masked by their (i, j) range.
//
// Bound on this card: operations (~30 int32 operations for each of the 128
// cells of an anti-diagonal; the bytes are the two sequences once and 1.5 KB
// of result planes per pair).  The chain over anti-diagonals is serial, so a
// pair costs m + n barrier-separated steps; the card is filled by pairs, one
// block each, and a block stops at its own pair's last anti-diagonal.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EW = 128;          // band lanes per pair
constexpr int HALF = 64;
constexpr int NINF = -(1 << 28);

__global__ void __launch_bounds__(EW) ext_fwd_kernel(
    const uint8_t* __restrict__ qbuf,    // (B, M): q[i-1] at column i-1
    const uint8_t* __restrict__ tbuf,    // (B, N): t[j-1] at column j-1
    const int32_t* __restrict__ mn,      // (B, 2)
    int32_t* __restrict__ planes,        // (B, 3, EW): best, besta, end
    int M, int N, int match, int mism, int gapo, int gape) {
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const int m = mn[2 * b], n = mn[2 * b + 1];
    const uint8_t* q = qbuf + (size_t)b * M;
    const uint8_t* t = tbuf + (size_t)b * N;
    const int goe = gapo + gape;

    // [buffer][lane + 1]; columns 0 and EW + 1 stay -inf
    __shared__ int sh[2][EW + 2], se[2][EW + 2], sf[2][EW + 2];
    for (int k = 0; k < 2; ++k) {
        sh[k][lane + 1] = NINF;
        se[k][lane + 1] = NINF;
        sf[k][lane + 1] = NINF;
        if (lane == 0) {
            sh[k][0] = se[k][0] = sf[k][0] = NINF;
            sh[k][EW + 1] = se[k][EW + 1] = sf[k][EW + 1] = NINF;
        }
    }
    int h1 = NINF, h2 = NINF, e1 = NINF, f1 = NINF;
    int best = NINF, besta = 0, endv = NINF;
    __syncthreads();

    const int a_end = m + n;
    for (int a = 0; a <= a_end; ++a) {
        const int cur = a & 1, prev = cur ^ 1;
        const int i = ((a + 1) >> 1) - HALF + lane;
        const int j = a - i;
        int h_up, f_up, h_left, e_left;
        if ((a & 1) == 0) {          // above: lane - 1; left: same lane
            h_up = sh[prev][lane];
            f_up = sf[prev][lane];
            h_left = h1;
            e_left = e1;
        } else {                     // left: lane + 1; above: same lane
            h_left = sh[prev][lane + 2];
            e_left = se[prev][lane + 2];
            h_up = h1;
            f_up = f1;
        }
        int e_new = max(h_left - goe, e_left - gape);
        int f_new = max(h_up - goe, f_up - gape);
        const bool i0 = (i == 0), j0 = (j == 0);
        const bool invalid = (i < 0) || (i > m) || (j < 0) || (j > n);
        int diag = NINF;
        if (!invalid && !i0 && !j0)
            diag = h2 + ((q[i - 1] == t[j - 1]) ? match : -mism);
        if (j0) e_new = NINF;
        if (i0) f_new = NINF;
        int h_new = max(diag, max(e_new, f_new));
        if (i0 && j0) h_new = 0;
        if (invalid) {
            h_new = NINF;
            e_new = NINF;
            f_new = NINF;
        }
        if (h_new > best) {          // strict: a lane keeps its earliest a
            best = h_new;
            besta = a;
        }
        if (i == m && j == n) endv = h_new;
        h2 = h1;
        h1 = h_new;
        e1 = e_new;
        f1 = f_new;
        sh[cur][lane + 1] = h_new;
        se[cur][lane + 1] = e_new;
        sf[cur][lane + 1] = f_new;
        __syncthreads();
    }
    int32_t* out = planes + (size_t)b * 3 * EW;
    out[lane] = best;
    out[EW + lane] = besta;
    out[2 * EW + lane] = endv;
}

}  // namespace

extern "C" {

int ndt_ext_fwd(const void* qbuf, const void* tbuf, const void* mn,
                void* planes, int B, int M, int N, int match, int mism,
                int gapo, int gape, void* stream) {
    if (B <= 0) return 0;
    ext_fwd_kernel<<<B, EW, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)qbuf, (const uint8_t*)tbuf, (const int32_t*)mn,
        (int32_t*)planes, M, N, match, mism, gapo, gape);
    return (int)cudaGetLastError();
}

}  // extern "C"
