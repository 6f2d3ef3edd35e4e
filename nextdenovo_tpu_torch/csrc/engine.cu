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
//   engine_anchor   one thread a query minimizer.  Binary search of its
//                   hash in the sorted index (int64, the 0xFFFFFFFF filter
//                   rows at the end), the first max_occ occurrences, the
//                   row's rid and position bases, the strand bit, and the
//                   three gates (no self hit, t_rid >= 0, the pair-once
//                   qmask gate).  Run twice: a count pass (write = 0) that
//                   keeps lo, cnt and the number taken, then, after an
//                   inclusive cumsum of the counts, a write pass (write = 1)
//                   that writes the taken anchors compacted, in flat
//                   (minimizer, occurrence) order: torch.nonzero's order.
//   vote_corridor   one warp a (key_q, key_t) group of the first sort's
//                   order.  The group's anchors are sorted by key_b, so
//                   each diagonal bin is a run; a run's first anchor finds
//                   the run's end by binary search, which gives the bin's
//                   count.  top_k rounds of an argmax over the runs (the
//                   first run on a tie: the warp takes the max of
//                   (count + 1) << 32 | ~offset), a round's bin kept where
//                   bc * 2 >= prim_cnt and bc > 0, bins within 2 of an
//                   earlier round's bin counting -1; then each anchor's
//                   nearest kept corridor within +-width (di < bestd, the
//                   earlier round on a tie), written as key_t2 and qp2_key.
//                   Nothing is kept per bin or per anchor: a group of any
//                   size (a repeat, a 1 Mb read) is a loop over its anchors
//                   in 32s, with no shared memory.
//   chain_emit      one warp a (key_q, key_t) group of the second sort's
//                   order.  Its corridor segments (g2: at most top_k + 1,
//                   corridor 0 first) are walked in order; per segment the
//                   warp sums the quantised link scores and takes cnt2 and
//                   the extents; corridor 0's query extent gives the
//                   group's qs0 / qe0; a segment's last anchor gets the
//                   emit flag and the record, every other anchor zeros.
//
// The one float step, the link score
//     beta = 0.01*k*dd + 0.5*log2(dd + 1),  round(max(alpha - beta, 0) * 8),
// is written with __fmul_rn / __fadd_rn / __fsub_rn, so that nvcc contracts
// nothing into an FMA: PyTorch's elementwise ops round after every step.
// The constant is (float)(0.01 * k), as PyTorch casts its Python scalar;
// log2f without fast math, rintf for torch.round (half to even).  Integers
// are int64 throughout, as in the plain versions (diag may be negative and
// >> stays arithmetic).
//
// Bound on this card: bytes.  engine_anchor reads the minimizers, the index
// entries its occurrences touch (plus ~log2 H probes a minimizer, mostly in
// L2) and writes 40 B an anchor; vote_corridor reads 32 B and writes 16 B an
// anchor, top_k + 1 times over a group's key_b; chain_emit reads 32 B and
// writes 65 B an anchor.  At the main path's batch (~10^5 anchors) each is a
// few MB, so a launch is latency more than bandwidth; the gain over the
// plain versions is the launch count.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t POS_MASK = (1LL << 30) - 1;
constexpr int STRAND_BIT = 30;
constexpr int64_t I32MAX = 2147483647LL;
constexpr int64_t INF = 1LL << 30;
constexpr int MAX_TOP_K = 8;
constexpr int WARPS = 4;                  // groups (warps) a block
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

__device__ __forceinline__ int64_t upper_bound(const int64_t* a, int64_t lo,
                                               int64_t hi, int64_t x) {
    while (lo < hi) {                     // first i in [lo, hi): a[i] > x
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (a[mid] <= x) lo = mid + 1; else hi = mid;
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

__global__ void engine_anchor_kernel(
    const int64_t* __restrict__ qm_rid, const int64_t* __restrict__ qm_pos,
    const int64_t* __restrict__ qm_hash, const int64_t* __restrict__ qm_strand,
    const int64_t* __restrict__ q_rid_base,
    const int64_t* __restrict__ q_pos_base, const int8_t* __restrict__ qmask,
    const int64_t* __restrict__ idx_h, const int32_t* __restrict__ idx_rid,
    const int32_t* __restrict__ idx_pos,
    int64_t* __restrict__ lo_cnt,        // (2, M): lo, cnt
    int64_t* __restrict__ ntake,         // (M,): taken; cumsum'd between
    int64_t* __restrict__ out,           // (5, A): qr, t_rid, t_pos, rel, qpos
    int M, int64_t H, int64_t A, int max_occ, int write) {
    const int m = blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    const int64_t row = qm_rid[m];
    const int64_t qg = q_rid_base[row];
    int64_t lo, cnt;
    if (!write) {
        const int64_t h = qm_hash[m];
        lo = lower_bound(idx_h, 0, H, h);
        cnt = mn(upper_bound(idx_h, lo, H, h) - lo, max_occ);
        lo_cnt[m] = lo;
        lo_cnt[M + m] = cnt;
    } else {
        lo = lo_cnt[m];
        cnt = lo_cnt[M + m];
    }
    // in the write pass ntake holds the inclusive cumsum of the counts
    int64_t w = write ? (m ? ntake[m - 1] : 0) : 0;
    const int64_t strand = qm_strand[m];
    const int64_t qpos = qm_pos[m] + q_pos_base[row];
    for (int64_t o = 0; o < cnt; ++o) {
        const int64_t a = lo + o;
        const int64_t tr = idx_rid[a];
        // no self hit, no filter row, and the pair-once gate
        if (tr == qg || tr < 0 || (qmask[tr] > 0 && tr < qg)) continue;
        if (write) {
            const int64_t posst = idx_pos[a];
            out[w] = qg;
            out[A + w] = tr;
            out[2 * A + w] = posst & POS_MASK;
            out[3 * A + w] = (strand ^ (posst >> STRAND_BIT)) & 1;
            out[4 * A + w] = qpos;
        }
        ++w;
    }
    if (!write) ntake[m] = w;
}

// ---------------------------------------------------------------------------
// vote_corridor

__global__ void __launch_bounds__(WARPS * 32) vote_corridor_kernel(
    const int64_t* __restrict__ key_t, const int64_t* __restrict__ key_b,
    const int64_t* __restrict__ diag, const int64_t* __restrict__ qpos,
    const int64_t* __restrict__ gstart,  // (G + 1,): group starts, then A
    int64_t* __restrict__ key_t2, int64_t* __restrict__ qp2_key,
    int G, int diag_shift, int top_k) {
    const int g = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (g >= G) return;                   // the whole warp leaves together
    const int64_t s = gstart[g], e = gstart[g + 1];
    int64_t bb[MAX_TOP_K];
    bool ok[MAX_TOP_K];
    int64_t prim = 0;
    for (int r = 0; r < top_k; ++r) {
        unsigned long long best = 0;
        for (int64_t i = s + lane; i < e; i += 32) {
            const int64_t d = key_b[i] >> 10;
            if (i != s && (key_b[i - 1] >> 10) == d) continue;  // not a run start
            // the run of bin d ends at the first key_b >= (d + 1) << 10
            int64_t cur = lower_bound(key_b, i + 1, e, (d + 1) * 1024) - i;
            for (int j = 0; j < r; ++j)
                if (ab(d - bb[j]) <= 2) cur = -1;
            const unsigned long long p =
                ((unsigned long long)(cur + 1) << 32)
                | (unsigned long long)(FULL - (unsigned)(i - s));
            best = p > best ? p : best;
        }
        best = warp_max_u(best);
        const int64_t bc = (int64_t)(best >> 32) - 1;
        const int64_t first = s + (int64_t)(FULL - (unsigned)(best & FULL));
        bb[r] = key_b[first] >> 10;
        if (r == 0) prim = bc;
        ok[r] = bc * 2 >= prim && bc > 0;
    }
    const int64_t width = 1LL << diag_shift;
    const int64_t kc = top_k + 1;
    for (int64_t i = s + lane; i < e; i += 32) {
        const int64_t dg = diag[i];
        int corr = top_k;
        int64_t bestd = INF;
        for (int r = 0; r < top_k; ++r) {
            if (!ok[r]) continue;
            const int64_t center = (bb[r] - (1LL << 20)) * width + width / 2;
            const int64_t di = ab(dg - center);
            if (di <= width && di < bestd) {
                corr = r;
                bestd = di;
            }
        }
        key_t2[i] = key_t[i] * kc + corr;
        qp2_key[i] = corr < top_k ? qpos[i] : I32MAX;
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
    const int64_t* __restrict__ gstart,  // (G + 1,): group starts, then A
    uint8_t* __restrict__ emit, int64_t* __restrict__ rec,  // (A,), (8, A)
    int64_t A, int G, int k, int top_k, int min_cnt, int min_span,
    float c01k) {
    const int g = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (g >= G) return;
    const int64_t s = gstart[g], e = gstart[g + 1];
    const int64_t kc = top_k + 1;
    const int64_t qname = kq2[s];
    int64_t qs0 = -INF, qe0 = -INF;
    int64_t a = s;
    while (a < e) {                       // one corridor segment [a, b)
        const int64_t kt = kt2[a];
        int64_t sum = 0, cnt = 0, qmin = INF, qmax = -INF, tmin = INF,
                tmax = -INF;
        int64_t b = e;
        for (int64_t base = a; base < e; base += 32) {
            const int64_t i = base + lane;
            const bool in = i < e && kt2[i] == kt;  // a prefix of the 32
            const unsigned mask = __ballot_sync(FULL, in);
            if (in) {
                const int64_t q = qp2[i], t = tp2[i];
                if (q != I32MAX) {
                    ++cnt;
                    qmin = mn(qmin, q);
                    qmax = mx(qmax, q);
                    tmin = mn(tmin, t);
                    tmax = mx(tmax, t);
                    if (i > a) {          // a link inside the segment
                        const int64_t pq = qp2[i - 1];
                        const int64_t dq = q - pq, dt = t - tp2[i - 1];
                        if (pq != I32MAX && dq > 0 && dt > 0)
                            sum += link_q(dq, dt, k, c01k);
                    }
                }
            }
            if (mask != FULL) {
                b = base + __popc(mask);
                break;
            }
        }
        sum = warp_sum(sum);
        cnt = warp_sum(cnt);
        const int64_t qs = warp_min(qmin), qe = warp_max(qmax) + k;
        const int64_t ts = warp_min(tmin), te = warp_max(tmax) + k;
        const int64_t key_tq = floordiv(kt, kc);
        const int64_t corr = kt - key_tq * kc;
        if (corr == 0 && cnt > 0) {       // corridor 0 comes first
            qs0 = qs;
            qe0 = qe;
        }
        const int64_t oq = mn(qe, qe0) - mx(qs, qs0);
        const bool sec_ok = corr == 0 || oq * 2 < qe - qs;
        const int64_t span = mn(qe - qs, te - ts);
        const bool em = qp2[b - 1] != I32MAX && sec_ok && cnt >= min_cnt
                        && span >= min_span;
        const int64_t vals[8] = {qname, key_tq & 1, qs, qe, key_tq >> 1, ts,
                                 te, mn(floordiv(sum, 8) + k, span)};
        for (int64_t i = a + lane; i < b; i += 32) {
            const bool here = em && i == b - 1;
            emit[i] = here;
#pragma unroll
            for (int f = 0; f < 8; ++f) rec[f * A + i] = here ? vals[f] : 0;
        }
        a = b;
    }
}

}  // namespace

extern "C" {

int ndt_engine_anchor(const void* qm_rid, const void* qm_pos,
                      const void* qm_hash, const void* qm_strand,
                      const void* q_rid_base, const void* q_pos_base,
                      const void* qmask, const void* idx_h,
                      const void* idx_rid, const void* idx_pos, void* lo_cnt,
                      void* ntake, void* out, int M, long long H, long long A,
                      int max_occ, int write, void* stream) {
    if (M <= 0) return 0;
    const int threads = 256;
    engine_anchor_kernel<<<(M + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
        (const int64_t*)qm_rid, (const int64_t*)qm_pos,
        (const int64_t*)qm_hash, (const int64_t*)qm_strand,
        (const int64_t*)q_rid_base, (const int64_t*)q_pos_base,
        (const int8_t*)qmask, (const int64_t*)idx_h, (const int32_t*)idx_rid,
        (const int32_t*)idx_pos, (int64_t*)lo_cnt, (int64_t*)ntake,
        (int64_t*)out, M, (int64_t)H, (int64_t)A, max_occ, write);
    return (int)cudaGetLastError();
}

int ndt_vote_corridor(const void* key_t, const void* key_b, const void* diag,
                      const void* qpos, const void* gstart, void* key_t2,
                      void* qp2_key, int G, int diag_shift, int top_k,
                      void* stream) {
    if (G <= 0) return 0;
    if (top_k < 1 || top_k > MAX_TOP_K) return (int)cudaErrorInvalidValue;
    vote_corridor_kernel<<<(G + WARPS - 1) / WARPS, WARPS * 32, 0,
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
    chain_emit_kernel<<<(G + WARPS - 1) / WARPS, WARPS * 32, 0,
                        (cudaStream_t)stream>>>(
        (const int64_t*)kq2, (const int64_t*)kt2, (const int64_t*)qp2,
        (const int64_t*)tp2, (const int64_t*)gstart, (uint8_t*)emit,
        (int64_t*)rec, (int64_t)A, G, k, top_k, min_cnt, min_span, c01k);
    return (int)cudaGetLastError();
}

}  // extern "C"
