// POA window sweep for Hopper: graph-banded global NW of one layer
// sequence against its window's topo-ordered POA graph, plus the
// traceback, one (window, layer) job per CTA.
//
// Replaces racon_tpu/ops/poa_pallas.py::window_sweep (the Pallas TPU
// kernel). Same inputs, same int32 arithmetic, same tie order, so the
// ranks equal the plain version (ops/poa_graph.py::graph_aligner) and
// the consensus stays byte-identical to the host engine.
//
// Layout:
//   codes [B,N] i8, preds [B,N,P] i16 (rank+1; 0 = virtual source row;
//   -1 pad), centers [B,N] i16, sinks [B,N] u8, seq [B,L] i8,
//   lens/band/nnodes [B] i32 -> ranks [B,L] i32 (node rank, -1
//   insertion, -2 beyond lens). H [B,N+1,L+1] i32 and the backpointer
//   plane [B,N,L+1] i8 are device-memory scratch allocated by the
//   wrapper: at the (2048, 640) envelope H is ~5.3 MB per job, far beyond
//   the 227 KB of shared memory, so rows live in global memory and the
//   working rows stay hot in the 50 MB L2.
//
// Per node row k (rows run to the job's own nnodes):
//   - the P predecessor ranks go to shared memory (double-buffered by the
//     row's parity, so a slow thread of row k-1 never sees row k's);
//   - each thread owns a contiguous run of at most 4 of the L+1 columns:
//     it takes the max over predecessors of diag (+match/mismatch) and
//     vert (+gap), masks cells outside center +- band/2 to NEG;
//   - the in-row horizontal gap recurrence H[j] = max(pre[j], H[j-1]+gap)
//     is a running max of pre[j] - j*gap: a per-thread scan of its run,
//     a warp-shuffle scan of the run totals and one cross-warp pass;
//   - backpointers: p = diag via pred p, P+p = vert via pred p, 2P =
//     horizontal; first match in that order wins (diag > vert > horizontal,
//     preds in edge order).
// The best sink (column slen, ties -> smallest rank) is a block argmax;
// the traceback is a pointer chase on one thread. int16 scores (the JAX
// package's poa_int16_ok variant) are not carried over.
//
// What bounds it: each row reads up to P predecessor rows of H and
// writes one H row and one backpointer row, ~ (4P + 5) bytes per DP cell
// against ~6P integer operations per cell, with three block barriers per
// row; the sweep is latency- and L2-bound, one CTA per job. A later
// design keeps a ring of the last RING=128 rows (int16 when the overflow
// proof holds) in shared memory (the JAX package's RING,
// ops/poa_graph.py:217) and packs several jobs per CTA.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 29);
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRun = 4;     // columns per thread: L+1 <= 1024
constexpr int kMaxPred = 16;

__device__ __forceinline__ bool better(int v, int i, int bv, int bi) {
    return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads) window_sweep_kernel(
    const int8_t* __restrict__ codes, const int16_t* __restrict__ preds,
    const int16_t* __restrict__ centers, const uint8_t* __restrict__ sinks,
    const int8_t* __restrict__ seq, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ bandw, const int32_t* __restrict__ nnodes,
    int32_t* __restrict__ Hs, int8_t* __restrict__ bps,
    int32_t* __restrict__ out, int N, int L, int P, int match,
    int mismatch, int gap) {
    __shared__ int s_pred[2][kMaxPred];
    __shared__ int s_warp[kWarps];
    __shared__ int s_bv[kWarps];
    __shared__ int s_bi[kWarps];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int W = L + 1;
    int32_t* H = Hs + (size_t)b * (N + 1) * W;
    int8_t* BP = bps + (size_t)b * N * W;
    const int8_t* sq = seq + (size_t)b * L;
    const int16_t* pb = preds + (size_t)b * N * P;
    int32_t* ob = out + (size_t)b * L;
    const int slen = lens[b];
    const int bw = bandw[b];
    const int nn = nnodes[b];
    const int band2 = bw / 2;
    const bool use_band = bw > 0;

    const int run = (W + kThreads - 1) / kThreads;
    const int c0 = tid * run;
    const int c1 = min(c0 + run, W);

    // virtual source row: D[0][j] = j*gap within the layer
    for (int j = c0; j < c1; ++j) H[j] = (j <= slen) ? j * gap : kNeg;
    for (int j = tid; j < L; j += kThreads) ob[j] = -2;

    for (int k = 1; k <= nn; ++k) {
        const int buf = k & 1;
        if (tid < P) s_pred[buf][tid] = pb[(size_t)(k - 1) * P + tid];
        __syncthreads();
        const int* pr = s_pred[buf];
        const int code_k = codes[(size_t)b * N + k - 1];
        const int center_k = centers[(size_t)b * N + k - 1];
        const int jlo = use_band ? max(1, center_k - band2) : 1;
        const int jhi = use_band ? min(slen, center_k + band2) : slen;

        int row0 = INT_MIN;
        for (int p = 0; p < P; ++p) {
            const int v = pr[p] >= 0 ? H[(size_t)pr[p] * W] : kNeg;
            row0 = max(row0, v);
        }
        row0 += gap;

        // pre-scan values x[j] = pre[j] - j*gap; column 0 is the seed
        int x[kMaxRun];
        int acc = INT_MIN;
#pragma unroll
        for (int c = 0; c < kMaxRun; ++c) {
            const int j = c0 + c;
            if (c >= run || j >= W) break;
            int v;
            if (j == 0) {
                v = (jlo == 1) ? row0 : kNeg;
            } else {
                const int s = (sq[j - 1] == code_k) ? match : mismatch;
                int best = INT_MIN;
                for (int p = 0; p < P; ++p) {
                    int hd = kNeg, hv = kNeg;
                    if (pr[p] >= 0) {
                        const int32_t* row = H + (size_t)pr[p] * W;
                        hd = row[j - 1];
                        hv = row[j];
                    }
                    best = max(best, max(hd + s, hv + gap));
                }
                const bool inb = j >= jlo && j <= jhi;
                v = (inb ? best : kNeg) - j * gap;
            }
            acc = max(acc, v);
            x[c] = acc;
        }
        // block-wide inclusive running max of the run totals
        int incl = acc;
        for (int off = 1; off < 32; off <<= 1) {
            const int n = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl = max(incl, n);
        }
        int excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) excl = INT_MIN;
        if (lane == 31) s_warp[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            int w = lane < kWarps ? s_warp[lane] : INT_MIN;
            for (int off = 1; off < kWarps; off <<= 1) {
                const int n = __shfl_up_sync(0xffffffffu, w, off);
                if (lane >= off) w = max(w, n);
            }
            if (lane < kWarps) s_warp[lane] = w;
        }
        __syncthreads();
        const int prefix = max(warp > 0 ? s_warp[warp - 1] : INT_MIN, excl);

        int32_t* hk = H + (size_t)k * W;
        int8_t* bk = BP + (size_t)(k - 1) * W;
#pragma unroll
        for (int c = 0; c < kMaxRun; ++c) {
            const int j = c0 + c;
            if (c >= run || j >= W) break;
            if (j == 0) {
                hk[0] = row0;
                int code = P;
                for (int p = 0; p < P; ++p) {
                    const int v = pr[p] >= 0 ? H[(size_t)pr[p] * W] : kNeg;
                    if (v + gap == row0) { code = P + p; break; }
                }
                bk[0] = (int8_t)code;
                continue;
            }
            const bool inb = j >= jlo && j <= jhi;
            const int h = inb ? max(prefix, x[c]) + j * gap : kNeg;
            hk[j] = h;
            const int s = (sq[j - 1] == code_k) ? match : mismatch;
            int dcode = -1, vcode = -1;
            for (int p = 0; p < P; ++p) {
                int hd = kNeg, hv = kNeg;
                if (pr[p] >= 0) {
                    const int32_t* row = H + (size_t)pr[p] * W;
                    hd = row[j - 1];
                    hv = row[j];
                }
                if (dcode < 0 && hd + s == h) dcode = p;
                if (vcode < 0 && hv + gap == h) vcode = P + p;
            }
            bk[j] = (int8_t)(dcode >= 0 ? dcode : (vcode >= 0 ? vcode : 2 * P));
        }
    }
    __syncthreads();

    // best sink at the layer's final column; ties -> smallest rank
    int bv = INT_MIN, bi = INT_MAX;
    for (int kk = tid; kk < N; kk += kThreads) {
        int v = kNeg;
        if (kk < nn && sinks[(size_t)b * N + kk] > 0)
            v = H[(size_t)(kk + 1) * W + slen];
        if (better(v, kk, bv, bi)) { bv = v; bi = kk; }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { s_bv[warp] = bv; s_bi[warp] = bi; }
    __syncthreads();

    if (tid == 0) {
        bv = s_bv[0];
        bi = s_bi[0];
        for (int w = 1; w < kWarps; ++w)
            if (better(s_bv[w], s_bi[w], bv, bi)) { bv = s_bv[w]; bi = s_bi[w]; }
        if (N == 0) bi = 0;
        // a job with no nodes (batch padding) wrote no rows: its
        // traceback starts finished
        int r = nn > 0 ? bi + 1 : 0;
        int j = nn > 0 ? slen : 0;
        while (r > 0 || j > 0) {
            const int code = r > 0 ? (int)BP[(size_t)(r - 1) * W + j] : 2 * P;
            const bool is_diag = code < P;
            const bool is_vert = code >= P && code < 2 * P;
            if (!is_vert && j > 0) ob[j - 1] = is_diag ? r - 1 : -1;
            if (is_diag || is_vert) {
                const int p = is_diag ? code : code - P;
                r = pb[(size_t)(r - 1) * P + p];
            }
            if (!is_vert) --j;
        }
    }
}

}  // namespace

extern "C" int rt_poa_window_sweep(
    const void* codes, const void* preds, const void* centers,
    const void* sinks, const void* seq, const void* lens, const void* band,
    const void* nnodes, void* H, void* bps, void* out, int B, int N, int L,
    int P, int match, int mismatch, int gap, void* stream) {
    window_sweep_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)codes, (const int16_t*)preds, (const int16_t*)centers,
        (const uint8_t*)sinks, (const int8_t*)seq, (const int32_t*)lens,
        (const int32_t*)band, (const int32_t*)nnodes, (int32_t*)H,
        (int8_t*)bps, (int32_t*)out, N, L, P, match, mismatch, gap);
    return (int)cudaGetLastError();
}
