// Banded unit-cost global alignment for Hopper, one (query, target) pair
// per CTA: anti-diagonal wavefronts over per-lane band offsets, an int8
// backpointer plane, and the traceback with the band-edge "touched" flag.
//
// Replaces racon_tpu/ops/align_pallas.py::wavefront_align (the Pallas
// TPU kernel) and computes, cell for cell, what its XLA twin
// racon_tpu/ops/align.py::_banded_nw_kernel + _traceback compute: the
// same INF clamp (1<<28), the same tie order (diag < up < left), the same
// clipped operand reads q[clamp(i-1)] / t[clamp(j-1)] on the padded
// [B, edge] code arrays (so even cells outside the matrix carry the same
// backpointer), the distance recorded at (m, n), and the same walk.
// The plain version is ops/align.py::banded_nw + traceback.
//
// Layout: q, t [B, edge] i8 (PAD 5 beyond length), q_lens, t_lens [B]
// i32, offsets [B, n_waves] i32 (align.band_offsets) -> ops [B, n_waves]
// i32 (backpointer codes in traceback order, `count` of them) and
// meta [B, 3] i32 = (count, dist, touched). The backpointer plane
// [B, n_waves, band] i8 is device-memory scratch from the wrapper.
//
// The three rolling wavefronts (d, d-1, d-2) live in shared memory as
// int32 rows of `band` cells (3 x 4 x band bytes, ~11 KB at band 896),
// rotated by pointer, one barrier per wavefront; threads stride over the
// band. The sweep stops at d = m + n instead of 2*edge: no cell past that
// wavefront is on the matrix, so the distance, the backpointers the
// traceback reads, and every output are unchanged.
//
// What bounds it: one byte of backpointer written per cell and the
// recurrence's 8 integer operations per cell (about as many again for
// indexing and masks), with a barrier per wavefront — the sweep
// over m + n wavefronts is latency-bound at one CTA per pair; the
// single-thread traceback adds m + n dependent global reads. A later
// design packs 2-bit backpointers (a quarter of the plane) and runs
// several pairs per CTA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 28;
constexpr int kThreads = 256;
constexpr int kDiag = 0, kUp = 1, kLeft = 2;

__global__ void __launch_bounds__(kThreads) align_wavefront_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ t,
    const int32_t* __restrict__ q_lens, const int32_t* __restrict__ t_lens,
    const int32_t* __restrict__ offsets, int8_t* __restrict__ bps,
    int32_t* __restrict__ ops, int32_t* __restrict__ meta, int edge,
    int band, int n_waves) {
    extern __shared__ int smem[];
    __shared__ int s_dist;
    int* s0 = smem;
    int* s1 = smem + band;
    int* s2 = smem + 2 * band;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int m = q_lens[b];
    const int n = t_lens[b];
    const int8_t* qb = q + (size_t)b * edge;
    const int8_t* tb = t + (size_t)b * edge;
    const int32_t* offs = offsets + (size_t)b * n_waves;
    int8_t* bp = bps + (size_t)b * n_waves * band;

    for (int k = tid; k < band; k += kThreads) {
        s1[k] = kInf;
        s2[k] = kInf;
    }
    if (tid == 0) s_dist = kInf;
    __syncthreads();

    int a1 = 0, a2 = 0;
    const int last = min(m + n, n_waves - 1);
    for (int d = 0; d <= last; ++d) {
        const int a0 = offs[d];
        int8_t* bpd = bp + (size_t)d * band;
        for (int k = tid; k < band; k += kThreads) {
            const int i = a0 + k;
            const int j = d - i;
            const int k1 = k + (a0 - a1);
            const int k1m = k1 - 1;
            const int k2m = k + (a0 - a2) - 1;
            const int g_up = (k1m >= 0 && k1m < band) ? s1[k1m] : kInf;
            const int g_left = (k1 >= 0 && k1 < band) ? s1[k1] : kInf;
            const int g_diag = (k2m >= 0 && k2m < band) ? s2[k2m] : kInf;
            const int up = i >= 1 ? g_up : kInf;
            const int left = j >= 1 ? g_left : kInf;
            const int diag = (i >= 1 && j >= 1) ? g_diag : kInf;
            const int qi = qb[min(max(i - 1, 0), edge - 1)];
            const int tj = tb[min(max(j - 1, 0), edge - 1)];
            const int sub = qi == tj ? 0 : 1;
            const int cd = diag + sub;
            const int cu = up + 1;
            const int cl = left + 1;
            int score = cd;
            int code = kDiag;
            if (cu < score) code = kUp;
            score = min(score, cu);
            if (cl < score) code = kLeft;
            score = min(score, cl);
            if (i == 0 && j == 0) score = 0;
            const bool valid = i >= 0 && i <= m && j >= 0 && j <= n;
            score = valid ? min(score, kInf) : kInf;
            if (i == m && j == n) s_dist = score;
            s0[k] = score;
            bpd[k] = (int8_t)code;
        }
        __syncthreads();
        int* tmp = s2;
        s2 = s1;
        s1 = s0;
        s0 = tmp;
        a2 = a1;
        a1 = a0;
    }

    if (tid == 0) {
        int i = m, j = n, cnt = 0, touched = 0;
        int32_t* ob = ops + (size_t)b * n_waves;
        while (i > 0 || j > 0) {
            const int d = i + j;
            const int dc = min(d, n_waves - 1);
            const int off = offs[dc];
            const int k = i - off;
            const int row_lo = max(0, d - n);
            const int row_hi = min(d, m);
            // a band-boundary cell marks possible clipping, only when
            // the matrix continues past the boundary on that side
            if (k <= 0 && off > row_lo) touched = 1;
            if (k >= band - 1 && off + band - 1 < row_hi) touched = 1;
            const int kc = min(max(k, 0), band - 1);
            int code = bp[(size_t)dc * band + kc];
            if (i == 0) code = kLeft;
            if (j == 0) code = kUp;
            ob[cnt++] = code;
            if (code != kLeft) --i;
            if (code != kUp) --j;
        }
        meta[(size_t)b * 3 + 0] = cnt;
        meta[(size_t)b * 3 + 1] = s_dist;
        meta[(size_t)b * 3 + 2] = touched;
    }
}

}  // namespace

extern "C" int rt_align_wavefront(
    const void* q, const void* t, const void* q_lens, const void* t_lens,
    const void* offsets, void* bps, void* ops, void* meta, int B, int edge,
    int band, int n_waves, void* stream) {
    const size_t smem = 3 * (size_t)band * sizeof(int);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            align_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    align_wavefront_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int8_t*)t, (const int32_t*)q_lens,
        (const int32_t*)t_lens, (const int32_t*)offsets, (int8_t*)bps,
        (int32_t*)ops, (int32_t*)meta, edge, band, n_waves);
    return (int)cudaGetLastError();
}
