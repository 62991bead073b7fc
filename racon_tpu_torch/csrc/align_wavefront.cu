// Banded unit-cost global alignment for Hopper, one (query, target) pair
// per CTA: anti-diagonal wavefronts over per-lane band offsets, a 2-bit
// backpointer plane, and a tiled traceback with the band-edge "touched"
// flag.
//
// Replaces racon_tpu/ops/align_pallas.py::wavefront_align (the Pallas
// TPU kernel) and computes, cell for cell, what its XLA twin
// racon_tpu/ops/align.py::_banded_nw_kernel + _traceback compute: the
// same INF clamp, the same tie order (diag < up < left), the same
// clipped operand reads q[clamp(i-1)] / t[clamp(j-1)] on the padded
// [B, edge] code arrays (so even cells outside the matrix carry the same
// backpointer), the distance recorded at (m, n), and the same walk.
// The plain version is ops/align.py::banded_nw + traceback.
//
// Layout: q, t [B, edge] i8 (PAD 5 beyond length), q_lens, t_lens [B]
// i32, offsets [B, n_waves] i32 (align.band_offsets) -> ops [B, n_waves]
// i32 (backpointer codes in traceback order, `count` of them) and
// meta [B, 3] i32 = (count, dist, touched). Scratch from the wrapper: the
// backpointer plane [B, n_waves, ceil(band / 16)] u32, 16 cells of 2 bits
// per word (cell k of a wavefront in word k / 16, bits 2 (k % 16)).
//
// Two instantiation axes, as the JAX programs have them:
//   - the score type S: int32_t (INF 1<<28) or int16_t (INF 1<<14, legal
//     where 2 edge + 1 < 1<<14, ops/dtypes.aligner_int16_ok). Every value
//     is min-clamped at INF each wavefront, so the DP runs in 32-bit
//     registers either way and computes the integers the int16 program
//     computes; S is the width of what passes through shared memory (the
//     edge cells, and the wavefronts of the shared-memory path) and the
//     sentinel, which shows as `dist` when (m, n) lies outside the band;
//   - the operand form: int8 codes, or q, t [B, edge / 4] u8 2-bit packed
//     (encode.pack_2bit), expanded where the staging loads them and PAD
//     restored at positions at or beyond the lane's length, so every
//     byte that reaches the rings is the int8 form's.
//
// What bounds it on this card: the chain of m + n wavefronts. Wavefront d
// needs d - 1 and d - 2 finished and holds only `band` cells of about 15
// integer operations each, so a pair is latency-bound; a batch has a few
// hundred pairs at most (146 at the main path's edge 8192), about one CTA
// per SM, with nothing else on the SM to hide a wavefront's latency.
// Neither bytes nor operations bound it (its bound is 1/10 of its time
// or less): the design shortens the per-wavefront chain and keeps device
// memory off it.
//
//   - scores in registers: thread t owns cells [t RUN, t RUN + RUN) of the
//     band (RUN, a template parameter, is 4 up to band 2048 and 8 up to
//     4096, so a team has at most 512 threads) and
//     keeps its previous wavefront's scores and their band-shifted view in
//     registers. The band shift a0 - a1 in {0, 1} makes a cell read its
//     own or its neighbour's previous values; the neighbours' edge cells
//     pass through shared memory, one block barrier per wavefront. A
//     thread whose run lies inside both matrix and band takes an interior
//     cell without boundary tests;
//   - operands in shared memory, then registers: the query rows and target
//     columns a wavefront touches slide by at most one per wavefront. Each
//     lives in a ring of >= band + 2C bytes (C = chunk of wavefronts, the
//     team size up to 256), and the offsets in a ring of C; at the start
//     of a chunk the team stores the bytes and offsets it loaded into
//     registers a chunk earlier (already clamped as the reference clamps
//     them) and issues the loads for the next, so no cell reads device
//     memory and no wavefront waits on a load. A thread keeps its cells'
//     bases in registers and slides them by one cell a wavefront, with one
//     new base from a ring; the next wavefront's offset is read one
//     wavefront ahead;
//   - 2-bit backpointers: a thread's 2 RUN code bits are one byte (RUN 4)
//     or one 16-bit word (RUN 8) of the row, stored coalesced; the plane is
//     a quarter of the int8 one;
//   - a tiled traceback: the path's band slot moves by at most one per
//     step and a step lowers the wavefront by one or two, so the next
//     kTile wavefronts lie within kTile query rows of the current cell.
//     The team loads those rows' <= kTileWords plane words (the rows'
//     offsets were prefetched during the last tile's walk), all in flight
//     at once, into shared memory over the sweep's, expands each row's
//     window into walk entries (the op, the touched flag and the step to
//     the next entry), and thread 0 walks them with one shared-memory
//     load a step; the team writes the tile's ops out coalesced. m + n
//     dependent device-memory reads become one per kTile wavefronts.
//
// Bands beyond 8 cells a thread at 512 threads (band > 4096, up to the
// wrapper's MAX_BAND) take a second path of the same kernel: the run is
// 16 or 32 cells a thread and its two wavefronts live in shared memory
// ([cell][thread], updated in place with the old values slid through
// registers, bases read from the rings per cell); staging, exchange,
// plane and traceback are the same.
//
// Tried on the card and taken out (PERF.md): warp shuffles for the
// neighbour exchange, with shared memory only at warp edges; shuffles
// merging 16 cells into a plane word; per-cell operand loads from the
// rings; a traceback by one warp whose lane read two dependent
// shared-memory words a step; 2 or 8 cells a thread at band 896 (8 leaves
// one warp per scheduler and its latency exposed, 2 spends more
// instructions a cell).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 5;
constexpr int kDiag = 0, kUp = 1, kLeft = 2;
constexpr int kMaxThreads = 1024;
constexpr int kMaxChunk = 256;
// traceback tile: kTile wavefronts, whose path cells span at most kTile
// band slots of a row, so kTile / 16 + 1 plane words
constexpr int kTile = 64;
constexpr int kTileWords = kTile / 16 + 1;
// per thread of the smallest team (one warp): the next tile's offsets it
// prefetches (that tile's rows lie within kTile + 1 rows below this
// tile's first), and the tile's plane words it loads
constexpr int kPre = (kTile + 1 + 31) / 32;
constexpr int kLoads = kTile * kTileWords / 32;
// entries a tile row holds: its <= kTile cells and room for the walk's
// index to leave the tile (a query row at most 2 past the row's last)
constexpr int kPitch = kTile + 4;

// The sentinel of score type S.
template <typename S>
__host__ __device__ constexpr int inf_of() {
    return sizeof(S) == 2 ? 1 << 14 : 1 << 28;
}

// One pair's geometry and staging state, uniform over the CTA.
struct Pair {
    const uint8_t* q;
    const uint8_t* t;
    const int32_t* offs;
    uint32_t* bp;
    int m, n, edge, band, n_waves, wpr, last;
    int chunk, ring_mask;
};

// Shared-memory staging: offsets of the current chunk, the two operand
// rings, every thread's edge cells (parity, first/last, thread).
template <typename S>
struct Stage {
    int* offs;
    S* edges;
    int8_t* qr;
    int8_t* tr;
};

// One DP cell, exactly as the reference computes it.
template <int kInf>
__device__ __forceinline__ int cell(int up, int left, int diag, int qi,
                                    int tj, int i, int j, int m, int n,
                                    int& code) {
    up = i >= 1 ? up : kInf;
    left = j >= 1 ? left : kInf;
    diag = (i >= 1 && j >= 1) ? diag : kInf;
    const int cd = diag + (qi == tj ? 0 : 1);
    const int cu = up + 1;
    const int cl = left + 1;
    int score = cd;
    code = kDiag;
    if (cu < score) code = kUp;
    score = min(score, cu);
    if (cl < score) code = kLeft;
    score = min(score, cl);
    if (i == 0 && j == 0) score = 0;
    const bool valid = i >= 0 && i <= m && j >= 0 && j <= n;
    return valid ? min(score, kInf) : kInf;
}

// x[clamp(idx)] of a padded code row whose first `len` bases are real:
// a byte of the int8 form, or a base expanded from the packed form with
// PAD at or beyond `len`, where the int8 form holds it.
template <bool PACKED>
__device__ __forceinline__ int8_t clamped(const uint8_t* x, int idx,
                                          int edge, int len) {
    const int c = min(max(idx, 0), edge - 1);
    if constexpr (PACKED)
        return c < len ? (int8_t)((x[c >> 2] >> (2 * (c & 3))) & 3) : kPad;
    else
        return (int8_t)x[c];
}

// Operand and offset staging, chunk by chunk. Thread tid < chunk holds
// one query byte, one target byte and one offset in registers between
// chunks; the fill points hq / ht (next ring index to fill) are uniform.
template <typename S, bool PACKED>
struct Prefetch {
    int off, qi, ti;
    int8_t qv, tv;
    int hq, ht;

    // Chunk 0, synchronously: its offsets, query rows [-1, band + C - 1)
    // and target columns [-band, C - 1).
    __device__ __forceinline__ void first(const Pair& p, const Stage<S>& s,
                                          int tid, int nt) {
        const int C = p.chunk;
        for (int x = tid; x < C; x += nt)
            s.offs[x] = x < p.n_waves ? p.offs[x] : 0;
        hq = p.band + C - 1;
        ht = C - 1;
        for (int x = -1 + tid; x < hq; x += nt)
            s.qr[x & p.ring_mask] = clamped<PACKED>(p.q, x, p.edge, p.m);
        for (int x = -p.band + tid; x < ht; x += nt)
            s.tr[x & p.ring_mask] = clamped<PACKED>(p.t, x, p.edge, p.n);
    }

    // At the start of chunk d0 (after a barrier, offsets in place): issue
    // the loads of what chunk d0 + C needs. Query rows reach at most
    // a0 + band + 2C - 2 and target columns d - a0 + 2C - 2 before then,
    // and each fill point moves by at most C per chunk.
    __device__ __forceinline__ void issue(const Pair& p, const Stage<S>& s,
                                          int d0, int tid) {
        const int C = p.chunk;
        const int a = s.offs[0];
        const int nq = a + p.band + 2 * C - 1;
        const int nt = d0 - a + 2 * C - 1;
        off = 0;
        qi = ti = INT32_MIN;
        if (tid < C) {
            const int x = d0 + C + tid;
            if (x < p.n_waves) off = p.offs[x];
            if (hq + tid < nq) {
                qi = hq + tid;
                qv = clamped<PACKED>(p.q, qi, p.edge, p.m);
            }
            if (ht + tid < nt) {
                ti = ht + tid;
                tv = clamped<PACKED>(p.t, ti, p.edge, p.n);
            }
        }
        hq = nq;
        ht = nt;
    }

    // Before the barrier that opens the next chunk (the previous chunk's
    // reads are done): store what `issue` loaded.
    __device__ __forceinline__ void store(const Pair& p, const Stage<S>& s,
                                          int tid) const {
        if (tid < p.chunk) {
            s.offs[tid] = off;
            if (qi != INT32_MIN) s.qr[qi & p.ring_mask] = qv;
            if (ti != INT32_MIN) s.tr[ti & p.ring_mask] = tv;
        }
    }
};

// The neighbours' edge cells of the wavefront just computed: `first` and
// `last` are this thread's new first and last cells; returns the left
// neighbour's last (L) and the right neighbour's first (R) cell, kInf
// past the band's ends. Every thread posts both to shared memory (two
// parities, so one block barrier a wavefront suffices); shuffles within
// the warp measured slower.
template <typename S>
__device__ __forceinline__ void exchange(const Stage<S>& s, int first,
                                         int last, int par, int& L, int& R) {
    constexpr int kInf = inf_of<S>();
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    S* e = s.edges + par * 2 * nt;
    e[tid] = first;
    e[nt + tid] = last;
    __syncthreads();
    L = tid > 0 ? e[nt + tid - 1] : kInf;
    R = tid < nt - 1 ? e[tid + 1] : kInf;
}

// The register path: RUN cells a thread. Per wavefront d the thread keeps
// in registers its previous wavefront's scores s1, the band-shifted view
// of them U (U[x] = s1[x - 1 + (a0 - a1)], neighbours past the run's
// ends), the previous wavefront's U as P (so diag = P[c + a0 - a1]), and
// its cells' query and target bases qv, tv, which slide by one cell per
// wavefront (the query's when the band moves down, the target's when it
// does not) with one new base each from the rings. A thread whose run
// lies inside the matrix and the band takes the interior cell (no
// boundary tests); the others take `cell`.
template <int RUN, typename S, bool PACKED>
__device__ __forceinline__ void sweep_registers(const Pair& p,
                                                const Stage<S>& s,
                                                int* s_dist) {
    constexpr int kInf = inf_of<S>();
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int k0 = tid * RUN;
    const int mask = p.ring_mask;
    int s1[RUN], P[RUN + 1], qv[RUN], tv[RUN];
#pragma unroll
    for (int c = 0; c < RUN; ++c) s1[c] = kInf;
#pragma unroll
    for (int x = 0; x <= RUN; ++x) P[x] = kInf;
    int L1 = kInf, R1 = kInf;
    int a1 = 0;
    Prefetch<S, PACKED> pf;
    pf.first(p, s, tid, nt);
    for (int d0 = 0; d0 <= p.last; d0 += p.chunk) {
        if (d0 > 0) {
            __syncthreads();
            pf.store(p, s, tid);
        }
        __syncthreads();
        pf.issue(p, s, d0, tid);
        const int dend = min(d0 + p.chunk - 1, p.last);
        int a0n = s.offs[0];
        uint8_t* row =
            reinterpret_cast<uint8_t*>(p.bp + (size_t)(d0 - 1) * p.wpr);
        {
            const int i0 = a0n + k0;
            const int j0 = d0 - i0;
#pragma unroll
            for (int c = 0; c < RUN; ++c) {
                qv[c] = s.qr[(i0 + c - 1) & mask];
                tv[c] = s.tr[(j0 - c - 1) & mask];
            }
        }
        for (int d = d0; d <= dend; ++d) {
            // the next wavefront's offset loads while this one computes
            const int a0 = a0n;
            if (d < dend) a0n = s.offs[d + 1 - d0];
            const bool d1 = a0 != a1;
            const int i0 = a0 + k0;
            const int j0 = d - i0;
            int U[RUN + 1];
            U[0] = d1 ? s1[0] : L1;
#pragma unroll
            for (int x = 1; x < RUN; ++x) U[x] = d1 ? s1[x] : s1[x - 1];
            U[RUN] = d1 ? R1 : s1[RUN - 1];
            uint32_t codes = 0;
            if (i0 >= 1 && i0 + RUN - 1 <= p.m && j0 - RUN + 1 >= 1 &&
                j0 <= p.n && k0 + RUN <= p.band) {
#pragma unroll
                for (int c = 0; c < RUN; ++c) {
                    const int diag = d1 ? P[c + 1] : P[c];
                    const int cd = diag + (qv[c] != tv[c] ? 1 : 0);
                    const int cu = U[c] + 1;
                    const int cl = U[c + 1] + 1;
                    const int m1 = min(cd, cu);
                    uint32_t code = cu < cd ? kUp << (2 * c) : 0;
                    code = cl < m1 ? kLeft << (2 * c) : code;
                    s1[c] = min(min(m1, cl), kInf);
                    codes |= code;
                }
            } else {
#pragma unroll
                for (int c = 0; c < RUN; ++c) {
                    const int diag = d1 ? P[c + 1] : P[c];
                    int code;
                    const int v = cell<kInf>(U[c], U[c + 1], diag, qv[c],
                                             tv[c], i0 + c, j0 - c, p.m, p.n,
                                             code);
                    s1[c] = k0 + c < p.band ? v : kInf;
                    codes |= (uint32_t)code << (2 * c);
                }
            }
#pragma unroll
            for (int x = 0; x <= RUN; ++x) P[x] = U[x];
            if (d == p.m + p.n) {
#pragma unroll
                for (int c = 0; c < RUN; ++c)
                    if (i0 + c == p.m && k0 + c < p.band) *s_dist = s1[c];
            }
            // the next wavefront's new query and target bases, loaded
            // before the barrier that hides their latency
            const int qn = s.qr[(a0n + k0 + RUN - 2) & mask];
            const int tn = s.tr[(d - a0 - k0) & mask];
            // the thread's 2 RUN bits are bits [2 k0, 2 k0 + 2 RUN) of the
            // row: one byte or one 16-bit store
            row += 4 * p.wpr;
            if constexpr (RUN == 4) {
                if (tid < 4 * p.wpr) row[tid] = codes;
            } else {
                if (tid < 2 * p.wpr)
                    reinterpret_cast<uint16_t*>(row)[tid] = codes;
            }
            exchange(s, s1[0], s1[RUN - 1], d & 1, L1, R1);
            // the next wavefront's bases: the query's slide down a cell
            // when the band moves, else the target's slide up
            if (a0n != a0) {
#pragma unroll
                for (int c = 0; c < RUN - 1; ++c) qv[c] = qv[c + 1];
                qv[RUN - 1] = qn;
            } else {
#pragma unroll
                for (int c = RUN - 1; c > 0; --c) tv[c] = tv[c - 1];
                tv[0] = tn;
            }
            a1 = a0;
        }
    }
}

// The shared-memory path: `run` (16 or 32) cells a thread, its two
// wavefronts at sc[c * nt + tid] (s1) and sc[(run + c) * nt + tid] (s2),
// the new wavefront written over s2 as the sweep passes.
template <typename S, bool PACKED>
__device__ __forceinline__ void sweep_shared(const Pair& p, const Stage<S>& s,
                                             S* sc, int run, int* s_dist) {
    constexpr int kInf = inf_of<S>();
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int k0 = tid * run;
    S* S1 = sc;
    S* S2 = sc + run * nt;
    for (int c = 0; c < run; ++c) S1[c * nt + tid] = S2[c * nt + tid] = kInf;
    int L1 = kInf, R1 = kInf, L2 = kInf, R2 = kInf;
    int a1 = 0, a2 = 0;
    Prefetch<S, PACKED> pf;
    pf.first(p, s, tid, nt);
    for (int d0 = 0; d0 <= p.last; d0 += p.chunk) {
        if (d0 > 0) {
            __syncthreads();
            pf.store(p, s, tid);
        }
        __syncthreads();
        pf.issue(p, s, d0, tid);
        const int dend = min(d0 + p.chunk - 1, p.last);
        for (int d = d0; d <= dend; ++d) {
            const int a0 = s.offs[d - d0];
            const int d1 = a0 - a1;
            const int d2 = a0 - a2;
            const int i0 = a0 + k0;
            const int j0 = d - i0;
            int p1 = L1, c1 = S1[tid], p2 = L2, c2 = S2[tid];
            int first = kInf, last = kInf;
            uint32_t codes = 0;
            for (int c = 0; c < run; ++c) {
                const int n1 = c + 1 < run ? S1[(c + 1) * nt + tid] : R1;
                const int n2 = c + 1 < run ? S2[(c + 1) * nt + tid] : R2;
                const int up = d1 ? c1 : p1;
                const int left = d1 ? n1 : c1;
                const int diag = d2 == 0 ? p2 : (d2 == 1 ? c2 : n2);
                const int i = i0 + c;
                const int j = j0 - c;
                const int qi = s.qr[(i - 1) & p.ring_mask];
                const int tj = s.tr[(j - 1) & p.ring_mask];
                int code;
                int v = cell<kInf>(up, left, diag, qi, tj, i, j, p.m, p.n,
                                   code);
                v = k0 + c < p.band ? v : kInf;
                if (d == p.m + p.n && i == p.m && k0 + c < p.band)
                    *s_dist = v;
                S2[c * nt + tid] = v;
                if (c == 0) first = v;
                last = v;
                codes |= (uint32_t)code << (2 * (c & 15));
                if ((c & 15) == 15) {
                    const int word = (k0 + c) / 16;
                    if (word < p.wpr) p.bp[(size_t)d * p.wpr + word] = codes;
                    codes = 0;
                }
                p1 = c1;
                c1 = n1;
                p2 = c2;
                c2 = n2;
            }
            L2 = L1;
            R2 = R1;
            exchange(s, first, last, d & 1, L1, R1);
            S* tmp = S2;
            S2 = S1;
            S1 = tmp;
            a2 = a1;
            a1 = a0;
        }
    }
}

// The traceback's tile, over the sweep's shared memory once the sweep is
// done: kTile rows' offsets, each row's first loaded plane word and
// kTileWords words, the walk's entries (kTile rows of kPitch), the tile's
// ops and the walker's (i, j, ops) for the team. An entry packs the step
// to the next entry's index (low byte) and the op code (bits 8-9) with
// the touched flag (bit 10).
struct Tile {
    int off[kTile];
    int w0[kTile];
    uint32_t words[kTile][kTileWords];
    uint16_t ent[kTile * kPitch];
    int ops[kTile];
    int state[3];
};

// The entry of a cell whose op is `code`: diag steps two rows back and one
// query row less from the tile's top, up one row, left one row and one
// entry on.
__device__ __forceinline__ uint16_t entry_of(int code) {
    return code << 8 | (code == kDiag ? 2 * kPitch - 1 : kPitch + 1 - code);
}

// threads a launch may have: the register path up to 512, so that its
// registers are not capped at 64; the shared-memory path up to 1024
__host__ __device__ constexpr int max_threads(int run) {
    return run > 0 ? kMaxThreads / 2 : kMaxThreads;
}

template <int RUN, typename S, bool PACKED>
__global__ void __launch_bounds__(max_threads(RUN)) align_wavefront_kernel(
    const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
    const int32_t* __restrict__ q_lens, const int32_t* __restrict__ t_lens,
    const int32_t* __restrict__ offsets, uint32_t* __restrict__ bps,
    int32_t* __restrict__ ops, int32_t* __restrict__ meta, int edge,
    int band, int n_waves, int run, int chunk, int ring) {
    extern __shared__ int4 smem4[];
    __shared__ int s_dist;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    Pair p;
    const int width = PACKED ? (edge + 3) / 4 : edge;
    p.q = q + (size_t)b * width;
    p.t = t + (size_t)b * width;
    p.offs = offsets + (size_t)b * n_waves;
    p.m = q_lens[b];
    p.n = t_lens[b];
    p.edge = edge;
    p.band = band;
    p.n_waves = n_waves;
    p.wpr = (band + 15) / 16;
    p.bp = bps + (size_t)b * n_waves * p.wpr;
    p.last = min(p.m + p.n, n_waves - 1);
    p.chunk = chunk;
    p.ring_mask = ring - 1;
    Stage<S> s;
    s.offs = reinterpret_cast<int*>(smem4);
    s.edges = reinterpret_cast<S*>(s.offs + chunk);
    S* sc = s.edges + 2 * 2 * nt;
    s.qr = reinterpret_cast<int8_t*>(sc + (RUN ? 0 : 2 * run * nt));
    s.tr = s.qr + ring;
    if (tid == 0) s_dist = inf_of<S>();
    if constexpr (RUN > 0)
        sweep_registers<RUN, S, PACKED>(p, s, &s_dist);
    else
        sweep_shared<S, PACKED>(p, s, sc, run, &s_dist);
    __syncthreads();

    // -- traceback --
    {
        Tile& tile = *reinterpret_cast<Tile*>(smem4);
        const int m = p.m, n = p.n;
        const int32_t* offs = p.offs;
        int32_t* ob = ops + (size_t)b * n_waves;
        int i = m, j = n, cnt = 0, touched = 0;
        int dlo = -1;
        int pre[kPre];
        while (i > 0 || j > 0) {
            const int dc = min(i + j, n_waves - 1);
            const int dnext = max(0, dc - kTile + 1);
            const int rows = dc - dnext + 1;
            // this tile's offsets: prefetched while the last tile was
            // walked (rows dlo - kTile - 1 .. dlo - 1), or loaded now
#pragma unroll
            for (int q = 0; q < kPre; ++q) {
                const int x = tid + nt * q;
                const int r = dlo - (kTile + 1) + x - dnext;
                if (dlo >= 0 && x < kTile + 1 && r >= 0 && r < rows)
                    tile.off[r] = pre[q];
            }
            if (dlo < 0)
                for (int r = tid; r < rows; r += nt)
                    tile.off[r] = offs[dnext + r];
            dlo = dnext;
            __syncthreads();
            // row dlo + r: the path is at a query row in [i - (dc - dlo - r),
            // i], a band slot (clamped as the walk clamps it) within kTile
            for (int r = tid; r < rows; r += nt) {
                const int lo = i - (dc - dlo - r) - tile.off[r];
                tile.w0[r] = min(max(lo, 0), band - 1) / 16;
            }
            __syncthreads();
            // every load of the tile in flight at once, then stored; the
            // next tile's offsets load too and stay in registers
            uint32_t got[kLoads];
#pragma unroll
            for (int q = 0; q < kLoads; ++q) {
                const int x = tid + nt * q;
                const int r = x / kTileWords;
                const int wi = r < rows ? tile.w0[r] + x % kTileWords : p.wpr;
                got[q] = wi < p.wpr ? p.bp[(size_t)(dlo + r) * p.wpr + wi] : 0;
            }
#pragma unroll
            for (int q = 0; q < kPre; ++q) {
                const int d = dlo - (kTile + 1) + tid + nt * q;
                pre[q] = d >= 0 && tid + nt * q < kTile + 1 ? offs[d] : 0;
            }
#pragma unroll
            for (int q = 0; q < kLoads; ++q) {
                const int x = tid + nt * q;
                if (x / kTileWords < rows) tile.words[0][x] = got[q];
            }
            __syncthreads();
            // each cell the walk may visit, (row r, query row
            // i - (dc - dlo - r) + x), becomes an entry: the step to the
            // next entry's index (low byte) and the op code with the
            // touched flag above it. Rows whose window stays off the band's
            // edges and the matrix's first row and column expand 16 codes
            // from one realigned word; the others go cell by cell.
            for (int x = tid; x < rows * (kTile / 16); x += nt) {
                const int r = x / (kTile / 16);
                const int q = x % (kTile / 16);
                const int width = dc - dlo - r + 1;
                if (16 * q >= width) continue;
                const int d = dlo + r;
                const int off = tile.off[r];
                const int ilo = i - (dc - d);
                const int klo = ilo - off;
                uint16_t* e = tile.ent + r * kPitch + 16 * q;
                if (klo > 0 && i - off < band - 1 && d > i) {
                    const uint32_t word = __funnelshift_r(
                        tile.words[r][q], tile.words[r][q + 1],
                        2 * (klo & 15));
#pragma unroll
                    for (int c = 0; c < 16; ++c)
                        e[c] = entry_of((word >> (2 * c)) & 3);
                } else {
                    const int row_lo = max(0, d - n);
                    const int row_hi = min(d, m);
                    for (int c = 16 * q; c < min(16 * q + 16, width); ++c) {
                        const int ip = ilo + c;
                        const int k = ip - off;
                        // a band-boundary cell marks possible clipping,
                        // only when the matrix continues past the boundary
                        const int t =
                            (k <= 0 && off > row_lo) ||
                            (k >= band - 1 && off + band - 1 < row_hi);
                        const int kc = min(max(k, 0), band - 1);
                        int code = (tile.words[r][kc / 16 - tile.w0[r]] >>
                                    (2 * (kc & 15))) & 3;
                        if (ip == 0) code = kLeft;
                        if (d - ip == 0) code = kUp;
                        e[c - 16 * q] = entry_of(code) | t << 10;
                    }
                }
            }
            __syncthreads();
            if (tid == 0) {
                // entry index r * kPitch + x with r = d - dlo and
                // x = dc - i_top - j; it leaves the tile below 0
                int A = (i + j - dlo) * kPitch + dc - i - j;
                int n_ops = 0;
                while (A >= 0 && (i > 0 || j > 0)) {
                    const int e = tile.ent[A];
                    A -= e & 0xff;
                    const int code = (e >> 8) & 3;
                    touched |= e >> 10;
                    tile.ops[n_ops++] = code;
                    if (code != kLeft) --i;
                    if (code != kUp) --j;
                }
                tile.state[0] = i;
                tile.state[1] = j;
                tile.state[2] = n_ops;
            }
            __syncthreads();
            i = tile.state[0];
            j = tile.state[1];
            const int n_ops = tile.state[2];
            for (int x = tid; x < n_ops; x += nt) ob[cnt + x] = tile.ops[x];
            cnt += n_ops;
        }
        if (tid == 0) {
            meta[(size_t)b * 3 + 0] = cnt;
            meta[(size_t)b * 3 + 2] = touched;
        }
    }
    // -- end traceback --
    if (tid == 0) meta[(size_t)b * 3 + 1] = s_dist;
}

// The launch shape of a band: cells a thread (run), threads, and the
// kernel path (register RUN, or 0 for the shared-memory path).
struct Shape {
    int run, threads, kernel_run, chunk, ring;
    size_t smem;
};

Shape shape_of(int band, int score_bytes) {
    Shape sh;
    int run = band <= 2048 ? 4 : 8;
    if ((band + run - 1) / run <= max_threads(run)) {
        sh.kernel_run = run;
    } else {
        run = band <= 16 * kMaxThreads ? 16 : 32;
        sh.kernel_run = 0;
    }
    sh.run = run;
    sh.threads = ((band + run - 1) / run + 31) / 32 * 32;
    sh.chunk = sh.threads < kMaxChunk ? sh.threads : kMaxChunk;
    sh.ring = 1;
    while (sh.ring < band + 2 * sh.chunk) sh.ring *= 2;
    sh.smem = (size_t)sh.chunk * 4 + (size_t)2 * 2 * sh.threads * score_bytes +
              2 * (size_t)sh.ring;
    if (!sh.kernel_run)
        sh.smem += 2 * (size_t)run * sh.threads * score_bytes;
    if (sh.smem < sizeof(Tile)) sh.smem = sizeof(Tile);
    return sh;
}

template <int RUN, typename S, bool PACKED>
int launch(const Shape& sh, const void* q, const void* t, const void* q_lens,
           const void* t_lens, const void* offsets, void* bps, void* ops,
           void* meta, int B, int edge, int band, int n_waves,
           cudaStream_t stream) {
    if (sh.smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            align_wavefront_kernel<RUN, S, PACKED>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
        if (e != cudaSuccess) return (int)e;
    }
    align_wavefront_kernel<RUN, S, PACKED><<<B, sh.threads, sh.smem, stream>>>(
        (const uint8_t*)q, (const uint8_t*)t, (const int32_t*)q_lens,
        (const int32_t*)t_lens, (const int32_t*)offsets, (uint32_t*)bps,
        (int32_t*)ops, (int32_t*)meta, edge, band, n_waves, sh.run,
        sh.chunk, sh.ring);
    return (int)cudaGetLastError();
}

// The kernel path of a launch shape, at one score type and operand form.
template <typename S, bool PACKED>
int dispatch(const Shape& sh, const void* q, const void* t,
             const void* q_lens, const void* t_lens, const void* offsets,
             void* bps, void* ops, void* meta, int B, int edge, int band,
             int n_waves, cudaStream_t st) {
    switch (sh.kernel_run) {
        case 4:
            return launch<4, S, PACKED>(sh, q, t, q_lens, t_lens, offsets,
                                        bps, ops, meta, B, edge, band,
                                        n_waves, st);
        case 8:
            return launch<8, S, PACKED>(sh, q, t, q_lens, t_lens, offsets,
                                        bps, ops, meta, B, edge, band,
                                        n_waves, st);
        default:
            return launch<0, S, PACKED>(sh, q, t, q_lens, t_lens, offsets,
                                        bps, ops, meta, B, edge, band,
                                        n_waves, st);
    }
}

}  // namespace

// score_bytes: 4 (int32 scores) or 2 (int16); packed: q and t are 2-bit
// packed [B, edge / 4] u8 rather than [B, edge] i8.
extern "C" int rt_align_wavefront(
    const void* q, const void* t, const void* q_lens, const void* t_lens,
    const void* offsets, void* bps, void* ops, void* meta, int B, int edge,
    int band, int n_waves, int score_bytes, int packed, void* stream) {
    const Shape sh = shape_of(band, score_bytes);
    auto st = (cudaStream_t)stream;
    if (score_bytes == 4)
        return packed ? dispatch<int32_t, true>(sh, q, t, q_lens, t_lens,
                                                offsets, bps, ops, meta, B,
                                                edge, band, n_waves, st)
                      : dispatch<int32_t, false>(sh, q, t, q_lens, t_lens,
                                                 offsets, bps, ops, meta, B,
                                                 edge, band, n_waves, st);
    if (score_bytes == 2)
        return packed ? dispatch<int16_t, true>(sh, q, t, q_lens, t_lens,
                                                offsets, bps, ops, meta, B,
                                                edge, band, n_waves, st)
                      : dispatch<int16_t, false>(sh, q, t, q_lens, t_lens,
                                                 offsets, bps, ops, meta, B,
                                                 edge, band, n_waves, st);
    return (int)cudaErrorInvalidValue;
}

