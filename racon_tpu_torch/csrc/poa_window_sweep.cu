// POA window sweep for Hopper: graph-banded global NW of one layer
// sequence against its window's topo-ordered POA graph, plus the
// traceback. One (window, layer) job per block of four warps.
//
// Replaces racon_tpu/ops/poa_pallas.py::window_sweep (the Pallas TPU
// kernel). Same inputs, same arithmetic, same tie order
// (diagonal > vertical > horizontal, predecessors in edge order, sink
// ties to the smallest rank), so the ranks equal the plain version
// (ops/poa_graph.py::graph_aligner) and the consensus stays
// byte-identical to the host engine.
//
// Inputs: codes [B,N] i8, preds [B,N,P] i16 (rank+1; 0 = virtual source
// row; -1 pad), centers [B,N] i16, sinks [B,N] u8, seq [B,L] i8,
// lens/band/nnodes [B] i32 -> ranks [B,L] i32 (node rank, -1 insertion,
// -2 beyond lens). Scratch from the wrapper: a band-compact score spill
// [B,N,Lw] of the score type and backpointer plane [B,N,Lw] i8 (Lw = L
// rounded up to 16), of which a job uses nnodes rows of its own window
// width.
//
// Two instantiation axes, as the JAX programs have them:
//   - the score type S: int32_t (sentinel kNeg -(1<<29)) or int16_t
//     (-(1<<14), legal where (N + L + 2) * mp <= 16383,
//     ops/dtypes.poa_int16_ok). The proof bounds every value and
//     intermediate of the bucket, the drift of unreachable cells below
//     the sentinel included, so the DP runs in 32-bit registers either
//     way and computes the integers the int16 program computes; S is the
//     width of the stored scores: the ring rows and their guards, the
//     spill, and so the traceback's cache, which reuses the ring;
//   - the operand form: int8 codes, or codes [B, N/4] and seq [B, L/4]
//     u8 2-bit packed (encode.pack_2bit), expanded as the staging loads
//     them. Staging covers the nnodes codes and lens bases a job reads,
//     so no PAD needs restoring.
//
// What bounds it on this card: the per-row dependency chain. Row k needs
// every predecessor row finished, and a row holds at most band+1 (257)
// or slen (640) cells, a few hundred integer operations; so the sweep is
// latency-bound, not byte- or operation-bound. The TPU kernel keeps the
// whole job in VMEM; at the (2048, 640) envelope that is 5.3 MB, far
// beyond the 227 KB of shared memory a block may hold. The design keeps
// the dependency chain on-chip anyway:
//
//   - band-compact rows: a node row stores its column 0 (in a per-job
//     shared array of all rows) and its in-band window [lo, hi] only; a
//     read outside a predecessor's own window yields kNeg, exactly what a
//     full row holds there. The virtual source row is computed, not
//     stored. Every row's window is staged once as a packed (lo, hi);
//   - a ring of the last R rows (scores and int8 backpointers) in
//     dynamic shared memory. R is derived per job from its window width
//     and the shared memory left after the staged operands (ring_rows
//     below). A ring row keeps kGuard kNeg cells on each side of its
//     window, so a predecessor whose window covers the row's, give or
//     take kGuard columns, is read with plain loads. Every row is also
//     copied once, coalesced, to the global spill (loaded at the start
//     of the next row, stored after its predecessor reads); a
//     predecessor R or more ranks back is read from there, so any
//     distance is correct;
//   - the job's codes, sinks, windows and layer bases are staged into
//     shared memory once, before the sweep, with each row's predecessor
//     list compacted to its real entries and one stand-in for its
//     padding, in edge order; an entry carries its row, that row's first
//     column and whether plain ring loads serve it. The next row's
//     operands load while a row computes;
//   - a team of four warps per job, one per scheduler of the SM: thread
//     t owns a contiguous run of the row's window (an odd run, so the
//     threads' reads of a ring row hit distinct banks). The run length
//     is a template parameter picked per job from its window width (1, 3
//     or 5 cells: band-256 rows take 3), and so is P. The pred loop runs
//     over the compacted list only; per cell it keeps the best diagonal
//     and vertical value and the first entry reaching each, so score and
//     backpointer come from one pass over registers. The in-row gap
//     recurrence H[j] = max(pre[j], H[j-1]+gap) is a running max of
//     pre[j] - j*gap: a per-thread scan of the run, a warp-shuffle scan
//     of the run totals and the lower warps' totals from shared memory.
//     Two named barriers (bar.sync 1, 128) per row: the warps' totals
//     are in, and the row is in the ring. One warp per job measured
//     slower: its lone warp leaves every load and shuffle latency
//     exposed;
//   - the sink argmax is a running best in registers as rows retire
//     (strictly greater replaces, so ties keep the smallest rank), one
//     per thread, reduced across the team at the end;
//   - the traceback is a pointer chase by warp 0 in lockstep over the
//     shared-memory lists and band-compact backpointers: the ring for the
//     last R rows; before that a cache in the score ring's space,
//     refilled by the warp with coalesced copies of as many rows of the
//     global plane as fit. A cell outside its row's window (a clipped
//     band) has no stored backpointer: it is recomputed from the spilled
//     scores with the same equality tests.
//
// Limits: a row window is at most 128 * 5 = 640 columns, P is 4 or 8, and
// the staged operands plus two ring rows must fit 227 KB (N up to ~5,000
// at P = 8 and 640 columns at int32).

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTeam = 128;  // one job's threads: four warps
constexpr int kWarps = kTeam / kWarp;
constexpr unsigned kFull = 0xffffffffu;
// the 227 KB (232,448 bytes) of shared memory a block may hold
constexpr int kMaxSmem = 232448;
constexpr int kMaxRun = 5;  // window cells a thread at most: 640 columns
// kNeg cells on each side of a ring row's window: a predecessor whose
// window covers the row's, give or take kGuard columns, is read with
// plain loads
constexpr int kGuard = 8;

// The sentinel of score type S.
template <typename S>
__host__ __device__ constexpr int neg_of() {
    return sizeof(S) == 2 ? -(1 << 14) : -(1 << 29);
}

__host__ __device__ inline size_t align16(size_t x) {
    return (x + 15) & ~size_t(15);
}

// row strides of a job whose windows are `width` columns wide, each row
// 16-byte aligned: scores of `sb` bytes in the spill, int8 backpointers,
// and a ring row (the window between guards, then room for the reads of
// the threads past the window's end)
__host__ __device__ inline int score_stride(int width, int sb) {
    const int a = 16 / sb;
    return width > a ? (width + a - 1) / a * a : a;
}
__host__ __device__ inline int bp_stride(int width) {
    return width > 16 ? (width + 15) & ~15 : 16;
}
__host__ __device__ inline int ring_stride(int width, int sb) {
    return score_stride(kGuard + width + kGuard + kMaxRun + 1, sb);
}

// staged operands: the team's totals, col0 [N+1] i32, edges [N*P] i32,
// windows [N+1] i32,
// codes, sinks, column-0 backpointers and list lengths [N] i8, seq [L] i8
__host__ __device__ inline size_t operand_bytes(int N, int L, int P) {
    return align16(2 * kWarps * sizeof(int)) + align16((size_t)(N + 1) * 4) +
           align16((size_t)N * P * 4) +
           align16((size_t)(N + 1) * 4) + 4 * align16((size_t)N) +
           align16((size_t)L);
}

// ring rows for a job whose row windows are `width` columns wide, in
// `smem` bytes of shared memory, at `sb`-byte scores (at most N: then the
// ring holds the job)
__host__ __device__ inline int ring_rows(int N, int L, int P, int width,
                                         int smem, int sb) {
    const long long avail =
        (long long)smem - (long long)operand_bytes(N, L, P);
    const long long slot =
        (long long)sb * ring_stride(width, sb) + bp_stride(width);
    const long long r = avail > 0 ? avail / slot : 0;
    const int cap = N > 0 ? N : 1;
    return r < cap ? (int)r : cap;
}

inline int smem_bytes(int N, int L, int P, int sb) {
    const size_t want =
        operand_bytes(N, L, P) +
        (size_t)(N > 0 ? N : 1) * (sb * ring_stride(L, sb) + bp_stride(L));
    return want < (size_t)kMaxSmem ? (int)want : kMaxSmem;
}

__device__ __forceinline__ int win_lo(int packed) {
    return (int)(int16_t)(packed & 0xffff);
}
__device__ __forceinline__ int win_hi(int packed) { return packed >> 16; }

// A compacted list entry: the predecessor's DP row (int16; the padding
// stand-in keeps its raw value), its window's first column, and the sign
// bit when the sweep may read it with plain ring loads (a swept row
// fewer than R rows back whose window, stretched by kGuard, covers the
// row's).
__device__ __forceinline__ int edge_row(int e) { return (int16_t)(e & 0xffff); }
__device__ __forceinline__ int edge_lo(int e) { return (e >> 16) & 0x7fff; }

// copy nbytes from global to shared with the team, 16 bytes a thread
// where both ends are aligned
__device__ __forceinline__ void stage(void* dst, const void* src, int nbytes,
                                      int t) {
    const char* s = static_cast<const char*>(src);
    char* d = static_cast<char*>(dst);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
        const int n16 = nbytes >> 4;
#pragma unroll 4
        for (int i = t; i < n16; i += kTeam)
            reinterpret_cast<int4*>(d)[i] = reinterpret_cast<const int4*>(s)[i];
        done = n16 << 4;
    }
    for (int i = done + t; i < nbytes; i += kTeam) d[i] = s[i];
}

// the first n codes of a row into shared memory: bytes of the int8 form,
// or bases expanded from the packed form (four a byte, base i in bits
// 2i..2i+1)
template <bool PACKED>
__device__ __forceinline__ void stage_codes(int8_t* dst, const void* src,
                                            int n, int t) {
    if constexpr (PACKED) {
        const uint8_t* s = static_cast<const uint8_t*>(src);
        for (int i = t; i < n; i += kTeam)
            dst[i] = (int8_t)((s[i >> 2] >> (2 * (i & 3))) & 3);
    } else {
        stage(dst, src, n, t);
    }
}

// copy n16 16-byte words with the warp (the global backpointer plane to
// the traceback's cache)
__device__ __forceinline__ void copy16(void* dst, const void* src, int n16,
                                       int lane) {
    for (int i = lane; i < n16; i += kWarp)
        reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
}

// The team's barrier: named barrier 1 over the job's kTeam threads.
__device__ __forceinline__ void team_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(kTeam) : "memory");
}

// The job's staged operands in shared memory.
struct Staged {
    int* tot;        // [kWarps] each warp's scan total; [kWarps] sink best
    int32_t* col0;   // [N+1] column 0 of every row (row 0: the source)
    int32_t* edges;  // [nn*P] compacted predecessor lists, P apart
    int32_t* win;    // [nn+1] each row's window, lo | hi << 16 (row 0:
                     // the source, [1, slen])
    int8_t* codes;   // [nn]
    uint8_t* sinks;  // [nn]
    int8_t* bp0;     // [nn] column-0 backpointers
    int8_t* nedge;   // [nn] entries in each compacted list
    int8_t* seq;     // [slen]
    void* ring;      // [R][Wr] scores of the last R rows, from kGuard on
    int8_t* bring;   // [R][Wb] their backpointers
};

// One job's band geometry and stored rows, shared by the sweep and the
// traceback. Row r >= 1 is node rank r - 1; row 0 is the virtual source.
template <typename S>
struct Job {
    static constexpr int kNeg = neg_of<S>();
    int slen, gap, Ws, Wb, Wr, R;
    const int32_t* win;
    const int32_t* col0;
    const S* spill;  // every swept row's window, Ws apart

    // H[r][j] of a swept row (or the source), read from the spill
    __device__ int score(int r, int j) const {
        if (r == 0) return j <= slen ? j * gap : kNeg;
        if (j == 0) return col0[r];
        const int w = win[r];
        const int l = win_lo(w);
        return (j >= l && j <= win_hi(w)) ? spill[(size_t)(r - 1) * Ws + j - l]
                                          : kNeg;
    }
};

// Backpointer of a cell outside its row's window, where H is kNeg: the
// same equality tests the sweep makes, on the spilled scores, over the
// row's n-entry compacted predecessor list.
template <int P, typename S>
__device__ int off_window_code(const Job<S>& q, const int32_t* pk, int n,
                               int r, int j, int s) {
    constexpr int kNeg = neg_of<S>();
    for (int e = 0; e < n; ++e) {
        const int pr = edge_row(pk[e]);
        const int hd = (pr >= 0 && pr < r) ? q.score(pr, j - 1) : kNeg;
        if (hd + s == kNeg) return e;
    }
    for (int e = 0; e < n; ++e) {
        const int pr = edge_row(pk[e]);
        const int hv = (pr >= 0 && pr < r) ? q.score(pr, j) : kNeg;
        if (hv + q.gap == kNeg) return P + e;
    }
    return 2 * P;
}

template <int P>
__device__ __forceinline__ void load_edges(const int32_t* p, int (&e)[P]) {
    static_assert(P % 4 == 0, "P is a multiple of 4");
#pragma unroll
    for (int i = 0; i < P; i += 4) {
        const int4 t = *reinterpret_cast<const int4*>(p + i);
        e[i] = t.x;
        e[i + 1] = t.y;
        e[i + 2] = t.z;
        e[i + 3] = t.w;
    }
}

// H[r][j0-1 .. j0-1+RUN] of a predecessor row whose window is `wlen`
// (>= 0) columns from offset 0 of `row`; `o0` is the offset of column
// j0-1. Cells outside the window read kNeg; loads stay inside the row.
template <int RUN, typename S>
__device__ __forceinline__ void read_row(int (&v)[RUN + 1], const S* row,
                                         int o0, int wlen) {
    constexpr int kNeg = neg_of<S>();
    const int last = wlen > 0 ? wlen - 1 : 0;
#pragma unroll
    for (int c = 0; c <= RUN; ++c) {
        const int o = o0 + c;
        const int x = row[min(max(o, 0), last)];
        v[c] = (unsigned)o < (unsigned)wlen ? x : kNeg;
    }
}

// A ring row on its way to the spill, with the team: the window's cells
// as 16-byte words, loaded together at the start of the next row and
// stored once that row's predecessor reads are out. n4 counts the score
// row's 16-byte words, n16 the backpointer row's.
template <int RUN, typename S>
struct SpillCopy {
    static constexpr int kS =
        (RUN * kTeam * (int)sizeof(S) / 16 + kTeam - 1) / kTeam;
    static constexpr int kB = (RUN * kTeam / 16 + kTeam - 1) / kTeam;
    int4 h[kS], b[kB];

    __device__ __forceinline__ void load(const S* hs, int n4,
                                         const int8_t* bs, int n16,
                                         int t) {
#pragma unroll
        for (int i = 0; i < kS; ++i)
            if (t + i * kTeam < n4)
                h[i] = reinterpret_cast<const int4*>(hs)[t + i * kTeam];
#pragma unroll
        for (int i = 0; i < kB; ++i)
            if (t + i * kTeam < n16)
                b[i] = reinterpret_cast<const int4*>(bs)[t + i * kTeam];
    }
    __device__ __forceinline__ void store(S* hd, int n4, int8_t* bd,
                                          int n16, int t) const {
#pragma unroll
        for (int i = 0; i < kS; ++i)
            if (t + i * kTeam < n4)
                reinterpret_cast<int4*>(hd)[t + i * kTeam] = h[i];
#pragma unroll
        for (int i = 0; i < kB; ++i)
            if (t + i * kTeam < n16)
                reinterpret_cast<int4*>(bd)[t + i * kTeam] = b[i];
    }
};

// A row's operands, loaded one row ahead of its sweep.
template <int P>
struct RowMeta {
    int edges[P];  // compacted predecessor list
    int n, code, sink, win;

    __device__ __forceinline__ void load(const Staged& s, int r) {
        load_edges<P>(s.edges + (size_t)r * P, edges);
        n = s.nedge[r];
        code = s.codes[r];
        sink = s.sinks[r];
        win = s.win[r + 1];
    }
};

// The row sweep of one job, RUN cells a thread. Returns the sink argmax's
// rank (before the rows-past-nnodes rule) and its score.
template <int P, int RUN, typename S>
__device__ __forceinline__ int2 sweep_rows(const Job<S>& q, const Staged& s,
                                           int nn, S* sp, int8_t* bp,
                                           int t, int match,
                                           int mismatch) {
    constexpr int kNeg = neg_of<S>();
    // 16-byte words of a spilled score row
    constexpr int kPerWord = 16 / (int)sizeof(S);
    S* const ring = static_cast<S*>(s.ring);
    const int lane = t % kWarp, warp = t / kWarp;
    const int gap = q.gap, slen = q.slen, Ws = q.Ws, Wb = q.Wb, Wr = q.Wr,
              R = q.R;
    int best_v = INT_MIN, best_r = 0;  // this thread's running sink best
    // the ring's guards: kNeg left of every window, and kGuard cells
    // right of it as each row is written
    for (int i = t; i < R * kGuard; i += kTeam)
        ring[(size_t)(i / kGuard) * Wr + i % kGuard] = kNeg;
    team_sync();
    int slot = 0;  // ring slot of row k, k % R
    RowMeta<P> next;
    next.load(s, 0);
    for (int k = 1; k <= nn; ++k) {
        const RowMeta<P> m = next;
        next.load(s, min(k, nn - 1));
        const int prev = slot;
        slot = slot + 1 == R ? 0 : slot + 1;
        // row k - 1 goes to the spill while this row computes
        SpillCopy<RUN, S> cp;
        cp.load(ring + (size_t)prev * Wr + kGuard, Ws / kPerWord,
                s.bring + (size_t)prev * Wb, Wb / 16, t);
        const int jlo = win_lo(m.win), jhi = win_hi(m.win);
        const int wrow = max(0, jhi - jlo + 1);
        const int run = ((wrow + kTeam - 1) / kTeam) | 1;
        const int c0 = t * run;
        const int nc = max(0, min(run, wrow - c0));  // this thread's cells
        const int j0 = jlo + c0;

        // the per-cell code below is branch-free (cells past nc compute
        // values nobody stores), so the compiler can interleave the cells
        int sub[RUN], dmax[RUN], pd[RUN], vmax[RUN], pv[RUN];
#pragma unroll
        for (int c = 0; c < RUN; ++c) {
            const int jc = max(1, min(j0 + c, slen));
            sub[c] = s.seq[jc - 1] == m.code ? match : mismatch;
        }
        // the compacted predecessors in edge order: the real ones, and
        // the first padding entry (or row not swept yet), which reads
        // kNeg everywhere as a full row would and stands for all of them.
        // Strictly greater replaces, so the first entry keeps each cell's
        // best diagonal and best vertical value. The codes are indices
        // into this list.
        int row0 = INT_MIN, row0p = 0;
#pragma unroll
        for (int i = 0; i < P; ++i) {
            if (i >= m.n) break;
            const int e = m.edges[i];
            const int r = edge_row(e);
            int h0;
            int v[RUN + 1];
            if (e < 0) {
                // the common case, one uniform branch: plain loads from
                // the ring (threads past the row's end read cells of the
                // same row nobody stores)
                h0 = s.col0[r];
                const int d = k - r;
                const int ps = slot - d < 0 ? slot - d + R : slot - d;
                const S* row = ring + (size_t)ps * Wr +
                               (min(j0, jhi) - 1 - edge_lo(e) + kGuard);
#pragma unroll
                for (int c = 0; c <= RUN; ++c) v[c] = row[c];
                if (j0 == 1) v[0] = h0;
            } else if (r < 0 || r >= k) {
                h0 = kNeg;
#pragma unroll
                for (int c = 0; c <= RUN; ++c) v[c] = kNeg;
            } else if (r == 0) {
                // the source row is computed
                h0 = 0;
#pragma unroll
                for (int c = 0; c <= RUN; ++c) {
                    const int j = j0 - 1 + c;
                    v[c] = j <= slen ? j * gap : kNeg;
                }
            } else {
                // a window the guards do not stretch over, in the ring
                // (r fewer than R rows back) or the spill; each branch is
                // uniform across the team
                h0 = s.col0[r];
                const int wp = s.win[r];
                const int plo = win_lo(wp);
                const int wlen = max(0, win_hi(wp) - plo + 1);
                const int d = k - r;
                if (d < R) {
                    const int ps = slot - d < 0 ? slot - d + R : slot - d;
                    read_row<RUN, S>(v, ring + (size_t)ps * Wr + kGuard,
                                     j0 - 1 - plo, wlen);
                } else {
                    read_row<RUN, S>(v, sp + (size_t)(r - 1) * Ws,
                                     j0 - 1 - plo, wlen);
                }
                if (j0 == 1) v[0] = h0;
            }
            if (h0 + gap > row0) {
                row0 = h0 + gap;
                row0p = i;
            }
#pragma unroll
            for (int c = 0; c < RUN; ++c) {
                const int dv = v[c] + sub[c];
                const int vv = v[c + 1] + gap;
                if (i == 0) {
                    dmax[c] = dv;
                    vmax[c] = vv;
                    pd[c] = pv[c] = 0;
                } else {
                    if (dv > dmax[c]) { dmax[c] = dv; pd[c] = i; }
                    if (vv > vmax[c]) { vmax[c] = vv; pv[c] = i; }
                }
            }
        }
        if (k > 1)
            cp.store(sp + (size_t)(k - 2) * Ws, Ws / kPerWord,
                     bp + (size_t)(k - 2) * Wb, Wb / 16, t);

        // in-row gap recurrence: running max of pre[j] - j*gap, seeded by
        // the columns left of the window (column 0 when jlo == 1, kNeg
        // cells otherwise). A shuffle from below lane `off` returns the
        // lane's own value, so the scan needs no lane test.
        int x[RUN];
        int acc = INT_MIN;
#pragma unroll
        for (int c = 0; c < RUN; ++c) {
            const int u = max(dmax[c], vmax[c]) - (j0 + c) * gap;
            acc = c < nc ? max(acc, u) : acc;
            x[c] = acc;
        }
        int incl = acc;
#pragma unroll
        for (int off = 1; off < kWarp; off <<= 1)
            incl = max(incl, __shfl_up_sync(kFull, incl, off));
        const int excl = __shfl_up_sync(kFull, incl, 1);
        if (lane == kWarp - 1) s.tot[warp] = incl;
        team_sync();  // the warps' totals are in
        int prefix = jlo == 1 ? row0 : max(kNeg, kNeg - (jlo - 1) * gap);
#pragma unroll
        for (int w = 0; w < kWarps - 1; ++w)
            if (w < warp) prefix = max(prefix, s.tot[w]);
        if (lane > 0) prefix = max(prefix, excl);

        S* hk = ring + (size_t)slot * Wr + kGuard;
        int8_t* bk = s.bring + (size_t)slot * Wb;
        // every row is a sink candidate, a non-sink at kNeg; one thread
        // per row (the owner of column slen of a sink, else thread 0)
        // keeps it
        const bool sink_k = m.sink != 0;
        const int own = slen - j0;
        const bool sink_mine =
            sink_k && slen > 0 && slen >= jlo && slen <= jhi
                ? own >= 0 && own < nc
                : t == 0;
        int sink_v = sink_k && slen == 0 ? row0 : kNeg;
#pragma unroll
        for (int c = 0; c < RUN; ++c) {
            const int j = j0 + c;
            const int h = max(prefix, x[c]) + j * gap;
            const int8_t code = (int8_t)(h == dmax[c]   ? pd[c]
                                         : h == vmax[c] ? P + pv[c]
                                                        : 2 * P);
            if (c < nc) {
                hk[c0 + c] = (S)h;
                bk[c0 + c] = code;
            }
            sink_v = sink_k && c < nc && j == slen ? h : sink_v;
        }
        if (t < kGuard) hk[wrow + t] = kNeg;
        if (t == 0) {
            s.col0[k] = row0;
            s.bp0[k - 1] = (int8_t)(P + row0p);
        }
        if (sink_mine && sink_v > best_v) {
            best_v = sink_v;
            best_r = k - 1;
        }
        team_sync();  // row k is in the ring
    }
    SpillCopy<RUN, S> cp;
    cp.load(ring + (size_t)slot * Wr + kGuard, Ws / kPerWord,
            s.bring + (size_t)slot * Wb, Wb / 16, t);
    cp.store(sp + (size_t)(nn - 1) * Ws, Ws / kPerWord,
             bp + (size_t)(nn - 1) * Wb, Wb / 16, t);
    // the team's best: the largest score, ties to the smallest rank
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
        const int ov = __shfl_xor_sync(kFull, best_v, off);
        const int orr = __shfl_xor_sync(kFull, best_r, off);
        if (ov > best_v || (ov == best_v && orr < best_r)) {
            best_v = ov;
            best_r = orr;
        }
    }
    if (lane == 0) {
        s.tot[warp] = best_v;
        s.tot[kWarps + warp] = best_r;
    }
    team_sync();  // every row is in the spill, every warp's best is in
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const int ov = s.tot[w], orr = s.tot[kWarps + w];
        if (ov > best_v || (ov == best_v && orr < best_r)) {
            best_v = ov;
            best_r = orr;
        }
    }
    return make_int2(best_r, best_v);
}

template <int P, typename S, bool PACKED>
__global__ void __launch_bounds__(kTeam, 1) window_sweep_kernel(
    const uint8_t* __restrict__ codes, const int16_t* __restrict__ preds,
    const int16_t* __restrict__ centers, const uint8_t* __restrict__ sinks,
    const uint8_t* __restrict__ seq, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ bandw, const int32_t* __restrict__ nnodes,
    S* __restrict__ spill, int8_t* __restrict__ bps,
    int32_t* __restrict__ out, int N, int L, int match, int mismatch,
    int gap, int smem) {
    constexpr int kNeg = neg_of<S>();
    constexpr int sb = (int)sizeof(S);
    extern __shared__ __align__(16) unsigned char sm[];
    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t % kWarp;
    int32_t* ob = out + (size_t)b * L;
    for (int j = t; j < L; j += kTeam) ob[j] = -2;
    const int nn = min(max(nnodes[b], 0), N);
    if (nn == 0) return;  // batch padding: no rows, nothing aligned

    Job<S> q;
    q.slen = min(max(lens[b], 0), L);
    const bool banded = bandw[b] > 0;
    const int b2 = bandw[b] / 2;
    q.gap = gap;
    const int W = banded ? min(2 * b2 + 1, q.slen) : q.slen;
    q.Ws = score_stride(W, sb);
    q.Wr = ring_stride(W, sb);
    q.Wb = bp_stride(W);
    q.R = ring_rows(N, L, P, W, smem, sb);
    const int slen = q.slen;

    Staged s;
    unsigned char* at = sm;
    s.tot = reinterpret_cast<int*>(at);
    at += align16(2 * kWarps * sizeof(int));
    s.col0 = reinterpret_cast<int32_t*>(at);
    at += align16((size_t)(N + 1) * 4);
    s.edges = reinterpret_cast<int32_t*>(at);
    at += align16((size_t)N * P * 4);
    s.win = reinterpret_cast<int32_t*>(at);
    at += align16((size_t)(N + 1) * 4);
    s.codes = reinterpret_cast<int8_t*>(at);
    at += align16(N);
    s.sinks = at;
    at += align16(N);
    s.bp0 = reinterpret_cast<int8_t*>(at);
    at += align16(N);
    s.nedge = reinterpret_cast<int8_t*>(at);
    at += align16(N);
    s.seq = reinterpret_cast<int8_t*>(at);
    at += align16(L);
    s.ring = at;
    s.bring = reinterpret_cast<int8_t*>(reinterpret_cast<S*>(at) +
                                        (size_t)q.R * q.Wr);

    const int16_t* pg = preds + (size_t)b * N * P;
    const int cw = PACKED ? (N + 3) / 4 : N;
    const int sw = PACKED ? (L + 3) / 4 : L;
    stage_codes<PACKED>(s.codes, codes + (size_t)b * cw, nn, t);
    stage(s.sinks, sinks + (size_t)b * N, nn, t);
    stage_codes<PACKED>(s.seq, seq + (size_t)b * sw, slen, t);
    for (int i = t; i < nn; i += kTeam) {
        const int c = centers[(size_t)b * N + i];
        const int lo = banded ? max(1, c - b2) : 1;
        const int hi = banded ? min(slen, c + b2) : slen;
        s.win[i + 1] = (lo & 0xffff) | (hi << 16);
    }
    if (t == 0) s.win[0] = 1 | (slen << 16);
    if (t == 0) s.col0[0] = 0;  // the source row at column 0
    team_sync();
    // each row's compacted list, in edge order: its real predecessors,
    // then only the first padding entry (or row not swept yet), which
    // stands for all of them (later ones tie with it and lose)
    for (int i = t; i < nn; i += kTeam) {
        const int16_t* raw = pg + (size_t)i * P;
        int32_t* pk = s.edges + (size_t)i * P;
        const int k = i + 1;
        const int jlo = win_lo(s.win[k]), jhi = win_hi(s.win[k]);
        int n = 0;
        bool pad = false;
        for (int e = 0; e < P; ++e) {
            const int r = raw[e];
            const bool real = r >= 0 && r < k;
            if (!real && pad) continue;
            pad = pad || !real;
            int ent = r & 0xffff;
            if (real && r > 0) {
                const int plo = win_lo(s.win[r]);
                const int phi = max(plo - 1, win_hi(s.win[r]));
                const bool plain = k - r < q.R && jlo <= jhi &&
                                   jlo - 1 >= plo - kGuard &&
                                   jhi <= phi + kGuard;
                ent |= (plo << 16) | (plain ? (int)0x80000000u : 0);
            }
            pk[n++] = ent;
        }
        s.nedge[i] = (int8_t)n;
    }
    team_sync();
    const size_t job = (size_t)b * N * ((L + 15) & ~15);
    S* sp = spill + job;
    int8_t* bp = bps + job;
    q.win = s.win;
    q.col0 = s.col0;
    q.spill = sp;

    int2 best;
    if (W <= kTeam)
        best = sweep_rows<P, 1, S>(q, s, nn, sp, bp, t, match, mismatch);
    else if (W <= kTeam * 3)
        best = sweep_rows<P, 3, S>(q, s, nn, sp, bp, t, match, mismatch);
    else
        best = sweep_rows<P, 5, S>(q, s, nn, sp, bp, t, match, mismatch);
    if (t >= kWarp) return;  // warp 0 traces back

    // -- traceback --
    {
        // the warp runs the chase in lockstep (every lane holds the same
        // r, j); its lanes refill the backpointer cache together
        const int R = q.R, Wb = q.Wb;
        // rows above `top` are in the ring; row top + 1 is in slot `slot0`
        const int top = nn - R;
        const int slot0 = ((top + 1) % R + R) % R;
        int best_i = best.x;
        // ranks past nnodes are candidates at kNeg too
        if (nn < N && kNeg > best.y) best_i = nn;
        // the score ring is free now: a cache of M backpointer rows
        int8_t* cache = reinterpret_cast<int8_t*>(s.ring);
        const int cache_off = (int)(s.bring - cache);
        const int M = (int)(((size_t)R * q.Wr * sb) / Wb);
        int cb = 1, ct = 0;  // cached rows cb..ct (none yet)
        int r = best_i + 1, j = slen;
        // a chase over topo-ordered preds takes at most r + j steps; the
        // cap only stops malformed input from hanging the card
        for (int step = 0; (r > 0 || j > 0) && step <= N + L; ++step) {
            int code, nr;
            const int w = s.win[min(max(r, 0), nn)];
            const int lo = win_lo(w);
            const bool ring = r > top;
            if (r >= 1 && r <= nn && j >= lo && j <= win_hi(w) &&
                (ring || (r >= cb && r <= ct))) {
                // the common step, one branch: a swept row at a window
                // column, its backpointers in the ring or the cache (which
                // lies before the ring's backpointers in shared memory)
                const int rs = slot0 + r - top - 1;
                code = s.bring[ring ? (rs < R ? rs : rs - R) * Wb + j - lo
                                    : (r - cb) * Wb + j - lo - cache_off];
                const int e = code < P ? code : code < 2 * P ? code - P : 0;
                nr = edge_row(s.edges[(size_t)(r - 1) * P + e]);
            } else if (r >= 1 && r <= nn && j >= 1) {
                if (j >= lo && j <= win_hi(w)) {
                    // rows r - M + 1 .. r, one coalesced copy
                    __syncwarp();
                    ct = r;
                    cb = max(1, r - M + 1);
                    copy16(cache, bp + (size_t)(cb - 1) * Wb,
                           (ct - cb + 1) * Wb / 16, lane);
                    __syncwarp();
                    code = cache[(size_t)(r - cb) * Wb + j - lo];
                } else {
                    const int sc = s.seq[j - 1] == s.codes[r - 1] ? match
                                                                  : mismatch;
                    code = off_window_code<P, S>(
                        q, s.edges + (size_t)(r - 1) * P, s.nedge[r - 1], r,
                        j, sc);
                }
                const int e = code < P ? code : code < 2 * P ? code - P : 0;
                nr = edge_row(s.edges[(size_t)(r - 1) * P + e]);
            } else if (r <= 0) {
                code = 2 * P;  // the source row: horizontal
                nr = r;
            } else if (r > nn) {
                code = P;  // a row past nnodes holds its initial code
                nr = pg[(size_t)min(r - 1, N - 1) * P];
            } else {
                code = s.bp0[r - 1];  // column 0
                nr = edge_row(s.edges[(size_t)(r - 1) * P + code - P]);
            }
            const bool is_diag = code < P;
            const bool is_vert = code >= P && code < 2 * P;
            if (!is_vert && j > 0 && lane == 0)
                ob[j - 1] = is_diag ? r - 1 : -1;
            if (is_diag || is_vert) r = nr;
            if (!is_vert) --j;
        }
    }
    // -- end traceback --
}

template <int P, typename S, bool PACKED>
cudaError_t launch(const void* codes, const void* preds, const void* centers,
                   const void* sinks, const void* seq, const void* lens,
                   const void* band, const void* nnodes, void* spill,
                   void* bps, void* out, int B, int N, int L, int match,
                   int mismatch, int gap, cudaStream_t stream) {
    const int smem = smem_bytes(N, L, P, (int)sizeof(S));
    const cudaError_t e = cudaFuncSetAttribute(
        window_sweep_kernel<P, S, PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    window_sweep_kernel<P, S, PACKED><<<B, kTeam, smem, stream>>>(
        (const uint8_t*)codes, (const int16_t*)preds, (const int16_t*)centers,
        (const uint8_t*)sinks, (const uint8_t*)seq, (const int32_t*)lens,
        (const int32_t*)band, (const int32_t*)nnodes, (S*)spill,
        (int8_t*)bps, (int32_t*)out, N, L, match, mismatch, gap, smem);
    return cudaGetLastError();
}

template <typename S, bool PACKED>
cudaError_t dispatch(const void* codes, const void* preds,
                     const void* centers, const void* sinks, const void* seq,
                     const void* lens, const void* band, const void* nnodes,
                     void* spill, void* bps, void* out, int B, int N, int L,
                     int P, int match, int mismatch, int gap,
                     cudaStream_t st) {
    switch (P) {
        case 4:
            return launch<4, S, PACKED>(codes, preds, centers, sinks, seq,
                                        lens, band, nnodes, spill, bps, out,
                                        B, N, L, match, mismatch, gap, st);
        case 8:
            return launch<8, S, PACKED>(codes, preds, centers, sinks, seq,
                                        lens, band, nnodes, spill, bps, out,
                                        B, N, L, match, mismatch, gap, st);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// score_bytes: 4 (int32 scores and spill) or 2 (int16); packed: codes and
// seq are 2-bit packed [B, ceil(N/4)] and [B, ceil(L/4)] u8.
extern "C" int rt_poa_window_sweep(
    const void* codes, const void* preds, const void* centers,
    const void* sinks, const void* seq, const void* lens, const void* band,
    const void* nnodes, void* spill, void* bps, void* out, int B, int N,
    int L, int P, int match, int mismatch, int gap, int score_bytes,
    int packed, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaErrorInvalidValue;
    if (score_bytes == 4)
        e = packed ? dispatch<int32_t, true>(codes, preds, centers, sinks,
                                             seq, lens, band, nnodes, spill,
                                             bps, out, B, N, L, P, match,
                                             mismatch, gap, st)
                   : dispatch<int32_t, false>(codes, preds, centers, sinks,
                                              seq, lens, band, nnodes, spill,
                                              bps, out, B, N, L, P, match,
                                              mismatch, gap, st);
    else if (score_bytes == 2)
        e = packed ? dispatch<int16_t, true>(codes, preds, centers, sinks,
                                             seq, lens, band, nnodes, spill,
                                             bps, out, B, N, L, P, match,
                                             mismatch, gap, st)
                   : dispatch<int16_t, false>(codes, preds, centers, sinks,
                                              seq, lens, band, nnodes, spill,
                                              bps, out, B, N, L, P, match,
                                              mismatch, gap, st);
    return (int)e;
}

// Ring rows a job of `width`-column windows gets at this launch shape, at
// `score_bytes`-byte scores.
extern "C" int rt_poa_ring_rows(int N, int L, int P, int width,
                                int score_bytes) {
    return ring_rows(N, L, P, width, smem_bytes(N, L, P, score_bytes),
                     score_bytes);
}
