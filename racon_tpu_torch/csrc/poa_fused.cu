// Whole-window POA for Hopper (K3): every layer of a chunk of windows,
// one block per window, in one launch — the topological order, the
// graph-NW DP and its traceback, the banded clipped -> full-DP retry and
// the ingest of the aligned layer into the window's graph arrays.
//
// Replaces racon_tpu/ops/poa_fused.py::fused_raw (an XLA program: a scan
// over layers of argsort, a fori_loop DP, a while_loop traceback and
// vectorised scatters). Same state arrays, updated in place, and the
// same integers: the plain version (ops/poa_fused.py::fused_raw, which
// the CPU tests hold against the JAX program) is what the kernel is held
// against on the card.
//
// State (leading dim B, C = N): codes [B,N] i8 (-1 free), preds [B,N,P]
// i16, predw [B,N,P] i32, nseq [B,N] i32, col_of [B,N] i16, colkey [B,N]
// i64, colnodes [B,N,5] i16, bpos [B,N] i16, n_nodes/n_cols [B] i32,
// failed [B] u8. Layers: seqs/wts [B,D,L] i8, lens [B,D] i32, lbase [B]
// i32, and either rlo/rhi [B,D] i16 + band [B,D] i32 (the split posture:
// sliced on the host) or begins/ends [B,D] i32 + bblen/offs [B] i32 (the
// fused posture: the slicing rule runs here). Scratch: a band-compact
// score spill [B, spill_cells(N, L)] of the score type and backpointers
// [B, N, Lw] i8 (Lw = L rounded up to 16), of which a DP uses nn rows of
// its own window width.
//
// The JAX program's semantics that decide bytes, kept exactly:
//   - each layer reads the whole pre-layer state, then writes: the
//     reads land in shared memory before any write, a barrier between;
//   - the DP keeps a ring of the last 128 rows (slot 0 the virtual
//     source), as the JAX carry does; a window whose predecessor lies
//     more than 128 ranks back fails (ring_fail, counting out-of-range
//     rows), and a predecessor later in rank order reads its slot as it
//     stands, so the ring is not an optimisation but the semantics. Row
//     k goes to slot 1 + (k - 1) % 128, so a read of predecessor rank pk
//     from row k reads row pk when pk < k, else the last row before k in
//     pk's slot (pk - 128 m), or the slot's initial sentinel row;
//   - tie order: the first predecessor slot with a diagonal hit, then
//     the first with a vertical one, else horizontal (2P); column 0
//     takes P + the first vertical hit; the best sink is the first
//     maximum over all N ranks, ranks past the window's nodes holding
//     the sentinel; a pred slot is the matching one, else the first
//     empty one;
//   - scores: int32_t (sentinel -(1 << 29)) or int16_t (-(1 << 14),
//     legal under ops/dtypes.poa_int16_ok). The overflow proof bounds
//     every value, the drift of unreachable cells below the sentinel
//     included, so the DP runs in 32-bit registers and the score type is
//     the sentinel and the stored width of the ring and spill;
//   - insertion keys: int64 floor division of span * jrun, & ~0xFF, the
//     salt (layer index + 1) & 0xFF; the JAX scans' edge values (a scan
//     with no flag yet yields position 0's value) are kept.
//
// What bounds it on this card: the per-row dependency chain of the DP
// (row k waits for its predecessors; a row is a few hundred integer
// operations), not bytes or operations, and a chunk waits for its
// deepest window's chain of layers. So the design cuts the latency of a
// row, as K1 (csrc/poa_window_sweep.cu) does for the same recurrence:
//
//   - a team of four warps (128 threads) per window, one per scheduler
//     of the SM, all four on each row; two named barriers (bar.sync 1,
//     128) per row: the warps' scan totals are in, and the row is in the
//     ring. (One warp a row, four independent rows of a column at once
//     with one barrier a group, measured 1.7 times slower a row on the
//     card: a lone warp leaves every latency exposed, as K1 found.)
//     Thread t owns a contiguous odd run of the row's band window
//     [jlo, jhi] only, the run length (1, 3 or 5 cells: band 256 takes 3, the
//     full-DP retry up to 640 columns 5) a template parameter picked
//     per DP from its window width. The in-row gap recurrence is a
//     running max of pre[j] - j*gap: a per-thread scan of the run, a
//     warp-shuffle scan of the run totals and the lower warps' totals
//     from shared memory, seeded by the columns left of the window;
//   - band-compact rows: a row stores its column 0 (in a shared array
//     of all rows) and its window only; a read outside a predecessor's
//     window yields kNeg, exactly what the JAX ring holds there
//     (hrow = where(inb, run, NEG)). Rows live in a ring of R slots in
//     shared memory between kNeg guard cells (R from the window width
//     and the shared memory left, up to N), and every row is copied
//     once, coalesced, to the global spill: all rows of a banded DP (the
//     traceback recomputes clipped cells from them), the last 128 of a
//     full one (the farthest a read reaches). The ring's slot map is
//     the JAX ring's: a read resolves to the row its slot holds;
//   - each row's predecessor list is compacted once per DP to its real
//     entries and one stand-in for the empty slots, in edge order; an
//     entry carries the predecessor's rank (for the traceback), how far
//     back the row it reads lies, that row's first column and whether
//     plain ring loads serve it. Per cell the sweep keeps the best
//     diagonal and vertical value and the first entry reaching each, so
//     score and backpointer come from one pass over registers;
//   - the traceback is a pointer chase by warp 0 in lockstep over the
//     shared lists and band-compact int8 backpointers: the ring for the
//     last R rows, before that a cache in the ring's space refilled from
//     the global plane by cp.async bursts (all of a refill's copies in
//     flight at once); a cell outside its row's window is recomputed
//     from the spilled scores with the same equality tests;
//   - the topological order sorts the nn live nodes' keys only, padded
//     to a power of two (ranks nn..N-1 hold the dead ids nn..N-1 in
//     order, which is where a sort of all N keys puts them: live nodes
//     are ids 0..n_nodes-1, as the engine allocates them): bitonic, the
//     stages whose partner is in the same thread in registers, in the
//     same warp by shuffles, and only those across warps in shared
//     memory. The sort keys, the ring and the ingest's per-position
//     arrays share one region of shared memory, never live together;
//   - the ingest's scans (the last aligned position, the next one,
//     insertion and new-node counts) and the band-clip count run
//     across the team: per-thread runs, shuffles, warp totals; the
//     segmented max of the insertion runs is read off the run's last
//     position (jrun never falls within a run);
//   - a layer that fails the ring rule skips its DP: layer_fail gates
//     every write of the layer and the window leaves the device, so
//     nothing of that DP is ever read.
//
// Limits: N <= 2048 (the sort key keeps the id in 11 bits), P <= 8,
// L <= 640 (5 cells a thread), bands of 0 or at most 256 (the engine's
// static band), and the block's arrays plus two ring rows of L columns
// within 227 KB (rt_poa_fused_smem).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kTeam = 128;  // one window's threads: four warps
constexpr int kWarps = kTeam / kWarp;
constexpr unsigned kFull = 0xffffffffu;
// the 227 KB (232,448 bytes) of shared memory a block may hold
constexpr int kMaxSmem = 232448;
constexpr int kRing = 128;  // the JAX ring's rows, the source apart
constexpr int kMaxNodes = 2048;
constexpr int kMaxPred = 8;  // list stride, and P of the internal codes
constexpr int kMaxRun = 5;   // window cells a thread at most
constexpr int kMaxLen = kTeam * kMaxRun;
// kNeg cells on each side of a ring row's window
constexpr int kGuard = 8;
// spill stride bound of a band-256 row (257 cells), 16-byte rows
constexpr int kBandCols = 272;
constexpr int kSortPer = kMaxNodes / kTeam;  // keys a thread sorts at most
constexpr long long kMaxKey = 1LL << 44;

template <typename S>
__host__ __device__ constexpr int neg_of() {
    return sizeof(S) == 2 ? -(1 << 14) : -(1 << 29);
}

struct Params {
    int8_t* codes;
    int16_t* preds;
    int32_t* predw;
    int32_t* nseq;
    int16_t* col_of;
    int64_t* colkey;
    int16_t* colnodes;
    int16_t* bpos;
    int32_t* n_nodes;
    int32_t* n_cols;
    uint8_t* failed;
    const int8_t* seqs;
    const int32_t* lens;
    const int8_t* wts;
    const void* a0;  // rlo (i16) | begins (i32)
    const void* a1;  // rhi (i16) | ends (i32)
    const void* a2;  // band (i32) | bblen (i32)
    const void* a3;  // - | offs (i32)
    const int32_t* lbase;
    void* spill;
    int8_t* bps;
    long long* stages;  // the diagnostic build's [B, 16] stage clocks
    int N, L, D, P, match, mismatch, gap, banded_only, sliced, smem;
};

// block-level scalars
struct Scalars {
    int n_nodes, n_cols, failed;
    int ring_fail, layer_fail, edge_fail;
    int n_al, n_ma;
#ifdef K3_STAGE_CLOCKS
    long long stg[16], mark;
#endif
};

// Stage clocks of the diagnostic build (K3_STAGE_CLOCKS, never defined by
// the production build): thread 0 adds the cycles since the last mark to
// stage i right after the barrier that ends it. Stages: 0 sort, 1 range
// subgraph, 2 DP sweep, 3 traceback, 4 scans, 5 writes; counters: 6 rows
// swept, 7 DP passes, 8 layers run; 9 the block's cycles.
#ifdef K3_STAGE_CLOCKS
#define STAGE(s, i)                          \
    if (threadIdx.x == 0) {                  \
        const long long now_ = clock64();    \
        (s)->stg[i] += now_ - (s)->mark;     \
        (s)->mark = now_;                    \
    }
#define COUNT(s, i, n) \
    if (threadIdx.x == 0) (s)->stg[i] += (n);
#else
#define STAGE(s, i)
#define COUNT(s, i, n)
#endif

__host__ __device__ inline size_t align16(size_t x) {
    return (x + 15) & ~size_t(15);
}

// row strides of a DP whose windows are `width` columns wide, each row
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
__host__ __device__ inline int ring_slot_bytes(int width, int sb) {
    return sb * ring_stride(width, sb) + bp_stride(width);
}
__host__ __device__ inline int lw_of(int L) { return (L + 15) & ~15; }

// score cells of a window's spill: every row of a banded DP, or the last
// kRing rows of a full one
__host__ __device__ inline size_t spill_cells(int N, int L) {
    const size_t band = (size_t)N * kBandCols;
    const size_t ring = (size_t)kRing * lw_of(L);
    return band > ring ? band : ring;
}

// the ingest's per-position arrays in the shared region
__host__ __device__ inline size_t ingest_bytes(int L) {
    return 2 * align16(8 * (size_t)L) + 2 * align16(4 * (size_t)L) +
           9 * align16(2 * (size_t)L) + 2 * align16((size_t)L);
}

__host__ __device__ inline size_t sort_bytes(int N) {
    int np2 = kTeam;
    while (np2 < N) np2 <<= 1;
    return 8 * (size_t)np2;
}

// The block's arrays, then the shared region (sort keys | ring | ingest).
struct Smem {
    Scalars* s;
    int* tot;          // [4 * kWarps] the team's scan totals
    int32_t* col0;     // [N+1] column 0 of every row (row 0: the source)
    int32_t* win;      // [N+1] each row's window, lo | hi << 16
    int32_t* edges;    // [N * kMaxPred] compacted predecessor lists
    int16_t* order;    // [N] node at rank
    int16_t* rank_of;  // [N] rank of node
    int16_t* ranks;    // [L] the traceback's path
    int8_t* codes_r;   // [N] code per rank, 5 out of range
    uint8_t* sinks;    // [N] per rank
    int8_t* bp0;       // [N] column-0 backpointers
    int8_t* nedge;     // [N] entries in each compacted list
    uint8_t* in_range; // [N] per node
    uint8_t* has_succ; // [N] per node
    int8_t* seq;       // [L]
    unsigned char* region;
};

__host__ __device__ inline size_t fixed_layout(int N, int L,
                                               unsigned char* base,
                                               Smem* m) {
    size_t off = 0;
    auto take = [&](size_t bytes) {
        unsigned char* p = base ? base + off : nullptr;
        off = align16(off + bytes);
        return p;
    };
    Smem t;
    t.s = (Scalars*)take(sizeof(Scalars));
    t.tot = (int*)take(4 * 4 * kWarps);
    t.col0 = (int32_t*)take(4 * (size_t)(N + 1));
    t.win = (int32_t*)take(4 * (size_t)(N + 1));
    t.edges = (int32_t*)take(4 * (size_t)N * kMaxPred);
    t.order = (int16_t*)take(2 * (size_t)N);
    t.rank_of = (int16_t*)take(2 * (size_t)N);
    t.ranks = (int16_t*)take(2 * (size_t)L);
    t.codes_r = (int8_t*)take((size_t)N);
    t.sinks = (uint8_t*)take((size_t)N);
    t.bp0 = (int8_t*)take((size_t)N);
    t.nedge = (int8_t*)take((size_t)N);
    t.in_range = (uint8_t*)take((size_t)N);
    t.has_succ = (uint8_t*)take((size_t)N);
    t.seq = (int8_t*)take((size_t)L);
    t.region = base ? base + off : nullptr;
    if (m) *m = t;
    return off;
}

// Shared memory a block asks for at (N, L) and score width sb: the
// arrays, and a region for the sort keys, the ingest or a ring of up to
// N rows of L columns, within 227 KB. Above kMaxSmem when even two ring
// rows do not fit (the launch refuses the shape).
inline int smem_bytes(int N, int L, int sb) {
    const size_t fixed = fixed_layout(N, L, nullptr, nullptr);
    size_t least = 2 * (size_t)ring_slot_bytes(L, sb);
    if (ingest_bytes(L) > least) least = ingest_bytes(L);
    if (sort_bytes(N) > least) least = sort_bytes(N);
    if (fixed + least > (size_t)kMaxSmem) return (int)(fixed + least);
    size_t want = (size_t)N * ring_slot_bytes(L, sb);
    if (least > want) want = least;
    return fixed + want < (size_t)kMaxSmem ? (int)(fixed + want) : kMaxSmem;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// floor division of int64 by a positive int64 (numpy / JAX `//`)
__device__ __forceinline__ long long floordiv(long long a, long long b) {
    long long q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
    return q;
}

// The team's barrier: named barrier 1 over the window's kTeam threads.
__device__ __forceinline__ void team_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(kTeam) : "memory");
}

__device__ __forceinline__ int win_lo(int packed) { return packed & 0xffff; }
__device__ __forceinline__ int win_hi(int packed) { return packed >> 16; }

// A compacted list entry: bits 0-11 the predecessor's rank + 1 (0: the
// stand-in for empty slots, 1: the source row, else rank pk + 1 of a
// node row), 12-22 the first column of the row it reads, 23-30 how far
// back that row lies (0: the slot still holds its initial sentinel row),
// bit 31 set when plain ring loads serve it.
__device__ __forceinline__ int entry_pk(int e) { return (e & 0xfff) - 1; }
__device__ __forceinline__ int entry_lo(int e) { return (e >> 12) & 0x7ff; }
__device__ __forceinline__ int entry_back(int e) { return (e >> 23) & 0xff; }

// copy n16 16-byte words from global to shared memory with the warp (the
// backpointer plane to the traceback's cache): asynchronous copies, all in
// flight before the warp waits for them, so a refill costs about one
// memory latency rather than one a word a lane
__device__ __forceinline__ void copy16(void* dst, const void* src, int n16,
                                       int lane) {
#ifdef __CUDA_ARCH__
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int4* s = reinterpret_cast<const int4*>(src);
    for (int i = lane; i < n16; i += kWarp)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         d + 16 * i),
                     "l"(s + i)
                     : "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#else
    const int4* s = reinterpret_cast<const int4*>(src);
    for (int i = lane; i < n16; i += kWarp)
        reinterpret_cast<int4*>(dst)[i] = s[i];
#endif
}

// One DP's band geometry and stored rows, shared by the sweep and the
// traceback. Row r >= 1 is node rank r - 1; row 0 is the virtual source.
template <typename S>
struct Job {
    static constexpr int kNeg = neg_of<S>();
    int slen, gap, Ws, Wb, Wr, R, all_rows;
    const int32_t* win;
    const int32_t* col0;
    S* spill;

    // the spill row of DP row r: every row, or a ring of kRing
    __device__ __forceinline__ size_t spill_row(int r) const {
        return (size_t)(all_rows ? r - 1 : (r - 1) % kRing) * Ws;
    }
    // H[r][j] of a swept row (or the source), read from the spill
    __device__ int score(int r, int j) const {
        if (r == 0) return j <= slen ? j * gap : kNeg;
        if (j == 0) return col0[r];
        const int w = win[r];
        const int l = win_lo(w);
        return (j >= l && j <= win_hi(w)) ? (int)spill[spill_row(r) + j - l]
                                          : kNeg;
    }
    // H at column j of what list entry e of row r reads
    __device__ int entry_score(int e, int r, int j) const {
        const int pk1 = e & 0xfff;
        if (pk1 == 1) return score(0, j);
        if (pk1 == 0 || entry_back(e) == 0) return kNeg;
        return score(r - entry_back(e), j);
    }
};

// Backpointer of a cell outside its row's window, where H is kNeg: the
// same equality tests the sweep makes, on the spilled scores, over the
// row's n-entry compacted list.
template <typename S>
__device__ int off_window_code(const Job<S>& q, const int32_t* pk, int n,
                               int r, int j, int s) {
    constexpr int kNeg = neg_of<S>();
    for (int e = 0; e < n; ++e)
        if (q.entry_score(pk[e], r, j - 1) + s == kNeg) return e;
    for (int e = 0; e < n; ++e)
        if (q.entry_score(pk[e], r, j) + q.gap == kNeg) return kMaxPred + e;
    return 2 * kMaxPred;
}

__device__ __forceinline__ void load_edges(const int32_t* p,
                                           int (&e)[kMaxPred]) {
#pragma unroll
    for (int i = 0; i < kMaxPred; i += 4) {
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
struct RowMeta {
    int edges[kMaxPred];  // compacted predecessor list
    int n, code, sink, win;

    __device__ __forceinline__ void load(const Smem& s, int r) {
        load_edges(s.edges + (size_t)r * kMaxPred, edges);
        n = s.nedge[r];
        code = s.codes_r[r];
        sink = s.sinks[r];
        win = s.win[r + 1];
    }
};

// The row sweep of one DP, RUN cells a thread. Returns the sink argmax's
// rank (before the ranks-past-nn rule) and its score.
template <int RUN, typename S>
__device__ __forceinline__ int2 sweep_rows(const Job<S>& q, const Smem& s,
                                           S* ring, int8_t* bring, int nn,
                                           int8_t* bp, int t, int match,
                                           int mismatch) {
    constexpr int kNeg = neg_of<S>();
    constexpr int P = kMaxPred;
    // 16-byte words of a spilled score row
    constexpr int kPerWord = 16 / (int)sizeof(S);
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
    RowMeta next;
    next.load(s, 0);
    for (int k = 1; k <= nn; ++k) {
        const RowMeta m = next;
        next.load(s, min(k, nn - 1));
        const int prev = slot;
        slot = slot + 1 == R ? 0 : slot + 1;
        // row k - 1 goes to the spill while this row computes
        SpillCopy<RUN, S> cp;
        cp.load(ring + (size_t)prev * Wr + kGuard, Ws / kPerWord,
                bring + (size_t)prev * Wb, Wb / 16, t);
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
        // the compacted predecessors in edge order. Strictly greater
        // replaces, so the first entry keeps each cell's best diagonal
        // and best vertical value. The codes are indices into this list.
        int row0 = INT_MIN, row0p = 0;
#pragma unroll
        for (int i = 0; i < P; ++i) {
            if (i >= m.n) break;
            const int e = m.edges[i];
            const int pk1 = e & 0xfff;
            const int d = entry_back(e);
            int h0;
            int v[RUN + 1];
            if (e < 0) {
                // the common case, one uniform branch: plain loads from
                // the ring (threads past the row's end read cells of the
                // same row nobody stores)
                h0 = s.col0[k - d];
                const int ps = slot - d < 0 ? slot - d + R : slot - d;
                const S* row = ring + (size_t)ps * Wr +
                               (min(j0, jhi) - 1 - entry_lo(e) + kGuard);
#pragma unroll
                for (int c = 0; c <= RUN; ++c) v[c] = row[c];
                if (j0 == 1) v[0] = h0;
            } else if (pk1 == 0 || (pk1 > 1 && d == 0)) {
                // the empty slots' stand-in, or a slot still holding its
                // initial row: kNeg everywhere, column 0 included
                h0 = kNeg;
#pragma unroll
                for (int c = 0; c <= RUN; ++c) v[c] = kNeg;
            } else if (pk1 == 1) {
                // the source row is computed
                h0 = 0;
#pragma unroll
                for (int c = 0; c <= RUN; ++c) {
                    const int j = j0 - 1 + c;
                    v[c] = j <= slen ? j * gap : kNeg;
                }
            } else {
                // a window the guards do not stretch over, in the ring
                // (fewer than R rows back) or the spill; each branch is
                // uniform across the team
                const int r = k - d;
                h0 = s.col0[r];
                const int wp = s.win[r];
                const int plo = win_lo(wp);
                const int wlen = max(0, win_hi(wp) - plo + 1);
                if (d < R) {
                    const int ps = slot - d < 0 ? slot - d + R : slot - d;
                    read_row<RUN, S>(v, ring + (size_t)ps * Wr + kGuard,
                                     j0 - 1 - plo, wlen);
                } else {
                    read_row<RUN, S>(v, q.spill + q.spill_row(r),
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
            cp.store(q.spill + q.spill_row(k - 1), Ws / kPerWord,
                     bp + (size_t)(k - 2) * Wb, Wb / 16, t);

        // in-row gap recurrence: running max of pre[j] - j*gap, seeded by
        // the columns left of the window (column 0 when jlo == 1, else the
        // kNeg cells 0..jlo-1, whose largest pre[j] - j*gap lies at an
        // end). A shuffle from below lane `off` returns the lane's
        // own value, so the scan needs no lane test.
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
        int8_t* bk = bring + (size_t)slot * Wb;
        // every row is a sink candidate, a non-sink at kNeg; one thread
        // per row (the owner of column slen of a sink, else thread 0)
        // keeps it
        const bool sink_k = m.sink != 0;
        const int own = slen - j0;
        const bool sink_mine =
            sink_k && slen >= jlo && slen <= jhi ? own >= 0 && own < nc
                                                 : t == 0;
        int sink_v = kNeg;
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
            bring + (size_t)slot * Wb, Wb / 16, t);
    cp.store(q.spill + q.spill_row(nn), Ws / kPerWord,
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
    team_sync();  // the totals are read before they are written again
    return make_int2(best_r, best_v);
}

// One DP of the layer (band 0: the full DP), then the traceback into
// s.ranks. The windows of a banded DP are in s.win already.
template <int RUN, typename S>
__device__ void dp_run(const Params& p, const Smem& s, int nn, int slen,
                       int band, S* spill, int8_t* bp, int t) {
    constexpr int kNeg = neg_of<S>();
    constexpr int P = kMaxPred;
    constexpr int sb = (int)sizeof(S);
    const int N = p.N;
    const bool full = band <= 0;
    const int W = full ? slen : min(2 * (band / 2) + 1, slen);
    Job<S> q;
    q.slen = slen;
    q.gap = p.gap;
    q.Ws = score_stride(W, sb);
    q.Wb = bp_stride(W);
    q.Wr = ring_stride(W, sb);
    const int region = p.smem - (int)(s.region - (unsigned char*)s.s);
    q.R = min(N, region / ring_slot_bytes(W, sb));
    q.all_rows = !full;
    q.win = s.win;
    q.col0 = s.col0;
    q.spill = spill;
    const int R = q.R;

    // each row's entries: the row each reads, its first column, and
    // whether plain ring loads serve it (a row fewer than R back whose
    // window, stretched by kGuard, covers the reading row's)
    const int fullw = 1 | (slen << 16);
    for (int r = t; r < nn; r += kTeam) {
        const int k = r + 1;
        if (full) s.win[k] = fullw;
        const int w = full ? fullw : s.win[k];
        const int jlo = win_lo(w), jhi = win_hi(w);
        int32_t* pk = s.edges + (size_t)r * P;
        for (int e = 0; e < s.nedge[r]; ++e) {
            int ent = pk[e] & 0xfff;
            const int pkv = ent - 1;
            if (pkv >= 1) {
                // the row pk's slot holds when row k reads it
                const int kr =
                    pkv < k ? pkv : pkv - kRing * ((pkv - k) / kRing + 1);
                if (kr >= 1) {
                    const int d = k - kr;
                    const int pw = full ? fullw : s.win[kr];
                    const int plo = win_lo(pw);
                    const int phi = max(plo - 1, win_hi(pw));
                    const bool plain = d < R && jlo <= jhi &&
                                       jlo - 1 >= plo - kGuard &&
                                       jhi <= phi + kGuard;
                    ent |= (plo << 12) | (d << 23) |
                           (plain ? (int)0x80000000u : 0);
                }
            }
            pk[e] = ent;
        }
    }
    if (t == 0) {
        s.win[0] = fullw;
        s.col0[0] = 0;  // the source row at column 0
    }
    for (int j = t; j < p.L; j += kTeam) s.ranks[j] = -2;
    team_sync();

    S* ring = reinterpret_cast<S*>(s.region);
    int8_t* bring = reinterpret_cast<int8_t*>(ring + (size_t)R * q.Wr);
    int2 best = make_int2(0, INT_MIN);
    if (nn > 0)
        best = sweep_rows<RUN, S>(q, s, ring, bring, nn, bp, t, p.match,
                                  p.mismatch);
    STAGE(s.s, 2)
    COUNT(s.s, 6, nn)
    COUNT(s.s, 7, 1)
    if (t < kWarp) {
        // -- traceback --
        // the warp runs the chase in lockstep (every lane holds the same
        // r, j); its lanes refill the backpointer cache together
        const int lane = t;
        const int Wb = q.Wb;
        // rows above `top` are in the ring; row r sits in slot r % R
        const int top = nn - R;
        const int slot0 = ((top + 1) % R + R) % R;
        int best_i = best.x;
        // ranks past the window's nodes are candidates at kNeg too
        if (nn < N && kNeg > best.y) best_i = nn;
        // the score ring is free now: a cache of M backpointer rows
        int8_t* cache = reinterpret_cast<int8_t*>(ring);
        const int cache_off = (int)(bring - cache);
        const int M = (int)(((size_t)R * q.Wr * sb) / Wb);
        int cb = 1, ct = 0;  // cached rows cb..ct (none yet)
        int r = best_i + 1, j = slen;
        // a chase over topo-ordered preds takes at most r + j steps; the
        // cap only stops malformed input from hanging the card
        for (int step = 0; (r > 0 || j > 0) && step <= N + p.L; ++step) {
            int code, nr;
            const int w = s.win[min(max(r, 0), nn)];
            const int lo = win_lo(w);
            const bool in_ring = r > top;
            if (r >= 1 && r <= nn && j >= lo && j <= win_hi(w) &&
                (in_ring || (r >= cb && r <= ct))) {
                // the common step, one branch: a swept row at a window
                // column, its backpointers in the ring or the cache (which
                // lies before the ring's backpointers in shared memory)
                const int rs = slot0 + r - top - 1;
                code = bring[in_ring ? (rs < R ? rs : rs - R) * Wb + j - lo
                                     : (r - cb) * Wb + j - lo - cache_off];
                const int e = code < P ? code : code < 2 * P ? code - P : 0;
                nr = entry_pk(s.edges[(size_t)(r - 1) * P + e]);
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
                    const int sc = s.seq[j - 1] == s.codes_r[r - 1]
                                       ? p.match
                                       : p.mismatch;
                    code = off_window_code<S>(
                        q, s.edges + (size_t)(r - 1) * P, s.nedge[r - 1], r,
                        j, sc);
                }
                const int e = code < P ? code : code < 2 * P ? code - P : 0;
                nr = entry_pk(s.edges[(size_t)(r - 1) * P + e]);
            } else if (r <= 0) {
                code = 2 * P;  // the source row: horizontal
                nr = r;
            } else if (r > nn) {
                // a rank past the window's nodes (a sink argmax at the
                // sentinel): the zero backpointer the JAX program's
                // unswept rows hold, a diagonal to the empty slot 0
                code = 0;
                nr = -1;
            } else {
                code = s.bp0[r - 1];  // column 0
                nr = entry_pk(s.edges[(size_t)(r - 1) * P + code - P]);
            }
            const bool is_diag = code < P;
            const bool is_vert = code >= P && code < 2 * P;
            if (!is_vert && j > 0 && lane == 0)
                s.ranks[j - 1] = (int16_t)(is_diag ? r - 1 : -1);
            if (is_diag || is_vert) r = nr;
            if (!is_vert) --j;
        }
        // -- end traceback --
    }
    team_sync();
    STAGE(s.s, 3)
}

template <typename S>
__device__ void dp_align(const Params& p, const Smem& s, int nn, int slen,
                         int band, S* spill, int8_t* bp, int t) {
    const int W = band > 0 ? min(2 * (band / 2) + 1, slen) : slen;
    if (W <= kTeam)
        dp_run<1, S>(p, s, nn, slen, band, spill, bp, t);
    else if (W <= 3 * kTeam)
        dp_run<3, S>(p, s, nn, slen, band, spill, bp, t);
    else
        dp_run<5, S>(p, s, nn, slen, band, spill, bp, t);
}

// The topological order: a bitonic sort of the nn live nodes' keys
// (column key << 11 | id), padded with LLONG_MAX to np2 >= kTeam keys.
// Key i sits in thread (warp w, lane l) at e with i = w*seg + e*32 + l
// (seg = np2 / 4): partners i ^ j for j < 32 are in other lanes of the
// warp (shuffles), for 32 <= j < seg in the thread's own registers, and
// only those with j >= seg in other warps (shared memory). Writes
// order/rank_of for all N ranks: the dead ids nn..N-1 keep their place.
__device__ void sort_live(const Smem& s, int nn, int N, const int8_t* codes,
                          const int64_t* colkey, const int16_t* col_of,
                          int t) {
    long long* keys = reinterpret_cast<long long*>(s.region);
    int np2 = kTeam;
    while (np2 < nn) np2 <<= 1;
    const int E = np2 / kTeam, seg = np2 / kWarps;
    const int lane = t % kWarp, warp = t / kWarp;
    const int base = warp * seg + lane;
    // the keys' loads, each round issued together: codes and columns,
    // then the column keys
    long long x[kSortPer];
    int col[kSortPer];
#pragma unroll
    for (int e = 0; e < kSortPer; ++e) {
        const int i = base + e * kWarp;
        col[e] = -1;
        if (e < E && i < nn && codes[i] >= 0)
            col[e] = clampi(col_of[i], 0, N - 1);
    }
#pragma unroll
    for (int e = 0; e < kSortPer; ++e) {
        const int i = base + e * kWarp;
        x[e] = e < E && i < nn ? (col[e] >= 0 ? (colkey[col[e]] << 11) | i
                                              : (1LL << 62) | i)
                               : LLONG_MAX;
    }
    for (int k = 2; k <= np2; k <<= 1) {
        int j = k >> 1;
        if (j >= seg) {
#pragma unroll
            for (int e = 0; e < kSortPer; ++e)
                if (e < E) keys[base + e * kWarp] = x[e];
            team_sync();
            for (; j >= seg; j >>= 1) {
                for (int pp = t; pp < np2 / 2; pp += kTeam) {
                    const int i = ((pp & ~(j - 1)) << 1) | (pp & (j - 1));
                    const long long a = keys[i], c = keys[i | j];
                    if ((a > c) == ((i & k) == 0)) {
                        keys[i] = c;
                        keys[i | j] = a;
                    }
                }
                team_sync();
            }
#pragma unroll
            for (int e = 0; e < kSortPer; ++e)
                if (e < E) x[e] = keys[base + e * kWarp];
            team_sync();
        }
#pragma unroll
        for (int qb = 3; qb >= 0; --qb) {
            if ((kWarp << qb) <= j) {
#pragma unroll
                for (int e = 0; e < kSortPer; ++e) {
                    const int f = e ^ (1 << qb);
                    if (f > e && f < E) {
                        const bool asc = ((base + e * kWarp) & k) == 0;
                        const long long a = x[e], c = x[f];
                        if ((a > c) == asc) {
                            x[e] = c;
                            x[f] = a;
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int qb = 4; qb >= 0; --qb) {
            const int jr = 1 << qb;
            if (jr <= j) {
                const bool lower = (lane & jr) == 0;
#pragma unroll
                for (int e = 0; e < kSortPer; ++e) {
                    if (e < E) {
                        const long long y = __shfl_xor_sync(kFull, x[e], jr);
                        const bool asc = ((base + e * kWarp) & k) == 0;
                        const bool lo_wins = (x[e] < y) == (lower == asc);
                        x[e] = lo_wins ? x[e] : y;
                    }
                }
            }
        }
    }
#pragma unroll
    for (int e = 0; e < kSortPer; ++e) {
        const int i = base + e * kWarp;
        if (e < E && i < nn) {
            const int id = (int)(x[e] & 0x7ff);
            s.order[i] = (int16_t)id;
            s.rank_of[id] = (int16_t)i;
        }
    }
    for (int i = nn + t; i < N; i += kTeam) {
        s.order[i] = (int16_t)i;
        s.rank_of[i] = (int16_t)i;
    }
}

// position flags
constexpr uint8_t kAligned = 1, kSame = 2, kUseAlt = 4, kInsertion = 8,
                  kNewNode = 16;

// The ingest's per-position arrays in the shared region.
struct Ingest {
    long long* akey;    // aligned position's column key, else 0
    long long* ikey;    // insertion column key
    int32_t* target;    // node each position lands on
    int32_t* tcol;      // its column
    int16_t* node_at;
    int16_t* c0;        // the aligned node's column
    int16_t* alt;       // the column's node of this base
    int16_t* bpos_at;
    int16_t* ins_bpos;
    int16_t* last_a;    // last aligned position <= j, else -1
    int16_t* next_a;    // first aligned position >= j, else slen
    int16_t* insi;      // insertions in 0..j
    int16_t* nnew;      // new nodes in 0..j
    uint8_t* kind;
    uint8_t* slot;      // pred slot of the edge into position j+1

    __device__ Ingest(unsigned char* base, int L) {
        size_t off = 0;
        auto take = [&](size_t bytes) {
            unsigned char* q = base + off;
            off = align16(off + bytes);
            return q;
        };
        akey = (long long*)take(8 * (size_t)L);
        ikey = (long long*)take(8 * (size_t)L);
        target = (int32_t*)take(4 * (size_t)L);
        tcol = (int32_t*)take(4 * (size_t)L);
        node_at = (int16_t*)take(2 * (size_t)L);
        c0 = (int16_t*)take(2 * (size_t)L);
        alt = (int16_t*)take(2 * (size_t)L);
        bpos_at = (int16_t*)take(2 * (size_t)L);
        ins_bpos = (int16_t*)take(2 * (size_t)L);
        last_a = (int16_t*)take(2 * (size_t)L);
        next_a = (int16_t*)take(2 * (size_t)L);
        insi = (int16_t*)take(2 * (size_t)L);
        nnew = (int16_t*)take(2 * (size_t)L);
        kind = (uint8_t*)take((size_t)L);
        slot = (uint8_t*)take((size_t)L);
    }
};

// The ingest's scans over positions 0..slen-1, across the team: each
// thread a contiguous run, then shuffles and the warps' totals. Fills
// last_a, next_a, insi and nnew.
__device__ void ingest_scans(const Smem& s, const Ingest& g, int slen,
                             int t) {
    const int lane = t % kWarp, warp = t / kWarp;
    const int run = (slen + kTeam - 1) / kTeam;
    const int j0 = min(slen, t * run), j1 = min(slen, j0 + run);
    int la = -1, ni = 0, nw = 0, na = INT_MAX;
    for (int j = j0; j < j1; ++j) {
        const uint8_t kd = g.kind[j];
        if (kd & kAligned) {
            la = j;
            if (na == INT_MAX) na = j;
        }
        ni += (kd & kInsertion) != 0;
        nw += (kd & kNewNode) != 0;
    }
    int la_i = la, ni_i = ni, nw_i = nw, na_i = na;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
        const int a = __shfl_up_sync(kFull, la_i, off);
        const int b = __shfl_up_sync(kFull, ni_i, off);
        const int c = __shfl_up_sync(kFull, nw_i, off);
        const int d = __shfl_down_sync(kFull, na_i, off);
        if (lane >= off) {
            la_i = max(la_i, a);
            ni_i += b;
            nw_i += c;
        }
        if (lane + off < kWarp) na_i = min(na_i, d);
    }
    if (lane == kWarp - 1) {
        s.tot[warp] = la_i;
        s.tot[kWarps + warp] = ni_i;
        s.tot[2 * kWarps + warp] = nw_i;
    }
    if (lane == 0) s.tot[3 * kWarps + warp] = na_i;
    team_sync();
    // exclusive: the lanes below, then the warps below (above for na)
    int la_x = __shfl_up_sync(kFull, la_i, 1);
    int na_x = __shfl_down_sync(kFull, na_i, 1);
    if (lane == 0) la_x = -1;
    if (lane == kWarp - 1) na_x = INT_MAX;
    int ni_x = ni_i - ni, nw_x = nw_i - nw;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        if (w < warp) {
            la_x = max(la_x, s.tot[w]);
            ni_x += s.tot[kWarps + w];
            nw_x += s.tot[2 * kWarps + w];
        }
        if (w > warp) na_x = min(na_x, s.tot[3 * kWarps + w]);
    }
    for (int j = j0; j < j1; ++j) {
        const uint8_t kd = g.kind[j];
        if (kd & kAligned) la_x = j;
        ni_x += (kd & kInsertion) != 0;
        nw_x += (kd & kNewNode) != 0;
        g.last_a[j] = (int16_t)la_x;
        g.insi[j] = (int16_t)ni_x;
        g.nnew[j] = (int16_t)nw_x;
    }
    for (int j = j1 - 1; j >= j0; --j) {
        if (g.kind[j] & kAligned) na_x = j;
        g.next_a[j] = (int16_t)min(na_x, slen);
    }
    team_sync();
}

template <typename S>
__global__ void __launch_bounds__(kTeam, 1) fused_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    Smem s;
    fixed_layout(p.N, p.L, smem, &s);
    const int t = threadIdx.x;
    const int b = blockIdx.x;
    const int N = p.N, L = p.L, D = p.D, P = p.P, C = p.N;

    int8_t* codes = p.codes + (size_t)b * N;
    int16_t* preds = p.preds + (size_t)b * N * P;
    int32_t* predw = p.predw + (size_t)b * N * P;
    int32_t* nseq = p.nseq + (size_t)b * N;
    int16_t* col_of = p.col_of + (size_t)b * N;
    int64_t* colkey = p.colkey + (size_t)b * C;
    int16_t* colnodes = p.colnodes + (size_t)b * C * 5;
    int16_t* bpos = p.bpos + (size_t)b * N;
    S* spill = (S*)p.spill + (size_t)b * spill_cells(N, L);
    int8_t* bp = p.bps + (size_t)b * N * lw_of(L);

    if (t == 0) {
        s.s->n_nodes = p.n_nodes[b];
        s.s->n_cols = p.n_cols[b];
        s.s->failed = p.failed[b] ? 1 : 0;
#ifdef K3_STAGE_CLOCKS
        for (int i = 0; i < 16; ++i) s.s->stg[i] = 0;
        s.s->mark = clock64();
#endif
    }
    team_sync();
#ifdef K3_STAGE_CLOCKS
    const long long t_start = clock64();
#endif

    for (int step = 0; step < D; ++step) {
        const size_t li = (size_t)b * D + step;
        const int slen = p.lens[li];
        if (slen <= 0 || s.s->failed) continue;  // inactive: no write
        const int nn = s.s->n_nodes;
        const int8_t* seq = p.seqs + li * L;
        const int8_t* wts = p.wts + li * L;
        int rlo, rhi, band;
        if (p.sliced) {
            const int b32 = ((const int32_t*)p.a0)[li];
            const int e32 = ((const int32_t*)p.a1)[li];
            const int bb = ((const int32_t*)p.a2)[b];
            const int of = ((const int32_t*)p.a3)[b];
            const bool spanning = b32 < of && e32 > bb - of;
            const int span = spanning ? bb : e32 - b32 + 1;
            rlo = spanning ? -32768 : (int16_t)b32;
            rhi = spanning ? 32767 : (int16_t)e32;
            const int diff = slen - span;
            band = (diff < 0 ? -diff : diff) < 256 / 2 - 16 ? 256 : 0;
        } else {
            rlo = ((const int16_t*)p.a0)[li];
            rhi = ((const int16_t*)p.a1)[li];
            band = ((const int32_t*)p.a2)[li];
        }
        const long long salt = ((long long)(p.lbase[b] + step) + 1) & 0xFF;
        COUNT(s.s, 8, 1)
        STAGE(s.s, 5)

        // ---- topological order
        sort_live(s, nn, N, codes, colkey, col_of, t);
        {
            // every node's range flag: the loads first, then the stores
            bool irr[kSortPer];
#pragma unroll
            for (int e = 0; e < kSortPer; ++e) {
                const int i = t + e * kTeam;
                irr[e] = false;
                if (i < N) {
                    const int bp_i = bpos[i];
                    irr[e] = codes[i] >= 0 && bp_i >= rlo && bp_i <= rhi;
                }
            }
#pragma unroll
            for (int e = 0; e < kSortPer; ++e) {
                const int i = t + e * kTeam;
                if (i < N) {
                    s.in_range[i] = irr[e];
                    s.has_succ[i] = 0;
                }
            }
        }
        for (int j = t; j < slen; j += kTeam) s.seq[j] = seq[j];
        if (t == 0) {
            s.s->ring_fail = 0;
            s.s->layer_fail = 0;
            s.s->edge_fail = 0;
            s.s->n_al = 0;
            s.s->n_ma = 0;
        }
        team_sync();
        STAGE(s.s, 0)

        // ---- the layer's range subgraph, by masking, in rank order: the
        // code, band window and compacted predecessor list of each rank
        const int origin = rlo > 0 ? rlo : 0;
        const int b2 = band / 2;
        for (int r = t; r < nn; r += kTeam) {
            const int n = s.order[r];
            const bool irr = s.in_range[n];
            s.codes_r[r] = irr ? codes[n] : 5;
            if (band > 0) {
                const int center = (int)bpos[n] - origin + 1;
                int lo = max(1, center - b2), hi = min(slen, center + b2);
                // an empty window, canonical: no cells, lo within 11 bits
                if (lo > hi) {
                    lo = slen + 1;
                    hi = slen;
                }
                s.win[r + 1] = lo | (hi << 16);
            }
            int raw[kMaxPred];
            bool any_ok = false, far = false;
#pragma unroll
            for (int q = 0; q < kMaxPred; ++q) {
                raw[q] = -1;
                if (q < P) {
                    const int pn = preds[n * P + q];
                    const int pc = clampi(pn, 0, N - 1);
                    const bool ok = pn >= 0 && s.in_range[pc];
                    if (ok) {
                        any_ok = true;
                        if (irr) s.has_succ[pc] = 1;
                        raw[q] = s.rank_of[pc] + 1;
                        if ((r + 1) - raw[q] > kRing) far = true;
                    }
                }
            }
            if (!any_ok && irr) raw[0] = 0;
            // the real entries in edge order, and the first empty slot,
            // which reads kNeg everywhere and stands for all of them
            // (later ones tie with it and lose)
            int32_t* pk = s.edges + (size_t)r * kMaxPred;
            int ne = 0;
            bool pad = false;
#pragma unroll
            for (int q = 0; q < kMaxPred; ++q) {
                if (q < P) {
                    const bool real = raw[q] >= 0;
                    if (real || !pad) pk[ne++] = raw[q] + 1;
                    pad = pad || !real;
                }
            }
            s.nedge[r] = (int8_t)ne;
            if (far) s.s->ring_fail = 1;
        }
        team_sync();
        for (int r = t; r < nn; r += kTeam) {
            const int n = s.order[r];
            s.sinks[r] = s.in_range[n] && !s.has_succ[n];
        }
        STAGE(s.s, 1)
        if (s.s->ring_fail) {
            // the layer fails whatever its DP gives, and the window leaves
            // the device: nothing of that DP would be read
            team_sync();
            if (t == 0) s.s->failed = 1;
            team_sync();
            continue;
        }

        // ---- align: banded, then the full DP where the band clipped
        dp_align<S>(p, s, nn, slen, band, spill, bp, t);
        if (!p.banded_only && band > 0) {
            int n_al = 0, n_ma = 0;
            for (int j = t; j < slen; j += kTeam) {
                const int rk = s.ranks[j];
                if (rk >= 0) {
                    ++n_al;
                    if ((rk < nn ? s.codes_r[rk] : 5) == s.seq[j]) ++n_ma;
                }
            }
#pragma unroll
            for (int off = kWarp / 2; off > 0; off >>= 1) {
                n_al += __shfl_xor_sync(kFull, n_al, off);
                n_ma += __shfl_xor_sync(kFull, n_ma, off);
            }
            if ((t % kWarp) == 0) {
                atomicAdd(&s.s->n_al, n_al);
                atomicAdd(&s.s->n_ma, n_ma);
            }
            team_sync();
            STAGE(s.s, 4)
            if (s.s->n_al == 0 || 2 * s.s->n_ma < s.s->n_al)
                dp_align<S>(p, s, nn, slen, 0, spill, bp, t);
        }

        // ---- ingest, read phase: every position against the pre-layer
        // graph
        const Ingest g(s.region, L);
        for (int j = t; j < slen; j += kTeam) {
            const int rk = s.ranks[j];
            const int base = s.seq[j];
            const bool aligned = rk >= 0;
            const int node = aligned ? s.order[clampi(rk, 0, N - 1)] : -1;
            const int nc = clampi(node, 0, N - 1);
            const int c0 = aligned ? col_of[nc] : -1;
            const bool same = aligned && codes[nc] == base;
            const int alt = aligned ? colnodes[clampi(c0, 0, C - 1) * 5 +
                                               clampi(base, 0, 4)]
                                    : -1;
            uint8_t kd = 0;
            if (aligned) kd |= kAligned;
            if (same) kd |= kSame;
            if (aligned && !same && alt >= 0) kd |= kUseAlt;
            if (aligned && !same && alt < 0) kd |= kNewNode;
            if (!aligned) kd |= kInsertion | kNewNode;
            g.kind[j] = kd;
            g.node_at[j] = (int16_t)node;
            g.c0[j] = (int16_t)c0;
            g.alt[j] = (int16_t)alt;
            g.bpos_at[j] = bpos[nc];
            g.akey[j] = aligned ? colkey[clampi(c0, 0, C - 1)] : 0;
        }
        team_sync();
        STAGE(s.s, 5)

        // ---- the ingest's scans, then each position's keys, targets and
        // failure flags. The JAX scans' edge values: a forward scan with
        // no flagged position yet yields position 0's value (0 for the
        // keys and bpos of an unaligned position 0, insi[0] for the
        // insertion run's start)
        ingest_scans(s, g, slen, t);
        const int n0 = s.s->n_nodes, c0n = s.s->n_cols;
        bool fail = false;
        for (int j = t; j < slen; j += kTeam) {
            const uint8_t kd = g.kind[j];
            const int la = j > 0 ? g.last_a[j - 1] : -1;
            const int na = g.next_a[j];
            const long long pkey_prev = la >= 0 ? g.akey[la] : 0;
            const int pbp_prev = la >= 0 ? g.bpos_at[la] : 0;
            const long long nkey_next = na < slen ? g.akey[na] : kMaxKey;
            const int nbp_next = na < slen ? g.bpos_at[na] : 0;
            g.ins_bpos[j] = (int16_t)(la >= 0 ? pbp_prev : nbp_next);
            const bool ins = kd & kInsertion;
            const int nid = n0 + g.nnew[j] - 1, cid = c0n + g.insi[j] - 1;
            if (((kd & kNewNode) && nid >= N) || (ins && cid >= C))
                fail = true;
            if (ins) {
                // place in the insertion run, and the run's largest place,
                // at its last position (e - 1: the run ends at the next
                // aligned position, or at slen)
                const int rs = j == 0 ? 0 : g.insi[la > 0 ? la : 0];
                const int jrun = g.insi[j] - rs;
                const int e1 = na - 1;
                const int rs1 = e1 == 0 ? 0 : g.insi[la > 0 ? la : 0];
                const int mr = g.insi[e1] - rs1;
                const long long span = nkey_next - pkey_prev;
                const long long m1 = (long long)mr + 1;
                const long long spacing = floordiv(span, m1);
                const long long grid =
                    pkey_prev + floordiv(span * (long long)jrun, m1);
                const long long ik = (grid & ~0xFFLL) | salt;
                if (spacing <= 512 || ik <= pkey_prev || ik >= nkey_next)
                    fail = true;
                g.ikey[j] = ik;
            }
            g.target[j] = (kd & kSame)      ? g.node_at[j]
                          : (kd & kUseAlt)  ? g.alt[j]
                          : (kd & kNewNode) ? nid
                                            : -1;
            g.tcol[j] = ins ? cid : g.c0[j];
        }
        if (fail) s.s->layer_fail = 1;
        team_sync();
        STAGE(s.s, 4)
        const bool ok = !s.s->layer_fail;

        // ---- edges, read phase: the pred slot of each new edge
        if (ok) {
            for (int j = t; j + 1 < slen; j += kTeam) {
                const int tail = g.target[j];
                const int h = clampi(g.target[j + 1], 0, N - 1);
                int match = -1, empty = -1;
                for (int q = 0; q < P; ++q) {
                    const int pn = preds[h * P + q];
                    if (match < 0 && pn == tail && tail >= 0) match = q;
                    if (empty < 0 && pn < 0) empty = q;
                }
                if (match < 0 && empty < 0) s.s->edge_fail = 1;
                g.slot[j] = (uint8_t)(match >= 0 ? match
                                                 : (empty >= 0 ? empty : 0));
            }
        }
        team_sync();

        // ---- write phase
        if (ok) {
            const bool edges = !s.s->edge_fail;
            for (int j = t; j < slen; j += kTeam) {
                const uint8_t kd = g.kind[j];
                const int base = s.seq[j];
                const int tg = g.target[j];
                if (kd & kNewNode) {
                    const int tc = g.tcol[j];
                    codes[tg] = (int8_t)base;
                    col_of[tg] = (int16_t)tc;
                    bpos[tg] =
                        (kd & kInsertion) ? g.ins_bpos[j] : g.bpos_at[j];
                    const int pos = clampi(tc, 0, C - 1) * 5 + base;
                    if (pos >= 0 && pos < C * 5) colnodes[pos] = (int16_t)tg;
                }
                if (kd & kInsertion) colkey[g.tcol[j]] = g.ikey[j];
                if (tg >= 0) atomicAdd(&nseq[tg], 1);
                if (edges && j + 1 < slen) {
                    const int h = clampi(g.target[j + 1], 0, N - 1);
                    const int q = g.slot[j];
                    preds[h * P + q] = (int16_t)tg;
                    atomicAdd(&predw[h * P + q],
                              (int)wts[j] + (int)wts[j + 1]);
                }
            }
        }
        team_sync();
        if (t == 0) {
            if (ok) {
                s.s->n_nodes += g.nnew[slen - 1];
                s.s->n_cols += g.insi[slen - 1];
            }
            if (!ok || s.s->edge_fail) s.s->failed = 1;
        }
        team_sync();
        STAGE(s.s, 5)
    }
    if (t == 0) {
#ifdef K3_STAGE_CLOCKS
        if (p.stages) {
            for (int i = 0; i < 16; ++i) p.stages[b * 16 + i] = s.s->stg[i];
            p.stages[b * 16 + 9] = clock64() - t_start;
        }
#endif
        p.n_nodes[b] = s.s->n_nodes;
        p.n_cols[b] = s.s->n_cols;
        p.failed[b] = (uint8_t)s.s->failed;
    }
}

template <typename S>
cudaError_t launch(Params prm, int B, cudaStream_t stream) {
    prm.smem = smem_bytes(prm.N, prm.L, (int)sizeof(S));
    if (prm.smem > kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        fused_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        prm.smem);
    if (e != cudaSuccess) return e;
    fused_kernel<S><<<B, kTeam, prm.smem, stream>>>(prm);
    return cudaGetLastError();
}

int run_fused(long long* stages, void* codes, void* preds, void* predw,
              void* nseq, void* col_of, void* colkey, void* colnodes,
              void* bpos, void* n_nodes, void* n_cols, void* failed,
              const void* seqs, const void* lens, const void* wts,
              const void* a0, const void* a1, const void* a2, const void* a3,
              const void* lbase, void* spill, void* bps, int B, int N, int L,
              int D, int P, int match, int mismatch, int gap, int banded_only,
              int score_bytes, int sliced, void* stream) {
    if (B <= 0 || D <= 0) return 0;
    if (N < 1 || N > kMaxNodes || P < 1 || P > kMaxPred || L < 1 ||
        L > kMaxLen)
        return (int)cudaErrorInvalidValue;
    Params prm{(int8_t*)codes, (int16_t*)preds, (int32_t*)predw,
               (int32_t*)nseq, (int16_t*)col_of, (int64_t*)colkey,
               (int16_t*)colnodes, (int16_t*)bpos, (int32_t*)n_nodes,
               (int32_t*)n_cols, (uint8_t*)failed, (const int8_t*)seqs,
               (const int32_t*)lens, (const int8_t*)wts, a0, a1, a2, a3,
               (const int32_t*)lbase, spill, (int8_t*)bps, stages, N, L, D,
               P, match, mismatch, gap, banded_only, sliced, 0};
    cudaStream_t st = (cudaStream_t)stream;
    if (score_bytes == 4) return (int)launch<int32_t>(prm, B, st);
    if (score_bytes == 2) return (int)launch<int16_t>(prm, B, st);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// The state arrays (the first 11 pointers) are updated in place. a0..a3
// are rlo, rhi, band, unused with sliced == 0, and begins, ends, bblen,
// offs with sliced == 1. spill and bps: the scratch of the score type
// and int8 (rt_poa_fused_scratch gives their sizes). score_bytes: 4
// (int32 scores) or 2 (int16).
extern "C" int rt_poa_fused(
    void* codes, void* preds, void* predw, void* nseq, void* col_of,
    void* colkey, void* colnodes, void* bpos, void* n_nodes, void* n_cols,
    void* failed, const void* seqs, const void* lens, const void* wts,
    const void* a0, const void* a1, const void* a2, const void* a3,
    const void* lbase, void* spill, void* bps, int B, int N, int L, int D,
    int P, int match, int mismatch, int gap, int banded_only,
    int score_bytes, int sliced, void* stream) {
    return run_fused(nullptr, codes, preds, predw, nseq, col_of, colkey,
                     colnodes, bpos, n_nodes, n_cols, failed, seqs, lens,
                     wts, a0, a1, a2, a3, lbase, spill, bps, B, N, L, D, P,
                     match, mismatch, gap, banded_only, score_bytes, sliced,
                     stream);
}

#ifdef K3_STAGE_CLOCKS
// The diagnostic build's entry: rt_poa_fused with each block's stage
// clocks written to stages [B, 16] i64.
extern "C" int rt_poa_fused_stages(
    void* stages, void* codes, void* preds, void* predw, void* nseq,
    void* col_of, void* colkey, void* colnodes, void* bpos, void* n_nodes,
    void* n_cols, void* failed, const void* seqs, const void* lens,
    const void* wts, const void* a0, const void* a1, const void* a2,
    const void* a3, const void* lbase, void* spill, void* bps, int B, int N,
    int L, int D, int P, int match, int mismatch, int gap, int banded_only,
    int score_bytes, int sliced, void* stream) {
    return run_fused((long long*)stages, codes, preds, predw, nseq, col_of,
                     colkey, colnodes, bpos, n_nodes, n_cols, failed, seqs,
                     lens, wts, a0, a1, a2, a3, lbase, spill, bps, B, N, L, D,
                     P, match, mismatch, gap, banded_only, score_bytes,
                     sliced, stream);
}
#endif

// Dynamic shared memory a block asks for at this shape (int32 scores, the
// wider): above 232,448 bytes the shape does not fit.
extern "C" int rt_poa_fused_smem(int N, int L, int P) {
    (void)P;
    return smem_bytes(N, L, 4);
}

// Elements of a window's score spill and of its backpointer rows (the
// scratch is [B, spill] of the score type and [B, N, bp_cols] i8).
extern "C" long long rt_poa_fused_scratch(int N, int L, int which) {
    return which == 0 ? (long long)spill_cells(N, L) : (long long)lw_of(L);
}
