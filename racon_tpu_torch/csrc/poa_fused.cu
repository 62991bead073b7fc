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
// fused posture: the slicing rule runs here). Scratch: a DP ring
// [B, 129, L+1] of the score type and backpointers [B, N, L+1] i8.
//
// The JAX program's semantics that decide bytes, kept exactly:
//   - each layer reads the whole pre-layer state, then writes: the
//     reads land in shared memory before any write, a barrier between;
//   - the DP keeps a ring of the last 128 rows (slot 0 the virtual
//     source), as the JAX carry does; a window whose predecessor lies
//     more than 128 ranks back fails (ring_fail, counting out-of-range
//     rows), and a predecessor later in rank order reads its slot as it
//     stands, so the ring is not an optimisation but the semantics;
//   - tie order: the first predecessor slot with a diagonal hit, then
//     the first with a vertical one, else horizontal (2P); column 0
//     takes P + the first vertical hit; the best sink is the first
//     maximum in rank order; a pred slot is the matching one, else the
//     first empty one;
//   - scores: int32_t (sentinel -(1 << 29)) or int16_t (-(1 << 14),
//     legal under ops/dtypes.poa_int16_ok). The overflow proof bounds
//     every value, so the DP runs in 32-bit registers and the score
//     type is the sentinel and the ring's stored width;
//   - insertion keys: int64 floor division of span * jrun, & ~0xFF, the
//     salt (layer index + 1) & 0xFF; the JAX scans' edge values (a scan
//     with no flag yet yields position 0's value) are kept.
//
// What bounds it on this card: the per-row dependency chain of the DP
// (row k waits for its predecessors) and the sequential traceback, not
// bytes or operations. The design is the simple one: one block of 512
// threads per window; per layer a bitonic sort of the (key << 11 | id)
// keys in shared memory (N <= 2048: the id keeps 11 bits), the layer's
// rank-ordered operands in shared memory, a DP row across the threads
// with a block max-scan for the in-row gap recurrence (a run of
// pre[j] - j*gap), the ring and backpointers in global memory (L2), and
// one thread for the traceback and the ingest's scans.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kRing = 128;
constexpr int kMaxNodes = 2048;
constexpr int kMaxPred = 8;
constexpr long long kMaxKey = 1LL << 44;

template <typename S>
struct Score;
template <>
struct Score<int32_t> {
    static constexpr int kNeg = -(1 << 29);
};
template <>
struct Score<int16_t> {
    static constexpr int kNeg = -(1 << 14);
};

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
    void* ring;
    int8_t* bps;
    int N, L, D, P, match, mismatch, gap, banded_only, sliced, np2;
};

// block-level scalars, at the head of the dynamic shared memory
struct Scalars {
    int n_nodes, n_cols, failed;
    int ring_fail, layer_fail, edge_fail;
    int row0, clipped, n_new, n_ins;
};

struct Smem {
    Scalars* s;
    long long* keys;    // [np2] sort keys
    long long* akey;    // [L] anchor column key per position
    long long* ikey;    // [L] insertion column key
    int32_t* centers;   // [N] band centre per rank
    int32_t* scores;    // [N] score at column slen per rank
    int32_t* srow;      // [L+1] the row being swept
    int32_t* target;    // [L] node each position lands on
    int32_t* tcol;      // [L] its column
    int32_t* red_v;     // [kThreads] argmax reduction
    int32_t* red_i;
    int16_t* order;     // [N] node at rank
    int16_t* rank_of;   // [N] rank of node
    int16_t* prr;       // [N*P] predecessor ranks + 1 (0 source, -1 none)
    int16_t* ranks;     // [L] traceback result
    int16_t* node_at;   // [L]
    int16_t* col0;      // [L]
    int16_t* alt;       // [L]
    int16_t* bpos_at;   // [L]
    int16_t* ins_bpos;  // [L]
    int16_t* nbp;       // [L] next aligned position's bpos
    int16_t* jrun;      // [L] place in the insertion run
    int8_t* codes_r;    // [N] code per rank, 5 out of range
    uint8_t* in_range;  // [N] per node
    uint8_t* has_succ;  // [N] per node
    uint8_t* sink_r;    // [N] per rank
    uint8_t* kind;      // [L] position flags
    uint8_t* slot;      // [L] pred slot of the edge into position j+1
};

// position flags
constexpr uint8_t kAligned = 1, kSame = 2, kUseAlt = 4, kInsertion = 8,
                  kNewNode = 16;

__host__ __device__ inline size_t align16(size_t x) {
    return (x + 15) & ~size_t(15);
}

__host__ __device__ inline size_t smem_layout(int N, int L, int P, int np2,
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
    t.keys = (long long*)take(8 * (size_t)np2);
    t.akey = (long long*)take(8 * (size_t)L);
    t.ikey = (long long*)take(8 * (size_t)L);
    t.centers = (int32_t*)take(4 * (size_t)N);
    t.scores = (int32_t*)take(4 * (size_t)N);
    t.srow = (int32_t*)take(4 * (size_t)(L + 1));
    t.target = (int32_t*)take(4 * (size_t)L);
    t.tcol = (int32_t*)take(4 * (size_t)L);
    t.red_v = (int32_t*)take(4 * (size_t)kThreads);
    t.red_i = (int32_t*)take(4 * (size_t)kThreads);
    t.order = (int16_t*)take(2 * (size_t)N);
    t.rank_of = (int16_t*)take(2 * (size_t)N);
    t.prr = (int16_t*)take(2 * (size_t)N * P);
    t.ranks = (int16_t*)take(2 * (size_t)L);
    t.node_at = (int16_t*)take(2 * (size_t)L);
    t.col0 = (int16_t*)take(2 * (size_t)L);
    t.alt = (int16_t*)take(2 * (size_t)L);
    t.bpos_at = (int16_t*)take(2 * (size_t)L);
    t.ins_bpos = (int16_t*)take(2 * (size_t)L);
    t.nbp = (int16_t*)take(2 * (size_t)L);
    t.jrun = (int16_t*)take(2 * (size_t)L);
    t.codes_r = (int8_t*)take((size_t)N);
    t.in_range = (uint8_t*)take((size_t)N);
    t.has_succ = (uint8_t*)take((size_t)N);
    t.sink_r = (uint8_t*)take((size_t)N);
    t.kind = (uint8_t*)take((size_t)L);
    t.slot = (uint8_t*)take((size_t)L);
    if (m) *m = t;
    return off;
}

__device__ inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// floor division of int64 by a positive int64 (numpy / JAX `//`)
__device__ inline long long floordiv(long long a, long long b) {
    long long q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
    return q;
}

// Inclusive running max over v[0..n) in shared memory, in place.
__device__ void block_max_scan(int32_t* v, int n, int32_t* warp_tot) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ch = (n + kThreads - 1) / kThreads;
    const int lo = tid * ch, hi = min(n, lo + ch);
    int m = INT_MIN;
    for (int c = lo; c < hi; ++c) {
        m = max(m, v[c]);
        v[c] = m;
    }
    int incl = m;
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = INT_MIN;
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int pre = excl;
    for (int w = 0; w < warp; ++w) pre = max(pre, warp_tot[w]);
    for (int c = lo; c < hi; ++c) v[c] = max(v[c], pre);
    __syncthreads();
}

// One DP of the layer against the rank-ordered graph at band `band`
// (0 = full), then the traceback into m.ranks.
template <typename S>
__device__ void dp_align(const Params& p, const Smem& m, int nn, int slen,
                         int band, const int8_t* seq, S* ring,
                         int8_t* bps) {
    const int tid = threadIdx.x;
    const int L = p.L, P = p.P, gap = p.gap;
    const int W1 = L + 1;
    const int NEG = Score<S>::kNeg;
    for (int i = tid; i < (kRing + 1) * (slen + 1); i += kThreads) {
        const int s = i / (slen + 1), c = i % (slen + 1);
        ring[s * W1 + c] = (S)(s == 0 ? c * gap : NEG);
    }
    for (int r = tid; r < nn; r += kThreads) m.scores[r] = NEG;
    __syncthreads();
    const int band2 = band / 2;
    const bool use_band = band > 0;
    for (int k = 1; k <= nn; ++k) {
        const int r = k - 1;
        const int code_k = m.codes_r[r];
        const int center = m.centers[r];
        const int jlo = use_band ? max(1, center - band2) : 1;
        const int jhi = use_band ? min(slen, center + band2) : slen;
        int pslot[kMaxPred];
        bool pvalid[kMaxPred];
        for (int q = 0; q < P; ++q) {
            const int pk = m.prr[r * P + q];
            pvalid[q] = pk >= 0;
            pslot[q] = pk > 0 ? 1 + (pk - 1) % kRing : 0;
        }
        for (int c = 1 + tid; c <= slen; c += kThreads) {
            const int sub = seq[c - 1] == code_k ? p.match : p.mismatch;
            int best = INT_MIN;
            for (int q = 0; q < P; ++q) {
                const int d = pvalid[q] ? (int)ring[pslot[q] * W1 + c - 1]
                                        : NEG;
                const int v = pvalid[q] ? (int)ring[pslot[q] * W1 + c] : NEG;
                best = max(best, max(d + sub, v + gap));
            }
            const bool inb = c >= jlo && c <= jhi;
            m.srow[c] = (inb ? best : NEG) - c * gap;
        }
        if (tid == 0) {
            int row0 = INT_MIN;
            for (int q = 0; q < P; ++q)
                row0 = max(row0, (pvalid[q] ? (int)ring[pslot[q] * W1] : NEG)
                                     + gap);
            m.s->row0 = row0;
            m.srow[0] = jlo == 1 ? row0 : NEG;
        }
        __syncthreads();
        block_max_scan(m.srow, slen + 1, m.red_v);
        int8_t* bp_row = bps + (size_t)r * W1;
        for (int c = 1 + tid; c <= slen; c += kThreads) {
            const bool inb = c >= jlo && c <= jhi;
            const int h = inb ? m.srow[c] + c * gap : NEG;
            const int sub = seq[c - 1] == code_k ? p.match : p.mismatch;
            int pd = -1, pv = -1;
            for (int q = 0; q < P; ++q) {
                const int d = pvalid[q] ? (int)ring[pslot[q] * W1 + c - 1]
                                        : NEG;
                const int v = pvalid[q] ? (int)ring[pslot[q] * W1 + c] : NEG;
                if (pd < 0 && d + sub == h) pd = q;
                if (pv < 0 && v + gap == h) pv = q;
            }
            bp_row[c] = (int8_t)(pd >= 0 ? pd : (pv >= 0 ? P + pv : 2 * P));
            m.srow[c] = h;
            if (c == slen) m.scores[r] = h;
        }
        if (tid == 0) {
            const int row0 = m.s->row0;
            int pv = -1;
            for (int q = 0; q < P; ++q) {
                const int v = pvalid[q] ? (int)ring[pslot[q] * W1] : NEG;
                if (pv < 0 && v + gap == row0) pv = q;
            }
            bp_row[0] = (int8_t)(P + (pv >= 0 ? pv : 0));
            m.srow[0] = row0;
        }
        __syncthreads();
        S* dst = ring + (size_t)(1 + (k - 1) % kRing) * W1;
        for (int c = tid; c <= slen; c += kThreads) dst[c] = (S)m.srow[c];
        __syncthreads();
    }

    // the best sink: the first maximum over all N ranks, ranks past the
    // window's nodes holding the sentinel (as the JAX program's do)
    int bv = INT_MIN, bi = 0;
    for (int r = tid; r < nn; r += kThreads) {
        const int v = m.sink_r[r] ? m.scores[r] : NEG;
        if (v > bv) { bv = v; bi = r; }
    }
    if (tid == 0 && nn < p.N && NEG > bv) { bv = NEG; bi = nn; }
    if (bv == INT_MIN) bi = INT_MAX;
    m.red_v[tid] = bv;
    m.red_i[tid] = bi;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
        if (tid < h) {
            const int ov = m.red_v[tid + h], oi = m.red_i[tid + h];
            if (ov > m.red_v[tid] || (ov == m.red_v[tid] && oi < m.red_i[tid])) {
                m.red_v[tid] = ov;
                m.red_i[tid] = oi;
            }
        }
        __syncthreads();
    }
    for (int j = tid; j < L; j += kThreads) m.ranks[j] = -2;
    __syncthreads();
    if (tid == 0) {
        const int N = p.N;
        int r = m.red_i[0] + 1, j = slen;
        while (r > 0 || j > 0) {
            const int code =
                r > 0 ? bps[(size_t)clampi(r - 1, 0, N - 1) * W1 +
                            clampi(j, 0, L)]
                      : 2 * P;
            const bool is_d = code < P;
            const bool is_v = code >= P && code < 2 * P;
            const int q = is_d ? code : code - P;
            const int pr = m.prr[clampi(r - 1, 0, N - 1) * P +
                                 clampi(q, 0, P - 1)];
            if (!is_v) m.ranks[clampi(j - 1, 0, L - 1)] =
                (int16_t)(is_d ? r - 1 : -1);
            if (is_d || is_v) r = pr;
            if (!is_v) --j;
        }
    }
    __syncthreads();
}

template <typename S>
__global__ void __launch_bounds__(kThreads, 1) fused_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    Smem m;
    smem_layout(p.N, p.L, p.P, p.np2, smem, &m);
    const int tid = threadIdx.x;
    const int b = blockIdx.x;
    const int N = p.N, L = p.L, D = p.D, P = p.P, C = p.N;
    const int W1 = L + 1;

    int8_t* codes = p.codes + (size_t)b * N;
    int16_t* preds = p.preds + (size_t)b * N * P;
    int32_t* predw = p.predw + (size_t)b * N * P;
    int32_t* nseq = p.nseq + (size_t)b * N;
    int16_t* col_of = p.col_of + (size_t)b * N;
    int64_t* colkey = p.colkey + (size_t)b * C;
    int16_t* colnodes = p.colnodes + (size_t)b * C * 5;
    int16_t* bpos = p.bpos + (size_t)b * N;
    S* ring = (S*)p.ring + (size_t)b * (kRing + 1) * W1;
    int8_t* bps = p.bps + (size_t)b * N * W1;

    if (tid == 0) {
        m.s->n_nodes = p.n_nodes[b];
        m.s->n_cols = p.n_cols[b];
        m.s->failed = p.failed[b] ? 1 : 0;
    }
    __syncthreads();

    for (int step = 0; step < D; ++step) {
        const size_t li = (size_t)b * D + step;
        const int slen = p.lens[li];
        if (slen <= 0 || m.s->failed) continue;  // inactive: no write
        const int nn = m.s->n_nodes;
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

        // ---- topological order: sort (column key << 11 | id)
        for (int i = tid; i < p.np2; i += kThreads) {
            long long key = LLONG_MAX;
            if (i < N) {
                key = codes[i] >= 0
                          ? (colkey[clampi(col_of[i], 0, C - 1)] << 11) | i
                          : (1LL << 62) | i;
            }
            m.keys[i] = key;
        }
        __syncthreads();
        for (int k = 2; k <= p.np2; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int i = tid; i < p.np2; i += kThreads) {
                    const int ixj = i ^ j;
                    if (ixj > i) {
                        const long long a = m.keys[i], c = m.keys[ixj];
                        if ((a > c) == ((i & k) == 0)) {
                            m.keys[i] = c;
                            m.keys[ixj] = a;
                        }
                    }
                }
                __syncthreads();
            }
        }
        for (int r = tid; r < N; r += kThreads) {
            const int n = (int)(m.keys[r] & 0x7FF);
            m.order[r] = (int16_t)n;
            m.rank_of[n] = (int16_t)r;
        }
        for (int i = tid; i < N; i += kThreads) {
            m.in_range[i] = codes[i] >= 0 && bpos[i] >= rlo && bpos[i] <= rhi;
            m.has_succ[i] = 0;
        }
        if (tid == 0) {
            m.s->ring_fail = 0;
            m.s->layer_fail = 0;
            m.s->edge_fail = 0;
        }
        __syncthreads();

        // ---- the layer's range subgraph, by masking, in rank order
        const int origin = rlo > 0 ? rlo : 0;
        for (int r = tid; r < nn; r += kThreads) {
            const int n = m.order[r];
            const bool irr = m.in_range[n];
            m.codes_r[r] = irr ? codes[n] : 5;
            m.centers[r] = (int)bpos[n] - origin + 1;
            bool any_ok = false, far = false;
            for (int q = 0; q < P; ++q) {
                const int pn = preds[n * P + q];
                const int pc = clampi(pn, 0, N - 1);
                const bool ok = pn >= 0 && m.in_range[pc];
                const int v = ok ? m.rank_of[pc] + 1 : -1;
                if (ok) {
                    any_ok = true;
                    if (irr) m.has_succ[pc] = 1;
                }
                if (v > 0 && (r + 1) - v > kRing) far = true;
                m.prr[r * P + q] = (int16_t)v;
            }
            if (!any_ok && irr) m.prr[r * P] = 0;
            if (far) m.s->ring_fail = 1;
        }
        __syncthreads();
        for (int r = tid; r < nn; r += kThreads)
            m.sink_r[r] = m.in_range[m.order[r]] && !m.has_succ[m.order[r]];
        __syncthreads();

        // ---- align: banded, then the full DP where the band clipped
        dp_align<S>(p, m, nn, slen, band, seq, ring, bps);
        if (!p.banded_only && band > 0) {
            if (tid == 0) {
                int n_al = 0, n_ma = 0;
                for (int j = 0; j < slen; ++j) {
                    const int rk = m.ranks[j];
                    if (rk >= 0) {
                        ++n_al;
                        if (m.codes_r[clampi(rk, 0, N - 1)] == seq[j]) ++n_ma;
                    }
                }
                m.s->clipped = n_al == 0 || 2 * n_ma < n_al;
            }
            __syncthreads();
            if (m.s->clipped) dp_align<S>(p, m, nn, slen, 0, seq, ring, bps);
        }

        // ---- ingest, read phase: every position against the pre-layer
        // graph
        for (int j = tid; j < slen; j += kThreads) {
            const int rk = m.ranks[j];
            const int base = seq[j];
            const bool aligned = rk >= 0;
            const int node = aligned ? m.order[clampi(rk, 0, N - 1)] : -1;
            const int nc = clampi(node, 0, N - 1);
            const int c0 = aligned ? col_of[nc] : -1;
            const bool same = aligned && codes[nc] == base;
            const int alt =
                aligned ? colnodes[clampi(c0, 0, C - 1) * 5 + clampi(base, 0, 4)]
                        : -1;
            uint8_t kd = 0;
            if (aligned) kd |= kAligned;
            if (same) kd |= kSame;
            if (aligned && !same && alt >= 0) kd |= kUseAlt;
            if (aligned && !same && alt < 0) kd |= kNewNode;
            if (!aligned) kd |= kInsertion | kNewNode;
            m.kind[j] = kd;
            m.node_at[j] = (int16_t)node;
            m.col0[j] = (int16_t)c0;
            m.alt[j] = (int16_t)alt;
            m.bpos_at[j] = bpos[nc];
            m.akey[j] = aligned ? colkey[clampi(c0, 0, C - 1)] : 0;
        }
        __syncthreads();

        // ---- the ingest's scans, one thread. The JAX program's
        // associative scans, edge values included: a forward scan with no
        // flagged position yet yields position 0's value
        if (tid == 0) {
            const int n0 = m.s->n_nodes, c0n = m.s->n_cols;
            // backward: the next aligned position's key and bpos
            long long nkey = kMaxKey;
            int nbp = 0;
            for (int j = slen - 1; j >= 0; --j) {
                if (m.kind[j] & kAligned) {
                    nkey = m.akey[j];
                    nbp = m.bpos_at[j];
                }
                m.ikey[j] = nkey;  // the next key, until the key itself
                m.nbp[j] = (int16_t)nbp;
            }
            // forward: the previous aligned key and bpos, each position's
            // place in its insertion run, node and column allocation
            long long pkey_incl = 0;
            int pbp_incl = 0, ins_i = 0, rs_incl = 0, n_new = 0, n_ins = 0;
            bool has_prev = false, fail = false;
            for (int j = 0; j < slen; ++j) {
                const uint8_t kd = m.kind[j];
                const long long pkey_prev = j == 0 ? 0 : pkey_incl;
                const int pbp_prev = j == 0 ? 0 : pbp_incl;
                const int rs_excl = j == 0 ? 0 : rs_incl;
                const bool ins = kd & kInsertion;
                m.ins_bpos[j] = (int16_t)(has_prev ? pbp_prev : m.nbp[j]);
                if (ins) ++ins_i;
                if (kd & kAligned) {
                    pkey_incl = m.akey[j];
                    pbp_incl = m.bpos_at[j];
                    has_prev = true;
                    rs_incl = ins_i;
                } else if (j == 0) {
                    rs_incl = ins_i;
                }
                m.jrun[j] = (int16_t)(ins ? ins_i - rs_excl : 0);
                m.akey[j] = pkey_prev;  // the previous key from here on
                if (kd & kNewNode) ++n_new;
                if (ins) ++n_ins;
                const int nid = n0 + n_new - 1, cid = c0n + n_ins - 1;
                if (((kd & kNewNode) && nid >= N) || (ins && cid >= C))
                    fail = true;
                m.target[j] = (kd & kSame)      ? m.node_at[j]
                              : (kd & kUseAlt)  ? m.alt[j]
                              : (kd & kNewNode) ? nid
                                                : -1;
                m.tcol[j] = ins ? cid : m.col0[j];
            }
            // backward again: each run's largest jrun, then the keys
            int mr = 0;
            for (int j = slen - 1; j >= 0; --j) {
                const uint8_t kd = m.kind[j];
                const int jrun = m.jrun[j];
                mr = (kd & kAligned) ? 0 : max(mr, jrun);
                if (kd & kInsertion) {
                    const long long pkey_prev = m.akey[j];
                    const long long nkey_next = m.ikey[j];
                    const long long span = nkey_next - pkey_prev;
                    const long long m1 = (long long)mr + 1;
                    const long long spacing = floordiv(span, m1);
                    const long long grid =
                        pkey_prev + floordiv(span * (long long)jrun, m1);
                    const long long ik = (grid & ~0xFFLL) | salt;
                    if (spacing <= 512 || ik <= pkey_prev || ik >= nkey_next)
                        fail = true;
                    m.ikey[j] = ik;
                }
            }
            m.s->layer_fail = fail || m.s->ring_fail;
            m.s->n_new = n_new;
            m.s->n_ins = n_ins;
        }
        __syncthreads();
        const bool ok = !m.s->layer_fail;

        // ---- edges, read phase: the pred slot of each new edge
        if (ok) {
            for (int j = tid; j + 1 < slen; j += kThreads) {
                const int tail = m.target[j];
                const int h = clampi(m.target[j + 1], 0, N - 1);
                int match = -1, empty = -1;
                for (int q = 0; q < P; ++q) {
                    const int pn = preds[h * P + q];
                    if (match < 0 && pn == tail && tail >= 0) match = q;
                    if (empty < 0 && pn < 0) empty = q;
                }
                if (match < 0 && empty < 0) m.s->edge_fail = 1;
                m.slot[j] = (uint8_t)(match >= 0 ? match : (empty >= 0 ? empty : 0));
            }
        }
        __syncthreads();

        // ---- write phase
        if (ok) {
            const int edges = !m.s->edge_fail;
            for (int j = tid; j < slen; j += kThreads) {
                const uint8_t kd = m.kind[j];
                const int base = seq[j];
                const int t = m.target[j];
                if (kd & kNewNode) {
                    const int tc = m.tcol[j];
                    codes[t] = (int8_t)base;
                    col_of[t] = (int16_t)tc;
                    bpos[t] = (kd & kInsertion) ? m.ins_bpos[j] : m.bpos_at[j];
                    const int pos = clampi(tc, 0, C - 1) * 5 + base;
                    if (pos >= 0 && pos < C * 5) colnodes[pos] = (int16_t)t;
                }
                if (kd & kInsertion) colkey[m.tcol[j]] = m.ikey[j];
                if (t >= 0) atomicAdd(&nseq[t], 1);
                if (edges && j + 1 < slen) {
                    const int h = clampi(m.target[j + 1], 0, N - 1);
                    const int q = m.slot[j];
                    preds[h * P + q] = (int16_t)t;
                    atomicAdd(&predw[h * P + q], (int)wts[j] + (int)wts[j + 1]);
                }
            }
        }
        __syncthreads();
        if (tid == 0) {
            if (ok) {
                m.s->n_nodes += m.s->n_new;
                m.s->n_cols += m.s->n_ins;
            }
            if (!ok || m.s->edge_fail) m.s->failed = 1;
        }
        __syncthreads();
    }
    if (tid == 0) {
        p.n_nodes[b] = m.s->n_nodes;
        p.n_cols[b] = m.s->n_cols;
        p.failed[b] = (uint8_t)m.s->failed;
    }
}

template <typename S>
cudaError_t launch(const Params& prm, int B, cudaStream_t stream) {
    const int smem = (int)smem_layout(prm.N, prm.L, prm.P, prm.np2, nullptr,
                                      nullptr);
    const cudaError_t e = cudaFuncSetAttribute(
        fused_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    fused_kernel<S><<<B, kThreads, smem, stream>>>(prm);
    return cudaGetLastError();
}

int next_pow2(int n) {
    int v = 1;
    while (v < n) v <<= 1;
    return v;
}

}  // namespace

// The state arrays (the first 11 pointers) are updated in place. a0..a3
// are rlo, rhi, band, unused with sliced == 0, and begins, ends, bblen,
// offs with sliced == 1. score_bytes: 4 (int32 ring) or 2 (int16).
extern "C" int rt_poa_fused(
    void* codes, void* preds, void* predw, void* nseq, void* col_of,
    void* colkey, void* colnodes, void* bpos, void* n_nodes, void* n_cols,
    void* failed, const void* seqs, const void* lens, const void* wts,
    const void* a0, const void* a1, const void* a2, const void* a3,
    const void* lbase, void* ring, void* bps, int B, int N, int L, int D,
    int P, int match, int mismatch, int gap, int banded_only,
    int score_bytes, int sliced, void* stream) {
    if (B <= 0 || D <= 0) return 0;
    if (N < 1 || N > kMaxNodes || P < 1 || P > kMaxPred || L < 1)
        return (int)cudaErrorInvalidValue;
    Params prm{(int8_t*)codes, (int16_t*)preds, (int32_t*)predw,
               (int32_t*)nseq, (int16_t*)col_of, (int64_t*)colkey,
               (int16_t*)colnodes, (int16_t*)bpos, (int32_t*)n_nodes,
               (int32_t*)n_cols, (uint8_t*)failed, (const int8_t*)seqs,
               (const int32_t*)lens, (const int8_t*)wts, a0, a1, a2, a3,
               (const int32_t*)lbase, ring, (int8_t*)bps, N, L, D, P, match,
               mismatch, gap, banded_only, sliced, next_pow2(N)};
    cudaStream_t st = (cudaStream_t)stream;
    if (score_bytes == 4) return (int)launch<int32_t>(prm, B, st);
    if (score_bytes == 2) return (int)launch<int16_t>(prm, B, st);
    return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block takes at this shape.
extern "C" int rt_poa_fused_smem(int N, int L, int P) {
    return (int)smem_layout(N, L, P, next_pow2(N), nullptr, nullptr);
}
