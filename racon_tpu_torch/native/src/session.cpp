// Round-based POA session: the host half of the evolving-graph device
// consensus engine.
//
// The reference's GPU path (GenomeWorks cudapoa, src/cuda/cudabatch.cpp)
// runs the whole POA — graph DP and consensus — inside one CUDA block per
// window. The TPU engine splits it differently: the graph lives HERE (all
// the irregular bookkeeping: node/edge insertion, aligned-column merging,
// heaviest-bundle consensus), while the O(nodes x len) graph-banded NW DP
// — the hot loop — runs on the TPU as a batched fixed-shape XLA program
// (racon_tpu/ops/poa_graph.py). Each round, `prepare` densifies the
// *current* graph of every ready window (topo-ordered codes, predecessor
// rank lists, band centers, sink flags), the device aligns that window's
// next layer against it, and `commit` ingests the returned path with the
// exact same add_alignment the host engine uses. Because the layer is
// aligned against the evolving graph — not just the backbone — the device
// engine inherits the host engine's consensus quality by construction
// (unlike an anchored prealign, which cannot see other layers' insertions
// during alignment).
//
// Orchestration contracts mirror reference src/window.cpp:65-142 exactly:
// layers sorted stable by begin; window-spanning layers (within a 1%
// offset margin) align against the full graph, others against the
// [begin, end] bpos-subgraph; banded DP (band 256) when the layer fits the
// band, with a full-DP redo when the banded result is clipped. Windows the
// device cannot take (too many nodes, in-degree over the predecessor cap,
// layer too long, or a malformed device result) fall back to the host
// engine at finish() — the same per-window GPU->CPU fallback discipline as
// reference src/cuda/cudapolisher.cpp:354-383.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include "poa.hpp"

namespace racon_host {

namespace {

constexpr int32_t kBand = 256;  // cudapoa static-band contract (cudabatch.cpp:56-59)

struct WindowState {
    // inputs (copied; index 0 = backbone)
    std::vector<std::vector<uint8_t>> seqs;
    std::vector<std::vector<uint8_t>> quals;  // empty = no quality
    std::vector<int32_t> begins, ends;

    Graph graph;
    std::vector<int32_t> layer_rank;  // layer visit order (begin-sorted)
    size_t next_layer = 0;            // index into layer_rank
    bool outstanding = false;         // a prepared job awaits commit
    bool redo_full = false;           // banded result clipped: redo band=0
    bool unfit = false;               // host fallback at finish()
    bool backbone_only = false;       // < 3 sequences

    // densification cached from prepare() for the matching commit() —
    // the graph is untouched while a job is outstanding, so the topo
    // order and subgraph mapping stay valid and are never re-derived
    bool pending_spanning = false;
    std::vector<int32_t> pending_order;    // topo rank -> (sub)graph node id
    std::vector<int32_t> pending_mapping;  // sub node id -> full node id
};

struct Session {
    std::vector<WindowState> windows;
    int32_t match, mismatch, gap;
    int32_t max_nodes, max_pred, max_len;
    // -b / banded-only mode: trust banded results (skip the clipped ->
    // full-DP retry) — the speed/accuracy trade the reference's
    // --cuda-banded-alignment flag selects via cudapoa's static_band mode
    // (cudabatch.cpp:56-59). Off by default, which keeps device output
    // byte-identical to the host engine.
    bool banded_only = false;
    size_t cursor = 0;  // round-robin scan position for prepare()
    // observability counters (SURVEY.md §5 metrics discipline)
    int64_t n_prepared = 0;   // jobs handed to the device
    int64_t n_committed = 0;  // layer alignments ingested
    int64_t n_redo = 0;       // banded results clipped -> full-DP requeue
};

std::mutex g_mutex;
std::unordered_map<int64_t, std::unique_ptr<Session>> g_sessions;
int64_t g_next_id = 1;

Session* get_session(int64_t handle) {
    std::lock_guard<std::mutex> lock(g_mutex);
    auto it = g_sessions.find(handle);
    return it == g_sessions.end() ? nullptr : it->second.get();
}

const uint32_t* weights_of(const WindowState& w, int32_t i,
                           std::vector<uint32_t>& buf) {
    const int32_t len = static_cast<int32_t>(w.seqs[i].size());
    buf.assign(len, 1);
    if (!w.quals[i].empty()) {
        for (int32_t j = 0; j < len; ++j) {
            buf[j] = w.quals[i][j] >= 33 ? w.quals[i][j] - 33 : 0;
        }
    }
    return buf.data();
}

// Decide full-graph vs subgraph and banded vs exact for this layer —
// the same rules as window_consensus (poa.cpp) / reference window.cpp:87-103.
struct JobPlan {
    bool spanning;
    int32_t band;    // 0 = exact full DP
    int32_t origin;  // bpos origin of the band centers
};

JobPlan plan_layer(const WindowState& w, int32_t i, bool redo_full) {
    const int32_t backbone_len = static_cast<int32_t>(w.seqs[0].size());
    const int32_t len = static_cast<int32_t>(w.seqs[i].size());
    const int32_t offset = static_cast<int32_t>(0.01 * backbone_len);
    JobPlan p;
    p.spanning = w.begins[i] < offset && w.ends[i] > backbone_len - offset;
    const int32_t span =
        p.spanning ? backbone_len : w.ends[i] - w.begins[i] + 1;
    const bool fits = std::abs(len - span) < kBand / 2 - 16;
    p.band = (fits && !redo_full) ? kBand : 0;
    p.origin = p.spanning ? 0 : w.begins[i];
    return p;
}

// Same acceptance rule as the host engine's banded retry (poa.cpp
// band_clipped): fewer than half the aligned columns matching means the
// in-band path is clipping artifact, not signal.
bool band_clipped(const Alignment& aln, const uint8_t* seq, const Graph& g) {
    int32_t aligned = 0, matched = 0;
    for (const auto& p : aln) {
        if (p.node >= 0 && p.pos >= 0) {
            ++aligned;
            matched += g.nodes[p.node].code == kBaseCode[seq[p.pos]];
        }
    }
    return aligned == 0 || 2 * matched < aligned;
}

}  // namespace
}  // namespace racon_host

using racon_host::Alignment;
using racon_host::AlnPair;
using racon_host::Graph;
using racon_host::Session;
using racon_host::WindowState;

extern "C" {

// Create a session over the same flat window layout rh_poa_batch takes
// (all sequences concatenated, per-window spans via win_off, first
// sequence of each window the backbone). max_nodes / max_pred / max_len
// are the device kernel's shape envelope: windows that exceed any of them
// fall back to the host engine at finish().
int64_t rh_poa_session_new(
    const uint8_t* seq_data, const int64_t* seq_off,
    const uint8_t* qual_data, const int64_t* qual_off,
    const int32_t* begins, const int32_t* ends,
    const int64_t* win_off, int64_t n_windows,
    int32_t match, int32_t mismatch, int32_t gap,
    int32_t max_nodes, int32_t max_pred, int32_t max_len,
    int32_t banded_only) {
    auto session = std::make_unique<Session>();
    session->match = match;
    session->mismatch = mismatch;
    session->gap = gap;
    session->max_nodes = max_nodes;
    session->max_pred = max_pred;
    session->max_len = max_len;
    session->banded_only = banded_only != 0;
    session->windows.resize(n_windows);

    std::vector<uint32_t> wbuf;
    for (int64_t w = 0; w < n_windows; ++w) {
        WindowState& ws = session->windows[w];
        const int64_t s0 = win_off[w], s1 = win_off[w + 1];
        const int64_t count = s1 - s0;
        for (int64_t s = s0; s < s1; ++s) {
            ws.seqs.emplace_back(seq_data + seq_off[s],
                                 seq_data + seq_off[s + 1]);
            ws.quals.emplace_back(qual_data + qual_off[s],
                                  qual_data + qual_off[s + 1]);
            ws.begins.push_back(begins[s]);
            ws.ends.push_back(ends[s]);
        }
        if (count < 3) {
            ws.backbone_only = true;
            continue;
        }
        // backbone seeds the graph
        ws.graph.add_alignment(Alignment(), ws.seqs[0].data(),
                               static_cast<int32_t>(ws.seqs[0].size()),
                               racon_host::weights_of(ws, 0, wbuf));
        // layer order: stable sort by begin (reference window.cpp:84-85)
        for (int64_t s = 1; s < count; ++s) {
            ws.layer_rank.push_back(static_cast<int32_t>(s));
        }
        std::stable_sort(ws.layer_rank.begin(), ws.layer_rank.end(),
                         [&](int32_t a, int32_t b) {
                             return ws.begins[a] < ws.begins[b];
                         });
        // a layer longer than the kernel envelope sinks the whole window
        for (int32_t i : ws.layer_rank) {
            if (static_cast<int32_t>(ws.seqs[i].size()) > max_len) {
                ws.unfit = true;
                break;
            }
        }
    }

    std::lock_guard<std::mutex> lock(racon_host::g_mutex);
    const int64_t id = racon_host::g_next_id++;
    racon_host::g_sessions.emplace(id, std::move(session));
    return id;
}

// Emit up to max_jobs ready jobs (windows with layers left and no
// outstanding job). Dense per-job buffers, caller-allocated:
//   job_win/job_layer/job_band/job_nnodes/job_len/job_origin: [max_jobs]
//   codes:   [max_jobs * max_nodes] int8  (topo-ordered node codes; pad 5)
//   preds:   [max_jobs * max_nodes * max_pred] int32 (H row index of each
//            predecessor: rank+1, 0 = virtual source; pad -1)
//   centers: [max_jobs * max_nodes] int32 (band center column per node)
//   sinks:   [max_jobs * max_nodes] uint8 (1 = sink node)
//   seqs:    [max_jobs * max_len] int8 (layer base codes; pad 5)
// Returns the number of jobs written (0 = no window is ready; the round is
// drained when this is 0 and no jobs are uncommitted).
int32_t rh_poa_session_prepare(
    int64_t handle, int32_t max_jobs, int32_t n_threads,
    int32_t* job_win, int32_t* job_layer, int32_t* job_band,
    int32_t* job_nnodes, int32_t* job_len, int32_t* job_origin,
    int32_t* job_maxpred,
    int8_t* codes, int16_t* preds, int16_t* centers, uint8_t* sinks,
    int8_t* seqs) {
    Session* s = racon_host::get_session(handle);
    if (s == nullptr || max_jobs <= 0) {
        return 0;
    }
    const int32_t N = s->max_nodes, P = s->max_pred, L = s->max_len;
    const size_t n_windows = s->windows.size();

    // pass 1 (serial): round-robin candidate selection — cheap flag checks
    std::vector<int32_t> cand;
    cand.reserve(max_jobs);
    for (size_t scanned = 0;
         scanned < n_windows &&
         static_cast<int32_t>(cand.size()) < max_jobs;
         ++scanned) {
        const size_t w = (s->cursor + scanned) % n_windows;
        WindowState& ws = s->windows[w];
        if (ws.backbone_only || ws.unfit || ws.outstanding ||
            ws.next_layer >= ws.layer_rank.size()) {
            continue;
        }
        cand.push_back(static_cast<int32_t>(w));
    }
    const int32_t n_cand = static_cast<int32_t>(cand.size());
    s->cursor = (s->cursor + n_cand) % (n_windows ? n_windows : 1);

    // pass 2 (parallel over candidates — distinct windows, no sharing):
    // plan, subgraph, topo order, densify into the candidate's slot
    std::vector<uint8_t> valid(n_cand, 0);
    std::atomic<int32_t> next(0);
    auto densify = [&]() {
        std::vector<int32_t> order, rank_of, mapping;
        while (true) {
            const int32_t c = next.fetch_add(1);
            if (c >= n_cand) {
                return;
            }
            WindowState& ws = s->windows[cand[c]];
            const int32_t li = ws.layer_rank[ws.next_layer];
            const racon_host::JobPlan plan =
                racon_host::plan_layer(ws, li, ws.redo_full);
            const Graph* g = &ws.graph;
            Graph sub;
            mapping.clear();
            if (!plan.spanning) {
                sub = ws.graph.subgraph(ws.begins[li], ws.ends[li],
                                        mapping);
                g = &sub;
            }
            const int32_t n = static_cast<int32_t>(g->nodes.size());
            if (n > N ||
                static_cast<int32_t>(ws.graph.nodes.size()) > N) {
                // graph outgrew the kernel envelope (possibly mid-build):
                // discard and host-polish the whole window at finish()
                ws.unfit = true;
                continue;
            }
            order = g->topo_order();
            rank_of.assign(n, 0);
            for (int32_t r = 0; r < n; ++r) {
                rank_of[order[r]] = r;
            }
            int8_t* jc = codes + static_cast<int64_t>(c) * N;
            int16_t* jp = preds + static_cast<int64_t>(c) * N * P;
            int16_t* jcen = centers + static_cast<int64_t>(c) * N;
            uint8_t* jsink = sinks + static_cast<int64_t>(c) * N;
            std::memset(jc, 5, N);
            std::fill(jp, jp + static_cast<int64_t>(N) * P,
                      static_cast<int16_t>(-1));
            std::memset(jcen, 0,
                        static_cast<int64_t>(N) * sizeof(int16_t));
            std::memset(jsink, 0, N);
            bool fits = true;
            int32_t max_indeg = 1;  // the virtual source counts as one
            for (int32_t r = 0; r < n && fits; ++r) {
                const racon_host::Node& node = g->nodes[order[r]];
                jc[r] = static_cast<int8_t>(node.code);
                jcen[r] = static_cast<int16_t>(node.bpos - plan.origin + 1);
                jsink[r] = node.out.empty() ? 1 : 0;
                if (node.in.empty()) {
                    jp[static_cast<int64_t>(r) * P] = 0;  // virtual source
                } else if (static_cast<int32_t>(node.in.size()) > P) {
                    fits = false;  // in-degree over the cap: host fallback
                } else {
                    for (size_t e = 0; e < node.in.size(); ++e) {
                        jp[static_cast<int64_t>(r) * P + e] =
                            static_cast<int16_t>(
                                rank_of[g->edges[node.in[e]].tail] + 1);
                    }
                    if (static_cast<int32_t>(node.in.size()) > max_indeg) {
                        max_indeg = static_cast<int32_t>(node.in.size());
                    }
                }
            }
            if (!fits) {
                ws.unfit = true;
                continue;
            }
            const int32_t len = static_cast<int32_t>(ws.seqs[li].size());
            int8_t* jq = seqs + static_cast<int64_t>(c) * L;
            std::memset(jq, 5, L);
            for (int32_t i = 0; i < len; ++i) {
                jq[i] = static_cast<int8_t>(
                    racon_host::kBaseCode[ws.seqs[li][i]]);
            }
            job_win[c] = cand[c];
            job_layer[c] = li;
            job_band[c] = plan.band;
            job_nnodes[c] = n;
            job_len[c] = len;
            job_origin[c] = plan.origin;
            job_maxpred[c] = max_indeg;
            ws.pending_spanning = plan.spanning;
            ws.pending_order = order;
            ws.pending_mapping = mapping;
            ws.outstanding = true;
            valid[c] = 1;
        }
    };
    int32_t nt = n_threads > 1 ? n_threads : 1;
    if (nt > n_cand) {
        nt = n_cand > 0 ? n_cand : 1;
    }
    if (nt <= 1) {
        densify();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nt);
        for (int32_t t = 0; t < nt; ++t) {
            pool.emplace_back(densify);
        }
        for (auto& th : pool) {
            th.join();
        }
    }

    // pass 3 (serial): compact over slots invalidated by unfit windows
    // (rare — at most once per window over the whole session)
    int32_t n_jobs = 0;
    for (int32_t c = 0; c < n_cand; ++c) {
        if (!valid[c]) {
            continue;
        }
        if (n_jobs != c) {
            std::memcpy(codes + static_cast<int64_t>(n_jobs) * N,
                        codes + static_cast<int64_t>(c) * N, N);
            std::memcpy(preds + static_cast<int64_t>(n_jobs) * N * P,
                        preds + static_cast<int64_t>(c) * N * P,
                        static_cast<int64_t>(N) * P * sizeof(int16_t));
            std::memcpy(centers + static_cast<int64_t>(n_jobs) * N,
                        centers + static_cast<int64_t>(c) * N,
                        static_cast<int64_t>(N) * sizeof(int16_t));
            std::memcpy(sinks + static_cast<int64_t>(n_jobs) * N,
                        sinks + static_cast<int64_t>(c) * N, N);
            std::memcpy(seqs + static_cast<int64_t>(n_jobs) * L,
                        seqs + static_cast<int64_t>(c) * L, L);
            job_win[n_jobs] = job_win[c];
            job_layer[n_jobs] = job_layer[c];
            job_band[n_jobs] = job_band[c];
            job_nnodes[n_jobs] = job_nnodes[c];
            job_len[n_jobs] = job_len[c];
            job_origin[n_jobs] = job_origin[c];
            job_maxpred[n_jobs] = job_maxpred[c];
        }
        ++n_jobs;
    }
    s->n_prepared += n_jobs;
    return n_jobs;
}

// Ingest device alignments. ranks[j * max_len + i] is, for job j and layer
// base i, the 0-based topo rank of the graph node base i aligned to, or
// -1 for an insertion (every i < job_len must be covered — global
// alignment consumes the whole layer). Banded jobs whose result is
// clipped are NOT ingested; they are re-queued for a full-DP redo (the
// band_clipped retry of the host engine). Malformed results mark the
// window unfit (host fallback).
void rh_poa_session_commit(
    int64_t handle, int32_t n_jobs, int32_t n_threads,
    const int32_t* job_win, const int32_t* job_layer,
    const int32_t* job_band, const int32_t* ranks) {
    Session* s = racon_host::get_session(handle);
    if (s == nullptr) {
        return;
    }
    const int32_t L = s->max_len;

    // parallel over jobs: each job's window is distinct within a batch
    // (one outstanding job per window), so graph ingest has no sharing
    std::atomic<int32_t> next(0);
    std::atomic<int64_t> committed(0), redos(0);
    auto ingest = [&]() {
        std::vector<uint32_t> wbuf;
        while (true) {
            const int32_t j = next.fetch_add(1);
            if (j >= n_jobs) {
                return;
            }
            WindowState& ws = s->windows[job_win[j]];
            const int32_t li = job_layer[j];
            ws.outstanding = false;
            // rank -> full-graph node id via the densification cached at
            // prepare() (the graph is untouched while outstanding)
            const std::vector<int32_t> order = std::move(ws.pending_order);
            const std::vector<int32_t> mapping =
                std::move(ws.pending_mapping);
            const bool spanning = ws.pending_spanning;
            ws.pending_order.clear();
            ws.pending_mapping.clear();
            if (ws.unfit) {
                continue;
            }
            const int32_t n = static_cast<int32_t>(order.size());

            const int32_t len = static_cast<int32_t>(ws.seqs[li].size());
            const int32_t* jr = ranks + static_cast<int64_t>(j) * L;
            Alignment aln;
            aln.reserve(len);
            bool ok = true;
            for (int32_t i = 0; i < len; ++i) {
                int32_t node = -1;
                if (jr[i] >= 0) {
                    if (jr[i] >= n) {
                        ok = false;
                        break;
                    }
                    node = order[jr[i]];
                    if (!spanning) {
                        node = mapping[node];
                    }
                } else if (jr[i] != -1) {
                    ok = false;  // -2 pad inside the sequence span
                    break;
                }
                aln.push_back(AlnPair{node, i});
            }
            if (!ok) {
                ws.unfit = true;
                continue;
            }
            if (job_band[j] > 0 && !s->banded_only &&
                racon_host::band_clipped(aln, ws.seqs[li].data(),
                                         ws.graph)) {
                ws.redo_full = true;  // re-queue this layer with band 0
                redos.fetch_add(1);
                continue;
            }
            ws.graph.add_alignment(aln, ws.seqs[li].data(), len,
                                   racon_host::weights_of(ws, li, wbuf));
            ws.redo_full = false;
            ++ws.next_layer;
            committed.fetch_add(1);
        }
    };
    int32_t nt = n_threads > 1 ? n_threads : 1;
    if (nt > n_jobs) {
        nt = n_jobs > 0 ? n_jobs : 1;
    }
    if (nt <= 1) {
        ingest();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nt);
        for (int32_t t = 0; t < nt; ++t) {
            pool.emplace_back(ingest);
        }
        for (auto& th : pool) {
            th.join();
        }
    }
    s->n_committed += committed.load();
    s->n_redo += redos.load();
}

// Counters: out[0] jobs prepared, out[1] layers committed, out[2] banded
// clipped->full-DP redos, out[3] unfit (host-fallback) windows so far.
void rh_poa_session_stats(int64_t handle, int64_t* out) {
    Session* s = racon_host::get_session(handle);
    if (s == nullptr) {
        out[0] = out[1] = out[2] = out[3] = 0;
        return;
    }
    out[0] = s->n_prepared;
    out[1] = s->n_committed;
    out[2] = s->n_redo;
    int64_t unfit = 0;
    for (const WindowState& ws : s->windows) {
        unfit += ws.unfit ? 1 : 0;
    }
    out[3] = unfit;
}

// Consensus for every window. Device-built graphs emit directly; unfit
// windows (and any with layers still pending) are host-polished from
// scratch; backbone-only windows copy their backbone (window.cpp:68-71).
// Output layout identical to rh_poa_batch. win_status[w]: 0 device,
// 1 host fallback, 2 backbone. Returns total bytes or -needed.
int64_t rh_poa_session_finish(
    int64_t handle, int32_t n_threads,
    uint8_t* cons_data, uint32_t* cov_data, int64_t cons_cap,
    int64_t* cons_off, int32_t* win_status) {
    Session* s = racon_host::get_session(handle);
    if (s == nullptr) {
        return -1;
    }
    const int64_t n_windows = static_cast<int64_t>(s->windows.size());
    std::vector<std::vector<uint8_t>> results(n_windows);
    std::vector<std::vector<uint32_t>> coverages(n_windows);

    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<const uint8_t*> seqs, quals;
        std::vector<int32_t> lens;
        while (true) {
            const int64_t w = next.fetch_add(1);
            if (w >= n_windows) {
                return;
            }
            WindowState& ws = s->windows[w];
            if (ws.backbone_only) {
                results[w] = ws.seqs[0];
                coverages[w].assign(ws.seqs[0].size(), 0);
                win_status[w] = 2;
            } else if (!ws.unfit &&
                       ws.next_layer == ws.layer_rank.size()) {
                results[w] = ws.graph.consensus(coverages[w]);
                win_status[w] = 0;
            } else {
                // host fallback: full window_consensus from the inputs
                const int32_t count = static_cast<int32_t>(ws.seqs.size());
                seqs.clear();
                quals.clear();
                lens.clear();
                for (int32_t i = 0; i < count; ++i) {
                    seqs.push_back(ws.seqs[i].data());
                    lens.push_back(static_cast<int32_t>(ws.seqs[i].size()));
                    quals.push_back(ws.quals[i].empty()
                                        ? nullptr
                                        : ws.quals[i].data());
                }
                results[w] = racon_host::window_consensus(
                    seqs.data(), lens.data(), quals.data(),
                    ws.begins.data(), ws.ends.data(), count, s->match,
                    s->mismatch, s->gap, coverages[w], nullptr);
                win_status[w] = 1;
            }
        }
    };
    int32_t nt = n_threads > 0 ? n_threads : 1;
    if (nt > n_windows) {
        nt = static_cast<int32_t>(n_windows > 0 ? n_windows : 1);
    }
    if (nt == 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nt);
        for (int32_t i = 0; i < nt; ++i) {
            pool.emplace_back(worker);
        }
        for (auto& th : pool) {
            th.join();
        }
    }

    int64_t total = 0;
    for (int64_t w = 0; w < n_windows; ++w) {
        total += static_cast<int64_t>(results[w].size());
    }
    if (total > cons_cap) {
        return -total;
    }
    int64_t at = 0;
    for (int64_t w = 0; w < n_windows; ++w) {
        cons_off[w] = at;
        std::memcpy(cons_data + at, results[w].data(), results[w].size());
        std::memcpy(cov_data + at, coverages[w].data(),
                    coverages[w].size() * sizeof(uint32_t));
        at += static_cast<int64_t>(results[w].size());
    }
    cons_off[n_windows] = at;
    return total;
}

void rh_poa_session_free(int64_t handle) {
    std::lock_guard<std::mutex> lock(racon_host::g_mutex);
    racon_host::g_sessions.erase(handle);
}

// Consensus from the fused device engine's fetched graph arrays
// (racon_tpu/ops/poa_fused.py): rebuild each window's Graph — nodes with
// codes and sequence counts, edges from the predecessor slots in slot
// order (the DP tie-break order), aligned lists from column membership —
// then run the exact host heaviest-bundle consensus. Output layout
// identical to rh_poa_batch; returns total bytes or -needed.
int64_t rh_poa_finish_arrays(
    const int8_t* codes, const int16_t* preds, const int32_t* predw,
    const int32_t* nseq, const int16_t* col_of,
    const int32_t* n_nodes, int64_t n_windows, int32_t N, int32_t P,
    int32_t n_threads,
    uint8_t* cons_data, uint32_t* cov_data, int64_t cons_cap,
    int64_t* cons_off) {
    std::vector<std::vector<uint8_t>> results(n_windows);
    std::vector<std::vector<uint32_t>> coverages(n_windows);

    std::atomic<int64_t> next_w(0);
    auto worker = [&]() {
        while (true) {
            const int64_t w = next_w.fetch_add(1);
            if (w >= n_windows) {
                return;
            }
            const int32_t n = n_nodes[w];
            const int8_t* wc = codes + w * N;
            const int16_t* wp = preds + static_cast<int64_t>(w) * N * P;
            const int32_t* ww = predw + static_cast<int64_t>(w) * N * P;
            const int32_t* wn = nseq + w * N;
            const int16_t* wcol = col_of + w * N;

            Graph g;
            g.nodes.resize(n);
            std::unordered_map<int32_t, std::vector<int32_t>> columns;
            for (int32_t v = 0; v < n; ++v) {
                racon_host::Node& node = g.nodes[v];
                node.code = static_cast<uint8_t>(wc[v]);
                node.bpos = 0;
                node.n_seqs = wn[v];
                columns[wcol[v]].push_back(v);
            }
            for (int32_t v = 0; v < n; ++v) {
                for (int32_t s = 0; s < P; ++s) {
                    const int32_t t = wp[static_cast<int64_t>(v) * P + s];
                    if (t < 0) {
                        continue;
                    }
                    const int32_t ei = static_cast<int32_t>(g.edges.size());
                    g.edges.push_back(racon_host::Edge{
                        t, v, ww[static_cast<int64_t>(v) * P + s]});
                    g.nodes[v].in.push_back(ei);
                    g.nodes[t].out.push_back(ei);
                }
            }
            for (const auto& kv : columns) {
                for (int32_t a : kv.second) {
                    for (int32_t b : kv.second) {
                        if (a != b) {
                            g.nodes[a].aligned.push_back(b);
                        }
                    }
                }
            }
            results[w] = g.consensus(coverages[w]);
        }
    };
    int32_t nt = n_threads > 1 ? n_threads : 1;
    if (nt > n_windows) {
        nt = static_cast<int32_t>(n_windows > 0 ? n_windows : 1);
    }
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nt);
        for (int32_t i = 0; i < nt; ++i) {
            pool.emplace_back(worker);
        }
        for (auto& th : pool) {
            th.join();
        }
    }

    int64_t total = 0;
    for (int64_t w = 0; w < n_windows; ++w) {
        total += static_cast<int64_t>(results[w].size());
    }
    if (total > cons_cap) {
        return -total;
    }
    int64_t at = 0;
    for (int64_t w = 0; w < n_windows; ++w) {
        cons_off[w] = at;
        std::memcpy(cons_data + at, results[w].data(), results[w].size());
        std::memcpy(cov_data + at, coverages[w].data(),
                    coverages[w].size() * sizeof(uint32_t));
        at += static_cast<int64_t>(results[w].size());
    }
    cons_off[n_windows] = at;
    return total;
}

}  // extern "C"
