#include "poa.hpp"

#include <algorithm>
#include <cassert>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <limits>

namespace racon_host {

static uint8_t make_code(int c) {
    switch (c) {
        case 'A': return 0;
        case 'C': return 1;
        case 'G': return 2;
        case 'T': return 3;
        default: return 4;
    }
}

const uint8_t kBaseCode[256] = {
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,4,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
};
const char kCodeBase[6] = {'A', 'C', 'G', 'T', 'N', '-'};

int32_t Graph::add_node(uint8_t code, int32_t bpos) {
    nodes.push_back(Node{code, bpos, 0, {}, {}, {}});
    return static_cast<int32_t>(nodes.size()) - 1;
}

void Graph::add_edge(int32_t tail, int32_t head, int64_t weight) {
    // merge with an existing parallel edge (in-degrees are small)
    for (int32_t ei : nodes[head].in) {
        if (edges[ei].tail == tail) {
            edges[ei].weight += weight;
            return;
        }
    }
    int32_t ei = static_cast<int32_t>(edges.size());
    edges.push_back(Edge{tail, head, weight});
    nodes[tail].out.push_back(ei);
    nodes[head].in.push_back(ei);
}

void Graph::add_alignment(const Alignment& aln, const uint8_t* seq,
                          int32_t len, const uint32_t* weights,
                          bool anchored) {
    if (len <= 0) {
        return;
    }
    const bool backbone = nodes.empty();

    // Build the per-position node path, then connect consecutive path nodes
    // with edges weighted w[i-1] + w[i] (the endpoint-weight-sum convention
    // the reference GPU adapter mirrors with Phred int8 weights,
    // src/cuda/cudabatch.cpp:182-191).
    std::vector<int32_t> path(len, -1);

    int32_t first = -1, last = -1;
    for (const auto& p : aln) {
        if (p.pos >= 0) {
            if (first < 0) first = p.pos;
            last = p.pos;
        }
    }

    if (first < 0) {
        // no aligned bases: whole sequence becomes a fresh path
        for (int32_t i = 0; i < len; ++i) {
            path[i] = add_node(kBaseCode[seq[i]], backbone ? i : 0);
        }
    } else {
        // aligned middle
        int32_t col_bpos = 0;  // bpos of the last visited column
        bool col_seen = false;
        int32_t ins_offset = 0;  // consecutive insertions since last column
        for (const auto& p : aln) {
            if (p.pos < 0) {
                continue;
            }
            const uint8_t code = kBaseCode[seq[p.pos]];
            int32_t cur;
            if (p.node < 0) {
                if (anchored) {
                    // merge with identical insertions from earlier layers:
                    // key = (anchor column, run offset, base code)
                    const int64_t col_key =
                        ((static_cast<int64_t>(col_seen ? col_bpos : -1)
                          << 20) |
                         static_cast<int64_t>(ins_offset));
                    const int64_t key = (col_key << 8) | code;
                    auto it = ins_node_.find(key);
                    if (it != ins_node_.end()) {
                        cur = it->second;
                    } else {
                        cur = add_node(code, col_seen ? col_bpos : -1);
                        ins_node_.emplace(key, cur);
                        // register same-anchor different-code nodes as one
                        // column so coverage counting sees them together
                        std::vector<int32_t>& col = ins_col_[col_key];
                        for (int32_t a : col) {
                            nodes[a].aligned.push_back(cur);
                            nodes[cur].aligned.push_back(a);
                        }
                        col.push_back(cur);
                    }
                    ++ins_offset;
                } else {
                    // insertion relative to the graph
                    cur = add_node(code, col_seen ? col_bpos : -1);
                }
            } else {
                ins_offset = 0;
                Node& q = nodes[p.node];
                col_bpos = q.bpos;
                col_seen = true;
                if (q.code == code) {
                    cur = p.node;
                } else {
                    cur = -1;
                    for (int32_t a : q.aligned) {
                        if (nodes[a].code == code) {
                            cur = a;
                            break;
                        }
                    }
                    if (cur < 0) {
                        cur = add_node(code, q.bpos);
                        // register in the column: cur <-> node and all its
                        // aligned alternates
                        std::vector<int32_t> column = nodes[p.node].aligned;
                        column.push_back(p.node);
                        for (int32_t a : column) {
                            nodes[a].aligned.push_back(cur);
                            nodes[cur].aligned.push_back(a);
                        }
                    }
                }
            }
            path[p.pos] = cur;
        }
        // backfill bpos for leading insertions that preceded any column
        if (col_seen) {
            int32_t fill = -1;
            for (int32_t i = last; i >= first; --i) {
                if (path[i] >= 0 && nodes[path[i]].bpos >= 0) {
                    fill = nodes[path[i]].bpos;
                } else if (path[i] >= 0 && nodes[path[i]].bpos < 0) {
                    nodes[path[i]].bpos = fill;
                }
            }
        }
        // unaligned prefix / suffix become fresh chains inheriting the bpos
        // of the nearest aligned column
        int32_t pre_bpos = path[first] >= 0 ? nodes[path[first]].bpos : 0;
        for (int32_t i = 0; i < first; ++i) {
            path[i] = add_node(kBaseCode[seq[i]], pre_bpos);
        }
        int32_t suf_bpos = path[last] >= 0 ? nodes[path[last]].bpos : 0;
        for (int32_t i = last + 1; i < len; ++i) {
            path[i] = add_node(kBaseCode[seq[i]], suf_bpos);
        }
    }

    for (int32_t i = 0; i < len; ++i) {
        nodes[path[i]].n_seqs += 1;
    }
    for (int32_t i = 1; i < len; ++i) {
        const int64_t w = static_cast<int64_t>(weights[i - 1]) + weights[i];
        add_edge(path[i - 1], path[i], w);
    }
}

std::vector<int32_t> Graph::topo_order() const {
    const int32_t n = static_cast<int32_t>(nodes.size());
    std::vector<int32_t> indeg(n);
    for (int32_t i = 0; i < n; ++i) {
        indeg[i] = static_cast<int32_t>(nodes[i].in.size());
    }
    std::deque<int32_t> q;
    for (int32_t i = 0; i < n; ++i) {
        if (indeg[i] == 0) q.push_back(i);
    }
    std::vector<int32_t> order;
    order.reserve(n);
    while (!q.empty()) {
        int32_t v = q.front();
        q.pop_front();
        order.push_back(v);
        for (int32_t ei : nodes[v].out) {
            int32_t h = edges[ei].head;
            if (--indeg[h] == 0) q.push_back(h);
        }
    }
    assert(static_cast<int32_t>(order.size()) == n && "graph has a cycle");
    return order;
}

static constexpr int32_t kNegInf = std::numeric_limits<int32_t>::min() / 4;

// DP + traceback body, templated on the score cell type: int16_t halves
// the memory traffic and doubles the SIMD lane count of the hot loops when
// the score bounds allow it (checked by align_nw); int32_t otherwise. The
// clamp to neg_inf in the fold loops stops unreachable-cell drift from
// wrapping the narrow type; reachable scores and the traceback are
// bit-identical between the two instantiations.
template <typename S>
static Alignment align_nw_impl(const Graph& g, const uint8_t* seq,
                               int32_t len, int32_t match, int32_t mismatch,
                               int32_t gap, int32_t band,
                               int32_t bpos_origin, S neg_inf) {
    Alignment out;
    const std::vector<Node>& nodes = g.nodes;
    const std::vector<Edge>& edges = g.edges;
    const int32_t n = static_cast<int32_t>(nodes.size());

    const std::vector<int32_t> order = g.topo_order();
    std::vector<int32_t> rank_of(n);
    for (int32_t r = 0; r < n; ++r) {
        rank_of[order[r]] = r;
    }

    // H is (n + 1) x (len + 1); row 0 is the virtual source.
    const int64_t stride = len + 1;
    std::vector<S> H(static_cast<size_t>(n + 1) * stride);
    for (int32_t j = 0; j <= len; ++j) {
        H[j] = static_cast<S>(j * gap);
    }

    // per-code substitution profiles hoisted out of the DP loops (the
    // striped-profile idea SIMD POA engines use): profile[c][j] is the
    // diagonal score delta for aligning seq[j-1] to a code-c node, so the
    // inner loops below are branchless and auto-vectorize.
    std::vector<S> profile(static_cast<size_t>(5) * stride);
    for (int32_t c = 0; c < 5; ++c) {
        S* p = &profile[static_cast<size_t>(c) * stride];
        for (int32_t j = 1; j <= len; ++j) {
            p[j] = static_cast<S>((kBaseCode[seq[j - 1]] == c) ? match
                                                               : mismatch);
        }
    }
    const S sgap = static_cast<S>(gap);

    std::vector<int32_t> pred_rows;  // predecessor row indices, reused
    for (int32_t r = 1; r <= n; ++r) {
        const Node& node = nodes[order[r - 1]];
        S* row = &H[static_cast<size_t>(r) * stride];
        const S* prof = &profile[static_cast<size_t>(node.code) * stride];

        // banded: compute only columns near the node's expected diagonal;
        // everything else scores -inf (cheap vector fill vs DP compute)
        int32_t jlo = 1, jhi = len;
        if (band > 0) {
            const int32_t center = node.bpos - bpos_origin + 1;
            jlo = std::max<int32_t>(1, center - band / 2);
            jhi = std::min<int32_t>(len, center + band / 2);
            std::fill(row, row + stride, neg_inf);
        }

        pred_rows.clear();
        for (int32_t ei : node.in) {
            pred_rows.push_back(rank_of[edges[ei].tail] + 1);
        }
        if (pred_rows.empty()) {
            pred_rows.push_back(0);
        }

        // initialize from the first predecessor, then fold the rest in
        {
            const S* prow = &H[static_cast<size_t>(pred_rows[0]) * stride];
            row[0] = static_cast<S>(prow[0] + sgap);
            for (int32_t j = jlo; j <= jhi; ++j) {
                const S diag = static_cast<S>(prow[j - 1] + prof[j]);
                const S vert = static_cast<S>(prow[j] + sgap);
                const S best = diag > vert ? diag : vert;
                row[j] = best > neg_inf ? best : neg_inf;
            }
        }
        for (size_t pi = 1; pi < pred_rows.size(); ++pi) {
            const S* prow = &H[static_cast<size_t>(pred_rows[pi]) * stride];
            if (static_cast<S>(prow[0] + sgap) > row[0]) {
                row[0] = static_cast<S>(prow[0] + sgap);
            }
            for (int32_t j = jlo; j <= jhi; ++j) {
                const S diag = static_cast<S>(prow[j - 1] + prof[j]);
                const S vert = static_cast<S>(prow[j] + sgap);
                const S best = diag > vert ? diag : vert;
                if (best > row[j]) row[j] = best;
            }
        }
        // horizontal pass (sequence gap) — must run after all predecessors
        for (int32_t j = jlo; j <= jhi; ++j) {
            const S horiz = static_cast<S>(row[j - 1] + sgap);
            if (horiz > row[j]) row[j] = horiz;
        }
    }

    // best sink row at the final column (ties -> smallest rank)
    int32_t best_r = -1;
    S best_score = neg_inf;
    for (int32_t r = 1; r <= n; ++r) {
        if (!nodes[order[r - 1]].out.empty()) continue;
        const S s = H[static_cast<size_t>(r) * stride + len];
        if (s > best_score) {
            best_score = s;
            best_r = r;
        }
    }
    if (best_r < 0) {  // no sink (can't happen in a DAG with nodes)
        return out;
    }

    // traceback; preference: diagonal, vertical, horizontal (deterministic)
    int32_t r = best_r, j = len;
    while (r != 0 || j != 0) {
        const S cur = H[static_cast<size_t>(r) * stride + j];
        bool moved = false;
        if (r != 0) {
            const Node& node = nodes[order[r - 1]];
            pred_rows.clear();
            for (int32_t ei : node.in) {
                pred_rows.push_back(rank_of[edges[ei].tail] + 1);
            }
            if (pred_rows.empty()) {
                pred_rows.push_back(0);
            }
            if (j > 0) {
                const S sub = static_cast<S>(
                    (kBaseCode[seq[j - 1]] == node.code) ? match : mismatch);
                for (int32_t pr : pred_rows) {
                    if (static_cast<S>(
                            H[static_cast<size_t>(pr) * stride + j - 1] +
                            sub) == cur) {
                        out.push_back(AlnPair{order[r - 1], j - 1});
                        r = pr;
                        --j;
                        moved = true;
                        break;
                    }
                }
            }
            // RACON_TPU_TIEBREAK=dhv flips the equal-score indel
            // preference to horizontal-before-vertical (quality-gap
            // attribution experiment, PARITY.md); default dvh is the
            // order the device kernels replicate bit-for-bit
            static const bool kHorizFirst = [] {
                const char* e = std::getenv("RACON_TPU_TIEBREAK");
                return e != nullptr && std::strcmp(e, "dhv") == 0;
            }();
            if (!moved && kHorizFirst && j > 0 &&
                static_cast<S>(H[static_cast<size_t>(r) * stride + j - 1] +
                               sgap) == cur) {
                out.push_back(AlnPair{-1, j - 1});
                --j;
                moved = true;
            }
            if (!moved) {
                for (int32_t pr : pred_rows) {
                    if (static_cast<S>(
                            H[static_cast<size_t>(pr) * stride + j] +
                            sgap) == cur) {
                        out.push_back(AlnPair{order[r - 1], -1});
                        r = pr;
                        moved = true;
                        break;
                    }
                }
            }
        }
        if (!moved) {
            // horizontal (consume sequence base against no node)
            out.push_back(AlnPair{-1, j - 1});
            --j;
        }
    }
    std::reverse(out.begin(), out.end());
    return out;
}


Alignment Graph::align_nw(const uint8_t* seq, int32_t len, int32_t match,
                          int32_t mismatch, int32_t gap, int32_t band,
                          int32_t bpos_origin) const {
    const int32_t n = static_cast<int32_t>(nodes.size());
    if (n == 0 || len <= 0) {
        return Alignment();
    }
    // int16 cells when every reachable score fits with margin: the worst
    // real path magnitude is (n + len + 2) * max|score|, which must stay
    // above the -28000 unreachable sentinel (itself clear of INT16_MIN
    // after the per-row clamp)
    const int32_t maxabs = std::max(std::abs(match),
                                    std::max(std::abs(mismatch),
                                             std::abs(gap)));
    const int64_t bound =
        static_cast<int64_t>(n + len + 2) * std::max(maxabs, 1);
    if (bound < 27000) {
        return align_nw_impl<int16_t>(*this, seq, len, match, mismatch, gap,
                                      band, bpos_origin,
                                      static_cast<int16_t>(-28000));
    }
    return align_nw_impl<int32_t>(*this, seq, len, match, mismatch, gap,
                                  band, bpos_origin, kNegInf);
}

Graph Graph::subgraph(int32_t begin, int32_t end,
                      std::vector<int32_t>& mapping) const {
    const int32_t n = static_cast<int32_t>(nodes.size());
    std::vector<int32_t> full_to_sub(n, -1);
    mapping.clear();
    for (int32_t i = 0; i < n; ++i) {
        if (nodes[i].bpos >= begin && nodes[i].bpos <= end) {
            full_to_sub[i] = static_cast<int32_t>(mapping.size());
            mapping.push_back(i);
        }
    }

    Graph sub;
    sub.nodes.reserve(mapping.size());
    for (int32_t fi : mapping) {
        const Node& src = nodes[fi];
        Node dst;
        dst.code = src.code;
        dst.bpos = src.bpos;
        dst.n_seqs = src.n_seqs;
        for (int32_t a : src.aligned) {
            if (full_to_sub[a] >= 0) dst.aligned.push_back(full_to_sub[a]);
        }
        sub.nodes.push_back(std::move(dst));
    }
    for (const Edge& e : edges) {
        const int32_t t = full_to_sub[e.tail], h = full_to_sub[e.head];
        if (t >= 0 && h >= 0) {
            sub.add_edge(t, h, e.weight);
        }
    }
    return sub;
}

void Graph::update_alignment(Alignment& aln,
                             const std::vector<int32_t>& mapping) {
    for (auto& p : aln) {
        if (p.node >= 0) {
            p.node = mapping[p.node];
        }
    }
}

std::vector<uint8_t> Graph::consensus(std::vector<uint32_t>& coverages) const {
    coverages.clear();
    const int32_t n = static_cast<int32_t>(nodes.size());
    std::vector<uint8_t> out;
    if (n == 0) {
        return out;
    }

    const std::vector<int32_t> order = topo_order();
    std::vector<int64_t> score(n, 0);
    std::vector<int32_t> pred(n, -1);

    // heaviest bundle: per node pick the heaviest in-edge (ties -> the
    // predecessor with the larger accumulated score, later edge wins equal)
    int32_t max_node = order[0];
    for (int32_t v : order) {
        int64_t best_w = -1;
        int32_t best_p = -1;
        for (int32_t ei : nodes[v].in) {
            const Edge& e = edges[ei];
            if (e.weight > best_w ||
                (e.weight == best_w &&
                 (best_p < 0 || score[e.tail] >= score[best_p]))) {
                best_w = e.weight;
                best_p = e.tail;
            }
        }
        if (best_p >= 0) {
            score[v] = best_w + score[best_p];
            pred[v] = best_p;
        }
        if (score[v] > score[max_node]) {
            max_node = v;
        }
    }

    // extend to a sink so the consensus spans the full graph. Two modes:
    //   greedy (default): follow the heaviest out-edge step by step;
    //   branch (RACON_TPU_CONSENSUS_EXT=branch): spoa-style branch
    //     completion — re-run the accumulated-score pass on the subgraph
    //     beyond the current bundle end, restricted to paths leaving it,
    //     jump to the new best-scoring node, iterate. Measured on the
    //     reference fixtures for the quality-gap attribution (PARITY.md).
    static const bool kBranchExt = [] {
        const char* e = std::getenv("RACON_TPU_CONSENSUS_EXT");
        return e != nullptr && std::strcmp(e, "branch") == 0;
    }();
    int32_t tip = max_node;
    if (kBranchExt) {
        std::vector<int32_t> rank_of(n);
        for (int32_t r = 0; r < n; ++r) {
            rank_of[order[r]] = r;
        }
        while (!nodes[tip].out.empty()) {
            // restrict the re-scan to paths THROUGH the bundle end: every
            // node ranked at or before `tip` except `tip` itself becomes
            // unreachable, so deep nodes cannot attach to tails that
            // bypass the bundle
            for (int32_t r = 0; r <= rank_of[tip]; ++r) {
                if (order[r] != tip) {
                    score[order[r]] = -1;
                }
            }
            score[tip] = std::max<int64_t>(score[tip], 0);
            int64_t ext_best = -1;
            int32_t ext_node = -1;
            for (int32_t r = rank_of[tip] + 1; r < n; ++r) {
                const int32_t v = order[r];
                score[v] = -1;
                pred[v] = -1;
                int64_t best_w = -1;
                int32_t best_p = -1;
                for (int32_t ei : nodes[v].in) {
                    const Edge& e = edges[ei];
                    if (score[e.tail] < 0) {
                        continue;  // unreachable from the bundle end
                    }
                    if (e.weight > best_w ||
                        (e.weight == best_w &&
                         (best_p < 0 || score[e.tail] >= score[best_p]))) {
                        best_w = e.weight;
                        best_p = e.tail;
                    }
                }
                if (best_p >= 0) {
                    score[v] = best_w + score[best_p];
                    pred[v] = best_p;
                    if (score[v] > ext_best) {
                        ext_best = score[v];
                        ext_node = v;
                    }
                }
            }
            if (ext_node < 0) {
                break;  // no path forward (tip is effectively a sink)
            }
            tip = ext_node;
        }
    } else {
        while (!nodes[tip].out.empty()) {
            int64_t best_w = -1;
            int32_t best_h = -1;
            for (int32_t ei : nodes[tip].out) {
                const Edge& e = edges[ei];
                if (e.weight > best_w ||
                    (e.weight == best_w &&
                     (best_h < 0 || score[e.head] >= score[best_h]))) {
                    best_w = e.weight;
                    best_h = e.head;
                }
            }
            pred[best_h] = tip;
            tip = best_h;
        }
    }

    std::vector<int32_t> path;
    for (int32_t v = tip; v >= 0; v = pred[v]) {
        path.push_back(v);
    }
    std::reverse(path.begin(), path.end());

    out.reserve(path.size());
    coverages.reserve(path.size());
    for (int32_t v : path) {
        out.push_back(static_cast<uint8_t>(kCodeBase[nodes[v].code]));
        uint32_t cov = static_cast<uint32_t>(nodes[v].n_seqs);
        for (int32_t a : nodes[v].aligned) {
            cov += static_cast<uint32_t>(nodes[a].n_seqs);
        }
        coverages.push_back(cov);
    }
    return out;
}

std::vector<uint8_t> window_consensus(
    const uint8_t* const* seqs, const int32_t* lens,
    const uint8_t* const* quals, const int32_t* begins, const int32_t* ends,
    int32_t n_seqs, int32_t match, int32_t mismatch, int32_t gap,
    std::vector<uint32_t>& coverages, const Alignment* prealigned) {
    Graph graph;

    std::vector<uint32_t> weights;
    auto weights_of = [&](int32_t i) -> const uint32_t* {
        weights.assign(lens[i], 1);
        if (quals[i] != nullptr) {
            for (int32_t j = 0; j < lens[i]; ++j) {
                weights[j] = quals[i][j] >= 33 ? quals[i][j] - 33 : 0;
            }
        }
        return weights.data();
    };

    // backbone
    graph.add_alignment(Alignment(), seqs[0], lens[0], weights_of(0));

    // layers sorted by begin position, stable (reference window.cpp:84-85)
    std::vector<int32_t> rank;
    rank.reserve(n_seqs - 1);
    for (int32_t i = 1; i < n_seqs; ++i) {
        rank.push_back(i);
    }
    std::stable_sort(rank.begin(), rank.end(), [&](int32_t a, int32_t b) {
        return begins[a] < begins[b];
    });

    const int32_t backbone_len = lens[0];
    const int32_t offset = static_cast<int32_t>(0.01 * backbone_len);
    const bool anchored = prealigned != nullptr;
    // static band (the cudapoa band-256 contract, cudabatch.cpp:56-59);
    // a layer whose length diverges from its graph span by close to the
    // half-band cannot fit the band and gets the exact full DP instead.
    // RACON_TPU_HOST_BAND overrides the width (0 = exact full DP always,
    // the reference spoa behavior) — the accuracy/speed knob behind the
    // banding attribution measured in PARITY.md.
    static const int32_t kBand = [] {
        const char* e = std::getenv("RACON_TPU_HOST_BAND");
        return e != nullptr ? std::atoi(e) : 256;
    }();
    // banded-result sanity: if fewer than half the aligned columns match,
    // the in-band path is mismatch soup from band clipping (e.g. balanced
    // indels with small net length change) — redo with the exact full DP,
    // the same accept/reject discipline the device aligner applies
    auto band_clipped = [&](const Alignment& aln, const uint8_t* s,
                            const Graph& g) -> bool {
        int32_t aligned = 0, matched = 0;
        for (const auto& p : aln) {
            if (p.node >= 0 && p.pos >= 0) {
                ++aligned;
                matched += g.nodes[p.node].code == kBaseCode[s[p.pos]];
            }
        }
        return aligned == 0 || 2 * matched < aligned;
    };
    for (int32_t i : rank) {
        Alignment aln;
        if (anchored) {
            aln = prealigned[i];
        } else if (begins[i] < offset && ends[i] > backbone_len - offset) {
            const bool fits = std::abs(lens[i] - backbone_len) < kBand / 2 - 16;
            aln = graph.align_nw(seqs[i], lens[i], match, mismatch, gap,
                                 fits ? kBand : 0, 0);
            if (fits && band_clipped(aln, seqs[i], graph)) {
                aln = graph.align_nw(seqs[i], lens[i], match, mismatch, gap);
            }
        } else {
            const int32_t span = ends[i] - begins[i] + 1;
            const bool fits = std::abs(lens[i] - span) < kBand / 2 - 16;
            std::vector<int32_t> mapping;
            Graph sub = graph.subgraph(begins[i], ends[i], mapping);
            aln = sub.align_nw(seqs[i], lens[i], match, mismatch, gap,
                               fits ? kBand : 0, begins[i]);
            if (fits && band_clipped(aln, seqs[i], sub)) {
                aln = sub.align_nw(seqs[i], lens[i], match, mismatch, gap);
            }
            Graph::update_alignment(aln, mapping);
        }
        graph.add_alignment(aln, seqs[i], lens[i], weights_of(i), anchored);
    }

    return graph.consensus(coverages);
}

}  // namespace racon_host
