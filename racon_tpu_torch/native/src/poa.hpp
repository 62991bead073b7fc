// Partial-order-alignment engine (host CPU).
//
// A from-scratch C++ implementation of the POA capabilities racon uses from
// the vendored spoa library (reference call sites: src/window.cpp:65-142,
// src/polisher.cpp:181-185): graph construction via add_alignment, global
// (NW) alignment of a sequence against the graph with linear gap scoring,
// subgraph extraction over a backbone position range, and heaviest-bundle
// consensus with per-base column coverages.
//
// The graph is a DAG. Nodes carry a base code; edges carry accumulated
// weights (sum of the Phred weights of their endpoint bases across all
// traversals). Nodes aligned to the same column but with different bases are
// linked through `aligned` lists. Each node remembers an approximate backbone
// position (`bpos`) — the backbone column it was aligned to or inserted
// after — which makes subgraph extraction a simple range filter instead of a
// graph traversal.
//
// Determinism: all tie-breaking rules are fixed (documented inline), so the
// same inputs produce byte-identical consensus on every run — the property
// the reference's golden CI diff demands (ci/gpu/cuda_test.sh:30-44).

#pragma once

#include <cstdint>
#include <unordered_map>
#include <vector>

namespace racon_host {

// base codes: A=0 C=1 G=2 T=3 other=4 (matches racon_tpu/ops/encode.py)
extern const uint8_t kBaseCode[256];
extern const char kCodeBase[6];

struct Edge {
    int32_t tail;
    int32_t head;
    int64_t weight;
};

struct Node {
    uint8_t code;
    int32_t bpos;     // approximate backbone column
    int32_t n_seqs;   // number of sequences whose path includes this node
    std::vector<int32_t> in;       // edge indices (tail -> this)
    std::vector<int32_t> out;      // edge indices (this -> head)
    std::vector<int32_t> aligned;  // node ids in the same column
};

// one aligned pair: (node_id, seq_pos); -1 on either side means gap
struct AlnPair {
    int32_t node;
    int32_t pos;
};
using Alignment = std::vector<AlnPair>;

class Graph {
public:
    std::vector<Node> nodes;
    std::vector<Edge> edges;

    bool empty() const { return nodes.empty(); }

    // Add `seq` (raw ASCII, uppercased) along `aln`. Empty alignment appends
    // the sequence as a fresh path. `weights[i]` is the per-base weight
    // (Phred quality - 33, or 1 when no quality). When the graph is empty the
    // sequence is the backbone and node bpos = base position; otherwise new
    // nodes inherit the bpos of their column / predecessor.
    //
    // `anchored`: the alignment's node ids refer to BACKBONE positions only
    // (the batched device prealign path, which cannot see nodes other layers
    // created). Insertions are then merged across layers by their anchor
    // (backbone column, offset within the insertion run, base code) so that
    // repeated insertions accumulate edge weight exactly as they would had
    // each layer been aligned against the evolving graph — without this,
    // backbone deletions could never win the heaviest-bundle consensus.
    void add_alignment(const Alignment& aln, const uint8_t* seq, int32_t len,
                       const uint32_t* weights, bool anchored = false);

    // Topological order of node ids (deterministic: Kahn's algorithm, FIFO
    // seeded in id order).
    std::vector<int32_t> topo_order() const;

    // Global (NW) alignment of seq against the whole graph with linear gap
    // scoring; maximizes score; alignment ends in a sink node column.
    // Tie order on traceback: diagonal > vertical (graph gap) > horizontal.
    //
    // band > 0 restricts each node row's DP to sequence columns within
    // band/2 of the node's expected diagonal (bpos - bpos_origin), the
    // static-band idea of cudapoa (src/cuda/cudabatch.cpp:56-59 band 256);
    // cells outside score -inf. band 0 = exact full DP. Callers pass
    // band 0 whenever |len - graph span| approaches band/2 (the band
    // cannot contain the path then).
    Alignment align_nw(const uint8_t* seq, int32_t len, int32_t match,
                       int32_t mismatch, int32_t gap, int32_t band = 0,
                       int32_t bpos_origin = 0) const;

    // Subgraph induced by nodes with begin <= bpos <= end (backbone column
    // range, inclusive — reference window.cpp:97-102 contract). `mapping`
    // gives sub node id -> full graph node id.
    Graph subgraph(int32_t begin, int32_t end,
                   std::vector<int32_t>& mapping) const;

    // Rewrite a subgraph alignment's node ids into full-graph ids.
    static void update_alignment(Alignment& aln,
                                 const std::vector<int32_t>& mapping);

    // Heaviest-bundle consensus. Returns base codes; `coverages[i]` = number
    // of sequences whose path passes through the consensus node's column
    // (node + aligned nodes) — used by the TGS trim (window.cpp:118-139).
    std::vector<uint8_t> consensus(std::vector<uint32_t>& coverages) const;

private:
    int32_t add_node(uint8_t code, int32_t bpos);
    void add_edge(int32_t tail, int32_t head, int64_t weight);

    // anchored-insertion registry: (bpos, offset, code) -> node id and
    // (bpos, offset) -> column members, used only by anchored additions
    std::unordered_map<int64_t, int32_t> ins_node_;
    std::unordered_map<int64_t, std::vector<int32_t>> ins_col_;
};

// Full per-window consensus: backbone + layers, mirroring the orchestration
// of reference window.cpp:65-142 (sort layers by begin, full-graph align for
// window-spanning layers, subgraph align otherwise). Caller guarantees
// n_seqs >= 3. Returns consensus ASCII bytes.
//
// seqs[i]/lens[i]: raw ASCII sequences, i = 0 is the backbone.
// quals[i]: Phred+33 bytes or nullptr.
// begins/ends[i]: layer positions on the backbone (inclusive end).
std::vector<uint8_t> window_consensus(
    const uint8_t* const* seqs, const int32_t* lens,
    const uint8_t* const* quals, const int32_t* begins, const int32_t* ends,
    int32_t n_seqs, int32_t match, int32_t mismatch, int32_t gap,
    std::vector<uint32_t>& coverages,
    const Alignment* prealigned /* nullable: per-layer backbone alignments */);

}  // namespace racon_host
