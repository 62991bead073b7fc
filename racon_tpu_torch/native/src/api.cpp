// C API for the host library (loaded from Python via ctypes —
// no pybind11 dependency, plain C symbols only).
//
// Provides the native-equivalents the reference gets from vendored C++
// libraries (SURVEY.md §2b): spoa -> rh_poa_batch (threaded batched POA),
// edlib -> rh_nw_cigar / rh_edit_distance, thread_pool -> the worker pool
// inside rh_poa_batch.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "poa.hpp"

namespace racon_host {
int64_t myers_nw(const uint8_t* q, int64_t m, const uint8_t* t, int64_t n,
                 std::vector<char>* cigar);
}  // namespace racon_host

using racon_host::Alignment;
using racon_host::AlnPair;

extern "C" {

int64_t rh_edit_distance(const uint8_t* a, int64_t m, const uint8_t* b,
                         int64_t n) {
    return racon_host::myers_nw(a, m, b, n, nullptr);
}

// Globally align query q against target t (unit costs). Writes the CIGAR
// into `out` (capacity `cap`); returns the CIGAR length, or -needed when the
// buffer is too small, or -1 on failure.
int64_t rh_nw_cigar(const uint8_t* q, int64_t m, const uint8_t* t, int64_t n,
                    char* out, int64_t cap) {
    std::vector<char> cigar;
    const int64_t d = racon_host::myers_nw(q, m, t, n, &cigar);
    if (d < 0) {
        return -1;
    }
    const int64_t len = static_cast<int64_t>(cigar.size());
    if (len > cap) {
        return -len;
    }
    std::memcpy(out, cigar.data(), len);
    return len;
}

// Batched per-window POA consensus (the spoa role in reference
// src/polisher.cpp:491-504, batched like the GPU path cudapolisher.cpp:228-345).
//
// Layout: all sequences of all windows are concatenated; `seq_off` has
// total_seqs + 1 entries; window w owns sequences [win_off[w], win_off[w+1]),
// the first being the backbone. `qual_off[i] == qual_off[i+1]` means "no
// quality" for sequence i. Optional prealigned paths (device alignment
// results) come as flat (node, pos) pair arrays with per-sequence `aln_off`;
// pass aln_off == nullptr to let the host engine align layers itself.
//
// Outputs: consensus bytes concatenated into cons_data with per-window
// cons_off (n_windows + 1), per-base column coverages into cov_data
// (same offsets). Returns total consensus bytes, or -needed when cons_cap
// is too small.
int64_t rh_poa_batch(
    const uint8_t* seq_data, const int64_t* seq_off,
    const uint8_t* qual_data, const int64_t* qual_off,
    const int32_t* begins, const int32_t* ends,
    const int64_t* win_off, int64_t n_windows,
    const int32_t* aln_nodes, const int32_t* aln_pos, const int64_t* aln_off,
    int32_t match, int32_t mismatch, int32_t gap, int32_t n_threads,
    uint8_t* cons_data, uint32_t* cov_data, int64_t cons_cap,
    int64_t* cons_off) {
    std::vector<std::vector<uint8_t>> results(n_windows);
    std::vector<std::vector<uint32_t>> coverages(n_windows);

    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<const uint8_t*> seqs, quals;
        std::vector<int32_t> lens;
        std::vector<Alignment> prealigned;
        while (true) {
            const int64_t w = next.fetch_add(1);
            if (w >= n_windows) {
                return;
            }
            const int64_t s0 = win_off[w], s1 = win_off[w + 1];
            const int64_t count = s1 - s0;
            seqs.clear();
            quals.clear();
            lens.clear();
            for (int64_t s = s0; s < s1; ++s) {
                seqs.push_back(seq_data + seq_off[s]);
                lens.push_back(static_cast<int32_t>(seq_off[s + 1] - seq_off[s]));
                quals.push_back(qual_off[s + 1] > qual_off[s]
                                    ? qual_data + qual_off[s]
                                    : nullptr);
            }
            if (count < 3) {
                // backbone fallback (reference window.cpp:68-71); caller
                // normally filters these out
                results[w].assign(seqs[0], seqs[0] + lens[0]);
                coverages[w].assign(lens[0], 0);
                continue;
            }
            const Alignment* pre = nullptr;
            if (aln_off != nullptr) {
                prealigned.assign(count, Alignment());
                for (int64_t s = s0 + 1; s < s1; ++s) {
                    Alignment& a = prealigned[s - s0];
                    for (int64_t k = aln_off[s]; k < aln_off[s + 1]; ++k) {
                        a.push_back(AlnPair{aln_nodes[k], aln_pos[k]});
                    }
                }
                pre = prealigned.data();
            }
            results[w] = racon_host::window_consensus(
                seqs.data(), lens.data(), quals.data(), begins + s0,
                ends + s0, static_cast<int32_t>(count), match, mismatch, gap,
                coverages[w], pre);
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

// Threaded batch variant of rh_nw_cigar: aligns pairs[i] = (q, t) given by
// flat data + offsets, writing CIGARs into per-pair slots of `out`
// (stride `slot`). out_lens[i] receives the CIGAR length, or -needed when
// the slot is too small (caller retries that pair with a bigger buffer).
// The host-parallel analogue of the reference's pooled edlib fan-out
// (src/polisher.cpp:462-470).
void rh_nw_cigar_batch(const uint8_t* q_data, const int64_t* q_off,
                       const uint8_t* t_data, const int64_t* t_off,
                       int64_t n_pairs, int32_t n_threads, char* out,
                       int64_t slot, int64_t* out_lens) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<char> cigar;
        while (true) {
            const int64_t i = next.fetch_add(1);
            if (i >= n_pairs) {
                return;
            }
            const int64_t m = q_off[i + 1] - q_off[i];
            const int64_t n = t_off[i + 1] - t_off[i];
            const int64_t d = racon_host::myers_nw(
                q_data + q_off[i], m, t_data + t_off[i], n, &cigar);
            if (d < 0) {
                out_lens[i] = -1;
                continue;
            }
            const int64_t len = static_cast<int64_t>(cigar.size());
            if (len > slot) {
                out_lens[i] = -len;
                continue;
            }
            std::memcpy(out + i * slot, cigar.data(), len);
            out_lens[i] = len;
        }
    };
    int32_t nt = n_threads > 0 ? n_threads : 1;
    if (nt > n_pairs) {
        nt = static_cast<int32_t>(n_pairs > 0 ? n_pairs : 1);
    }
    if (nt == 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int32_t i = 0; i < nt; ++i) {
            pool.emplace_back(worker);
        }
        for (auto& th : pool) {
            th.join();
        }
    }
}

int32_t rh_version() { return 2; }

}  // extern "C"
