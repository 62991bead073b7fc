// Myers bit-parallel global (NW) alignment: exact edit distance + CIGAR.
//
// The edlib role in the reference (src/overlap.cpp:205-224 uses edlib's
// banded Myers NW with CIGAR path; test/racon_test.cpp:16-25 uses it for
// edit-distance scoring). This is a from-scratch implementation of the
// Myers/Hyyrö block algorithm: the DP column is packed into 64-bit
// delta vectors (Pv/Mv), one column update costs ceil(m/64) word ops, and
// the traceback replays checkpointed columns so memory stays
// O(m/64 * (n/K + K)) instead of O(m*n).
//
// Deterministic tie order during traceback: diagonal, then up (I, consumes
// query), then left (D, consumes target).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace racon_host {

// Append "<len><op>" to dst.
void emit_cigar_run(std::vector<char>& dst, int64_t len, char op) {
    if (len <= 0) return;
    char buf[24];
    int k = 0;
    while (len > 0) {
        buf[k++] = static_cast<char>('0' + len % 10);
        len /= 10;
    }
    while (k > 0) dst.push_back(buf[--k]);
    dst.push_back(op);
}

namespace {

constexpr uint64_t kHigh = 1ull << 63;

struct BlockState {
    uint64_t Pv;     // bit r: D[r][j] - D[r-1][j] == +1
    uint64_t Mv;     // bit r: D[r][j] - D[r-1][j] == -1
    int32_t score;   // D at the block's bottom row
};

// One Hyyrö block update. hin is the horizontal delta entering the block's
// top row (-1/0/+1); returns the delta leaving the bottom row.
inline int block_step(uint64_t Eq, int hin, uint64_t& Pv, uint64_t& Mv) {
    const uint64_t Xv = Eq | Mv;
    if (hin < 0) {
        Eq |= 1ull;
    }
    const uint64_t Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
    uint64_t Ph = Mv | ~(Xh | Pv);
    uint64_t Mh = Pv & Xh;
    int hout = 0;
    if (Ph & kHigh) {
        hout = 1;
    } else if (Mh & kHigh) {
        hout = -1;
    }
    Ph <<= 1;
    Mh <<= 1;
    if (hin < 0) {
        Mh |= 1ull;
    } else if (hin > 0) {
        Ph |= 1ull;
    }
    Pv = Mh | ~(Xv | Ph);
    Mv = Ph & Xv;
    return hout;
}

// Score at pattern row `row` (1-based, <= 64*nb) given a column's blocks.
inline int32_t score_at_row(const BlockState* col, int64_t row, int64_t nb) {
    const int64_t b = (row - 1) / 64;
    int32_t s = col[b].score;
    // walk up from the block's bottom row to `row`
    for (int64_t r = 64 * (b + 1); r > row; --r) {
        const uint64_t bit = 1ull << ((r - 1) & 63);
        if (col[b].Pv & bit) {
            s -= 1;
        } else if (col[b].Mv & bit) {
            s += 1;
        }
    }
    return s;
}

}  // namespace

// Exact NW edit distance of q (length m) vs t (length n); when `cigar` is
// non-null the CIGAR path is appended (I consumes query, D consumes target).
int64_t myers_nw(const uint8_t* q, int64_t m, const uint8_t* t, int64_t n,
                 std::vector<char>* cigar) {
    if (cigar != nullptr) {
        cigar->clear();
    }
    if (m == 0 || n == 0) {
        if (cigar != nullptr) {
            if (m > 0) emit_cigar_run(*cigar, m, 'I');
            if (n > 0) emit_cigar_run(*cigar, n, 'D');
        }
        return m + n;
    }

    const int64_t nb = (m + 63) / 64;  // blocks per column

    // Exact-byte alphabet: each distinct byte of q gets a class; target
    // bytes absent from q match nothing (Eq = 0, class = n_classes slot of
    // zeros). Matches the scalar DP / edlib semantics of raw byte equality.
    int cls_of[256];
    std::fill(cls_of, cls_of + 256, -1);
    int n_classes = 0;
    for (int64_t i = 0; i < m; ++i) {
        if (cls_of[q[i]] < 0) {
            cls_of[q[i]] = n_classes++;
        }
    }
    std::vector<uint64_t> peq(static_cast<size_t>(n_classes + 1) * nb, 0);
    for (int64_t i = 0; i < m; ++i) {
        peq[static_cast<size_t>(cls_of[q[i]]) * nb + (i >> 6)] |=
            1ull << (i & 63);
    }
    auto code_of = [&](uint8_t c) -> int {
        const int k = cls_of[c];
        return k < 0 ? n_classes : k;  // n_classes row is all zeros
    };

    std::vector<BlockState> cur(nb);
    for (int64_t b = 0; b < nb; ++b) {
        cur[b].Pv = ~0ull;
        cur[b].Mv = 0;
        cur[b].score = static_cast<int32_t>(64 * (b + 1));
    }

    const int64_t kCheckpoint = 128;  // columns between stored snapshots
    std::vector<BlockState> snaps;    // column 0, K, 2K, ... (col 0 included)
    const bool want_path = cigar != nullptr;
    if (want_path) {
        snaps.reserve(static_cast<size_t>((n / kCheckpoint + 2) * nb));
        snaps.insert(snaps.end(), cur.begin(), cur.end());
    }

    for (int64_t j = 1; j <= n; ++j) {
        const int c = code_of(t[j - 1]);
        int hin = 1;  // D[0][j] - D[0][j-1] = +1
        for (int64_t b = 0; b < nb; ++b) {
            const uint64_t Eq = peq[static_cast<size_t>(c) * nb + b];
            const int hout = block_step(Eq, hin, cur[b].Pv, cur[b].Mv);
            cur[b].score += hout;
            hin = hout;
        }
        if (want_path && j % kCheckpoint == 0) {
            snaps.insert(snaps.end(), cur.begin(), cur.end());
        }
    }

    const int64_t dist = score_at_row(cur.data(), m, nb);
    if (!want_path) {
        return dist;
    }

    // -- traceback over replayed segments ---------------------------------
    // A segment holds kCheckpoint + 1 consecutive columns [seg_lo,
    // seg_lo + kCheckpoint] so that any (j-1, j) pair the traceback touches
    // fits in one loaded segment; consecutive segments overlap by a column.
    std::vector<BlockState> cols;
    int64_t seg_lo = -1, seg_hi = -1;

    auto load_segment = [&](int64_t lo) {
        seg_lo = lo;
        seg_hi = std::min(n, lo + kCheckpoint);
        cols.assign(static_cast<size_t>(seg_hi - seg_lo + 1) * nb,
                    BlockState{});
        // start from snapshot at column lo (lo is a multiple of K)
        const BlockState* snap = snaps.data() + (lo / kCheckpoint) * nb;
        std::copy(snap, snap + nb, cols.begin());
        std::vector<BlockState> col(snap, snap + nb);
        for (int64_t j = lo + 1; j <= seg_hi; ++j) {
            const int c = code_of(t[j - 1]);
            int hin = 1;
            for (int64_t b = 0; b < nb; ++b) {
                const uint64_t Eq = peq[static_cast<size_t>(c) * nb + b];
                const int hout = block_step(Eq, hin, col[b].Pv, col[b].Mv);
                col[b].score += hout;
                hin = hout;
            }
            std::copy(col.begin(), col.end(),
                      cols.begin() + static_cast<size_t>(j - seg_lo) * nb);
        }
    };

    auto cell = [&](int64_t i, int64_t j) -> int32_t {
        // D[i][j] for j within the loaded segment; i is 0-based row count
        if (i == 0) {
            return static_cast<int32_t>(j);
        }
        const BlockState* col = cols.data() +
                                static_cast<size_t>(j - seg_lo) * nb;
        return score_at_row(col, i, nb);
    };

    std::vector<char> rev_ops;
    rev_ops.reserve(m + n);
    int64_t i = m, j = n;
    load_segment((n > 0 ? (n - 1) / kCheckpoint : 0) * kCheckpoint);
    while (i > 0 || j > 0) {
        if (i == 0) {
            rev_ops.push_back('D');
            --j;
            continue;
        }
        if (j == 0) {
            rev_ops.push_back('I');
            --i;
            continue;
        }
        // need both columns j-1 and j loaded
        if (j - 1 < seg_lo) {
            load_segment((j - 1) / kCheckpoint * kCheckpoint);
        }
        const int32_t v = cell(i, j);
        const int32_t diag = cell(i - 1, j - 1);
        const int sub = (q[i - 1] == t[j - 1]) ? 0 : 1;
        if (diag + sub == v) {
            rev_ops.push_back('M');
            --i;
            --j;
            continue;
        }
        if (cell(i - 1, j) + 1 == v) {
            rev_ops.push_back('I');
            --i;
            continue;
        }
        rev_ops.push_back('D');
        --j;
    }

    char last = 0;
    int64_t run = 0;
    for (int64_t s = static_cast<int64_t>(rev_ops.size()) - 1; s >= 0; --s) {
        if (rev_ops[s] == last) {
            ++run;
        } else {
            emit_cigar_run(*cigar, run, last);
            last = rev_ops[s];
            run = 1;
        }
    }
    emit_cigar_run(*cigar, run, last);
    return dist;
}

}  // namespace racon_host
