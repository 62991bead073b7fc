"""The plain reference that decides `correct`: racon's window consensus and
the edit distances the alignment stage is held to, in Python and numpy.

It imports nothing of the program. What it computes:

  - `nw_distance(a, b)`: the global (Needleman-Wunsch) edit distance, by
    Myers' bit-vector algorithm on Python integers (one integer a column,
    as edlib's NW mode runs one block).
  - `breaking_point_excess(q, t, points)`: how many edits the cut points
    of one overlap's alignment cost beyond the optimum. The points (the
    first and one-past-the-last match of the overlap in every window) lie
    on one optimal alignment exactly when the edit distances of the pieces
    between them add up to the distance of the whole: 0 for a sound
    alignment, whichever of the equally good alignments it chose.
  - `polish_window(...)`: one window's consensus from its backbone and
    layers, as racon's Window::generate_consensus builds it
    (src/window.cpp:65-142): layers sorted stably by begin, window-spanning
    layers aligned to the whole graph and the others to the graph between
    their begin and end, a global alignment with linear gaps against the
    graph, heaviest-bundle consensus, then the coverage trim of long-read
    windows. The graph's rules (node and column merging, the topological
    order, the traceback's tie order diagonal / vertical / horizontal, the
    static band of 256 with the exact redo when the banded path is
    mostly mismatches, the int16 cells where the score bound allows them)
    are the ones the port's C++ host engine documents, which its device
    engines are held to byte for byte.

`narrow=8` computes every DP cell in 8-bit integers, wrapping as a cast
would: the control, one precision below the int16 cells the port runs.
"""

from __future__ import annotations

import numpy as np

#: base codes: A C G T, anything else 4 (the port's encoding)
CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
BASES = b"ACGTN-"

BAND = 256
INT32_NEG_INF = -(2**31) // 4
INT16_NEG_INF = -28000


# ----------------------------------------------------------- edit distance
def nw_distance(a: bytes, b: bytes) -> int:
    """Global edit distance between a and b (unit costs)."""
    m = len(a)
    if m == 0 or not b:
        return max(m, len(b))
    peq: dict[int, int] = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    mask = (1 << m) - 1
    high = 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        # the top row is D[0][j] = j: every column enters with +1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score


def breaking_point_excess(q: bytes, t: bytes, points) -> int:
    """Edits the path through `points` costs beyond the optimal alignment of
    q to t. `points` are (t_pos, q_pos) offsets into t and q, in order."""
    cuts = [(0, 0), *((int(a), int(b)) for a, b in points), (len(t), len(q))]
    pieces = 0
    for (ta, qa), (tb, qb) in zip(cuts, cuts[1:]):
        if tb < ta or qb < qa:
            raise ValueError(f"cut points out of order: {(ta, qa)} then "
                             f"{(tb, qb)}")
        pieces += nw_distance(q[qa:qb], t[ta:tb])
    return pieces - nw_distance(q, t)


# ---------------------------------------------------------------- the POA
class Graph:
    """A partial-order graph: nodes with a base code, an approximate
    backbone column (bpos) and a sequence count; weighted edges; nodes of
    one column with different bases linked as `aligned`."""

    def __init__(self):
        self.code: list[int] = []
        self.bpos: list[int] = []
        self.n_seqs: list[int] = []
        self.ins: list[list[int]] = []    # edge ids into the node
        self.outs: list[list[int]] = []   # edge ids out of the node
        self.aligned: list[list[int]] = []
        self.tail: list[int] = []
        self.head: list[int] = []
        self.weight: list[int] = []

    def __len__(self) -> int:
        return len(self.code)

    def add_node(self, code: int, bpos: int) -> int:
        self.code.append(code)
        self.bpos.append(bpos)
        self.n_seqs.append(0)
        self.ins.append([])
        self.outs.append([])
        self.aligned.append([])
        return len(self.code) - 1

    def add_edge(self, tail: int, head: int, weight: int) -> None:
        for e in self.ins[head]:
            if self.tail[e] == tail:
                self.weight[e] += weight
                return
        e = len(self.tail)
        self.tail.append(tail)
        self.head.append(head)
        self.weight.append(weight)
        self.outs[tail].append(e)
        self.ins[head].append(e)

    def add_alignment(self, aln, seq: np.ndarray, weights) -> None:
        """Thread the codes `seq` through the graph along `aln`, a list of
        (node or -1, seq position or -1); an empty alignment adds a fresh
        path (the backbone, when the graph is empty)."""
        n = len(seq)
        if n == 0:
            return
        backbone = len(self.code) == 0
        path = [-1] * n
        aligned_pos = [p for _, p in aln if p >= 0]
        if not aligned_pos:
            for i in range(n):
                path[i] = self.add_node(int(seq[i]), i if backbone else 0)
        else:
            first, last = aligned_pos[0], aligned_pos[-1]
            col_bpos, col_seen = 0, False
            for node, p in aln:
                if p < 0:
                    continue
                c = int(seq[p])
                if node < 0:
                    cur = self.add_node(c, col_bpos if col_seen else -1)
                else:
                    col_bpos = self.bpos[node]
                    col_seen = True
                    if self.code[node] == c:
                        cur = node
                    else:
                        cur = next((a for a in self.aligned[node]
                                    if self.code[a] == c), -1)
                        if cur < 0:
                            cur = self.add_node(c, self.bpos[node])
                            for a in [*self.aligned[node], node]:
                                self.aligned[a].append(cur)
                                self.aligned[cur].append(a)
                path[p] = cur
            if col_seen:
                fill = -1
                for i in range(last, first - 1, -1):
                    v = path[i]
                    if v >= 0 and self.bpos[v] >= 0:
                        fill = self.bpos[v]
                    elif v >= 0:
                        self.bpos[v] = fill
            pre = self.bpos[path[first]] if path[first] >= 0 else 0
            for i in range(first):
                path[i] = self.add_node(int(seq[i]), pre)
            suf = self.bpos[path[last]] if path[last] >= 0 else 0
            for i in range(last + 1, n):
                path[i] = self.add_node(int(seq[i]), suf)
        for v in path:
            self.n_seqs[v] += 1
        for i in range(1, n):
            self.add_edge(path[i - 1], path[i],
                          int(weights[i - 1]) + int(weights[i]))

    def topo_order(self) -> list[int]:
        """Kahn's algorithm, first-in first-out, seeded in id order."""
        indeg = [len(x) for x in self.ins]
        queue = [v for v in range(len(indeg)) if indeg[v] == 0]
        k = 0
        while k < len(queue):
            v = queue[k]
            k += 1
            for e in self.outs[v]:
                h = self.head[e]
                indeg[h] -= 1
                if indeg[h] == 0:
                    queue.append(h)
        if len(queue) != len(indeg):
            raise ValueError("the graph has a cycle")
        return queue

    def subgraph(self, begin: int, end: int):
        """The nodes with begin <= bpos <= end (in id order) and the edges
        between them (in edge order); returns (graph, sub id -> id)."""
        mapping = [v for v in range(len(self.code))
                   if begin <= self.bpos[v] <= end]
        to_sub = {v: i for i, v in enumerate(mapping)}
        sub = Graph()
        for v in mapping:
            i = sub.add_node(self.code[v], self.bpos[v])
            sub.n_seqs[i] = self.n_seqs[v]
            sub.aligned[i] = [to_sub[a] for a in self.aligned[v] if a in to_sub]
        for e in range(len(self.tail)):
            t, h = to_sub.get(self.tail[e]), to_sub.get(self.head[e])
            if t is not None and h is not None:
                sub.add_edge(t, h, self.weight[e])
        return sub, mapping

    def align_nw(self, seq: np.ndarray, match: int, mismatch: int, gap: int,
                 band: int = 0, bpos_origin: int = 0,
                 narrow: int | None = None) -> list[tuple[int, int]]:
        """Global alignment of `seq` (codes) to the graph with linear gaps,
        maximising the score; (node or -1, position or -1) pairs."""
        n, L = len(self.code), len(seq)
        if n == 0 or L == 0:
            return []
        order = self.topo_order()
        rank = [0] * n
        for r, v in enumerate(order):
            rank[v] = r
        bound = (n + L + 2) * max(abs(match), abs(mismatch), abs(gap), 1)
        neg_inf = INT16_NEG_INF if bound < 27000 else INT32_NEG_INF
        wrap = None
        if narrow is not None:
            half = 1 << (narrow - 1)
            neg_inf = -(half * 110 // 128)

            def wrap(x):
                return (x + half) % (2 * half) - half

        def cast(x):
            return x if wrap is None else wrap(x)

        H = np.empty((n + 1, L + 1), dtype=np.int64)
        H[0] = cast(np.arange(L + 1, dtype=np.int64) * gap)
        prof = np.where(np.arange(5)[:, None] == np.asarray(seq)[None, :],
                        match, mismatch).astype(np.int64)      # [5, L]
        preds = []
        for r in range(1, n + 1):
            v = order[r - 1]
            pr = [rank[self.tail[e]] + 1 for e in self.ins[v]] or [0]
            preds.append(pr)
            row = H[r]
            p = prof[self.code[v]]
            jlo, jhi = 1, L
            if band > 0:
                center = self.bpos[v] - bpos_origin + 1
                jlo = max(1, center - band // 2)
                jhi = min(L, center + band // 2)
                row[:] = neg_inf
            prow = H[pr[0]]
            row[0] = cast(prow[0] + gap)
            if jlo <= jhi:
                best = np.maximum(cast(prow[jlo - 1:jhi] + p[jlo - 1:jhi]),
                                  cast(prow[jlo:jhi + 1] + gap))
                row[jlo:jhi + 1] = np.maximum(best, neg_inf)
            for q in pr[1:]:
                prow = H[q]
                row[0] = max(row[0], cast(prow[0] + gap))
                if jlo <= jhi:
                    best = np.maximum(cast(prow[jlo - 1:jhi] + p[jlo - 1:jhi]),
                                      cast(prow[jlo:jhi + 1] + gap))
                    np.maximum(row[jlo:jhi + 1], best, out=row[jlo:jhi + 1])
            if jlo <= jhi:
                if wrap is None:
                    # row[j] = max(row[j], row[j-1] + gap), left to right
                    seg = row[jlo - 1:jhi + 1]
                    k = np.arange(len(seg), dtype=np.int64)
                    run = np.maximum.accumulate(seg - gap * k) + gap * k
                    row[jlo:jhi + 1] = run[1:]
                else:
                    for j in range(jlo, jhi + 1):
                        h = wrap(int(row[j - 1]) + gap)
                        if h > row[j]:
                            row[j] = h

        best_r, best = -1, neg_inf
        for r in range(1, n + 1):
            if not self.outs[order[r - 1]] and H[r, L] > best:
                best, best_r = H[r, L], r
        if best_r < 0:
            return []

        out: list[tuple[int, int]] = []
        r, j = best_r, L
        while r != 0 or j != 0:
            cur = H[r, j]
            moved = False
            if r != 0:
                v = order[r - 1]
                pr = preds[r - 1]
                if j > 0:
                    sub = match if seq[j - 1] == self.code[v] else mismatch
                    for q in pr:
                        if cast(int(H[q, j - 1]) + sub) == cur:
                            out.append((v, j - 1))
                            r, j, moved = q, j - 1, True
                            break
                if not moved:
                    for q in pr:
                        if cast(int(H[q, j]) + gap) == cur:
                            out.append((v, -1))
                            r, moved = q, True
                            break
                if not moved and j == 0:
                    # only wrapped (control) scores reach here
                    out.append((v, -1))
                    r, moved = pr[0], True
            if not moved:
                out.append((-1, j - 1))
                j -= 1
        out.reverse()
        return out

    def consensus(self) -> tuple[np.ndarray, list[int]]:
        """Heaviest bundle, extended greedily to a sink: (codes, coverage of
        each consensus node's column)."""
        n = len(self.code)
        if n == 0:
            return np.zeros(0, dtype=np.uint8), []
        order = self.topo_order()
        score = [0] * n
        pred = [-1] * n
        max_node = order[0]
        for v in order:
            best_w, best_p = -1, -1
            for e in self.ins[v]:
                w, t = self.weight[e], self.tail[e]
                if w > best_w or (w == best_w and (best_p < 0
                                                   or score[t] >= score[best_p])):
                    best_w, best_p = w, t
            if best_p >= 0:
                score[v] = best_w + score[best_p]
                pred[v] = best_p
            if score[v] > score[max_node]:
                max_node = v
        tip = max_node
        while self.outs[tip]:
            best_w, best_h = -1, -1
            for e in self.outs[tip]:
                w, h = self.weight[e], self.head[e]
                if w > best_w or (w == best_w and (best_h < 0
                                                   or score[h] >= score[best_h])):
                    best_w, best_h = w, h
            pred[best_h] = tip
            tip = best_h
        path = []
        v = tip
        while v >= 0:
            path.append(v)
            v = pred[v]
        path.reverse()
        codes = np.array([self.code[v] for v in path], dtype=np.uint8)
        cov = [self.n_seqs[v] + sum(self.n_seqs[a] for a in self.aligned[v])
               for v in path]
        return codes, cov


def _band_clipped(aln, seq, g: Graph) -> bool:
    aligned = matched = 0
    for v, p in aln:
        if v >= 0 and p >= 0:
            aligned += 1
            matched += g.code[v] == seq[p]
    return aligned == 0 or 2 * matched < aligned


def _weights(qual: bytes | None, n: int) -> np.ndarray:
    if qual is None:
        return np.ones(n, dtype=np.int64)
    q = np.frombuffer(qual, dtype=np.uint8).astype(np.int64)
    return np.where(q >= 33, q - 33, 0)


def window_consensus(seqs: list[bytes], quals: list, begins: list[int],
                     ends: list[int], match: int, mismatch: int, gap: int,
                     narrow: int | None = None):
    """Consensus of a window of >= 3 sequences (index 0 the backbone):
    (ASCII bytes, per-base coverages)."""
    codes = [CODE[np.frombuffer(s, dtype=np.uint8)] for s in seqs]
    g = Graph()
    g.add_alignment([], codes[0], _weights(quals[0], len(seqs[0])))
    order = sorted(range(1, len(seqs)), key=lambda i: begins[i])
    n0 = len(seqs[0])
    offset = int(0.01 * n0)
    for i in order:
        s, n = codes[i], len(seqs[i])
        if begins[i] < offset and ends[i] > n0 - offset:
            fits = abs(n - n0) < BAND // 2 - 16
            aln = g.align_nw(s, match, mismatch, gap, BAND if fits else 0, 0,
                             narrow)
            if fits and _band_clipped(aln, s, g):
                aln = g.align_nw(s, match, mismatch, gap, 0, 0, narrow)
        else:
            fits = abs(n - (ends[i] - begins[i] + 1)) < BAND // 2 - 16
            sub, mapping = g.subgraph(begins[i], ends[i])
            aln = sub.align_nw(s, match, mismatch, gap, BAND if fits else 0,
                               begins[i], narrow)
            if fits and _band_clipped(aln, s, sub):
                aln = sub.align_nw(s, match, mismatch, gap, 0, 0, narrow)
            aln = [(mapping[v] if v >= 0 else v, p) for v, p in aln]
        g.add_alignment(aln, s, _weights(quals[i], n))
    cons, cov = g.consensus()
    return bytes(BASES[c] for c in cons), cov


def polish_window(backbone: bytes, backbone_quality: bytes | None,
                  layers: list, match: int, mismatch: int, gap: int,
                  long_reads: bool = True, trim: bool = True,
                  narrow: int | None = None) -> bytes:
    """One window's polished bytes. `layers` are (bases, quality or None,
    begin, end) with end inclusive, in the order they were added. Fewer
    than two layers leave the backbone; long-read windows are trimmed to
    the columns at least half the layers cover."""
    if len(layers) < 2:
        return backbone
    seqs = [backbone] + [x[0] for x in layers]
    quals = [backbone_quality] + [x[1] for x in layers]
    begins = [0] + [x[2] for x in layers]
    ends = [0] + [x[3] for x in layers]
    cons, cov = window_consensus(seqs, quals, begins, ends, match, mismatch,
                                 gap, narrow)
    if not long_reads or not trim:
        return cons
    average = len(layers) // 2
    begin, end = 0, len(cons) - 1
    while begin < len(cons) and cov[begin] < average:
        begin += 1
    while end >= 0 and cov[end] < average:
        end -= 1
    if begin >= end:
        return cons
    return cons[begin:end + 1]


def revcomp(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
