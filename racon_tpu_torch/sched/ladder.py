"""Bucket-ladder derivation: minimal-padding shape sets under a launch-
shape budget.

The port's copy of the JAX package's racon_tpu/sched/ladder.py (the port
imports nothing of that package). Every device hot path pads jobs up to a
shape ladder (the cudapoa BatchConfig discipline, cudabatch.cpp:56-59). A
static ladder sized for the worst case wastes DP cells on easy inputs: a
batch of 600 bp overlaps padded to the 4096 bucket burns ~7x the useful
DP area. The solvers here derive the ladder from the run's actual
job-shape histogram instead — choose at most K edges (K = the static
ladder's own size, so adaptive mode never launches at MORE shapes than
the static one) minimizing the total padded cells:

    minimize  sum_jobs cost(edge(job))     s.t.  |edges| <= K
    where edge(job) = the smallest chosen edge >= the job's shape

Since the useful cells are fixed by the data, minimizing total dispatched
cells equals minimizing padded cells. Both solvers are exact dynamic
programs over the sorted shape histogram (segment the sorted jobs into
<= K runs; each run's edge is its own maximum, rounded up to a shape
quantum): O(K * U^2) for U candidate edges, with U thinned to a bound so
a multi-million-overlap run spends microseconds here, not seconds.

Correctness note: bucket shapes only control PADDING — every kernel masks
computation with the per-job true lengths/node counts — so any ladder
whose largest edge covers the largest job yields byte-identical output.
tests/test_torch_sched.py pins that property per engine.
"""

from __future__ import annotations

#: candidate-edge thinning bound: the DP is O(K * U^2), so U is capped by
#: keeping every quantized shape when few, else an even quantile sweep
#: (the maximum always kept — the top edge must cover the largest job)
MAX_CANDIDATES = 256


def round_up(v: int, quantum: int) -> int:
    """v rounded up to a positive multiple of `quantum`."""
    q = max(1, int(quantum))
    return max(q, (int(v) + q - 1) // q * q)


def _thin(sorted_vals: list, limit: int = MAX_CANDIDATES) -> list:
    """Evenly thin a sorted candidate list to <= limit entries, always
    keeping the last (the maximum: the ladder's top edge lives there)."""
    n = len(sorted_vals)
    if n <= limit:
        return list(sorted_vals)
    step = n / float(limit)
    picked = sorted({min(n - 1, int((i + 1) * step) - 1)
                     for i in range(limit)} | {n - 1})
    return [sorted_vals[i] for i in picked]


def ladder_1d(values, k: int, quantum: int = 1, cost=None) -> list[int]:
    """Choose <= k edges covering every value with minimal total cost.

    `values`: the job shapes (lengths / depths), any iterable of ints.
    `cost(edge)`: per-job cost of dispatching at `edge` (default: the
    edge itself — the right proxy when the padded area is linear in the
    bucket edge). Edges are segment maxima rounded up to `quantum`.

    Returns the ascending edge list ([] for empty input — callers keep
    their static ladder then).
    """
    vals = sorted(int(v) for v in values)
    if not vals:
        return []
    if cost is None:
        cost = lambda e: e  # noqa: E731 — default padded-area proxy
    # histogram over quantized candidate edges: jobs in (cand[i-1],
    # cand[i]] all dispatch at cand[i] or a larger chosen edge
    cands: list[int] = []
    weights: list[int] = []
    for v in vals:
        q = round_up(v, quantum)
        if cands and cands[-1] == q:
            weights[-1] += 1
        else:
            cands.append(q)
            weights.append(1)
    if len(cands) > MAX_CANDIDATES:
        kept = _thin(cands)
        wmap = dict.fromkeys(kept, 0)
        ki = 0
        for c, w in zip(cands, weights):
            while kept[ki] < c:
                ki += 1
            wmap[kept[ki]] += w
        cands = kept
        weights = [wmap[c] for c in cands]
    U = len(cands)
    k = max(1, min(int(k), U))
    W = [0] * (U + 1)  # prefix weights
    for i, w in enumerate(weights):
        W[i + 1] = W[i] + w
    ecost = [cost(c) for c in cands]
    INF = float("inf")
    # dp[j][i]: min cost covering cands[0..i] with exactly j+1 edges,
    # the last edge being cands[i]; par[j][i]: index of the previous edge
    dp = [[INF] * U for _ in range(k)]
    par = [[-1] * U for _ in range(k)]
    for i in range(U):
        dp[0][i] = W[i + 1] * ecost[i]
    for j in range(1, k):
        dpj, dpp, parj = dp[j], dp[j - 1], par[j]
        for i in range(j, U):
            for m in range(j - 1, i):
                c = dpp[m] + (W[i + 1] - W[m + 1]) * ecost[i]
                if c < dpj[i]:
                    dpj[i] = c
                    parj[i] = m
    jbest = min(range(k), key=lambda j: dp[j][U - 1])
    edges = []
    i = U - 1
    for j in range(jbest, -1, -1):
        edges.append(cands[i])
        i = par[j][i]
        if i < 0:
            break
    return sorted(edges)


def ladder_2d(shapes, k: int, quantum_a: int = 1, quantum_b: int = 1,
              area=None) -> list[tuple[int, int]]:
    """Choose <= k (a, b) bucket pairs covering every (a, b) job shape
    with minimal total dispatched area.

    Jobs are sorted by `a` and partitioned into <= k contiguous runs;
    each run's bucket is (max a, max b) over the run, rounded up to the
    quanta — so every job fits its own run's bucket by construction
    (callers still append their envelope bucket as the safety net, the
    existing engine discipline). `area(ea, eb)` is the per-job dispatch
    cost at bucket (ea, eb) (default ea * eb — the DP-matrix area).

    Returns buckets ascending in `a` (the order the engines' first-fit
    `_bucket` scan expects). The `b` edges need not be monotone; a job
    whose `b` exceeds its a-wise bucket's edge first-fits a later bucket
    or the envelope.
    """
    jobs = sorted((int(a), int(b)) for a, b in shapes)
    if not jobs:
        return []
    if area is None:
        area = lambda ea, eb: ea * eb  # noqa: E731
    # candidate segment ends: any job index (jobs are (a, b)-sorted, so
    # a segment's last job carries its max a; cuts INSIDE an equal-a run
    # are allowed — its low-b prefix may belong in a flatter bucket)
    bounds = _thin(list(range(len(jobs))))
    U = len(bounds)
    k = max(1, min(int(k), U))
    INF = float("inf")

    def seg_cost(m: int, i: int, maxb: int) -> float:
        """Jobs (bounds[m], bounds[i]] dispatched at this segment's
        bucket; m == -1 means the segment starts at job 0."""
        ea = round_up(jobs[bounds[i]][0], quantum_a)
        eb = round_up(maxb, quantum_b)
        count = bounds[i] - (bounds[m] if m >= 0 else -1)
        return count * area(ea, eb)

    # block maxima between consecutive boundaries: blk[p] = max b over
    # jobs (bounds[p-1], bounds[p]]; the m-descending sweeps below then
    # accumulate segment max-b in O(1) per step (O(k * U^2) total)
    blk = [0] * U
    prev_end = -1
    for p in range(U):
        blk[p] = max(b for _, b in jobs[prev_end + 1:bounds[p] + 1])
        prev_end = bounds[p]

    dp = [[INF] * U for _ in range(k)]
    par = [[-1] * U for _ in range(k)]
    mb = 0
    for i in range(U):
        mb = max(mb, blk[i])
        dp[0][i] = seg_cost(-1, i, mb)
    for j in range(1, k):
        dpj, dpp, parj = dp[j], dp[j - 1], par[j]
        for i in range(j, U):
            mb = blk[i]
            for m in range(i - 1, j - 2, -1):
                c = dpp[m] + seg_cost(m, i, mb)
                if c < dpj[i]:
                    dpj[i] = c
                    parj[i] = m
                mb = max(mb, blk[m])
    jbest = min(range(k), key=lambda j: dp[j][U - 1])
    ends = []
    i = U - 1
    for j in range(jbest, -1, -1):
        ends.append(bounds[i])
        i = par[j][i]
        if i < 0:
            break
    ends = sorted(ends)
    out: list[tuple[int, int]] = []
    prev = -1
    for end in ends:
        mb = max(b for _, b in jobs[prev + 1:end + 1])
        out.append((round_up(jobs[end][0], quantum_a),
                    round_up(mb, quantum_b)))
        prev = end
    return out


def padded_cost_1d(values, edges, cost=None) -> float:
    """Total dispatch cost of `values` under the edge ladder (the metric
    ladder_1d minimizes; used by tests and the occupancy report)."""
    if cost is None:
        cost = lambda e: e  # noqa: E731
    es = sorted(edges)
    total = 0.0
    for v in values:
        e = next((x for x in es if x >= v), None)
        if e is None:
            continue  # beyond the ladder: host fallback, no device cost
        total += cost(e)
    return total
