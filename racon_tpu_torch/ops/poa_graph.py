"""Evolving-graph POA consensus with the graph DP on the GPU.

The consensus role of GenomeWorks cudapoa, split the way the JAX package
splits it: the irregular graph bookkeeping stays on the host (the C++
session, native/src/session.cpp) and the regular hot loop — the
O(nodes x len) graph-banded NW DP plus its traceback — runs on the device:

  - the host densifies each window's current graph into topo-ordered
    arrays (node codes, predecessor rank lists, band centers, sink flags);
  - the device aligns the window's next layer against that graph
    (ops/poa_kernels.window_sweep: the hand-written CUDA kernel on a
    CUDA tensor, `graph_aligner` below on a CPU tensor);
  - the per-base node ranks are committed back into the session, which
    ingests them with the exact evolving-graph add_alignment the host
    engine uses.

DP values, band masking and tie order replicate the host engine, so the
consensus is byte-identical to the host engine's (the clipped-band
full-DP retry included). Windows outside the kernel's shape envelope are
built by the host engine inside the session (the reference's per-window
GPU->CPU fallback, cudapolisher.cpp:354-383) and counted.

Jobs are padded into a set of (nodes, len) buckets (static, or derived
from the windows by the occupancy scheduler), each with one batch width
pinned from the card's free memory (the 90%-of-free rule of
cudapolisher.cpp:169-173) and split over the batch runner's lanes.
Batches launch asynchronously on the current stream; the host commits
the oldest batch while younger ones compute. The host steps are spans
(obs/trace.py: profiler ranges in a capture, Chrome events when traced):
poa.prepare, poa.dispatch, poa.wait (split into poa.sync, the wait for
the batch's own event, and poa.fetch, its copy to the host and slice),
poa.commit and poa.finish, so a profiler trace splits the consensus
wall between them and the kernels. Each batch's launch and its wait plus
commit are also the spans session.dispatch and session.commit, as in the
JAX package. `span_s` totals poa.sync and poa.fetch over the engine's
life.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..device import free_bytes, resolve
from ..obs import trace
from ..utils.logger import Logger, log_info
from .dtypes import (NEG16, kernel_plan, plan_split, poa_int16_ok,
                     resolve_dtype)
from .encode import pack_2bit, packable, unpack_2bit

#: kernel shape envelope: max graph nodes, max layer len, max node
#: in-degree — sized so w=500 ONT polishing fits (the JAX package's
#: measured envelope); larger windows are host-built per window
MAX_NODES = 2048
MAX_LEN = 640
MAX_PRED = 8

#: the fused engine's fail rule (ops/poa_fused.py): a window whose
#: predecessor lies more than RING topological ranks back leaves the
#: device, as the JAX fused program's DP ring of RING rows demands
RING = 128

#: the (nodes, len) bucket grid every job shape is padded up into
BUCKETS = ((320, 256), (768, 640), (1280, 640), (MAX_NODES, MAX_LEN))

#: jobs requested from the session per scheduling round
_CYCLE_JOBS = 1024

NEG = -(1 << 29)  # the host engine's kNegInf (INT32_MIN / 4)


def graph_aligner(n_nodes: int, seq_len: int, max_pred: int, match: int,
                  mismatch: int, gap: int, score_dtype: str = "int32",
                  packed: bool = False):
    """Plain PyTorch batched graph-NW align + traceback for one shape
    bucket: the same function as the JAX package's `graph_aligner` and
    the CUDA kernel `window_sweep`, written with whole-batch tensor ops.

    `score_dtype` 'int16' stores the DP rows as int16 with the sentinel
    NEG16 (legal only under dtypes.poa_int16_ok), as the JAX int16
    program does: with no per-row clamp, unreachable in-band cells drift
    below NEG16 by up to mp a row, exactly as there. `packed` takes
    codes [B, ceil(N/4)] and seq [B, ceil(L/4)] uint8 2-bit packed
    (encode.pack_2bit), PAD restored beyond nnodes and lens.

    Returns fn(codes, preds, centers, sinks, seq, lens, band, nnodes=None)
    on tensors of one device:
      codes   [B, N] int8   topo-ordered node base codes (pad 5)
      preds   [B, N, P] int16  predecessor DP-row indices (rank+1; 0 is the
                               virtual source row; -1 pad)
      centers [B, N] int16  band center column per node
      sinks   [B, N] uint8  1 = sink node
      seq     [B, L] int8   layer base codes (pad 5)
      lens    [B]    int32  layer lengths
      band    [B]    int32  static band width (0 = exact full DP)
      nnodes  [B]    int32  real node count per job (derived from preds
                            when omitted)
    -> ranks [B, L] int32: node rank per layer base, -1 insertion, -2
    beyond lens.

    The node loop runs to the batch's largest real node count; rows past
    a job's own count hold no sink and are never on a traceback, so the
    result equals the full-N sweep.
    """
    N, L, P = n_nodes, seq_len, max_pred
    dt = torch.int16 if score_dtype == "int16" else torch.int32
    neg_v = NEG16 if score_dtype == "int16" else NEG

    def align(codes, preds, centers, sinks, seq, lens, band, nnodes=None):
        dev = codes.device
        B = codes.shape[0]
        i32, i64 = torch.int32, torch.int64

        def c32(v):
            return torch.tensor(v, dtype=i32, device=dev)

        # the arithmetic runs in int32 (by the proof it gives the int16
        # program's integers); the rows are stored at the score dtype
        neg, m32, mm32 = c32(neg_v), c32(match), c32(mismatch)
        preds = preds.to(i64)
        if nnodes is None:
            real = (preds >= 0).any(dim=2)                        # [B, N]
            last = torch.where(real, torch.arange(1, N + 1, device=dev), 0)
            nnodes = last.amax(dim=1) if N else torch.zeros(B, device=dev)
        if packed:
            codes = unpack_2bit(codes, N, nnodes)
            seq = unpack_2bit(seq, L, lens)
        codes = codes.to(i32)
        centers = centers.to(i32)
        seq = seq.to(i32)
        l32 = lens.to(i32)
        band = band.to(i32)
        nn = nnodes.to(i64)
        n_real = int(nn.max()) if B else 0

        jidx = torch.arange(L + 1, dtype=i32, device=dev)
        jg = jidx * gap
        j1 = jidx[1:]
        H = torch.full((B, N + 1, L + 1), neg_v, dtype=dt, device=dev)
        H[:, 0] = torch.where(jidx[None, :] <= l32[:, None], jg[None, :],
                              neg)
        bps = torch.full((B, N, L + 1), P, dtype=torch.int8, device=dev)
        band2 = band // 2
        use_band = band > 0
        pidx = torch.arange(P, dtype=torch.int8, device=dev)[None, :, None]

        for k in range(1, n_real + 1):
            pk = preds[:, k - 1, :]                               # [B, P]
            rows = torch.gather(
                H, 1, pk.clamp(0, N)[:, :, None].expand(B, P, L + 1)).to(i32)
            rows = torch.where((pk >= 0)[:, :, None], rows, neg)
            sub = torch.where(seq == codes[:, k - 1, None], m32, mm32)
            diag = rows[:, :, :-1] + sub[:, None, :]              # [B, P, L]
            vert = rows[:, :, 1:] + gap
            best = torch.maximum(diag, vert).amax(dim=1)          # [B, L]
            row0 = rows[:, :, 0].amax(dim=1) + gap                # [B]

            # static-band masking, replicating the host engine: out-of-
            # band cells are NEG, and the in-row gap recurrence runs only
            # inside the band (seeded from column 0 when the band
            # touches it)
            ck = centers[:, k - 1]
            jlo = torch.where(use_band, (ck - band2).clamp(min=1), 1)
            jhi = torch.where(use_band, torch.minimum(l32, ck + band2), l32)
            inband = (j1[None, :] >= jlo[:, None]) & (j1[None, :] <= jhi[:, None])
            pre = torch.where(inband, best, neg)
            seed0 = torch.where(jlo == 1, row0, neg)
            cat = torch.cat([seed0[:, None], pre], dim=1)
            run = torch.cummax(cat - jg, dim=1).values + jg
            hrow = torch.where(inband, run[:, 1:], pre)
            H[:, k, 0] = row0
            H[:, k, 1:] = hrow

            # backpointers from score equalities, host tie order:
            # diagonal first (predecessors in edge order), then
            # vertical, then horizontal. p = diag via pred p; P+p = vert
            # via pred p; 2P = horizontal
            # (the first true predecessor of each column is the argmax
            # of the equality mask, taken as a min over p-or-P)
            pd = torch.where(hrow[:, None, :] == diag, pidx, P).amin(dim=1)
            pv = torch.where(hrow[:, None, :] == vert, pidx, P).amin(dim=1)
            bpc = torch.where(pd < P, pd, torch.where(pv < P, P + pv, 2 * P))
            is_v0 = row0[:, None] == rows[:, :, 0] + gap          # [B, P]
            bps[:, k - 1, 0] = P + torch.where(is_v0, pidx[:, :, 0], P).amin(dim=1)
            bps[:, k - 1, 1:] = bpc

        # best sink at the layer's final column; ties -> smallest rank
        scores = torch.gather(H[:, 1:, :], 2,
                              l32.to(i64)[:, None, None].expand(B, N, 1))[:, :, 0]
        kidx = torch.arange(N, device=dev)
        cand = torch.where((sinks > 0) & (kidx[None, :] < nn[:, None]),
                           scores, neg)
        best_rank = torch.argmax(cand, dim=1) if N else torch.zeros(B, dtype=i64, device=dev)

        # traceback, all lanes at once; a job with no nodes (batch
        # padding) starts finished
        out = torch.full((B, L), -2, dtype=i32, device=dev)
        r = torch.where(nn > 0, best_rank + 1, 0)
        j = torch.where(nn > 0, l32.to(i64), 0)
        bp_flat = bps.reshape(B, N * (L + 1))
        preds_flat = preds.reshape(B, N * P)
        lanes = torch.arange(B, device=dev)
        while True:
            active = (r > 0) | (j > 0)
            if not bool(active.any()):
                break
            lin = (r - 1).clamp(0, N - 1) * (L + 1) + j.clamp(0, L)
            code = torch.gather(bp_flat, 1, lin[:, None])[:, 0].to(i64)
            code = torch.where(r > 0, code, 2 * P)   # source row: horizontal
            is_d = code < P
            is_v = (code >= P) & (code < 2 * P)
            p = torch.where(is_d, code, code - P)
            plin = (r - 1).clamp(0, N - 1) * P + p.clamp(0, P - 1)
            pr = torch.gather(preds_flat, 1, plin[:, None])[:, 0]
            consume = active & ~is_v & (j > 0)
            jc = (j - 1).clamp(0, L - 1)
            cur = torch.gather(out, 1, jc[:, None])[:, 0]
            emit = torch.where(is_d, r - 1, -1).to(i32)
            out[lanes, jc] = torch.where(consume, emit, cur)
            r = torch.where(active & (is_d | is_v), pr, r)
            j = torch.where(consume, j - 1, j)
        return out

    return align


def scratch_cols(seq_len: int) -> int:
    """Columns of a node row in the window-sweep kernel's scratch: the
    widest window (`seq_len`, a band-0 job) rounded up to 16 bytes of
    int8 backpointers."""
    return -(-seq_len // 16) * 16


def _bytes_per_row(n_nodes: int, seq_len: int, max_pred: int) -> int:
    """Device bytes one batch row costs while its kernel runs: the
    band-compact score spill (int32) and backpointer plane (int8), one
    row window per node, and the densified inputs."""
    scratch = n_nodes * scratch_cols(seq_len) * (4 + 1)
    inputs = n_nodes * (2 * max_pred + 4) + seq_len
    return scratch + inputs


def pin_pow2_rows(budget: int, per_row: int, lo: int = 8,
                  hi: int = 128) -> int:
    """The largest power of two whose rows fit `budget`, clamped to
    [lo, hi] — one batch width per bucket."""
    b = 1 << max(0, (budget // max(per_row, 1)).bit_length() - 1)
    return max(lo, min(hi, b))


def device_budget(dev: torch.device) -> int:
    """Bytes to size batches from: 90% of the card's free memory (the
    reference's cudaMemGetInfo rule), or the small CPU budget."""
    free = free_bytes(dev)
    return int(free * 0.9) if dev.type == "cuda" else free


def pinned_rows(dev: torch.device, n_nodes: int, seq_len: int) -> int:
    """One lane's batch width for bucket (n_nodes, seq_len): the largest
    power of two whose footprint fits a quarter of the device budget
    (several batches are in flight while the pipeline is full)."""
    return pin_pow2_rows(device_budget(dev) // 4,
                         _bytes_per_row(n_nodes, seq_len, MAX_PRED))


class DeviceGraphPOA:
    """Orchestrates the session <-> device scheduling loop.

    Each round: ask the C++ session for the next ready layer of up to
    `_CYCLE_JOBS` windows, bucket the jobs by (graph size, layer length),
    pad each bucket to its pinned batch width and launch it (async), then
    commit the OLDEST in-flight batch — so the host's graph ingest
    overlaps the device's compute on the younger batches.

    The envelope/bucket/batch-width knobs exist so tests can force tiny
    shapes (and the out-of-envelope host path).

    Each bucket runs at the score dtype `score_dtype` resolves to under
    its overflow proof (dtypes.resolve_dtype with poa_int16_ok), and a
    batch whose layer bases and node codes are all ACGT ships both 2-bit
    packed unless `pack_bases` is False (or the bucket's length is not a
    multiple of 4). Launches are counted per (dtype, packed).

    `scheduler` (sched.BatchScheduler; a non-adaptive one when omitted)
    derives the (nodes, len) grid from the windows when adaptive (the
    envelope bucket kept as the safety net), shape-sorts each bucket's
    jobs, and records every batch's occupancy; `runner`
    (parallel/mesh.BatchRunner; one lane on `device` when omitted)
    splits each batch over its lanes, job j on lane j % n, the batch
    width rounded to the lane count.

    `autotuner` (sched/autotune.Autotuner, or None) is the winner table
    consulted under the `auto` posture, once per bucket: engine
    "session", key (nb, lb), params (match, mismatch, gap, MAX_PRED). A
    bucket the table lacks, derived buckets included, resolves as
    without a table.
    """

    def __init__(self, match: int, mismatch: int, gap: int,
                 device: str | torch.device = "cuda", num_threads: int = 1,
                 logger: Logger | None = None, max_nodes: int = MAX_NODES,
                 max_len: int = MAX_LEN, buckets=None,
                 batch_rows: int | None = None, banded_only: bool = False,
                 score_dtype: str = "auto", pack_bases: bool = True,
                 scheduler=None, runner=None, autotuner=None):
        from ..parallel.mesh import BatchRunner
        from ..sched import BatchScheduler

        resolve_dtype(True, score_dtype)  # reject an unknown posture now
        self.score_dtype = score_dtype
        self.pack_bases = pack_bases
        self.autotuner = autotuner
        #: the score dtype per (nb, lb), resolved once
        self._plans: dict[tuple[int, int], str] = {}
        #: batches per (score dtype, packed)
        self.batches_by_plan: dict[tuple[str, bool], int] = {}
        self.device = resolve(device)
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.num_threads = num_threads
        self.logger = logger
        self.banded_only = banded_only
        self.max_nodes = max_nodes
        self.max_len = max_len
        #: occupancy-aware scheduler (sched/): adaptive (nodes, len) grid
        #: and sorted packing when armed, occupancy telemetry always
        self.sched = (scheduler if scheduler is not None
                      else BatchScheduler())
        #: the lanes each batch is split over (one lane on `device` when
        #: omitted)
        self.runner = (runner if runner is not None
                       else BatchRunner([self.device]))
        self._forced_batch_rows = batch_rows
        self._set_buckets(tuple(buckets) if buckets is not None else tuple(
            b for b in BUCKETS if b[0] <= max_nodes and b[1] <= max_len))
        self.last_stats: dict = {}
        #: seconds by span name: poa.sync and poa.fetch (obs/trace.py)
        self.span_s: dict = {}

    def _set_buckets(self, buckets) -> None:
        """Install a bucket grid (the envelope bucket appended as the
        safety net — every in-envelope job always fits SOME bucket) and
        pin one batch width per bucket."""
        self.buckets = tuple(buckets)
        if (not self.buckets or self.buckets[-1][0] < self.max_nodes
                or self.buckets[-1][1] < self.max_len):
            self.buckets = self.buckets + ((self.max_nodes, self.max_len),)
        self.batch_rows = {b: self._pin_batch(b, self._forced_batch_rows)
                           for b in self.buckets}

    #: predicted graph growth per committed layer base: graphs start at
    #: backbone size and gain ~GROWTH nodes per aligned layer bp from
    #: insertions (the JAX package's measurement). The prediction only
    #: shapes the adaptive grid — a job outgrowing it first-fits a larger
    #: bucket or the envelope, so a wrong GROWTH costs padding, never
    #: correctness.
    GROWTH = 0.08

    def adapt(self, windows) -> None:
        """Derive the adaptive (nodes, len) grid from the window set (the
        job-shape histogram at run start: one predicted job per layer).
        No-op when the scheduler is off. Called by consensus()."""
        if not self.sched.adaptive:
            return
        shapes: list[tuple[int, int]] = []
        for w in windows:
            if len(w) < 3:
                continue
            nodes = len(w[0][0]) + 1
            # host-engine visit order (begin-sorted, window.cpp:84-85):
            # early layers align small graphs, late ones the grown graph
            for seq, _, _, _ in sorted(w[1:], key=lambda s: s[2]):
                shapes.append((min(self.max_nodes, int(nodes)), len(seq)))
                nodes += self.GROWTH * len(seq)
        grid = self.sched.poa_grid(shapes, k=len(BUCKETS),
                                   max_nodes=self.max_nodes,
                                   max_len=self.max_len)
        if grid:
            self._set_buckets(grid)

    def _pin_batch(self, bucket, forced) -> int:
        """ONE batch width per bucket (`pinned_rows`, or `forced`),
        rounded to the lane count."""
        n_dev = self.runner.n_devices
        b = (forced if forced is not None
             else pinned_rows(self.runner.devices[0], *bucket))
        return max(n_dev, (b // n_dev) * n_dev)

    def plan_for(self, nb: int, lb: int) -> str:
        """The score dtype of bucket (nb, lb) under this engine's posture
        and winner table (dtypes.kernel_plan), resolved once a bucket."""
        plan = self._plans.get((nb, lb))
        if plan is None:
            plan = self._plans[(nb, lb)] = kernel_plan(
                self.score_dtype, self.autotuner, "session", (nb, lb),
                (self.match, self.mismatch, self.gap, MAX_PRED),
                poa_int16_ok(nb, lb, self.match, self.mismatch, self.gap),
                self.device.type)
        return plan

    def _bucket(self, n_nodes: int, length: int) -> tuple[int, int]:
        return next((nb, lb) for nb, lb in self.buckets
                    if n_nodes <= nb and length <= lb)

    def consensus(self, windows):
        """windows: list of lists of (seq, qual|None, begin, end), element 0
        the backbone. Returns (results, statuses): results like poa_batch's
        [(consensus bytes, coverages)], statuses int array (0 device,
        1 host-built outside the envelope, 2 backbone-only)."""
        from ..native import PoaSession

        # adaptive grid from the run's own job-shape histogram (no-op
        # when the scheduler is off — the static grid stays)
        self.adapt(windows)
        session = PoaSession(windows, self.match, self.mismatch, self.gap,
                             self.max_nodes, MAX_PRED, self.max_len,
                             max_jobs=_CYCLE_JOBS,
                             banded_only=self.banded_only,
                             n_threads=self.num_threads)
        bar = self.logger.bar if self.logger is not None else None
        total_layers = sum(max(0, len(w) - 1) for w in windows)
        if self.logger is not None and total_layers:
            self.logger.bar_total(total_layers)

        # split-half pipelining: each prepare() pulls at most HALF the
        # active windows (round-robin), so while half A's results are
        # committed (mutating graphs), half B computes on the device
        n_active = sum(1 for w in windows if len(w) >= 3)
        half = max(8, min(_CYCLE_JOBS, max(1, n_active // 2)))
        # batches kept queued: enough to hide the host's commit+prepare
        # time behind device compute
        depth = 4
        # prepare only in bursts, once commits have freed enough windows
        # to fill a decent batch
        threshold = 1
        freed = 1
        inflight: deque = deque()
        while True:
            if freed >= threshold or not inflight:
                burst = 0
                while len(inflight) < depth:
                    with trace.span("poa.prepare"):
                        jobs = session.prepare(half)
                    if jobs is None:
                        break
                    burst += jobs["n"]
                    with trace.span("poa.dispatch"):
                        inflight.extend(self._dispatch_round(jobs))
                if burst:
                    freed = 0
                    threshold = max(8, burst // 2)
            if not inflight:
                break
            # commit the oldest batch (waits only for ITS result; younger
            # batches keep computing)
            (win, layer, band, npart, lb, out, rows,
             done) = inflight.popleft()
            with trace.span("session.commit", engine="session", jobs=npart):
                with trace.span("poa.wait"):
                    with trace.span("poa.sync", into=self.span_s):
                        if done is not None:
                            done.synchronize()
                    # on one stream the copy also waits for the younger
                    # batches queued behind this one
                    with trace.span("poa.fetch", into=self.span_s):
                        ranks = out.cpu().numpy()[rows][:, :lb]
                with trace.span("poa.commit"):
                    session.commit(win, layer, band, ranks)
            freed += npart
            if bar is not None:
                for _ in range(npart):
                    bar("[racon_tpu_torch::Polisher.polish] "
                        "aligning layers to graphs on device")
        self.last_stats = session.stats()
        with trace.span("poa.finish"):
            results = session.finish(self.num_threads)
        session.close()
        return results

    #: bucket groups smaller than this merge upward into the next larger
    #: nonempty bucket: a slightly longer sweep for a few jobs beats
    #: another launch for a nearly-empty batch
    MIN_FILL = 16

    def _dispatch_round(self, jobs):
        """Bucket one prepare() round and launch every batch. Returns
        [(win, layer, band, n_jobs, len_bucket, device_out, rows, done)]
        — everything the commit needs is snapshotted so the session's
        prepare buffers can be reused at once."""
        n = jobs["n"]
        groups: dict[tuple[int, int], list[int]] = {}
        for i in range(n):
            b = self._bucket(int(jobs["nnodes"][i]), int(jobs["len"][i]))
            groups.setdefault(b, []).append(i)

        order = sorted(groups)
        for gi, b in enumerate(order[:-1]):
            if len(groups.get(b, ())) < self.MIN_FILL:
                for nb in order[gi + 1:]:
                    if groups.get(nb) and nb[0] >= b[0] and nb[1] >= b[1]:
                        groups[nb] = groups.pop(b) + groups[nb]
                        break

        batches = []
        n_dev = self.runner.n_devices
        kernel = "cuda" if self.device.type == "cuda" else "plain"
        for (nb, lb), idx in sorted(groups.items()):
            # sorted packing: shape-homogeneous batches within the bucket
            # (commits key on (win, layer), so cross-window dispatch
            # order is free); identity when the scheduler is off
            idx = self.sched.order(
                idx, key=lambda i: (int(jobs["nnodes"][i]),
                                    int(jobs["len"][i])))
            B = self.batch_rows[(nb, lb)]
            for s in range(0, len(idx), B):
                part = idx[s:s + B]
                sel = np.asarray(part, dtype=np.int64)
                meta = (jobs["win"][sel].copy(), jobs["layer"][sel].copy(),
                        jobs["band"][sel].copy())
                with trace.span("session.dispatch", engine="session",
                                bucket=f"{nb}x{lb}", jobs=len(part)):
                    out, rows, done = self._dispatch(jobs, sel, nb, lb, B)
                # occupancy, recorded after the launch: job j landed on
                # lane j % n_dev (the _dispatch scatter), so the per-lane
                # useful cells are strided sums. The batch is always
                # padded to the pinned width B, so the full-runner
                # baseline equals the dispatched capacity.
                row_cells = (jobs["nnodes"][sel].astype(np.int64)
                             * (jobs["len"][sel].astype(np.int64) + 1))
                self.sched.stats.record(
                    "session", (nb, lb), jobs=len(part), lanes=B,
                    useful_cells=int(row_cells.sum()),
                    total_cells=B * nb * (lb + 1), kernel=kernel,
                    dtype=self.plan_for(nb, lb), n_devices=n_dev,
                    shard_useful=[int(row_cells[k::n_dev].sum())
                                  for k in range(n_dev)],
                    full_mesh_cells=B * nb * (lb + 1))
                batches.append(meta + (len(part), lb, out, rows, done))
        return batches

    def _dispatch(self, jobs, sel, nb, lb, B):
        """Pad/scatter one bucket batch to its pinned width, pack its
        bases when it may, and launch it over the runner's lanes.
        Returns (device_out, rows, done): `rows[j]` is the batch row job j
        landed on — round-robin over the lanes' shards, so each lane
        carries an even share of the real (and of the padding) rows
        instead of the last lane eating all the pad; the lanes' outputs
        are concatenated in lane order on the engine's device, so `rows`
        addresses the whole batch; `done` is a CUDA event recorded behind
        the batch on the engine device's current stream (None on the
        CPU)."""
        import functools
        import time

        from ..parallel.mesh import concat

        n_dev = self.runner.n_devices
        per = B // n_dev
        j = np.arange(len(sel), dtype=np.int64)
        rows = (j % n_dev) * per + j // n_dev

        def take(arr, fill):
            out = np.full((B,) + arr.shape[1:], fill, dtype=arr.dtype)
            out[rows] = arr[sel]
            return out

        args = [take(jobs["codes"][:, :nb], 5),
                take(jobs["preds"][:, :nb], -1),
                take(jobs["centers"][:, :nb], 0),
                take(jobs["sinks"][:, :nb], 0),
                take(jobs["seqs"][:, :lb], 5),
                take(jobs["len"], 0), take(jobs["band"], 0),
                take(jobs["nnodes"], 0)]
        # 2-bit packing: every layer base and node code ACGT, and a layer
        # length the packed form carries whole (a multiple of 4)
        packed = (self.pack_bases and lb % 4 == 0
                  and packable(args[4], args[5])
                  and packable(args[0], args[7]))
        if packed:
            args[0], args[4] = pack_2bit(args[0]), pack_2bit(args[4])
        t0 = time.perf_counter()
        out = concat(self.runner.run_split(
            functools.partial(self.run_bucket, nb, lb),
            *(torch.from_numpy(a) for a in args)), self.device)
        # first-dispatch telemetry, keyed as the JAX engine keys it
        self.sched.stats.record_compile_once(
            "session",
            (nb, lb, B, self.match, self.mismatch, self.gap, MAX_PRED,
             "cuda" if self.device.type == "cuda" else "plain",
             self.plan_for(nb, lb), packed),
            time.perf_counter() - t0)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return out, rows, done

    def run_bucket(self, nb, lb, codes, preds, centers, sinks, seqs, lens,
                   band, nnodes):
        """Run ONE padded batch (or one lane's shard of it) at its
        bucket's score dtype, in the operand form it came in (uint8
        codes: 2-bit packed): the CUDA kernel on a CUDA device, the plain
        version on the CPU (poa_kernels.window_sweep decides by the
        tensors' device)."""
        from .poa_kernels import window_sweep

        plan = (self.plan_for(nb, lb), codes.dtype == torch.uint8)
        self.batches_by_plan[plan] = self.batches_by_plan.get(plan, 0) + 1
        return window_sweep(codes, preds, centers, sinks, seqs, lens, band,
                            nnodes, self.match, self.mismatch, self.gap,
                            *plan)


def log_session_stats(stats: dict, statuses: np.ndarray,
                      by_plan: dict) -> None:
    log_info(f"[racon_tpu_torch::BatchPOA] device layer alignments: "
             f"{stats.get('committed', 0)} committed, "
             f"{stats.get('redos', 0)} banded-clip full-DP retries; "
             f"{int((statuses == 0).sum())} windows built on device, "
             f"{int((statuses == 1).sum())} on host (outside the kernel "
             f"envelope), {int((statuses == 2).sum())} backbone-only; "
             f"batches by score dtype and operand form: "
             f"{plan_split(by_plan)}")
