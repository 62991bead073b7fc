"""Batched banded global alignment (edit distance + CIGAR path).

The GenomeWorks cudaaligner role: many pairwise global alignments at
once, each pair in a static band that tracks the (0,0)->(M,N) diagonal.
Anti-diagonal wavefront DP: cells (i, j) with i+j == d depend only on
wavefronts d-1 and d-2. On wavefront d only query rows i in
[offset[d], offset[d] + band) are kept; offsets are computed on the host
per lane (they advance by 0/1 per wavefront) and shared by the DP and the
traceback. Unit costs (match 0, mismatch 1, indel 1, minimize), ties
fixed (diagonal < up/I < left/D), so the output is bit-stable.

`banded_nw` + `traceback` are the plain PyTorch version of the CUDA
kernel ops/align_kernels.wavefront_align, at either score dtype and
operand form; `BatchAligner` buckets pairs, picks each batch's score
dtype and operand form, and runs them through the wrapper on its
device, through the dispatch pipeline's pack / dispatch / wait / unpack
stages, under the spans (obs/trace.py) align.operands, align.kernel
(split into align.launch, align.account and align.readback) and
align.decode.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve
from ..obs import trace
from .dtypes import INF16, aligner_int16_ok, kernel_plan, resolve_dtype
from .encode import unpack_2bit

INF = 1 << 28

# backpointer codes
BP_DIAG, BP_UP, BP_LEFT = 0, 1, 2  # M, I (consume query), D (consume target)


def band_offsets(q_len: int, t_len: int, band: int, n_waves: int) -> np.ndarray:
    """Per-wavefront band start rows for one lane (host side).

    Wavefront d holds query rows i in [off[d], off[d]+band). The band tracks
    the ideal diagonal i ~= d * M / (M+N) and is clamped so (0,0) and (M,N)
    are always inside. Offsets are nondecreasing with steps in {0, 1}.
    """
    m, n = q_len, t_len
    d = np.arange(n_waves, dtype=np.int64)
    center = (d * m) // (m + n) if (m + n) else d * 0
    lo = np.maximum(0, d - n)
    hi = np.minimum(d, m)
    off = np.clip(center - band // 2, lo, np.maximum(lo, hi - band + 1))
    off = np.maximum.accumulate(off)            # enforce monotone
    off = np.minimum(off, np.maximum(0, m - 0))  # safety clamp
    # steps must be 0/1 for the DP gather to stay in-range; enforce
    steps = np.diff(off)
    if (steps > 1).any():
        # smooth: cumulative min walk backwards
        for idx in np.where(steps > 1)[0][::-1]:
            off[idx] = off[idx + 1] - 1
    return off.astype(np.int32)


def banded_nw(q, t, q_lens, t_lens, offsets, band: int,
              score_dtype: str = "int32", packed: bool = False):
    """Plain batched banded edit-distance DP.

    q, t: [B, edge] int8 codes (PAD beyond length), or [B, edge / 4]
    uint8 2-bit packed when `packed` (encode.pack_2bit; PAD restored
    from the lengths); q_lens, t_lens: [B] int32; offsets: [B, n_waves]
    int32 band starts. `score_dtype` 'int16' stores the wavefronts as
    int16 with the sentinel INF16 (legal only under
    dtypes.aligner_int16_ok). Returns (bp [B, n_waves, band] int8
    backpointers, dist [B] distance at (M, N), at the score dtype; the
    sentinel where (M, N) lies outside the band). Wavefronts run to the
    batch's largest m + n; rows past a lane's own m + n are never read by
    its traceback.
    """
    dev = q.device
    if packed:
        q = unpack_2bit(q, q.shape[1] * 4, q_lens)
        t = unpack_2bit(t, t.shape[1] * 4, t_lens)
    B, edge = q.shape
    n_waves = offsets.shape[1]
    i32, i64 = torch.int32, torch.int64
    dt = torch.int16 if score_dtype == "int16" else i32
    big = INF16 if score_dtype == "int16" else INF
    inf = torch.tensor(big, dtype=dt, device=dev)
    ks = torch.arange(band, dtype=i64, device=dev)
    ql = q_lens.to(i64)[:, None]
    tl = t_lens.to(i64)[:, None]
    offs = offsets.to(i64)
    q = q.to(i32)
    t = t.to(i32)
    s1 = torch.full((B, band), big, dtype=dt, device=dev)
    s2 = s1.clone()
    a1 = torch.zeros(B, dtype=i64, device=dev)
    a2 = a1.clone()
    dist = torch.full((B,), big, dtype=dt, device=dev)
    bp = torch.zeros((B, n_waves, band), dtype=torch.int8, device=dev)
    last = min(int((q_lens.to(i64) + t_lens.to(i64)).max()) if B else -1,
               n_waves - 1)

    def gather(s, idx):
        ok = (idx >= 0) & (idx < band)
        return torch.where(ok, torch.gather(s, 1, idx.clamp(0, band - 1)),
                           inf)

    for d in range(last + 1):
        a0 = offs[:, d]
        i = a0[:, None] + ks[None, :]              # [B, band] query row
        j = d - i                                  # target col
        valid = (i >= 0) & (i <= ql) & (j >= 0) & (j <= tl)
        k1 = ks[None, :] + (a0 - a1)[:, None]      # (d-1, i) in s1
        k2m = ks[None, :] + (a0 - a2)[:, None] - 1  # (d-2, i-1) in s2
        up = torch.where(i >= 1, gather(s1, k1 - 1), inf)
        left = torch.where(j >= 1, gather(s1, k1), inf)
        diag = torch.where((i >= 1) & (j >= 1), gather(s2, k2m), inf)
        qi = torch.gather(q, 1, (i - 1).clamp(0, edge - 1))
        tj = torch.gather(t, 1, (j - 1).clamp(0, edge - 1))
        sub = (qi != tj).to(i32)
        cd = diag + sub
        cu = up + 1
        cl = left + 1
        # fixed tie order: diag, up, left
        score = cd
        code = torch.zeros((B, band), dtype=torch.int8, device=dev)
        code = torch.where(cu < score, BP_UP, code).to(torch.int8)
        score = torch.minimum(score, cu)
        code = torch.where(cl < score, BP_LEFT, code).to(torch.int8)
        score = torch.minimum(score, cl)
        score = torch.where((i == 0) & (j == 0), 0, score)
        score = torch.where(valid, torch.minimum(score, inf), inf).to(dt)
        at_end = (i == ql) & (j == tl)
        dist = torch.where(at_end.any(dim=1),
                           torch.where(at_end, score, inf).amin(dim=1), dist)
        bp[:, d] = code
        s2, s1 = s1, score
        a2, a1 = a1, a0
    return bp, dist


def traceback(bp, dist, offsets, q_lens, t_lens, band: int):
    """Plain lane-parallel traceback from (M, N) to (0, 0). Returns (ops
    [B, n_waves] int32 codes in traceback order, meta [B, 3] int32 =
    (count, dist, touched)) — the kernel's outputs. A lane whose path
    rides the band boundary (where the matrix continues past it) is
    flagged touched: its in-band optimum may have been clipped."""
    dev = bp.device
    B, n_waves = offsets.shape
    i64 = torch.int64
    ql = q_lens.to(i64)
    tl = t_lens.to(i64)
    offs = offsets.to(i64)
    i, j = ql.clone(), tl.clone()
    ops = torch.zeros((B, n_waves), dtype=torch.int32, device=dev)
    cnt = torch.zeros(B, dtype=i64, device=dev)
    touched = torch.zeros(B, dtype=torch.bool, device=dev)
    lanes = torch.arange(B, device=dev)
    while True:
        active = (i > 0) | (j > 0)
        if not bool(active.any()):
            break
        d = i + j
        dc = d.clamp(max=n_waves - 1)
        off = torch.gather(offs, 1, dc[:, None])[:, 0]
        k = i - off
        row_lo = (d - tl).clamp(min=0)
        row_hi = torch.minimum(d, ql)
        touched |= active & (k <= 0) & (off > row_lo)
        touched |= active & (k >= band - 1) & (off + band - 1 < row_hi)
        code = bp[lanes, dc, k.clamp(0, band - 1)].to(i64)
        # boundary overrides: on i==0 only D possible; on j==0 only I
        code = torch.where(i == 0, BP_LEFT, code)
        code = torch.where(j == 0, BP_UP, code)
        live = lanes[active]
        ops[live, cnt[live]] = code[live].to(torch.int32)
        cnt = cnt + active.to(i64)
        i = torch.where(active & (code != BP_LEFT), i - 1, i)
        j = torch.where(active & (code != BP_UP), j - 1, j)
    meta = torch.stack([cnt, dist.to(i64), touched.to(i64)], dim=1)
    return ops, meta.to(torch.int32)


#: the CIGAR op byte of each backpointer code (BP_DIAG, BP_UP, BP_LEFT)
_OP_BYTES = np.frombuffer(b"MID", dtype=np.uint8)


def run_arrays(seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Forward-order op codes -> the path's runs as (op bytes, lengths):
    uint8 `M` / `I` / `D` and int64, the arrays utils/cigar.parse_cigar
    gives for the path's CIGAR."""
    starts = np.flatnonzero(np.diff(seq, prepend=-1))
    return _OP_BYTES[seq[starts]], np.diff(starts, append=len(seq))


def run_list(runs: tuple[np.ndarray, np.ndarray]) -> list[tuple[int, str]]:
    """Run arrays (run_arrays) -> CIGAR-style run list."""
    ops, lens = runs
    return [(int(n), chr(op)) for op, n in zip(ops, lens)]


def runs_of(seq: np.ndarray) -> list[tuple[int, str]]:
    """Forward-order op codes -> CIGAR-style run list."""
    return run_list(run_arrays(seq))


class BatchAligner:
    """Buckets (query, target) pairs into static shapes and aligns each
    bucket on the device — the orchestration analogue of
    CUDABatchAligner (src/cuda/cudaaligner.cpp).

    band_width=0 means auto: 10% of the bucket's mean pair length (the
    reference's auto band rule, cudapolisher.cpp:158-174), rounded up to
    a multiple of 128.

    Rejects mirror cudaaligner's statuses (cudaaligner.cpp:63-71): pairs
    beyond the largest bucket edge within `max_length` (the cudaaligner
    max-length envelope, cudaaligner.cpp:63-68; 65536 admits every
    bucket), or empty, pairs whose traceback rode the
    band boundary, and pairs whose in-band cost is
    beyond what a <=30%-error overlap can produce come back as None, and
    the caller aligns them on the host — no overlap is ever dropped. Each
    reject is counted.

    Each (edge, band) runs at the score dtype `score_dtype` resolves to
    under the bucket's overflow proof (dtypes.resolve_dtype), and a
    batch whose bases are all ACGT on both sides ships 2-bit packed
    unless `pack_bases` is False. Batches and pairs are counted per
    (dtype, packed).

    `scheduler` (sched.BatchScheduler; a non-adaptive one when omitted)
    derives the length edges from the run's pairs when adaptive and
    records every batch's occupancy; `runner` (parallel/mesh.BatchRunner;
    one lane on `device` when omitted) splits each batch over its lanes.
    `autotuner` (sched/autotune.Autotuner, or None) is the winner table
    consulted under the `auto` posture, once per (edge, band): engine
    "aligner", params ().
    """

    #: length bucket edges (sequences are padded to the bucket edge)
    BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
    #: bytes of int8 backpointer plane per device batch
    MAX_BP_BYTES = 2 << 30

    def __init__(self, band_width: int = 0,
                 device: str | torch.device = "cuda",
                 score_dtype: str = "auto", pack_bases: bool = True,
                 scheduler=None, runner=None, autotuner=None,
                 max_length: int | None = None):
        from ..parallel.mesh import BatchRunner
        from ..sched import BatchScheduler

        self.band_width = band_width
        #: the length envelope (the reference's cudaaligner max length,
        #: cudaaligner.cpp:63-68; by default the largest bucket edge): a
        #: pair longer than the largest bucket edge within it is aligned
        #: on the host
        self.max_length = self.BUCKETS[-1] if max_length is None \
            else max_length
        self.device = resolve(device)
        resolve_dtype(True, score_dtype)  # reject an unknown posture now
        self.score_dtype = score_dtype
        self.pack_bases = pack_bases
        self.autotuner = autotuner
        #: the score dtype per (edge, band), resolved once
        self._plans: dict[tuple[int, int], str] = {}
        self.sched = (scheduler if scheduler is not None
                      else BatchScheduler())
        self.runner = (runner if runner is not None
                       else BatchRunner([self.device]))
        #: pairs sent back for host alignment, by reason
        self.n_unbucketed = 0
        self.n_band_rejects = 0
        #: device batches and their pairs per (score dtype, packed)
        self.batches_by_plan: dict[tuple[str, bool], int] = {}
        self.pairs_by_plan: dict[tuple[str, bool], int] = {}

    def plan_for(self, edge: int, band: int) -> str:
        """The score dtype of bucket (edge, band) under this aligner's
        posture and winner table (dtypes.kernel_plan), resolved once a
        bucket."""
        plan = self._plans.get((edge, band))
        if plan is None:
            plan = self._plans[(edge, band)] = kernel_plan(
                self.score_dtype, self.autotuner, "aligner", (edge, band),
                (), aligner_int16_ok(edge), self.device.type)
        return plan

    @classmethod
    def batch_cap(cls, edge: int, band: int) -> int:
        """The most pairs one batch of (edge, band) holds: its int8
        backpointer plane within MAX_BP_BYTES."""
        return cls.MAX_BP_BYTES // ((2 * edge + 1) * band)

    def _bucket_of(self, length: int) -> int | None:
        return next((edge for edge in self.BUCKETS
                     if length <= edge <= self.max_length), None)

    @staticmethod
    def _auto_band(mean_len: float) -> int:
        """The auto band rule: 10% of the mean pair length, rounded up to
        a multiple of 128."""
        return max(128, (int(mean_len * 0.1) + 127) // 128 * 128)

    @classmethod
    def auto_bands(cls, edge: int) -> list[int]:
        """Every band the auto rule can give a batch of static bucket
        `edge`: its pairs' mean length lies above the previous edge and
        at most `edge`. The keys the autotuner profiles for the aligner."""
        prev = max((e for e in cls.BUCKETS if e < edge), default=0)
        return list(range(cls._auto_band(prev),
                          cls._auto_band(edge) + 128, 128))

    def _band_for(self, pairs, idxs) -> int:
        if self.band_width > 0:
            return (self.band_width + 3) // 4 * 4
        mean_len = sum(max(len(pairs[i][0]), len(pairs[i][1]))
                       for i in idxs) / len(idxs)
        return self._auto_band(mean_len)

    def _split(self, pairs) -> tuple[list, list[int]]:
        """(edge, band, pair indices) device batches in dispatch order,
        and the unbucketable pairs (beyond the largest bucket, or
        empty). The JAX aligner's chunk loop
        (racon_tpu/ops/align.py:365-465)."""
        def shape_of(idx: int) -> int:
            return max(len(pairs[idx][0]), len(pairs[idx][1]))

        # device eligibility and the AUTO band are ALWAYS decided by the
        # static ladder, adaptive mode included. The band is algorithmic,
        # not padding — it changes which equal-cost path the banded DP
        # can see — so it must not move when the scheduler regroups jobs;
        # pinning both to the static rule makes scheduler-on vs -off
        # byte-identity structural, not a fixture property.
        static_groups: dict[int, list[int]] = {}
        unbucketed: list[int] = []
        for idx, (qs, ts) in enumerate(pairs):
            edge = self._bucket_of(max(len(qs), len(ts)))
            if edge is None or not qs or not ts:
                unbucketed.append(idx)
                continue
            static_groups.setdefault(edge, []).append(idx)
        band_of: dict[int, int] = {}
        for edge, idxs in static_groups.items():
            band = self._band_for(pairs, idxs)
            for i in idxs:
                band_of[i] = band

        # regroup by (edge, band). Static mode: one band per bucket.
        # Adaptive mode: a sub-ladder INSIDE each occupied static bucket
        # (the launch-shape budget K = len(BUCKETS) split across buckets
        # by job count), so jobs move to a tighter edge but keep their
        # static band — the per-lane DP (band + offsets) is identical,
        # only the wavefront count shrinks. Static edges are multiples
        # of the ladder quantum, so a derived edge never exceeds its
        # static bucket's.
        groups: dict[tuple[int, int], list[int]] = {}
        if self.sched.adaptive and static_groups:
            k_of = {edge: 1 for edge in static_groups}
            spare = len(self.BUCKETS) - len(static_groups)
            by_load = sorted(static_groups,
                             key=lambda e: -len(static_groups[e]))
            i = 0
            while spare > 0:
                k_of[by_load[i % len(by_load)]] += 1
                spare -= 1
                i += 1
            for edge, idxs in static_groups.items():
                sub = self.sched.aligner_ladder(
                    [shape_of(i) for i in idxs], k=k_of[edge],
                    max_length=self.max_length) or (edge,)
                for i in idxs:
                    e = next((x for x in sub if x >= shape_of(i)), edge)
                    groups.setdefault((e, band_of[i]), []).append(i)
        else:
            for edge, idxs in static_groups.items():
                for i in idxs:
                    groups.setdefault((edge, band_of[i]), []).append(i)

        from ..sched import shard_interleave

        out = []
        n_dev = self.runner.n_devices
        for (edge, band), idxs in sorted(groups.items()):
            # sorted packing: shape-homogeneous batches (results land by
            # original index); identity when the scheduler is off
            idxs = self.sched.order(idxs, key=shape_of)
            max_lanes = max(n_dev, self.batch_cap(edge, band))
            if n_dev > 1:
                # lane-aware chunking: BODY batches are multiples of the
                # lane count (rows interleaved so each lane carries an
                # even share of the sorted lengths) and the remainder
                # runs as its own batch on a sub-runner (for_batch)
                # instead of padding whole lanes up to the full count
                stride = max(n_dev, (max_lanes // n_dev) * n_dev)
                body = (len(idxs) // n_dev) * n_dev
                for s in range(0, body, stride):
                    part = idxs[s:s + min(stride, body - s)]
                    out.append((edge, band, shard_interleave(part, n_dev)))
                if body < len(idxs):
                    out.append((edge, band, idxs[body:]))
            else:
                for s in range(0, len(idxs), max_lanes):
                    out.append((edge, band, idxs[s:s + max_lanes]))
        return out, unbucketed

    def chunks(self, pairs) -> list[tuple[int, int, list[int]]]:
        """(edge, band, pair indices) device batches, in dispatch order
        (what align() dispatches); unbucketable pairs are left out."""
        return self._split(pairs)[0]

    def host_operands(self, pairs, edge: int, band: int, idx: list[int],
                      pack: bool | None = None, lanes: int | None = None):
        """Host tensors (q, t, q_lens, t_lens, offsets) for one batch,
        pinned when the aligner's device is a card, padded with one-base
        pairs up to `lanes` rows. q and t are 2-bit packed uint8 (the
        kernel's packed form) when `pack` is True, int8 codes when False;
        None packs when `pack_bases` is on and both sides are all
        ACGT."""
        from .encode import encode_padded, pack_2bit, packable

        n_waves = 2 * edge + 1
        pad = [b"A"] * ((lanes or len(idx)) - len(idx))
        q_arr, q_lens = encode_padded([pairs[i][0] for i in idx] + pad, edge)
        t_arr, t_lens = encode_padded([pairs[i][1] for i in idx] + pad, edge)
        offs = np.stack([band_offsets(int(a), int(b), band, n_waves)
                         for a, b in zip(q_lens, t_lens)])
        if pack is None:
            pack = (self.pack_bases and packable(q_arr, q_lens)
                    and packable(t_arr, t_lens))
        if pack:
            q_arr, t_arr = pack_2bit(q_arr), pack_2bit(t_arr)
        out = []
        for x in (q_arr, t_arr, q_lens, t_lens, offs):
            x = torch.from_numpy(np.ascontiguousarray(x))
            if self.device.type == "cuda":
                x = x.pin_memory()
            out.append(x)
        return tuple(out)

    def operands(self, pairs, edge: int, band: int, idx: list[int],
                 pack: bool | None = None):
        """host_operands' tensors copied to the aligner's device,
        asynchronously on the current stream."""
        from ..parallel.mesh import BatchRunner

        return tuple(BatchRunner.place(x, self.device)
                     for x in self.host_operands(pairs, edge, band, idx,
                                                 pack))

    def align(self, pairs: list[tuple[bytes, bytes]], progress=None,
              pipeline=None,
              on_reject=None
              ) -> list[tuple[np.ndarray, np.ndarray] | None]:
        """Globally align each (query, target) pair. Returns per pair its
        path's runs as (op bytes, lengths) arrays (run_arrays), or None
        for a rejected pair (see class docstring).

        `pipeline` (pipeline.DispatchPipeline) overlaps the host stages
        with the device: `pack` builds a batch's operands and (one lane)
        starts their copies to the card, `dispatch` launches K2 through
        the runner (several lanes: each lane's shard copied and launched
        on its own stream, the outputs concatenated in lane order) and
        the copies back (on the caller's thread, where the launch, plan
        and occupancy counters are bumped), `wait` blocks on the batch's
        event, and `unpack` decodes the runs and applies the reject
        test. On a card each
        batch in flight runs on its own stream, from a pool of depth + 2
        (one stream would serialise every stage); its tensors are
        allocated on that stream. Omitted, the stages run synchronously
        (depth 0). `on_reject(idx_list)` fires as soon as pairs are known
        to need the host aligner: unbucketable pairs up front, band-
        clipped pairs per batch as it is decoded. Results land by
        original index.
        """
        import functools
        import time

        from ..parallel.mesh import concat
        from ..pipeline import DispatchPipeline
        from .align_kernels import wavefront_align
        from .device_program import shard_useful_split

        pl = pipeline if pipeline is not None else DispatchPipeline(depth=0)
        results: list[tuple[np.ndarray, np.ndarray] | None] = \
            [None] * len(pairs)
        chunks, unbucketed = self._split(pairs)
        self.n_unbucketed += len(unbucketed)
        if on_reject is not None and unbucketed:
            on_reject(unbucketed)
        streams = ([torch.cuda.Stream(self.device)
                    for _ in range(pl.depth + 2)]
                   if self.device.type == "cuda" else None)
        runner = self.runner
        kernel = "cuda" if self.device.type == "cuda" else "plain"

        def on_stream(i):
            if streams is None:
                return contextlib.nullcontext()
            return torch.cuda.stream(streams[i % len(streams)])

        def pack(chunk):
            i, edge, band, idx = chunk
            # a tail smaller than the lane count runs on a sub-runner
            # (for_batch) with no padding lanes; one lane: the operands'
            # copies start here, on the batch's stream
            r = runner.for_batch(len(idx))
            with trace.span("align.operands"), on_stream(i):
                args = self.host_operands(pairs, edge, band, idx,
                                          lanes=r.round_batch(len(idx)))
                if r.n_devices == 1:
                    args = tuple(r.place(x, r.devices[0]) for x in args)
            lens = np.maximum([len(pairs[j][0]) for j in idx],
                              [len(pairs[j][1]) for j in idx])
            return args, lens

        def dispatch(chunk, packed):
            i, edge, band, idx = chunk
            (q, t, q_lens, t_lens, offs), lens = packed
            dtype = self.plan_for(edge, band)
            plan = (dtype, q.dtype == torch.uint8)
            self.batches_by_plan[plan] = self.batches_by_plan.get(plan, 0) + 1
            self.pairs_by_plan[plan] = self.pairs_by_plan.get(plan,
                                                              0) + len(idx)
            r = runner.for_batch(len(idx))
            lanes, n_waves = offs.shape
            with trace.span("align.kernel"), on_stream(i):
                with trace.span("align.launch"):
                    t0 = time.perf_counter()
                    ops, meta = concat(r.run_split(
                        functools.partial(wavefront_align, band=band,
                                          score_dtype=dtype,
                                          packed=plan[1]),
                        q, t, q_lens, t_lens, offs), self.device)
                    launch_s = time.perf_counter() - t0
                with trace.span("align.account"):
                    # first-dispatch telemetry: the JAX package's key, the
                    # lane count included
                    self.sched.stats.record_compile_once(
                        "aligner", (band, n_waves, lanes, kernel, *plan),
                        launch_s)
                    # occupancy: useful DP cells = per-pair wave count x
                    # band against the batch's n_waves x band x lanes,
                    # with the lane view (per-lane useful split; what the
                    # full runner's round_batch would have dispatched)
                    row_cells = [(len(pairs[j][0]) + len(pairs[j][1]) + 1)
                                 * band for j in idx]
                    self.sched.stats.record(
                        "aligner", (edge, band), jobs=len(idx), lanes=lanes,
                        useful_cells=sum(row_cells),
                        total_cells=lanes * n_waves * band, kernel=kernel,
                        dtype=dtype, n_devices=r.n_devices,
                        shard_useful=shard_useful_split(row_cells, lanes,
                                                        r.n_devices),
                        full_mesh_cells=(runner.round_batch(len(idx))
                                         * n_waves * band))
                    pl.stats.bump("launches")
                if streams is None:
                    return ops, meta, None, lens
                with trace.span("align.readback"):
                    # the copies back, queued behind the kernel on the
                    # batch's stream, into pinned buffers
                    ops_h = torch.empty(ops.shape, dtype=ops.dtype,
                                        pin_memory=True)
                    meta_h = torch.empty(meta.shape, dtype=meta.dtype,
                                         pin_memory=True)
                    ops_h.copy_(ops, non_blocking=True)
                    meta_h.copy_(meta, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
            return ops_h, meta_h, done, lens

        def wait(handle):
            ops, meta, done, lens = handle
            if done is not None:
                done.synchronize()
            return ops.numpy(), meta.numpy(), lens

        def unpack(chunk, res):
            i, edge, band, idx = chunk
            ops, meta, lens = res
            accepted = 0
            rejected: list[int] = []
            with trace.span("align.decode"):
                for lane, i_pair in enumerate(idx):
                    count, dist, touched = (int(v) for v in meta[lane])
                    # an in-band cost far above what a <=30%-error overlap
                    # can produce means the true (off-band) path was
                    # clipped
                    if touched or dist > 0.4 * lens[lane]:
                        self.n_band_rejects += 1
                        rejected.append(i_pair)
                        continue
                    results[i_pair] = run_arrays(ops[lane, :count][::-1])
                    accepted += 1
            if on_reject is not None and rejected:
                on_reject(rejected)
            if progress is not None:
                # rejected pairs tick when the host aligns them
                progress(accepted)

        pl.run([(i, *c) for i, c in enumerate(chunks)], pack, dispatch,
               wait, unpack, label="aligner",
               describe=lambda c: {"engine": "aligner",
                                   "bucket": f"{c[1]}x{c[2]}",
                                   "jobs": len(c[3])})
        return results
