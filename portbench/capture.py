"""What the benchmark reads from the program while a run goes on, taken by
wrapping a few of its entry points for the life of a `Capture`:

  - per polisher run: the breaking points of every overlap it aligned
    (before initialize() clears them), with the names of its query and
    target (taken as the overlaps are loaded: the program drops them
    before it aligns), its windows (their layers, and after polish()
    their consensus), and its counters once polish() returns: phase_s,
    the pipeline's stage seconds, the aligner's and the consensus
    engine's device and host counts, and the span totals (`span_s`);
  - the path each overlap and each window took, so that the check can
    draw from every one: an aligned overlap's K2 batch class (bucket edge,
    band, score dtype) or the host aligner; a window's K1 instantiations
    (score dtype, operand form) or the host engine;
  - in a traced run (`launches=True`): each K1 (window_sweep) and K2
    (wavefront_align) launch's operation and byte counts, computed on the
    card from the launch's own inputs and read once the window has
    closed (roofline.py).

A run is keyed by the trace id a server gives its polisher, or else by the
polisher object itself. Every wrapper calls through, so each launch is the
program's own.
"""

from __future__ import annotations

import threading

from . import roofline

#: the path label of a pair or a window that the host took
HOST = "host"


class Capture:
    def __init__(self, launches: bool = False):
        self.launches = launches
        self.lock = threading.Lock()
        #: key -> {"bps": [...], "bp_paths": [...], "windows": [...],
        #: "stats": {...}}
        self.runs: dict = {}
        #: id(window) -> the labels of the paths its layers took
        self.window_paths: dict = {}
        #: what one thread's polisher or consensus call is in the middle of
        self._local = threading.local()
        #: (bytes, operations) of every K1 / K2 launch on the card
        self.k1_terms: list = []
        self.k2_terms: list = []
        self._saved: list = []
        #: optional fault of the program's output (tests and the chip
        #: readings of each fault's upper limit; never in a benchmark run)
        self.fault = None

    @staticmethod
    def key(pol):
        return pol.serve_trace_id or id(pol)

    def run_of(self, pol) -> dict:
        with self.lock:
            return self.runs.setdefault(self.key(pol), {"bps": [],
                                                         "bp_paths": [],
                                                         "windows": None,
                                                         "stats": None})

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        from racon_tpu_torch.core.polisher import Polisher
        from racon_tpu_torch.ops import align_kernels, poa_kernels
        from racon_tpu_torch.ops.align import BatchAligner
        from racon_tpu_torch.ops.poa import BatchPOA
        from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA

        cap = self
        local = self._local

        def breaking_points(orig):
            def wrapped(pol, overlaps):
                # the pairs the aligner gets, in its order (the program's
                # own selection), so that each can be given its path
                local.need = [o for o in overlaps
                              if not o.cigar and o.is_valid
                              and pol._range_keeps(o)]
                local.pair_path = {}
                try:
                    orig(pol, overlaps)
                finally:
                    need, local.need = local.need, None
                path_of = {id(o): local.pair_path.get(i, HOST)
                           for i, o in enumerate(need)}
                if cap.fault == "bp_shift":
                    for o in overlaps:
                        if o.breaking_points is not None and len(
                                o.breaking_points):
                            o.breaking_points[:, 1] += 1
                            o.breaking_points[:, 3] += 1
                kept = [o for o in overlaps if o.breaking_points is not None]
                run = cap.run_of(pol)
                names = run["names"]
                rows = [(names[o.q_id], names[o.t_id], bool(o.strand),
                         o.q_begin, o.q_end, o.q_length, o.t_begin, o.t_end,
                         o.breaking_points.copy()) for o in kept]
                run["bps"] = rows
                run["bp_paths"] = [path_of.get(id(o), "cigar") for o in kept]
            return wrapped

        def load_overlaps(orig):
            def wrapped(pol, *a, **kw):
                overlaps = orig(pol, *a, **kw)
                # each sequence's name, by the id the overlaps now carry:
                # the polisher drops the overlaps' names as it resolves
                # them, and a read's own name before it aligns
                cap.run_of(pol)["names"] = [s.name for s in pol.sequences]
                return overlaps
            return wrapped

        def split(orig):
            def wrapped(aligner, pairs):
                chunks, unbucketed = orig(aligner, pairs)
                paths = getattr(local, "pair_path", None)
                if paths is not None:
                    for edge, band, idx in chunks:
                        label = (f"k2 {edge}x{band} "
                                 f"{aligner.plan_for(edge, band)}")
                        for i in idx:
                            paths[i] = label
                    for i in unbucketed:
                        paths[i] = HOST
                return chunks, unbucketed
            return wrapped

        def align(orig):
            def wrapped(aligner, pairs, progress=None, pipeline=None,
                        on_reject=None):
                paths = getattr(local, "pair_path", None)
                if on_reject is not None and paths is not None:
                    inner = on_reject

                    def on_reject(idxs):
                        for i in idxs:
                            paths[i] = HOST
                        inner(idxs)
                return orig(aligner, pairs, progress=progress,
                            pipeline=pipeline, on_reject=on_reject)
            return wrapped
        def initialize(orig):
            def wrapped(pol):
                orig(pol)
                if cap.fault == "layers_half":
                    for w in pol.windows:
                        for field in ("sequences", "qualities", "positions"):
                            got = getattr(w, field)
                            setattr(w, field, got[:1] + got[1::2])
                cap.run_of(pol)["windows"] = list(pol.windows)
            return wrapped

        def polish(orig):
            def wrapped(pol, *a, **kw):
                out = orig(pol, *a, **kw)
                if cap.fault == "stitch_altered":
                    for seq in out:
                        seq.data = alter(seq.data)
                poa = pol.poa
                run = cap.run_of(pol)
                with cap.lock:
                    run["window_paths"] = [
                        cap.window_paths.pop(id(w), set())
                        for w in run["windows"] or ()]
                run["stats"] = {
                    "phase_s": dict(pol.phase_s),
                    "stages": dict(pol.stage_stats),
                    "pairs": pol.n_aligner_pairs,
                    "device_pairs": pol.n_aligner_device,
                    "host_pairs": pol.n_aligner_host_fallback,
                    "windows": len(run["windows"] or ()),
                    "poa_host": getattr(poa, "n_host", 0),
                    "poa_device": getattr(poa, "n_device", 0),
                    "poa_backbone": getattr(poa, "n_backbone", 0),
                    "span_s": dict(getattr(pol, "span_s", {}))}
                return out
            return wrapped

        def consensus(orig):
            def wrapped(poa, windows, trim):
                todo = [w for w in windows if len(w.sequences) >= 3]
                local.session = None
                orig(poa, windows, trim)
                got, local.session = local.session, None
                if got is not None and len(got[1]) == len(todo):
                    plans, statuses = got
                    with cap.lock:
                        for i, w in enumerate(todo):
                            cap.window_paths[id(w)] = (
                                {HOST} if statuses[i] == 1 else
                                {f"k1 {dt} {'packed' if pk else 'int8'}"
                                 for dt, pk in plans.get(i, ())})
                if cap.fault in ("unchanged", "half", "altered"):
                    plant(cap.fault, windows)
            return wrapped

        def session_consensus(orig):
            def wrapped(engine, windows):
                local.plans = {}
                results, statuses = orig(engine, windows)
                local.session = (local.plans, statuses)
                return results, statuses
            return wrapped

        def session_dispatch(orig):
            def wrapped(engine, jobs, sel, nb, lb, B):
                before = dict(engine.batches_by_plan)
                out = orig(engine, jobs, sel, nb, lb, B)
                plans = getattr(local, "plans", None)
                if plans is not None:
                    new = {k for k, n in engine.batches_by_plan.items()
                           if n > before.get(k, 0)}
                    for win in jobs["win"][sel]:
                        plans.setdefault(int(win), set()).update(new)
                return out
            return wrapped

        def window_sweep(orig):
            def wrapped(*args, **kw):
                out = orig(*args, **kw)
                if args[0].is_cuda:
                    packed = args[-1] if len(args) > 12 else kw.get("packed")
                    seq = args[4]
                    L = seq.shape[1] * (4 if packed else 1)
                    with cap.lock:
                        cap.k1_terms.append(
                            roofline.window_sweep_terms(args[:8], L))
                return out
            return wrapped

        def wavefront_align(orig):
            def wrapped(q, t, q_lens, t_lens, offs, band, *a, **kw):
                ops, meta = orig(q, t, q_lens, t_lens, offs, band, *a, **kw)
                if q.is_cuda:
                    packed = kw.get("packed", a[1] if len(a) > 1 else False)
                    with cap.lock:
                        cap.k2_terms.append(roofline.wavefront_terms(
                            q_lens, t_lens, offs, band, meta[:, 0], packed))
                return ops, meta
            return wrapped

        self._patch(Polisher, "find_overlap_breaking_points", breaking_points)
        self._patch(Polisher, "_load_overlaps", load_overlaps)
        self._patch(Polisher, "initialize", initialize)
        self._patch(Polisher, "polish", polish)
        self._patch(BatchPOA, "_generate_consensus", consensus)
        self._patch(BatchAligner, "_split", split)
        self._patch(BatchAligner, "align", align)
        self._patch(DeviceGraphPOA, "consensus", session_consensus)
        self._patch(DeviceGraphPOA, "_dispatch", session_dispatch)
        if self.launches:
            self._patch(poa_kernels, "window_sweep", window_sweep)
            self._patch(align_kernels, "wavefront_align", wavefront_align)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []
        return False

    def bounds_ms(self) -> dict:
        """Summed least time (ms) and launch count of K1 and K2 over the
        launches counted; waits for the card once."""
        out = {}
        for name, terms in (("k1", self.k1_terms), ("k2", self.k2_terms)):
            total = 0.0
            for nbytes, ops in terms:
                total += roofline.bound(float(nbytes), float(ops))[0]
            out[name] = (total, len(terms))
        return out


#: the faults a run can plant (`--fault`), each where the program produces
#: what it alters: the consensus (`unchanged`: every window keeps its draft;
#: `half`: every other window of each consensus batch is left out, its
#: draft standing; `altered`: one base of each consensus changed), the
#: windows' layers (`layers_half`: every other layer of each window left
#: out), the breaking points (`bp_shift`: each moved one base along the
#: read) and the stitched output (`stitch_altered`: one base of each
#: returned sequence changed)
FAULTS = ("unchanged", "half", "altered", "layers_half", "bp_shift",
          "stitch_altered")


def alter(data: bytes) -> bytes:
    """`data` with its middle base changed."""
    if not data:
        return data
    k = len(data) // 2
    return data[:k] + (b"A" if data[k:k + 1] != b"A" else b"C") + data[k + 1:]


def plant(fault: str, windows) -> None:
    """A consensus fault (see FAULTS) on a batch of finished windows."""
    for i, w in enumerate(windows):
        if fault == "unchanged" or (fault == "half" and i % 2):
            w.consensus = w.sequences[0]
        elif fault == "altered":
            w.consensus = alter(w.consensus)
