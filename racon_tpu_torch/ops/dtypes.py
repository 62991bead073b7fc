"""Score-dtype policy: per-bucket int16 eligibility proofs.

Both device kernels carry DP scores. For most buckets int32 is twice the
width the arithmetic needs: the score magnitude a bucket can produce is
bounded by its shape and the scoring params, and when that envelope
provably fits int16 the stored DP state (K1's shared-memory ring, its
spill and traceback cache; K2's shared-memory wavefronts and edge cells)
can be int16. The narrow program is only selected when overflow is
impossible, so its results are the integers the wide program computes
with the narrow sentinels.

The proofs the predicates encode:

- aligner (unit-cost edit distance, minimize, sentinel INF): every
  stored cell is min-clamped at INF each wavefront, so values live in
  [0, INF + 1]. Real path costs are bounded by the anti-diagonal index
  d <= 2*edge. With INF16 = 1 << 14, int16 is safe iff 2*edge + 1 < INF16.

- POA graph-NW (maximize, sentinel NEG): real scores are bounded by
  (N + L + 1) * mp with mp = max(|match|, |mismatch|, |gap|). There is
  no per-row clamp, so unreachable in-band cells can drift below NEG by
  at most mp per node row; intermediates add at most one more op plus
  the running-max offset of |L * gap|. With NEG16 = -(1 << 14), every
  value and intermediate fits int16 iff
  (N + L + 2) * mp <= (1 << 15) - 1 - (1 << 14) = 16383.

The posture (`--cuda-dtype`, the engines' `score_dtype`) is `auto`
(int16 wherever the proof holds, unless the autotuner's winner table
measured int32 faster for the bucket), `int32` (wide everywhere) or
`int16` (narrow wherever provable, whatever the table says). A bucket
whose proof fails always runs int32, whatever the posture.

`kernel_plan` is the one dtype decision all three engines make per
bucket, the dtype half of the JAX package's `kernel_plan`: the JAX
package consults its table under `--tpu-pallas auto`, and the port,
which has no Pallas-or-XLA choice, under `--cuda-dtype auto`.
"""

from __future__ import annotations

#: int16 sentinel magnitudes (the int32 programs keep 1 << 28 / -(1 << 29))
INF16 = 1 << 14
NEG16 = -(1 << 14)

POSTURES = ("auto", "int32", "int16")

_I16_MAX = (1 << 15) - 1


def aligner_int16_ok(edge: int) -> bool:
    """True when the banded edit-distance DP at bucket `edge` provably
    fits int16 (see module docstring)."""
    return 2 * edge + 1 < INF16


def poa_int16_ok(n_nodes: int, seq_len: int, match: int, mismatch: int,
                 gap: int) -> bool:
    """True when the graph-NW DP at bucket (n_nodes, seq_len) with these
    scoring params provably fits int16 (see module docstring)."""
    mp = max(abs(match), abs(mismatch), abs(gap))
    return (n_nodes + seq_len + 2) * mp <= _I16_MAX - INF16


def resolve_dtype(envelope_ok: bool, mode: str = "auto",
                  winner: dict | None = None) -> str:
    """The per-bucket score dtype, 'int16' or 'int32', under posture
    `mode`. `envelope_ok` is the bucket's overflow proof: False always
    means int32. `winner` is an optional autotuner entry whose measured
    `dtype` applies under the `auto` posture only."""
    if mode not in POSTURES:
        raise ValueError(f"score dtype posture {mode!r}: want one of "
                         f"{POSTURES}")
    if not envelope_ok or mode == "int32":
        return "int32"
    if mode == "auto" and winner and winner.get("dtype") in ("int16",
                                                            "int32"):
        return winner["dtype"]
    return "int16"


def kernel_plan(mode: str, autotuner, engine: str, bucket, params,
                envelope_ok: bool, backend: str) -> str:
    """The score dtype of one bucket of `engine` ('session', 'aligner'
    or 'fused'): under posture `auto` the winner table of `autotuner`
    (sched/autotune.Autotuner, or None for none) is consulted at the
    bucket's key on `backend` (the torch device type), then the dtype is
    resolved against the bucket's overflow proof."""
    ent = None
    if mode == "auto" and autotuner is not None:
        ent = autotuner.winner(engine, bucket, params, backend=backend)
    return resolve_dtype(envelope_ok, mode, ent)


def plan_split(by_plan: dict) -> str:
    """'int16 packed 12, int32 int8 3'-style text of a count per (score
    dtype, packed)."""
    return ", ".join(f"{dt} {'packed' if pk else 'int8'} {n}"
                     for (dt, pk), n in sorted(by_plan.items())) or "none"
