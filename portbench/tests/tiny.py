"""Tiny cells for the CPU tests: a temporary copy of portbench/ with a
configuration, a traffic mix and a cell of its own, run in-process on the
CPU (the harness's look for a card skipped)."""

from __future__ import annotations

import argparse
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)

LIMITS = {"bp_excess": 0, "layer_mismatch": 0, "window_mismatch": 0,
          "stitch_mismatch": 0}


def copy(tmp_path, device_engines: bool = False) -> str:
    """portbench/ copied under tmp_path, with three tiny cells: tiny.contig
    (range shards of a 6 kb contig at 10x), tiny.reads (read correction,
    12,000-base chunks of the same reads, about 8 reads each, against
    their dual all-vs-all PAF)
    and tiny.serve (three clients against an in-process server, a pool of
    four 5 kb datasets). The
    port's host engines run them unless `device_engines` (the kernels'
    plain versions on the CPU: slower)."""
    base = str(tmp_path / "portbench")
    shutil.copytree(PORTBENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    lengths = {"median": 1500, "sigma": 0.4, "min": 800, "max": 3000}
    flag = 1 if device_engines else 0
    for name, src, extra in (
            ("tiny", "ecoli_ont30x", {"genome_length": 6000, "coverage": 10}),
            ("tinyl", "lambda_ont", {"genome_length": 5000, "reads": 30})):
        with open(os.path.join(base, "configs", f"{src}.json")) as fh:
            cfg = json.load(fh)
        cfg.update(name=name, read_length=lengths, **extra)
        cfg["device"].update(cuda_poa_batches=flag, cuda_aligner_batches=flag)
        write(base, "configs", name, cfg)
    write(base, "traffic", "tinyc", {
        "driver": "shards", "shard_windows": 4, "warmup_windows": 2,
        "metric": "polish_windows_per_s", "unit": "windows/s",
        "suffix": "polish"})
    write(base, "traffic", "tinys", {
        "driver": "served", "clients": 3, "pool": 4,
        "metric": "served_jobs_per_s", "unit": "jobs/s", "suffix": "serve"})
    write(base, "cells", "tiny.contig", {
        "config": "tiny", "traffic": "tinyc", "chips": 1,
        "check": {"windows": 4, "overlaps": 6, "limits": LIMITS}})
    write(base, "traffic", "tinyr", {
        "driver": "fragments", "split_bytes": 12000, "warmup_targets": 3,
        "min_shared_bp": 500, "metric": "polish_windows_per_s",
        "unit": "windows/s", "suffix": "polish"})
    write(base, "cells", "tiny.reads", {
        "config": "tiny", "traffic": "tinyr", "chips": 1,
        "check": {"windows": 4, "overlaps": 6, "limits": LIMITS}})
    write(base, "cells", "tiny.serve", {
        "config": "tinyl", "traffic": "tinys", "chips": 1,
        "check": {"windows": 4, "overlaps": 6,
                  "limits": LIMITS}})
    return base


def write(base: str, kind: str, name: str, obj) -> None:
    with open(os.path.join(base, kind, f"{name}.json"), "w") as fh:
        json.dump(obj, fh)


def args(workload: str, seconds: float = 1.5, trace: int = 0,
         seed: int = 2**31 + 17, control=None, fault=None):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace, control=control, fault=fault,
                              power_limit="none (CPU)")


def run(base: str, *a, **kw):
    import torch

    from portbench import run as harness

    torch.set_num_threads(2)
    return harness.run(args(*a, **kw), device="cpu", base=base)
