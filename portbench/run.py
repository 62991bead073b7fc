"""The benchmark of racon_tpu_torch on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

finds the cell's file (cells/<cell>.json), its configuration
(configs/<config>.json), its traffic mix (traffic/<traffic>.json) and the
mix's driver (drivers/<driver>.py) by name; the driver also gives the
check each job's inputs. With --trace 1 it also reads every per-layer
metric that a reader under metrics/ gives for the mix's suffix. It makes
its data from the seed, warms up, measures for --seconds, checks what the
window produced against the plain reference (check.py) and prints one
JSON line last on standard output. Set-up's parts go to standard error as
they end; the numbers the check compared go there last, each beside its
limit.

It exits with 3, printing no result, without a CUDA device, and with 4 if
the process loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "racon_tpu")


def process_start() -> float:
    """This process's start on the wall clock (from /proc)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/stat") as fh:
        btime = next(int(line.split()[1]) for line in fh
                     if line.startswith("btime"))
    return btime + int(fields[19]) / ticks


T_START = process_start()


def stamp(what: str) -> None:
    print(f"[portbench] {what}: {time.time() - T_START:.3f} s after the "
          f"process started", file=sys.stderr, flush=True)


def load_json(kind: str, name: str, base: str = HERE) -> dict:
    path = os.path.join(base, kind, f"{name}.json")
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers(base: str, suffix: str) -> dict:
    """metric name -> reader module, for every reader under metrics/ that
    serves this suffix."""
    out = {}
    folder = os.path.join(base, "metrics")
    for fn in sorted(os.listdir(folder)):
        if not fn.endswith(".py") or fn.startswith("_"):
            continue
        mod = load_module(os.path.join(folder, fn), f"portbench_metric_{fn[:-3]}")
        if suffix in mod.SUFFIXES:
            out[f"{fn[:-3]}.{suffix}"] = mod
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return got.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Context:
    """What a driver and the readers see of the run."""

    def __init__(self, seed, config, traffic, workdir, device):
        self.seed = seed
        self.config = config
        self.traffic = traffic
        self.workdir = workdir
        self.device = device
        build = os.path.join(ROOT, "build", "portbench")
        os.makedirs(build, exist_ok=True)
        #: a winner table that never exists: every run dispatches cold,
        #: and none reads the user's ~/.cache
        self.autotune_table = os.path.join(build, "autotune_cold.json")
        self.capture = None


def run(args, device: str = "cuda", base: str = HERE) -> tuple[dict, list]:
    """One run of a cell: returns (the result line's object, the numbers
    the check compared)."""
    from portbench import capture as capture_mod
    from portbench import check as check_mod

    cell = load_json("cells", args.workload, base)
    config = load_json("configs", cell["config"], base)
    traffic = load_json("traffic", cell["traffic"], base)
    driver_mod = load_module(os.path.join(base, "drivers",
                                          f"{traffic['driver']}.py"),
                             f"portbench_driver_{traffic['driver']}")
    import torch

    workdir = tempfile.mkdtemp(prefix="portbench_")
    ctx = Context(args.seed, config, traffic, workdir, device)
    drv = driver_mod.Driver(ctx)
    cap = capture_mod.Capture(launches=bool(args.trace))
    cap.fault = getattr(args, "fault", None)
    ctx.capture = cap
    try:
        with cap:
            drv.prepare()
            stamp("set-up, data")
            import racon_tpu_torch  # noqa: F401
            from racon_tpu_torch import _build
            from racon_tpu_torch import native

            if device == "cuda":
                _build.kernels()
            native.load()
            stamp("set-up, libraries")
            drv.warmup()
            cap.runs.clear()
            cap.k1_terms.clear()
            cap.k2_terms.clear()
            stamp("set-up, warm-up")
            setup_s = time.time() - T_START
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            trace = None
            if args.trace:
                from portbench.devtrace import DeviceTrace

                with DeviceTrace(device) as dt:
                    jobs, t0 = drv.window(args.seconds)
                trace = dt
            else:
                cpu0 = os.times()
                jobs, t0 = drv.window(args.seconds)
                cpu1 = os.times()
                print(f"[portbench] window: {cpu1.elapsed - cpu0.elapsed:.3f} "
                      f"s wall, process CPU {cpu1.user - cpu0.user:.3f} s user "
                      f"+ {cpu1.system - cpu0.system:.3f} s system, "
                      f"{torch.get_num_threads()} torch threads",
                      file=sys.stderr)
            t_end = max(j["t1"] for j in jobs)
            stamp(f"window closed ({len(jobs)} jobs)")
            walls = [round(j["t1"] - j["t0"], 3) for j in jobs]
            print(f"[portbench] job walls, s: {walls}", file=sys.stderr)
            peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                    else 0)
            batcher = {"before": getattr(drv, "before", {}),
                       "after": getattr(drv, "after", {})}
            reduced = trace.reduce() if trace is not None else None
            bounds = cap.bounds_ms() if args.trace else None
    finally:
        drv.close()
        shutil.rmtree(workdir, ignore_errors=True)

    if device == "cuda":
        torch.cuda.empty_cache()
    finished = [j for j in jobs if j["ok"]]
    inputs = drv.inputs(finished)
    control = getattr(args, "control", None)
    correct, numbers = check_mod.check(finished, inputs, config,
                                       cell["check"], args.seed)
    if control is not None:
        # the control's reading beside the sound one, on the same jobs
        for n, v, lim in numbers:
            print(f"[portbench] sound check {n}: {v} (limit {lim})",
                  file=sys.stderr)
        correct, numbers = check_mod.check(finished, inputs, config,
                                           cell["check"], args.seed,
                                           control=control)
    stamp("check")
    failed = sum(1 for j in jobs if not j["ok"])
    for j in jobs:
        if not j["ok"]:
            print(f"[portbench] job failed: {j['error']}", file=sys.stderr)
    correct = correct and failed == 0

    metrics = {}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(jobs), "failed": failed}
    view = {"jobs": jobs, "t0": t0, "t_end": t_end, "trace": reduced,
            "bounds": bounds, "peak_bytes": peak, "batcher": batcher,
            "power_limit": getattr(args, "power_limit", "unknown")}
    if not args.trace:
        metrics[traffic["metric"]] = {"value": drv.rate(jobs, t0),
                                      "unit": traffic["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        for name, mod in readers(base, traffic["suffix"]).items():
            value = mod.read(view)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        device_info["busy_s"] = reduced["busy_s"]
        device_info["window_s"] = reduced["window_s"]
        result["breakdown"] = reduced["breakdown"]
        for k, (s, n) in reduced["kernels"].items():
            b_ms, b_n = bounds.get(k, (0.0, 0))
            print(f"[portbench] {k}: {n} launches in the trace, {b_n} "
                  f"counted; device {s * 1e3:.3f} ms, bound {b_ms:.3f} ms; "
                  f"power limit {view['power_limit']}", file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    return result, numbers


def main(argv=None) -> int:
    from portbench.capture import FAULTS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the limits' upper readings: the control, and faults planted in the
    # program's output (never in a benchmark run)
    ap.add_argument("--control", choices=("int8",), default=None)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    args = ap.parse_args(argv)
    stamp("set-up, interpreter")
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    import torch

    stamp("set-up, import torch")
    cell = load_json("cells", args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.get("chips", 1):
        print("[portbench] no CUDA device (or fewer than the cell asks "
              "for): nothing measured", file=sys.stderr)
        return 3
    torch.zeros(1, device="cuda")
    stamp("set-up, CUDA context")
    args.power_limit = power_limit()
    result, numbers = run(args)
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] the run loaded {bad}: refused", file=sys.stderr)
        return 4
    for n, v, lim in numbers:
        print(f"[portbench] check {n}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
