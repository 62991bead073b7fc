"""Command-line interface: `python -m racon_tpu_torch reads overlaps target`.

The reference CLI (src/main.cpp:47-169): the same common options plus the
upstream racon-gpu device flags (-c/--cudapoa-batches,
--cudaaligner-batches, --cudaaligner-band-width,
-b/--cuda-banded-alignment), --device and --cuda-dtype, and the
counterparts of the JAX CLI's pipeline and observability flags
(--cuda-pipeline-depth, --cuda-trace, --cuda-metrics, --cuda-log-level,
--cuda-profile), its device consensus engine flags (--cuda-engine,
--cuda-fused), its scheduler flag (--cuda-adaptive-buckets) and
--cuda-autotune-table, the flag counterpart of its
RACON_TPU_AUTOTUNE_CACHE. Polished FASTA goes to stdout; errors print as
`[racon_tpu_torch::...] error: ...` on stderr with exit status 1.

`python -m racon_tpu_torch serve|submit|cancel ...` runs the warm job
server, sends it a job, or cancels one (serve/server.py,
serve/client.py); `router` runs one service over several servers
(serve/router.py) and `fleet` merges their metrics (obs/fleet.py);
`--help` on each.
"""

from __future__ import annotations

import sys

from . import __version__
from .errors import RaconError

HELP = """\
usage: python -m racon_tpu_torch [options ...] <sequences> <overlaps> <target sequences>

    #default output is stdout
    <sequences>
        input file in FASTA/FASTQ format (can be compressed with gzip)
        containing sequences used for correction
    <overlaps>
        input file in MHAP/PAF/SAM format (can be compressed with gzip)
        containing overlaps between sequences and target sequences
    <target sequences>
        input file in FASTA/FASTQ format (can be compressed with gzip)
        containing sequences which will be corrected

    options:
        -u, --include-unpolished
            output unpolished target sequences
        -f, --fragment-correction
            perform fragment correction instead of contig polishing
            (overlaps file should contain dual/self overlaps!)
        -w, --window-length <int>
            default: 500
            size of window on which POA is performed
        -q, --quality-threshold <float>
            default: 10.0
            threshold for average base quality of windows used in POA
        -e, --error-threshold <float>
            default: 0.3
            maximum allowed error rate used for filtering overlaps
        --no-trimming
            disables consensus trimming at window ends
        -m, --match <int>
            default: 3
            score for matching bases
        -x, --mismatch <int>
            default: -5
            score for mismatching bases
        -g, --gap <int>
            default: -4
            gap penalty (must be negative)
        -t, --threads <int>
            default: 1
            number of threads
        --version
            prints the version number
        -h, --help
            prints the usage
        -c, --cudapoa-batches <int>
            default: 0
            number of batches for GPU accelerated polishing (0 = host POA)
        -b, --cuda-banded-alignment
            use banding approximation for POA on the GPU: banded results
            are trusted as-is (the clipped-result full-DP retry is
            skipped), trading exact host-engine parity for speed
        --cuda-engine <session|fused>
            default: session
            device consensus engine: per-layer evolving-graph session
            (byte-identical to the host engine) or single-launch
            whole-window fused (equal aggregate quality; rare tie-order
            divergence possible on deep windows)
        --cuda-fused <auto|0|1>
            default: auto
            fused-engine chunk dispatch: 1 = the single-launch fused
            align->window-slice->POA program (device-side slicing, one
            launch + one fetch per chunk), 0 = the split chained path,
            auto = the autotuner table's measured winner per depth
            bucket (--cuda-autotune-table), the split path where the
            table has none. Output is byte-identical in every mode
        --cuda-adaptive-buckets
            derive each device engine's shape ladder from the run's own
            job-shape histogram (occupancy-aware batch scheduler) and
            pack shape-sorted batches, instead of the static worst-case
            ladders; output is byte-identical either way (the
            counterpart of --tpu-adaptive-buckets)
        --cudaaligner-batches <int>
            default: 0
            number of batches for GPU accelerated overlap alignment
        --cudaaligner-band-width <int>
            default: 0
            band width for GPU alignment; 0 = auto (10% of the mean
            pair length)
        --cudaaligner-max-length <int>
            default: the largest bucket edge (65536)
            length envelope of GPU alignment: a pair longer than the
            largest bucket edge within it is aligned on the CPU
        --device <cuda|cpu>
            default: cuda
            device of the GPU paths; cuda raises when no card is present,
            cpu runs the kernels' plain PyTorch versions
        --cuda-dtype <auto|int32|int16>
            default: auto
            DP score dtype policy: auto shrinks each bucket to int16
            when its overflow envelope proof holds (half the DP bytes,
            bit-identical results) unless the autotuner table measured
            int32 faster there, int32 forces the wide oracle
            everywhere, int16 shrinks wherever the proof holds
        --cuda-autotune-table <file>
            default: ~/.cache/racon_tpu_torch/racon_tpu_torch_autotune.json
            the autotuner's per-bucket winner table (written by
            racon_tpu_torch.sched.autotune's profilers), consulted
            under --cuda-dtype auto and --cuda-fused auto; a missing
            table changes nothing. A profiled entry departs from the
            cold decision only where its kernel's timed calls resolved
            the gap; no end-to-end speed-up from a table is measured
            yet. Output is byte-identical either way
        --cuda-pipeline-depth <int>
            default: 2
            async dispatch pipeline depth: chunks packed / in flight
            ahead of the one being unpacked (host pack, device compute,
            host unpack and host-fallback alignment all overlap, each
            chunk in flight on its own CUDA stream); 0 is the
            synchronous path
        --cuda-trace <file>
            default: none
            record a span trace of the run (pipeline stages per chunk,
            session dispatch and commit, polisher phases) as Chrome
            trace-event JSON loadable in Perfetto / chrome://tracing
        --cuda-metrics <file>
            default: none
            dump the end-of-run metrics snapshot (pipeline / sched /
            latency / aligner namespaces) as JSON, and print it as a
            stderr table
        --cuda-log-level <quiet|info|debug>
            default: info
            stderr verbosity: quiet silences progress and timing lines,
            debug also shows every deduplicated warning
        --cuda-profile <dir>
            default: none
            capture each device phase with torch.profiler into
            <dir>/align.json and <dir>/consensus.json (Chrome trace)

    subcommands (--help on each for every flag):
        serve [--wincache] [--wincache-max-bytes <int>]
              [--frag-group <int>] [--preempt] [--abort-margin <seconds>]
              [--cudaaligner-max-length <int>] [--host-poa-chunk <int>]
              [--device-latency-s <seconds>] [--device-latency-x <x>]
            the warm job server: the window cache, corrected reads per
            streamed frame of a fragment job, priority preemption, the
            deadline-abort margin, the aligner's length envelope, the
            host POA chunk and a simulated device latency (sleeps after
            each pipeline chunk; the output does not change)
        submit [--rounds <int>] [-f | --fragment]
               [--frag-lo <int> --frag-hi <int>] [--ingest]
               [--subsample <ref_len> <cov>] [--normalize]
               <sequences> <overlaps> <target sequences>
            sends the server one job: polishing rounds, read correction
            (a target slice of it), admit-time validation, subsampling
            and pair normalization
        cancel --job-id <id> | --trace-id <id>
            cancels a queued or running job
        router --replicas <sock,...> [--socket <path> | --port <int>]
               [--journal <path>] [--metrics-port <int>]
            one service over N warm servers: contig, window-range and
            read-range shards, requeue on a replica's loss, rolling
            restarts, the replicas' metrics federated
        fleet --endpoints <sock,...> [--json] [--port <int>]
            merges N servers' metrics and health into one view
"""


def parse_args(argv: list[str]) -> dict | None:
    """getopt-style parser mirroring src/main.cpp:75-155: intermixed
    options and positionals, `-c` with an optional argument. Returns the
    option dict, or None when --help/--version was handled."""
    opts = {
        "window_length": 500,
        "quality_threshold": 10.0,
        "error_threshold": 0.3,
        "trim": True,
        "match": 3,
        "mismatch": -5,
        "gap": -4,
        "fragment_correction": False,
        "drop_unpolished_sequences": True,
        "num_threads": 1,
        "cuda_poa_batches": 0,
        "cuda_aligner_batches": 0,
        "cuda_aligner_band_width": 0,
        "aligner_max_length": None,
        "cuda_banded_alignment": False,
        "device": "cuda",
        "score_dtype": "auto",
        "pipeline_depth": 2,
        "trace_path": None,
        "metrics_path": None,
        "log_level": None,
        "profile_dir": None,
        "cuda_engine": "session",
        "cuda_fused": "auto",
        "adaptive_buckets": False,
        "autotune_table": None,
        "paths": [],
    }

    def _device_choice(v: str) -> str:
        if v not in ("cuda", "cpu"):
            print("racon_tpu_torch: --device must be 'cuda' or 'cpu'",
                  file=sys.stderr)
            sys.exit(1)
        return v

    def _dtype_choice(v: str) -> str:
        if v not in ("auto", "int32", "int16"):
            print("racon_tpu_torch: --cuda-dtype must be 'auto', 'int32' or "
                  "'int16'", file=sys.stderr)
            sys.exit(1)
        return v

    def _engine_choice(v: str) -> str:
        if v not in ("session", "fused"):
            print("racon_tpu_torch: --cuda-engine must be 'session' or "
                  "'fused'", file=sys.stderr)
            sys.exit(1)
        return v

    def _fused_choice(v: str) -> str:
        if v not in ("0", "1", "auto"):
            print("racon_tpu_torch: --cuda-fused must be '0', '1' or 'auto'",
                  file=sys.stderr)
            sys.exit(1)
        return v

    def _level_choice(v: str) -> str:
        from .utils.logger import LEVEL_NAMES

        if v not in LEVEL_NAMES:
            names = ", ".join(f"'{n}'" for n in LEVEL_NAMES)
            print(f"racon_tpu_torch: --cuda-log-level must be one of {names}",
                  file=sys.stderr)
            sys.exit(1)
        return v

    value_short = {"w": ("window_length", int),
                   "q": ("quality_threshold", float),
                   "e": ("error_threshold", float),
                   "m": ("match", int),
                   "x": ("mismatch", int),
                   "g": ("gap", int),
                   "t": ("num_threads", int)}
    value_long = {"window-length": ("window_length", int),
                  "quality-threshold": ("quality_threshold", float),
                  "error-threshold": ("error_threshold", float),
                  "match": ("match", int),
                  "mismatch": ("mismatch", int),
                  "gap": ("gap", int),
                  "threads": ("num_threads", int),
                  "cudaaligner-batches": ("cuda_aligner_batches", int),
                  "cudaaligner-band-width": ("cuda_aligner_band_width", int),
                  "cudaaligner-max-length": ("aligner_max_length", int),
                  "device": ("device", _device_choice),
                  "cuda-dtype": ("score_dtype", _dtype_choice),
                  "cuda-engine": ("cuda_engine", _engine_choice),
                  "cuda-fused": ("cuda_fused", _fused_choice),
                  "cuda-pipeline-depth": ("pipeline_depth", int),
                  "cuda-trace": ("trace_path", str),
                  "cuda-metrics": ("metrics_path", str),
                  "cuda-log-level": ("log_level", _level_choice),
                  "cuda-profile": ("profile_dir", str),
                  "cuda-autotune-table": ("autotune_table", str)}

    def flag(name: str) -> bool:
        if name in ("u", "include-unpolished"):
            opts["drop_unpolished_sequences"] = False
        elif name in ("f", "fragment-correction"):
            opts["fragment_correction"] = True
        elif name == "no-trimming":
            opts["trim"] = False
        elif name in ("b", "cuda-banded-alignment"):
            opts["cuda_banded_alignment"] = True
        elif name == "cuda-adaptive-buckets":
            opts["adaptive_buckets"] = True
        else:
            return False
        return True

    i = 0
    n = len(argv)

    def take_value(display: str) -> str:
        nonlocal i
        i += 1
        if i >= n:
            print(f"racon_tpu_torch: option '{display}' requires an argument",
                  file=sys.stderr)
            sys.exit(1)
        return argv[i]

    def optional_count(inline: str | None) -> int:
        # optional argument: attached, or the next argv when it is a
        # number (reference src/main.cpp:113-125)
        nonlocal i
        if inline:
            return int(inline)
        if i + 1 < n and argv[i + 1].isdigit():
            i += 1
            return int(argv[i])
        return 1

    while i < n:
        arg = argv[i]
        if arg == "--":
            opts["paths"].extend(argv[i + 1:])
            break
        if arg.startswith("--"):
            name, eq, inline = arg[2:].partition("=")
            if name == "help":
                print(HELP, end="")
                return None
            if name == "version":
                print(f"v{__version__}")
                return None
            if flag(name):
                pass
            elif name in value_long:
                key, conv = value_long[name]
                opts[key] = conv(inline if eq else take_value(arg))
            elif name == "cudapoa-batches":
                opts["cuda_poa_batches"] = optional_count(inline if eq else None)
            else:
                print(f"racon_tpu_torch: unrecognized option '{arg}'",
                      file=sys.stderr)
                sys.exit(1)
        elif arg.startswith("-") and arg != "-":
            j = 1
            while j < len(arg):
                c = arg[j]
                if c == "h":
                    print(HELP, end="")
                    return None
                if c == "v":
                    print(f"v{__version__}")
                    return None
                if flag(c):
                    j += 1
                    continue
                if c in value_short:
                    key, conv = value_short[c]
                    rest = arg[j + 1:]
                    opts[key] = conv(rest) if rest else conv(take_value("-" + c))
                    break
                if c == "c":
                    opts["cuda_poa_batches"] = optional_count(arg[j + 1:])
                    break
                print(f"racon_tpu_torch: invalid option -- '{c}'",
                      file=sys.stderr)
                sys.exit(1)
        else:
            opts["paths"].append(arg)
        i += 1
    return opts


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # the serve subcommands: `serve` runs the warm job server, `submit`
    # sends it one job, `cancel` cancels one, `router` fans jobs out
    # over several servers and `fleet` merges their metrics
    if argv and argv[0] == "serve":
        from .serve.server import serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "submit":
        from .serve.client import submit_main

        return submit_main(argv[1:])
    if argv and argv[0] == "cancel":
        from .serve.client import cancel_main

        return cancel_main(argv[1:])
    if argv and argv[0] == "router":
        from .serve.router import router_main

        return router_main(argv[1:])
    if argv and argv[0] == "fleet":
        from .obs.fleet import fleet_main

        return fleet_main(argv[1:])
    opts = parse_args(argv)
    if opts is None:
        return 0
    if len(opts["paths"]) < 3:
        print("[racon_tpu_torch::] error: missing input file(s)!",
              file=sys.stderr)
        print(HELP, end="")
        return 1

    from .core.polisher import PolisherType, create_polisher
    from .obs import trace
    from .utils.logger import set_log_level

    try:
        polisher = create_polisher(
            opts["paths"][0], opts["paths"][1], opts["paths"][2],
            PolisherType.kF if opts["fragment_correction"]
            else PolisherType.kC,
            opts["window_length"], opts["quality_threshold"],
            opts["error_threshold"], opts["trim"], opts["match"],
            opts["mismatch"], opts["gap"], opts["num_threads"],
            opts["cuda_poa_batches"], opts["cuda_banded_alignment"],
            opts["cuda_aligner_batches"], opts["cuda_aligner_band_width"],
            opts["device"], opts["score_dtype"],
            pipeline_depth=opts["pipeline_depth"],
            trace_path=opts["trace_path"],
            metrics_path=opts["metrics_path"],
            log_level=opts["log_level"], profile_dir=opts["profile_dir"],
            cuda_engine=opts["cuda_engine"], cuda_fused=opts["cuda_fused"],
            adaptive_buckets=opts["adaptive_buckets"],
            autotune_table=opts["autotune_table"],
            aligner_max_length=opts["aligner_max_length"])
        polisher.initialize()
        polished = polisher.polish(opts["drop_unpolished_sequences"])
    except RaconError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    finally:
        # the level and the tracer are process-wide: a later in-process
        # main() without the flags must not inherit them
        set_log_level(None)
        trace.reset()
    out = sys.stdout.buffer
    for seq in polished:
        out.write(b">" + seq.name.encode() + b"\n" + seq.data + b"\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
