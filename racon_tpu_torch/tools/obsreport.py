"""The serve journal's job timelines beside the flight dumps.

A server leaves two kinds of evidence (`serve --journal`, `--flight-dir`):
the journal (obs/journal.py, one JSON line per lifecycle transition or
annotation) and the flight dumps (`<flight-dir>/flight_<job>_<reason>.json`,
a Chrome trace windowed to a failed or late job). This tool shows them
together, job by job:

    python -m racon_tpu_torch.tools.obsreport --journal j.jsonl \
        --flight-dir DIR [--job ID] [--check]

Per job: its events with +seconds from the first, the trace id, and the
flight dump that names it (for a failed, late or expired job). Events
this tool does not know render in their job's timeline and are ignored
by the checks. The autoscaler's `autoscale-up` / `autoscale-down` lines
name no job: each renders, tagged `[fleet]`, in the timeline of every
job whose lifetime it fell inside; a router's `hold` lines name their
job. The summary counts events by type and runs the checks, each a list
of problem strings (`--check` exits 1 on any):

  - `check_consistency` (obs/journal.py): one terminal state a job;
  - `check_parts_streamed`: a finished job's `part-streamed` lines (or
    their summed `reads`, for fragment groups) equal its sequences;
  - `check_parts_routed`: a router's `part-routed` receipts tile each
    contig's window axis (range segments, `lo` / `hi`) or the read axis
    (`frag_lo` / `frag_hi`) from 0, and a whole contig routes once;
  - `check_rounds`: `round-started` and `round-finished` balance;
  - `check_preemptions`: `preempted` and `resumed` balance;
  - `check_autoscale`: every `autoscale-down` names a replica a prior
    `autoscale-up` spawned and no earlier down stopped.

Jobs whose `received` line fell out of a rotated journal are skipped by
the per-job checks. The journal and the flight directory are flags; no
environment variable names them. Output and exit codes are the JAX
package's `tools/obsreport.py`'s on the same files.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ..obs.journal import check_consistency, read_journal


def load_flight_dumps(dirname: str) -> list[dict]:
    """The `flight` header objects of every dump artifact in `dirname`,
    each annotated with its path. Unreadable artifacts are reported as
    such, not fatal — this is a post-mortem tool."""
    out = []
    for path in sorted(glob.glob(os.path.join(dirname,
                                              "flight_*.json"))):
        info = {"path": path}
        try:
            with open(path) as fh:
                doc = json.load(fh)
            info.update(doc.get("flight") or {})
            info["events"] = len(doc.get("traceEvents") or [])
        except (OSError, ValueError) as exc:
            info["error"] = f"{type(exc).__name__}: {exc}"
        out.append(info)
    return out


def job_timelines(entries: list[dict]) -> dict[str, list[dict]]:
    """Journal entries grouped by job, in journal order; entries
    without a job id (serve-start / drain / serve-stop) are skipped —
    the summary counts them."""
    jobs: dict[str, list[dict]] = {}
    for e in entries:
        if e.get("job"):
            jobs.setdefault(str(e["job"]), []).append(e)
    return jobs


def _fields(e: dict) -> str:
    skip = {"t", "event", "job", "trace"}
    parts = [f"{k}={e[k]}" for k in e if k not in skip]
    return f" ({', '.join(parts)})" if parts else ""


def fleet_events(entries: list[dict]) -> list[dict]:
    """The jobless elasticity transitions (`autoscale-up` /
    `autoscale-down`) in journal order — render_job interleaves each
    into every job whose lifetime it fell inside."""
    return [e for e in entries
            if e.get("event") in ("autoscale-up", "autoscale-down")
            and not e.get("job")]


def render_job(job: str, events: list[dict], dumps: list[dict],
               out, fleet: list[dict] | None = None) -> None:
    trace = next((e["trace"] for e in events if e.get("trace")), None)
    t0 = events[0].get("t", 0.0)
    t_last = events[-1].get("t", t0)
    head = f"job {job}"
    if trace:
        head += f"  trace={trace}"
    print(head, file=out)
    names = {e.get("event") for e in events}
    lines = [(e.get("t", t0), e.get("event", "?"), _fields(e), "")
             for e in events]
    for e in fleet or []:
        t = e.get("t", t0)
        if t0 <= t <= t_last:
            lines.append((t, e.get("event", "?"), _fields(e),
                          " [fleet]"))
    lines.sort(key=lambda x: x[0])
    for t, name, fields, tag in lines:
        print(f"  +{t - t0:8.3f}s  {name:<18}{fields}{tag}",
              file=out)
    # dumps exist only for failed / deadline-missed jobs; job ids
    # restart per server lifetime, so a dump naming a job whose journal
    # shows a clean finish is a STALE artifact from an earlier server —
    # don't misattach it to this job's timeline
    if names & {"failed", "deadline-miss", "expired"}:
        for d in dumps:
            if d.get("job_id") == job:
                print(f"  flight dump: {d['path']} "
                      f"(reason={d.get('reason')}, "
                      f"error={d.get('error_type')})", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.tools.obsreport",
        description="render serve journal timelines alongside "
                    "flight-recorder dumps (see module docstring)")
    ap.add_argument("--journal", required=True,
                    help="the serve or router journal (JSONL)")
    ap.add_argument("--flight-dir", required=True,
                    help="the flight dump directory to index beside it")
    ap.add_argument("--job", default=None,
                    help="render only this job id")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when the journal fails its "
                         "consistency check (CI shape)")
    args = ap.parse_args(argv)

    entries = read_journal(args.journal)
    if not entries:
        print(f"[obsreport] error: no journal entries at "
              f"{args.journal}", file=sys.stderr)
        return 2

    dumps = (load_flight_dumps(args.flight_dir)
             if args.flight_dir and os.path.isdir(args.flight_dir)
             else [])
    jobs = job_timelines(entries)

    out = sys.stdout
    fleet = fleet_events(entries)
    shown = 0
    for job, events in jobs.items():
        if args.job and job != args.job:
            continue
        render_job(job, events, dumps, out, fleet=fleet)
        shown += 1
    if args.job and not shown:
        print(f"[obsreport] error: job {args.job!r} not in journal "
              f"({len(jobs)} jobs)", file=sys.stderr)
        return 2

    counts: dict[str, int] = {}
    for e in entries:
        counts[str(e.get("event"))] = counts.get(str(e.get("event")),
                                                 0) + 1
    print(f"summary: {len(entries)} events / {len(jobs)} jobs — "
          + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())),
          file=out)
    unmatched = [d for d in dumps
                 if d.get("job_id") and d["job_id"] not in jobs]
    print(f"flight dumps: {len(dumps)} in {args.flight_dir}"
          + (f" ({len(unmatched)} for jobs outside the journal window)"
             if unmatched else ""), file=out)

    problems = check_consistency(entries)
    problems += check_parts_streamed(entries)
    problems += check_parts_routed(entries)
    problems += check_rounds(entries)
    problems += check_preemptions(entries)
    problems += check_autoscale(entries)
    for p in problems:
        print(f"consistency: {p}", file=out)
    print(f"consistency: {'OK' if not problems else 'FAIL'} "
          f"({len(problems)} problems)", file=out)
    return 1 if (args.check and problems) else 0


def check_parts_streamed(entries: list[dict]) -> list[str]:
    """Streamed-results invariant: a job that `finished` successfully
    with N output sequences must have journaled exactly N
    `part-streamed` events (one per stitched contig). Fragment jobs
    stream reads in bounded GROUPS: their part-streamed lines carry
    `reads=N`, and each such line accounts for N output sequences
    instead of one. Jobs whose `finished` line predates the
    part-streamed era (no `sequences` field) or that never finished
    are skipped — this is a per-job receipt, not a schema
    migration."""
    parts: dict[str, int] = {}
    finished: dict[str, int] = {}
    received: set[str] = set()
    for e in entries:
        job = e.get("job")
        if not job:
            continue
        if e.get("event") == "received":
            received.add(str(job))
        elif e.get("event") == "part-streamed":
            n = e["reads"] if isinstance(e.get("reads"), int) else 1
            parts[str(job)] = parts.get(str(job), 0) + n
        elif e.get("event") == "finished" \
                and isinstance(e.get("sequences"), int):
            finished[str(job)] = e["sequences"]
    problems: list[str] = []
    for job, n_seqs in sorted(finished.items()):
        if job not in received:
            # the journal's rotation window cut this job's early
            # events (check_consistency applies the same tolerance):
            # its part-streamed lines may be in the discarded
            # generation, which is history loss, not a stream bug
            continue
        n_parts = parts.get(job, 0)
        if n_parts != n_seqs:
            problems.append(
                f"job {job}: {n_parts} part-streamed events for "
                f"{n_seqs} output sequences")
    return problems


def check_parts_routed(entries: list[dict]) -> list[str]:
    """Router part-receipt invariant, at segment granularity: the
    router journals one `part-routed` line per contig it forwards —
    and under window-range sharding, one per accepted SEGMENT, tagged
    with the segment's `lo`/`hi` window-grid coordinates. Per (job,
    contig): range segments sorted by `lo` must tile the axis from 0 —
    every `lo` equal to the previous `hi`, no overlap, no duplicate —
    because the merge ledger dedupes requeue replays BEFORE journaling;
    a violation means a segment was merged twice or a hole shipped
    inside a reassembled contig. Whole-contig lines (no `lo`) must
    appear exactly once per contig. Fragment-sharded jobs journal
    read-axis receipts instead (`frag_lo`/`frag_hi`, no contig name):
    per job, sorted by `frag_lo`, they must tile the read axis from
    0 — same discipline, different axis (a group whose reads all
    dropped still advances the receipt, so `reads` may be 0 but the
    range never runs backwards). Jobs whose `received` line fell out
    of the rotation window are skipped (the shared tolerance)."""
    segs: dict[tuple[str, str], list[tuple[int, int]]] = {}
    frags: dict[str, list[tuple[int, int]]] = {}
    whole: dict[tuple[str, str], int] = {}
    received: set[str] = set()
    for e in entries:
        job = e.get("job")
        if not job:
            continue
        if e.get("event") == "received":
            received.add(str(job))
        elif e.get("event") == "part-routed":
            key = (str(job), str(e.get("name")))
            if isinstance(e.get("lo"), int) \
                    and isinstance(e.get("hi"), int):
                segs.setdefault(key, []).append((e["lo"], e["hi"]))
            elif isinstance(e.get("frag_lo"), int) \
                    and isinstance(e.get("frag_hi"), int):
                frags.setdefault(str(job), []).append(
                    (e["frag_lo"], e["frag_hi"]))
            else:
                whole[key] = whole.get(key, 0) + 1
    problems: list[str] = []
    for (job, name), ranges in sorted(segs.items()):
        if job not in received:
            continue
        ranges.sort()
        expect = 0
        for lo, hi in ranges:
            if lo != expect or hi <= lo:
                problems.append(
                    f"job {job}: contig {name!r} segments do not tile "
                    f"— got [{lo},{hi}) where window {expect} was due")
                break
            expect = hi
    for job, ranges in sorted(frags.items()):
        if job not in received:
            continue
        ranges.sort()
        expect = 0
        for lo, hi in ranges:
            if lo != expect or hi < lo:
                problems.append(
                    f"job {job}: fragment groups do not tile — got "
                    f"[{lo},{hi}) where read {expect} was due")
                break
            expect = hi
    for (job, name), n in sorted(whole.items()):
        if job not in received:
            continue
        if n != 1:
            problems.append(
                f"job {job}: contig {name!r} routed {n} times "
                f"(expected exactly once)")
    return problems


def check_rounds(entries: list[dict]) -> list[str]:
    """Iterative-rounds invariant: every `round-started` a job journals
    must be balanced by exactly one `round-finished` (the server emits
    the pair around each round of a `rounds=N` job). An unbalanced
    count means a round died mid-loop without its boundary line — or a
    duplicated/lost journal write. Jobs whose `received` line fell out
    of the journal's rotation window are skipped (the same tolerance
    check_consistency and check_parts_streamed apply): their early
    round lines may be in the discarded generation."""
    started: dict[str, int] = {}
    finished: dict[str, int] = {}
    received: set[str] = set()
    for e in entries:
        job = e.get("job")
        if not job:
            continue
        if e.get("event") == "received":
            received.add(str(job))
        elif e.get("event") == "round-started":
            started[str(job)] = started.get(str(job), 0) + 1
        elif e.get("event") == "round-finished":
            finished[str(job)] = finished.get(str(job), 0) + 1
    problems: list[str] = []
    for job in sorted(set(started) | set(finished)):
        if job not in received:
            continue
        n_started = started.get(job, 0)
        n_finished = finished.get(job, 0)
        if n_started != n_finished:
            problems.append(
                f"job {job}: {n_started} round-started events vs "
                f"{n_finished} round-finished")
    return problems


def check_preemptions(entries: list[dict]) -> list[str]:
    """Preemption invariant: every `preempted` a job journals must be
    balanced by exactly one `resumed` — the server resumes a parked
    job when capacity frees, and a job that TERMINATES while parked
    still gets its `resumed` line (reason=terminal) from the
    post-terminal cleanup. An unbalanced count means a withdrawal
    leaked: a job parked forever with its windows held hostage. Jobs
    whose `received` line fell out of the journal's rotation window
    are skipped (the same tolerance the other per-job checks apply)."""
    preempted: dict[str, int] = {}
    resumed: dict[str, int] = {}
    received: set[str] = set()
    for e in entries:
        job = e.get("job")
        if not job:
            continue
        if e.get("event") == "received":
            received.add(str(job))
        elif e.get("event") == "preempted":
            preempted[str(job)] = preempted.get(str(job), 0) + 1
        elif e.get("event") == "resumed":
            resumed[str(job)] = resumed.get(str(job), 0) + 1
    problems: list[str] = []
    for job in sorted(set(preempted) | set(resumed)):
        if job not in received:
            continue
        n_pre = preempted.get(job, 0)
        n_res = resumed.get(job, 0)
        if n_pre != n_res:
            problems.append(
                f"job {job}: {n_pre} preempted events vs "
                f"{n_res} resumed")
    return problems


def check_autoscale(entries: list[dict]) -> list[str]:
    """Elasticity-ledger invariant: the autoscaler only drains
    replicas IT spawned (the operator's configured fleet is the floor
    it never touches), so every `autoscale-down` must name a replica
    with a prior, not-yet-drained `autoscale-up` — a down without its
    up, or a second down for the same spawn, means the up/down ledger
    lost a transition. Ups left open at the end of the journal are
    fine: spawned replicas legitimately outlive the window (the next
    idle pass, or the router's drain, retires them)."""
    live: dict[str, int] = {}
    problems: list[str] = []
    for e in entries:
        ev = e.get("event")
        if ev not in ("autoscale-up", "autoscale-down"):
            continue
        spec = str(e.get("replica"))
        if ev == "autoscale-up":
            live[spec] = live.get(spec, 0) + 1
        elif live.get(spec, 0) > 0:
            live[spec] -= 1
        else:
            problems.append(
                f"autoscale-down for {spec!r} without a prior "
                "autoscale-up (or already drained)")
    return problems


if __name__ == "__main__":
    sys.exit(main())
