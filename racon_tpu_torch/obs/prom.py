"""Prometheus text exposition (standard library only, format 0.0.4).

Renders counters, gauges and the log-bucketed histograms (obs/hist.py)
in the Prometheus text format every scraper speaks:

    # TYPE racon_tpu_serve_jobs_completed_total counter
    racon_tpu_serve_jobs_completed_total 42
    # TYPE racon_tpu_job_latency_seconds histogram
    racon_tpu_job_latency_seconds_bucket{le="0.25"} 12
    ...
    racon_tpu_job_latency_seconds_bucket{le="+Inf"} 42
    racon_tpu_job_latency_seconds_sum 13.9
    racon_tpu_job_latency_seconds_count 42

No client library and no registry: callers hand `render()` the numbers
they have and get back one scrape body. The series keep the JAX
package's `racon_tpu_` prefix and names, so one dashboard reads both.
It is a round-trip format, with three extensions beside the classic
lines:

  - labeled families (`Labeled`): one TYPE line, one sample line per
    label set (`..._tenant_queue_depth{tenant="gold"} 3`);
  - OpenMetrics exemplars: a bucket line may carry
    ` # {trace_id="..."} <value> <ts>`, the representative observation
    of the histogram's exemplar slot;
  - exact-stats sidecars: `<hist>_min` / `<hist>_max` gauges beside each
    non-empty histogram, so a scraped histogram rebuilds with the exact
    min and max its quantile estimate clamps to.

`parse()` is the strict inverse: it reads a scrape body back into typed
counters, gauges, labeled families and `ParsedHist` objects (which
`Scrape.histogram()` turns back into mergeable `Histogram`s), and
raises `PromParseError` on any line it does not understand.
"""

from __future__ import annotations

import re

from .hist import Histogram, HistogramSet

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

#: every exposed series is namespaced under this prefix
PREFIX = "racon_tpu_"

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def metric_name(name: str) -> str:
    """Sanitize a dotted internal name ("pipeline.pack") into a legal
    Prometheus metric name ("racon_tpu_pipeline_pack"). A name that
    already carries the prefix keeps it, so parsed series (full names)
    render again through the same `render()`."""
    if name.startswith(PREFIX):
        return _NAME_OK.sub("_", name)
    clean = _NAME_OK.sub("_", name.replace(".", "_")).strip("_")
    return PREFIX + clean


def _fmt(v) -> str:
    if v is None:
        return "0"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if v != v:  # NaN
            return "NaN"
        if v == float("inf"):
            return "+Inf"
        return repr(v)
    return str(v)


def _le(edge: float) -> str:
    return "+Inf" if edge == float("inf") else repr(edge)


def escape_label_value(v) -> str:
    """Text-format label-value escaping: backslash, quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape_label_value(v: str) -> str:
    out = []
    it = iter(v)
    for c in it:
        if c != "\\":
            out.append(c)
            continue
        nxt = next(it, "")
        out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
    return "".join(out)


def labels_str(labels: dict) -> str:
    """One canonical `{k="v",...}` rendering (sorted keys, escaped
    values), so a rendered-then-parsed label set equals the original."""
    if not labels:
        return ""
    return ("{" + ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items())) + "}")


class Labeled:
    """A labeled metric family for `render()`: `samples` is a list of
    (labels_dict, value) pairs sharing one metric name and TYPE line."""

    __slots__ = ("samples", "help")

    def __init__(self, samples, help_: str | None = None):
        self.samples = list(samples)
        self.help = help_


def counter_lines(name: str, value, help_: str | None = None) -> list[str]:
    n = metric_name(name)
    if not n.endswith("_total"):
        n += "_total"
    out = []
    if help_ or (isinstance(value, Labeled) and value.help):
        out.append(f"# HELP {n} "
                   f"{help_ or value.help}")
    out.append(f"# TYPE {n} counter")
    if isinstance(value, Labeled):
        for labels, v in value.samples:
            out.append(f"{n}{labels_str(labels)} {_fmt(v)}")
    else:
        out.append(f"{n} {_fmt(value)}")
    return out


def gauge_lines(name: str, value, help_: str | None = None) -> list[str]:
    n = metric_name(name)
    out = []
    if help_ or (isinstance(value, Labeled) and value.help):
        out.append(f"# HELP {n} "
                   f"{help_ or value.help}")
    out.append(f"# TYPE {n} gauge")
    if isinstance(value, Labeled):
        for labels, v in value.samples:
            out.append(f"{n}{labels_str(labels)} {_fmt(v)}")
    else:
        out.append(f"{n} {_fmt(value)}")
    return out


def _exemplar_suffix(ex: dict) -> str:
    """OpenMetrics exemplar rendering: ` # {labels} value timestamp`.
    The `value`/`t` keys are positional; everything else is a label."""
    labels = {k: v for k, v in ex.items()
              if k not in ("value", "t") and v is not None}
    return (f" # {labels_str(labels) or '{}'} "
            f"{_fmt(float(ex.get('value', 0.0)))}"
            + (f" {_fmt(float(ex['t']))}" if ex.get("t") else ""))


def histogram_lines(name: str, hist: Histogram,
                    help_: str | None = None) -> list[str]:
    """Classic cumulative-bucket exposition; the `_seconds` unit suffix
    is appended because every histogram here observes wall seconds.
    Buckets holding an exemplar render it OpenMetrics style, and a
    non-empty histogram emits its `_min` / `_max` gauge sidecars."""
    n = metric_name(name)
    if not n.endswith("_seconds"):
        n += "_seconds"
    out = []
    if help_:
        out.append(f"# HELP {n} {help_}")
    out.append(f"# TYPE {n} histogram")
    # one atomic export: buckets, _sum and _count agree within a scrape
    # even under concurrent observe
    buckets, count, total = hist.export()
    exemplars = hist.bucket_exemplars()
    for edge, cum in buckets:
        line = f'{n}_bucket{{le="{_le(edge)}"}} {cum}'
        ex = exemplars.get(edge)
        if ex is not None:
            line += _exemplar_suffix(ex)
        out.append(line)
    out.append(f"{n}_sum {_fmt(total)}")
    out.append(f"{n}_count {count}")
    if count:
        lo, hi = hist.min, hist.max
        out.append(f"# TYPE {n}_min gauge")
        out.append(f"{n}_min {_fmt(float(lo))}")
        out.append(f"# TYPE {n}_max gauge")
        out.append(f"{n}_max {_fmt(float(hi))}")
    return out


def render(counters: dict | None = None, gauges: dict | None = None,
           hists: HistogramSet | None = None) -> str:
    """One scrape body. `counters` / `gauges` map dotted names to
    numbers (or to (value, help) pairs, or to `Labeled` families);
    `hists` contributes every histogram it holds. Ends with the
    trailing newline the text format requires."""
    lines: list[str] = []
    for name, value in sorted((counters or {}).items()):
        help_ = None
        if isinstance(value, tuple):
            value, help_ = value
        lines.extend(counter_lines(name, value, help_))
    for name, value in sorted((gauges or {}).items()):
        help_ = None
        if isinstance(value, tuple):
            value, help_ = value
        lines.extend(gauge_lines(name, value, help_))
    if hists is not None:
        for name, hist in hists.items():
            lines.extend(histogram_lines(name, hist))
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------- parsing
class PromParseError(ValueError):
    """A scrape body line the strict parser refuses."""


class ParsedHist:
    """One scraped histogram: cumulative `(le, cum)` bucket pairs, the
    exact count/sum (and min/max when the sidecar gauges rode along),
    plus any OpenMetrics exemplars keyed by their bucket's le edge."""

    __slots__ = ("buckets", "sum", "count", "min", "max", "exemplars")

    def __init__(self):
        self.buckets: list[tuple[float, int]] = []
        self.sum = 0.0
        self.count = 0
        self.min: float | None = None
        self.max: float | None = None
        self.exemplars: dict[float, dict] = {}


class Scrape:
    """Typed view of one parsed scrape body. Unlabeled samples land in
    `counters` / `gauges` (metric name -> float); labeled samples in
    `counter_series` / `gauge_series` (name -> {labels_str: (labels,
    value)}); histograms in `hists` (base name -> ParsedHist)."""

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.counter_series: dict[str, dict[str, tuple[dict, float]]] = {}
        self.gauge_series: dict[str, dict[str, tuple[dict, float]]] = {}
        self.hists: dict[str, ParsedHist] = {}

    def histogram(self, name: str) -> Histogram:
        """The named scraped histogram as a live, mergeable
        obs.hist.Histogram (exact counts; exact min and max when the
        exposition carried the sidecars)."""
        ph = self.hists[name]
        return Histogram.from_export(ph.buckets, ph.count, ph.sum,
                                     ph.min, ph.max, ph.exemplars)

    def histogram_set(self) -> HistogramSet:
        hs = HistogramSet()
        for name in self.hists:
            hs._hists[name] = self.histogram(name)
        return hs

    def series_sum(self, name: str, kind: str = "counter") -> float:
        """Sum of one labeled family's sample values over every label
        set (zero when the family is absent)."""
        series = (self.counter_series if kind == "counter"
                  else self.gauge_series).get(name) or {}
        return sum(v for _, v in series.values())


_VALUE = r"[^\s#]+"
_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>" + _VALUE + r")"
    r"(?:\s+#\s+\{(?P<exlabels>[^}]*)\}\s+(?P<exvalue>" + _VALUE + r")"
    r"(?:\s+(?P<exts>" + _VALUE + r"))?)?\s*$")
_LABEL_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"\s*(?:,|$)')


def _parse_labels(raw: str | None) -> dict:
    if not raw:
        return {}
    out: dict = {}
    pos = 0
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            raise PromParseError(f"bad label pair at {raw[pos:]!r}")
        out[m.group("k")] = _unescape_label_value(m.group("v"))
        pos = m.end()
    return out


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    try:
        return float(raw)
    except ValueError:
        raise PromParseError(f"bad sample value {raw!r}") from None


def parse(text: str) -> Scrape:
    """Strictly parse one scrape body (the `render()` output format)
    back into a typed `Scrape`. Every non-comment line must be a valid
    sample; every sample must follow a `# TYPE` declaration; histogram
    bucket cumulative counts must be monotone — violations raise
    `PromParseError` naming the line."""
    out = Scrape()
    types: dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                if parts[3] not in ("counter", "gauge", "histogram",
                                    "summary", "untyped"):
                    raise PromParseError(
                        f"line {lineno}: unknown metric type "
                        f"{parts[3]!r}")
                types[parts[2]] = parts[3]
            elif len(parts) >= 2 and parts[1] == "HELP":
                pass
            else:
                raise PromParseError(
                    f"line {lineno}: unrecognized comment {line!r}")
            continue
        m = _LINE_RE.match(line)
        if m is None:
            raise PromParseError(f"line {lineno}: unparseable sample "
                                 f"{line!r}")
        name = m.group("name")
        labels = _parse_labels(m.group("labels"))
        value = _parse_value(m.group("value"))
        # histogram component lines attach to their base family
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            cand = name[:-len(suffix)] if name.endswith(suffix) else None
            if cand and types.get(cand) == "histogram":
                base = cand
                break
        if base is not None:
            ph = out.hists.setdefault(base, ParsedHist())
            if name.endswith("_bucket"):
                if "le" not in labels:
                    raise PromParseError(
                        f"line {lineno}: histogram bucket without le")
                le = _parse_value(labels["le"])
                if ph.buckets and value < ph.buckets[-1][1]:
                    raise PromParseError(
                        f"line {lineno}: non-monotone bucket counts")
                ph.buckets.append((le, int(value)))
                if m.group("exlabels") is not None:
                    ex = _parse_labels(m.group("exlabels"))
                    ex["value"] = _parse_value(m.group("exvalue"))
                    if m.group("exts"):
                        ex["t"] = _parse_value(m.group("exts"))
                    ph.exemplars[le] = ex
            elif name.endswith("_sum"):
                ph.sum = value
            else:
                ph.count = int(value)
            continue
        # min/max sidecars attach to their histogram when one exists
        for suffix, attr in (("_min", "min"), ("_max", "max")):
            cand = name[:-len(suffix)] if name.endswith(suffix) else None
            if cand and types.get(cand) == "histogram":
                setattr(out.hists.setdefault(cand, ParsedHist()),
                        attr, value)
                base = cand
                break
        if base is not None:
            continue
        mtype = types.get(name)
        if mtype is None:
            raise PromParseError(
                f"line {lineno}: sample {name!r} without a TYPE line")
        if mtype == "counter":
            flat, series = out.counters, out.counter_series
        elif mtype == "gauge":
            flat, series = out.gauges, out.gauge_series
        else:
            raise PromParseError(
                f"line {lineno}: unsupported sample type {mtype!r}")
        if labels:
            series.setdefault(name, {})[labels_str(labels)] = (labels,
                                                               value)
        else:
            flat[name] = value
    return out
