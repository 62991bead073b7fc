"""Metrics registry: one namespaced snapshot for the whole run.

`MetricsRegistry` puts the run's telemetry behind namespaces: the
dispatch pipeline's stage counters (`pipeline`), the latency histograms
(`latency`) and the aligner's accounting (`aligner`), so the
`--cuda-metrics out.json` dump and the end-of-run stderr table render
the same snapshot.

Providers are callables returning a dict, invoked at snapshot time, so
registering is free and the registry always reflects current counter
values. The polisher wires its namespaces in its constructor
(core/polisher.py).
"""

from __future__ import annotations

import json


class MetricsRegistry:
    """Namespace -> provider mapping with nested/flat snapshot views."""

    def __init__(self):
        self._providers: dict[str, object] = {}

    def register(self, namespace: str, provider) -> None:
        """Register `provider()` (-> dict) under `namespace`.
        Re-registering a namespace replaces its provider."""
        if not namespace or "." in namespace:
            raise ValueError(
                f"MetricsRegistry.register: invalid namespace {namespace!r}")
        self._providers[namespace] = provider

    def snapshot(self) -> dict:
        """{namespace: provider()}: nested, JSON-ready (the
        --cuda-metrics dump)."""
        return {ns: provider() for ns, provider in self._providers.items()}

    def flat(self) -> dict:
        """Dotted scalar keys (`pipeline.pack_s`, `latency.pipeline.pack.
        p50`, ...): the stderr-table and test-assertion view."""
        out: dict = {}

        def walk(prefix: str, value) -> None:
            if isinstance(value, dict):
                for k, v in value.items():
                    walk(f"{prefix}.{k}", v)
            else:
                out[prefix] = value

        for ns, sub in self.snapshot().items():
            walk(ns, sub)
        return out

    def dump(self, path: str) -> str:
        """Write the nested snapshot as indented JSON to `path`."""
        with open(path, "w") as fh:
            json.dump(self.snapshot(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        return path

    def table(self) -> str:
        """One aligned key/value line per flat metric, sorted: the
        end-of-run stderr summary."""
        flat = self.flat()
        if not flat:
            return "(no metrics recorded)"
        width = max(len(k) for k in flat)
        lines = []
        for key in sorted(flat):
            v = flat[key]
            if isinstance(v, float):
                v = round(v, 3)
            lines.append(f"  {key:<{width}}  {v}")
        return "\n".join(lines)
