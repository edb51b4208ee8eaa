"""Pool-wide observability: metrics registry + decision-audit trace.

``Obs`` is the bundle every layer shares: a ``MetricsRegistry`` (counters /
gauges / histograms with measured streaming percentiles) and a
``DecisionTrace`` (the causally-ordered decision/fault/span event log). The
controller creates one by default and hands it to its governor; the service
runtime reuses the controller's so all layers write one log. Recording is
always on — events are list appends and histogram observes, cheap enough
that the chaos benchmark's wall-clock budget (<5% overhead) holds — and
export is explicit (``dump``).

The port's copy of the JAX package's ``obs``: plain Python and numpy, no
kernel. Dumps, Prometheus text, alert sequences and flight bundles come out
byte for byte as the reference writes them for the same inputs.
"""
from __future__ import annotations

import pathlib
from typing import Iterable, Optional

from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.percentiles import P2Quantile, Reservoir  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    DECISION, FAULT, MARK, RECONCILE, SPAN, DecisionTrace, Span, TraceEvent)


class Obs:
    """One observability context: metrics + trace, shared across layers."""

    def __init__(self, seed: int = 0, clock=None):
        self.metrics = MetricsRegistry(seed=seed)
        self.trace = (DecisionTrace(clock=clock) if clock is not None
                      else DecisionTrace())

    def set_tick(self, tick: int) -> None:
        self.trace.set_tick(tick)

    # -- data-plane snapshot ---------------------------------------------------
    def snapshot_compile_caches(self, planes: Iterable = ()) -> None:
        """Pull the process-wide compile-cache hit/miss counters
        (core.graph) and per-plane dispatch stats into registry gauges, so
        an exported artifact carries the zero-steady-state-recompile
        evidence beside the latency series."""
        from repro_torch.core import graph
        for cache, stats in graph.compile_cache_stats().items():
            for field, v in stats.items():
                self.metrics.gauge("compile_cache_" + field,
                                   cache=cache).set(v)
        calls = compiles = 0
        for dp in planes:
            calls += dp.dispatch_stats.get("calls", 0)
            compiles += dp.dispatch_stats.get("compiles", 0)
        if calls or compiles:
            self.metrics.gauge("dataplane_dispatch_calls").set(calls)
            self.metrics.gauge("dataplane_dispatch_compiles").set(compiles)

    # -- artifact export -------------------------------------------------------
    def dump(self, out_dir, prefix: str = "") -> dict:
        """Write ``trace.jsonl``, ``metrics.jsonl``, and ``metrics.prom``
        under ``out_dir`` (created if missing); returns the paths."""
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        p = (prefix + "." if prefix else "")
        paths = {
            "trace": out / f"{p}trace.jsonl",
            "metrics": out / f"{p}metrics.jsonl",
            "prom": out / f"{p}metrics.prom",
        }
        self.trace.dump_jsonl(paths["trace"])
        self.metrics.dump_jsonl(paths["metrics"])
        paths["prom"].write_text(self.metrics.render_prometheus())
        return {k: str(v) for k, v in paths.items()}


def load_trace(path) -> DecisionTrace:
    """Load a dumped ``trace.jsonl`` artifact back into a queryable trace."""
    return DecisionTrace.load_jsonl(path)


# SLO / alerting / flight-recorder layer. Imported last: these modules use
# ``from repro_torch.obs import Obs``, which needs the class above to exist
# during this package's own initialization.
from repro_torch.obs.alerts import (  # noqa: E402,F401
    AlertTransition, BurnAlertManager, BurnRule, DEFAULT_RULES, FIRING, PAGE,
    RESOLVED, WARN)
from repro_torch.obs.flight import (  # noqa: E402,F401
    FlightRecorder, load_bundle)
from repro_torch.obs.slo import (  # noqa: E402,F401
    BurnSample, SLOEngine, SLOPolicy, TenantBudget)
