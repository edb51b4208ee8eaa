"""Metrics registry: counters, gauges, histograms with streaming quantiles.

One ``MetricsRegistry`` per observability context (``obs.Obs``). Metrics are
keyed by (name, sorted label items), so ``registry.counter("x", tenant="a")``
and ``tenant="b"`` are independent series of one family — the Prometheus
label model, without the client library.

Histograms carry BOTH percentile estimators from ``obs.percentiles``: the
seeded reservoir (exact until capacity, then uniform-sample estimates — the
headline "measured" number) and a set of P² markers (O(1) cross-check
series). ``quantile()`` returns the reservoir value.

Exposition: ``render_prometheus()`` emits spec-conformant text format:
counters carry the ``_total`` suffix exactly once, histograms
render as true Prometheus histograms — cumulative ``_bucket{le="..."}``
rows up to ``le="+Inf"`` plus ``_count``/``_sum`` — so the export parses
under promtool-style linting. Reservoir/P² quantiles stay queryable in
code and in the JSONL records (``to_records()``/``dump_jsonl()``).
"""
from __future__ import annotations

import bisect
import json
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.obs.percentiles import P2Quantile, Reservoir

LabelKey = Tuple[Tuple[str, str], ...]

DEFAULT_QUANTILES = (0.5, 0.9, 0.99)

# Default bucket ladder: a 1-2.5-5 log ladder from 5 µs to 10 s covering
# the latency-in-seconds series this registry mostly carries, with sane
# coverage for other unit scales (counts, Gbps) in the upper decades.
DEFAULT_BUCKETS = (
    5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    return f"{v:g}"


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    kind = "counter"

    def __init__(self, name: str, labels: LabelKey):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        assert v >= 0.0, "counters only go up"
        self.value += v


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, labels: LabelKey,
                 quantiles: Sequence[float] = DEFAULT_QUANTILES,
                 reservoir_capacity: int = 4096, seed: int = 0,
                 p2: bool = False,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.quantiles = tuple(quantiles)
        # Explicit bucket bounds: per-bucket (non-cumulative)
        # observation counts; exposition renders them cumulatively with a
        # trailing +Inf bucket equal to ``count``.
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * len(self.buckets)
        self.reservoir = Reservoir(reservoir_capacity, seed=seed)
        # The P² cross-check estimators are opt-in: they are O(1) memory but
        # per-sample Python updates, and the reservoir path is already exact
        # until capacity — always-on hot series (the runtime's per-tenant
        # latency stream) stay vectorized, diagnostic series can ask for the
        # second opinion.
        self._p2 = {q: P2Quantile(q) for q in self.quantiles} if p2 else {}

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        idx = bisect.bisect_left(self.buckets, x)
        if idx < len(self.buckets):
            self.bucket_counts[idx] += 1
        self.reservoir.observe(x)
        for est in self._p2.values():
            est.observe(x)

    def observe_many(self, xs: Iterable[float]) -> None:
        import numpy as np
        arr = np.asarray(list(xs) if not hasattr(xs, "ravel") else xs,
                         dtype=float).ravel()
        if arr.size == 0:
            return
        self.count += int(arr.size)
        self.sum += float(arr.sum())
        lo, hi = float(arr.min()), float(arr.max())
        self.min = lo if self.min is None else min(self.min, lo)
        self.max = hi if self.max is None else max(self.max, hi)
        idx = np.searchsorted(np.asarray(self.buckets), arr, side="left")
        per = np.bincount(idx, minlength=len(self.buckets) + 1)
        for i in range(len(self.buckets)):
            self.bucket_counts[i] += int(per[i])
        self.reservoir.observe_many(arr)
        for est in self._p2.values():
            for x in arr.tolist():
                est.observe(x)

    def quantile(self, q: float) -> Optional[float]:
        """The measured quantile (reservoir path: exact until capacity)."""
        return self.reservoir.quantile(q)

    def p2_quantile(self, q: float) -> Optional[float]:
        """The O(1) P² cross-check estimate (tracked quantiles only)."""
        est = self._p2.get(q)
        return est.value() if est is not None else None

    def cumulative_buckets(self) -> List[Tuple[str, int]]:
        """``(le, cumulative_count)`` pairs ending in ``("+Inf", count)`` —
        the exposition shape of the explicit bucket bounds."""
        out: List[Tuple[str, int]] = []
        cum = 0
        for b, c in zip(self.buckets, self.bucket_counts):
            cum += c
            out.append((_fmt(b), cum))
        out.append(("+Inf", self.count))
        return out

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create registry of labeled metric series."""

    def __init__(self, seed: int = 0, reservoir_capacity: int = 4096):
        self.seed = seed
        self.reservoir_capacity = reservoir_capacity
        self._metrics: Dict[Tuple[str, LabelKey], Metric] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kw) -> Metric:
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], **kw)
            self._metrics[key] = m
        assert isinstance(m, cls), (
            f"metric {name} already registered as {m.kind}")
        return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  quantiles: Sequence[float] = DEFAULT_QUANTILES,
                  p2: bool = False,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        # Per-series seed derived from the registry seed + identity so two
        # registries built alike retain identical reservoirs. Python salts
        # string hashes per process, so the seed (and a reservoir past its
        # capacity) repeats within one process only, as in the reference.
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = Histogram(name, key[1], quantiles=quantiles,
                          reservoir_capacity=self.reservoir_capacity,
                          seed=hash((self.seed,) + key) & 0x7FFFFFFF,
                          p2=p2, buckets=buckets)
            self._metrics[key] = m
        assert isinstance(m, Histogram)
        return m

    def get(self, name: str, **labels: str) -> Optional[Metric]:
        return self._metrics.get((name, _label_key(labels)))

    def series(self, name: str) -> List[Metric]:
        return [m for (n, _), m in sorted(self._metrics.items())
                if n == name]

    # -- exposition ------------------------------------------------------------
    def render_prometheus(self) -> str:
        """Spec-conformant text exposition: histograms render as
        cumulative ``_bucket{le=...}`` series ending in ``+Inf`` plus
        ``_count``/``_sum``; counters carry ``_total`` exactly once (series
        already named ``*_total`` are not suffixed again)."""
        lines: List[str] = []
        seen_type: set = set()
        for (name, labels), m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                if name not in seen_type:
                    lines.append(f"# TYPE {name} histogram")
                    seen_type.add(name)
                base = dict(labels)
                for le, cum in m.cumulative_buckets():
                    lk = _label_key({**base, "le": le})
                    lines.append(f"{name}_bucket{_label_str(lk)} {cum}")
                lines.append(f"{name}_count{_label_str(labels)} {m.count}")
                lines.append(f"{name}_sum{_label_str(labels)} {m.sum:.9g}")
            else:
                out_name = name
                if m.kind == "counter" and not name.endswith("_total"):
                    out_name = name + "_total"
                if out_name not in seen_type:
                    lines.append(f"# TYPE {out_name} {m.kind}")
                    seen_type.add(out_name)
                lines.append(f"{out_name}{_label_str(labels)} {m.value:.9g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_records(self) -> List[dict]:
        out: List[dict] = []
        for (name, labels), m in sorted(self._metrics.items()):
            rec = {"name": name, "labels": dict(labels), "kind": m.kind}
            if isinstance(m, Histogram):
                rec.update(count=m.count, sum=m.sum, min=m.min, max=m.max,
                           mean=m.mean,
                           quantiles={repr(q): m.quantile(q)
                                      for q in m.quantiles},
                           buckets=dict(m.cumulative_buckets()),
                           exact=m.reservoir.exact)
                if m._p2:              # cross-check only when tracked
                    rec["p2"] = {repr(q): m.p2_quantile(q)
                                 for q in m.quantiles}
            else:
                rec["value"] = m.value
            out.append(rec)
        return out

    def dump_jsonl(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            for rec in self.to_records():
                f.write(json.dumps(rec) + "\n")
