"""Flight recorder: a bounded ring of per-tick pool snapshots
that is cheap in steady state and dumps a self-contained incident bundle
when something goes wrong.

Every tick the runtime hands the recorder a high-resolution snapshot —
ingress queue depths, DWRR grants, the governor's headroom ledger, gray
suspicion scores, flow-cache hit counters, remaining SLO budgets, active
alerts, and the controller's per-NIC/per-shard flight state — appended to
a seeded bounded ring (``capacity`` ticks; large per-tenant maps are
thinned to ``max_entries`` by a seeded deterministic sample so a
1000-tenant pool cannot bloat the ring). No trace events, no device
syncs, no I/O: steady-state cost is dict building.

``dump()`` writes ``flight_<tick>.jsonl`` — a header record, every ring
snapshot, the trailing trace window, and the metric *deltas* since the
last dump — whenever ``sentinel_check`` fails or a page-severity burn
alert fires. The bundle is self-contained: a postmortem needs no live
process, only the file.

``dump_safe()`` is the exception-safe wrapper the trigger paths use:
a failed dump (unwritable directory, full disk) logs a
``flight_dump_failed`` trace event and returns None — it NEVER raises, so
it can never mask the sentinel error that triggered it. With no dump
directory configured it is a silent no-op (recording stays on; dumping is
opt-in).
"""
from __future__ import annotations

import collections
import json
import pathlib
import random
from typing import Any, Deque, Dict, List, Optional

from repro_torch.obs import Obs
from repro_torch.obs.metrics import Histogram


class FlightRecorder:
    def __init__(self, obs: Obs, capacity: int = 64, seed: int = 0,
                 out_dir=None, trace_window_ticks: int = 16,
                 max_entries: int = 32):
        self.obs = obs
        self.capacity = max(1, capacity)
        self.seed = seed
        self.out_dir = out_dir
        self.trace_window_ticks = max(1, trace_window_ticks)
        self.max_entries = max(1, max_entries)
        self.ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=self.capacity)
        self.dumps: List[str] = []
        self._rng = random.Random(seed)
        # Metric watermark for delta bundles: (name, labels) -> value/count
        # at the last dump (empty = deltas are absolute values).
        self._mark: Dict[tuple, float] = {}

    # -- recording -------------------------------------------------------------
    def _thin(self, d: Dict[str, Any]) -> Dict[str, Any]:
        """Bound a per-tenant/per-NIC map: past ``max_entries`` keys, keep a
        seeded deterministic sample (same seed + same data -> same choice)."""
        if len(d) <= self.max_entries:
            return dict(d)
        keys = self._rng.sample(sorted(d), self.max_entries)
        out = {k: d[k] for k in sorted(keys)}
        out["_thinned_from"] = len(d)
        return out

    def snapshot(self, tick: int, runtime) -> Dict[str, Any]:
        """Append one per-tick snapshot built from live runtime state."""
        gray = getattr(runtime, "gray", None)
        slo = getattr(runtime, "slo", None)
        alerts = getattr(runtime, "alerts", None)
        caches: Dict[str, Dict[str, int]] = {}
        for tenant, dp in sorted(getattr(runtime, "_planes", {}).items()):
            st = dp.flow_cache_stats() if hasattr(dp, "flow_cache_stats") \
                else None
            if st:
                caches[tenant] = {k: st[k] for k in ("hits", "misses")
                                  if k in st}
        # Raw copies only — no rounding, no sorting: snapshot() runs every
        # tick and is the layer's hot path; json's sort_keys orders the
        # dump, and full-precision floats just make the bundle marginally
        # bigger. dict() copies are C-speed.
        snap = {
            "tick": tick,
            "queues_pkts": self._thin(runtime._backlog),
            "grants_gbps": self._thin(runtime._granted),
            "headroom_units": runtime.ctrl.governor.headroom_snapshot(),
            "suspicion": (dict(gray.suspicion) if gray is not None else {}),
            "probation": sorted(gray.probation) if gray is not None else [],
            "budgets_remaining": ({t: b.remaining_frac()
                                   for t, b in slo.budgets.items()}
                                  if slo is not None else {}),
            "alerts_active": ([list(k) for k in alerts.active()]
                              if alerts is not None else []),
            "cache_stats": caches,
            "flight_state": runtime.ctrl.flight_state(),
        }
        self.ring.append(snap)
        return snap

    # -- dumping ---------------------------------------------------------------
    def _metric_deltas(self) -> List[dict]:
        out: List[dict] = []
        for (name, labels), m in sorted(self.obs.metrics._metrics.items()):
            cur = float(m.count if isinstance(m, Histogram) else m.value)
            prev = self._mark.get((name, labels), 0.0)
            if cur != prev:
                out.append({"name": name, "labels": dict(labels),
                            "kind": m.kind, "delta": cur - prev,
                            "value": cur})
            self._mark[(name, labels)] = cur
        return out

    def dump(self, trigger: str, tick: int, out_dir=None) -> str:
        """Write the ``flight_<tick>.jsonl`` bundle; returns its path.
        Raises on I/O failure — callers on error paths use ``dump_safe``."""
        base = out_dir if out_dir is not None else self.out_dir
        if base is None:
            raise ValueError("flight recorder has no dump directory")
        out = pathlib.Path(base)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"flight_{tick}.jsonl"
        since = tick - self.trace_window_ticks
        tail = [e for e in self.obs.trace.events if e.tick >= since]
        lines = [json.dumps({
            "record": "header", "trigger": trigger, "tick": tick,
            "capacity": self.capacity, "seed": self.seed,
            "snapshots": len(self.ring), "trace_events": len(tail),
            "trace_since_tick": since}, sort_keys=True)]
        for snap in self.ring:
            lines.append(json.dumps({"record": "snapshot", **snap},
                                    sort_keys=True))
        for e in tail:
            # Hand-built dict, not asdict/to_json: asdict deep-copies every
            # event recursively and a serialize/parse/re-serialize round
            # trip is worse still — both dominate dump latency on long
            # traces. json only READS detail, so the live dict is safe.
            lines.append(json.dumps(
                {"record": "trace", "seq": e.seq, "tick": e.tick,
                 "kind": e.kind, "name": e.name, "tenant": e.tenant,
                 "nic": e.nic, "span_id": e.span_id,
                 "parent_id": e.parent_id, "phase": e.phase,
                 "t_s": e.t_s, "detail": e.detail},
                sort_keys=True))
        for rec in self._metric_deltas():
            lines.append(json.dumps({"record": "metric_delta", **rec},
                                    sort_keys=True))
        path.write_text("\n".join(lines) + "\n")
        self.dumps.append(str(path))
        self.obs.trace.event("flight_dump", kind="mark", tick=tick,
                             trigger=trigger, snapshots=len(self.ring),
                             trace_events=len(tail))
        return str(path)

    def dump_safe(self, trigger: str, tick: int,
                  out_dir=None) -> Optional[str]:
        """Dump, but never raise: the trigger (a failed sentinel, a page
        alert) must keep propagating its OWN error, not the dump's. With no
        directory configured this is a silent no-op."""
        if out_dir is None and self.out_dir is None:
            return None
        try:
            return self.dump(trigger, tick, out_dir=out_dir)
        except Exception as exc:     # noqa: BLE001 — must not mask trigger
            try:
                self.obs.trace.event(
                    "flight_dump_failed", kind="mark", tick=tick,
                    trigger=trigger, error=f"{type(exc).__name__}: {exc}")
            except Exception:        # noqa: BLE001 — absolute last resort
                pass
            return None


def load_bundle(path) -> Dict[str, List[dict]]:
    """Read a ``flight_<tick>.jsonl`` bundle back, grouped by record type
    (``header`` / ``snapshot`` / ``trace`` / ``metric_delta``)."""
    out: Dict[str, List[dict]] = {"header": [], "snapshot": [],
                                  "trace": [], "metric_delta": []}
    with pathlib.Path(path).open() as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out.setdefault(rec.get("record", "unknown"), []).append(rec)
    return out
