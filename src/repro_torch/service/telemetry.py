"""Per-tenant / per-NIC telemetry for the service loop (Meili-Serve).

Latency comes from the calibrated discrete-event model (``core.sim``): each
tick simulates a window of packet arrivals at the tenant's offered rate
through its *placed* replica set (``dep.r_s``), with the paper's ~4.5 µs hop
penalty added wherever the allocation puts consecutive stages on disjoint
NICs (§8.5, Table 1). Sustained over-demand accumulates in a per-tenant
backlog whose drain time is added to the reported percentiles, so
under-provisioning shows up as latency SLO violations the autoscaler must
fix — the closed loop the runtime implements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.apps.profiles import HOP_US, PKT_BITS
from repro_torch.core import sim
from repro_torch.core.controller import Deployment
from repro_torch.core.defrag import disjoint_pairs


@dataclasses.dataclass
class TenantTick:
    tick: int
    tenant: str
    offered_gbps: float
    achieved_gbps: float
    p50_s: float
    p99_s: float                 # legacy estimator: sim percentile + backlog formula
    units: int                   # resource units attributed to the tenant
    slo_ok: bool
    in_grace: bool = False       # post-failover/migration grace (no SLO acct)
    event: str = ""              # "scale" / "failover" / "migrate" / ...
    hop_pairs: int = 0           # consecutive stages on disjoint NICs
    nics_used: int = 0           # NICs this tenant's placement spans
    granted_gbps: float = 0.0    # governor-granted provision target (QoS)
    backlog_pkts: float = 0.0    # ingress queue depth carried out of the tick
    p99_measured_s: float = 0.0  # measured p99 over the run's sample stream
                                 # (obs histogram; 0 until samples exist)


@dataclasses.dataclass
class ClusterTick:
    tick: int
    reserved_units: int
    achieved_gbps: float
    nic_util: Dict[str, float]   # resource kind -> pool utilization
    nics_used: int = 0           # distinct NICs carrying any placement
    hop_pairs: int = 0           # Σ per-tenant disjoint consecutive pairs


@dataclasses.dataclass
class FaultRecord:
    """One chaos/recovery event: injected faults (crash/flap/gray/rack/...)
    and the recovery reactions (parked/readmitted/evicted/degraded/
    gray_probation/gray_quarantined/failover_skipped)."""

    tick: int
    kind: str
    nic: Optional[str] = None
    tenant: Optional[str] = None
    detail: str = ""
    shard: Optional[str] = None  # owning failure domain (sharded controller)


class TelemetryLog:
    """Run log of tenant/cluster/fault records.

    ``warmup_ticks`` set at construction is the shared default horizon for
    every accessor that excludes warmup (``slo_report``/``slo_tick_count``/
    ``summary``) — callers may still override per call, but the log itself
    now knows the run's warmup so the accessors agree by default. When a
    ``DecisionTrace`` is attached, every fault record is mirrored into it
    as a ``kind="fault"`` event, so chaos injections and recovery
    transitions land in the same causally-ordered audit log as governor
    verdicts and controller spans.
    """

    def __init__(self, trace=None, warmup_ticks: int = 0):
        self.tenant_ticks: List[TenantTick] = []
        self.cluster_ticks: List[ClusterTick] = []
        self.fault_events: List[FaultRecord] = []
        self.trace = trace
        self.warmup_ticks = warmup_ticks
        # One-pass per-tenant grouping, built incrementally: accessors used
        # to rescan all ticks per tenant per call (O(tenants x ticks) every
        # report); the index appends only what arrived since the last call.
        self._groups: Dict[str, List[TenantTick]] = {}
        self._grouped_upto = 0
        # Live consumers of the tenant-tick stream: the SLO
        # engine subscribes so every recorded tick is scored exactly once,
        # at the moment the runtime records it.
        self._subscribers: List = []

    def subscribe(self, fn) -> None:
        """Register ``fn(TenantTick)`` to run on every ``record``."""
        self._subscribers.append(fn)

    def _grouped(self) -> Dict[str, List[TenantTick]]:
        for t in self.tenant_ticks[self._grouped_upto:]:
            self._groups.setdefault(t.tenant, []).append(t)
        self._grouped_upto = len(self.tenant_ticks)
        return self._groups

    def record(self, t: TenantTick) -> None:
        self.tenant_ticks.append(t)
        for fn in self._subscribers:
            fn(t)

    def record_cluster(self, c: ClusterTick) -> None:
        self.cluster_ticks.append(c)

    def record_fault(self, tick: int, kind: str, nic: Optional[str] = None,
                     tenant: Optional[str] = None, detail: str = "",
                     shard: Optional[str] = None) -> None:
        self.fault_events.append(FaultRecord(tick=tick, kind=kind, nic=nic,
                                             tenant=tenant, detail=detail,
                                             shard=shard))
        if self.trace is not None:
            extra = {"shard": shard} if shard is not None else {}
            self.trace.event(kind, tenant=tenant, nic=nic, kind="fault",
                             tick=tick, detail=detail, **extra)

    def faults(self, kind: Optional[str] = None) -> List[FaultRecord]:
        if kind is None:
            return list(self.fault_events)
        return [f for f in self.fault_events if f.kind == kind]

    def series(self, tenant: str) -> List[TenantTick]:
        return list(self._grouped().get(tenant, ()))

    def _warmup(self, warmup_ticks: Optional[int]) -> int:
        return self.warmup_ticks if warmup_ticks is None else warmup_ticks

    # -- SLO accounting -------------------------------------------------------
    def slo_report(self, warmup_ticks: Optional[int] = None,
                   max_violation_frac: float = 0.05) -> Dict[str, dict]:
        """Per-tenant SLO compliance over the run; ticks inside a post-failover
        grace window or the warmup are not counted against the tenant."""
        warmup = self._warmup(warmup_ticks)
        out: Dict[str, dict] = {}
        for tenant, s in self._grouped().items():
            r = {"ticks": 0, "violations": 0}
            for t in s:
                if t.tick < warmup or t.in_grace:
                    continue
                r["ticks"] += 1
                r["violations"] += 0 if t.slo_ok else 1
            if r["ticks"]:
                out[tenant] = r
        for tenant, r in out.items():
            r["violation_frac"] = (r["violations"] / r["ticks"]
                                   if r["ticks"] else 0.0)
            r["pass"] = r["violation_frac"] <= max_violation_frac
        return out

    def slo_tick_count(self, warmup_ticks: Optional[int] = None) -> int:
        """Tenant-ticks of SLO-compliant service (post-warmup, non-grace) —
        the chaos A/B's primary served-value metric: a parked tenant scores
        zero for every tick it sits out, a browned-out one for every tick
        the partial grant dips below SLO."""
        warmup = self._warmup(warmup_ticks)
        return sum(1 for t in self.tenant_ticks
                   if t.tick >= warmup and not t.in_grace and t.slo_ok)

    def summary(self, warmup_ticks: Optional[int] = None) -> Dict[str, dict]:
        """Per-tenant run statistics over post-warmup ticks (the same
        horizon ``slo_report`` uses, so the two reports describe the same
        window by default).

        One segment-reduction pass over stacked record arrays
        (``sched_kernel.telemetry_reduce_np``) instead of the per-tenant
        dict loops — O(records) regardless of tenant count. The old loop
        survives as ``summary_scalar``, the pinned reference oracle."""
        from repro_torch.core.sched_kernel import telemetry_reduce_np
        warmup = self._warmup(warmup_ticks)
        recs = [t for t in self.tenant_ticks if t.tick >= warmup]
        if not recs:
            return {}
        names = sorted({t.tenant for t in recs})
        row = {t: i for i, t in enumerate(names)}
        idx = np.fromiter((row[t.tenant] for t in recs), dtype=np.int64,
                          count=len(recs))
        counts, means, maxes = telemetry_reduce_np(
            idx, len(names),
            means={
                "offered_gbps_mean": [t.offered_gbps for t in recs],
                "achieved_gbps_mean": [t.achieved_gbps for t in recs],
                "units_mean": [t.units for t in recs],
                "hop_pairs_mean": [t.hop_pairs for t in recs],
                "nics_used_mean": [t.nics_used for t in recs],
            },
            maxes={
                "p99_s_max": [t.p99_s for t in recs],
                "p99_measured_s_max": [t.p99_measured_s for t in recs],
            })
        out: Dict[str, dict] = {}
        for tenant, i in row.items():
            if counts[i] <= 0:
                continue
            rec = {"ticks": int(counts[i])}
            rec.update({k: float(v[i]) for k, v in means.items()})
            rec.update({k: float(v[i]) for k, v in maxes.items()})
            out[tenant] = rec
        return {t: out[t] for t in sorted(out)}

    def summary_scalar(self, warmup_ticks: Optional[int] = None
                       ) -> Dict[str, dict]:
        """The original per-tenant dict-loop reduction, kept as the pinned
        reference oracle for the vectorized ``summary`` above."""
        warmup = self._warmup(warmup_ticks)
        out: Dict[str, dict] = {}
        for tenant in sorted(self._grouped()):
            s = [t for t in self._grouped()[tenant] if t.tick >= warmup]
            if not s:
                continue
            out[tenant] = {
                "ticks": len(s),
                "offered_gbps_mean": float(np.mean([t.offered_gbps for t in s])),
                "achieved_gbps_mean": float(np.mean([t.achieved_gbps for t in s])),
                "p99_s_max": float(max(t.p99_s for t in s)),
                "p99_measured_s_max": float(max(t.p99_measured_s for t in s)),
                "units_mean": float(np.mean([t.units for t in s])),
                "hop_pairs_mean": float(np.mean([t.hop_pairs for t in s])),
                "nics_used_mean": float(np.mean([t.nics_used for t in s])),
            }
        return out

    def locality(self, from_tick: int = 0) -> Dict[str, float]:
        """Cluster-level fragmentation view over ticks >= from_tick: mean
        NICs carrying placements and mean total disjoint-pair count — the
        two quantities defragmentation is supposed to pull back down."""
        window = [c for c in self.cluster_ticks if c.tick >= from_tick]
        if not window:
            return {"nics_used_mean": 0.0, "hop_pairs_mean": 0.0}
        return {
            "nics_used_mean": float(np.mean([c.nics_used for c in window])),
            "hop_pairs_mean": float(np.mean([c.hop_pairs for c in window])),
        }

    def totals(self) -> Tuple[float, float]:
        """(Σ achieved Gbps·ticks, Σ reserved units·ticks) over the run —
        the numerator/denominator of the resource-efficiency metric."""
        ach = sum(c.achieved_gbps for c in self.cluster_ticks)
        res = sum(c.reserved_units for c in self.cluster_ticks)
        return ach, float(res)


# -- the per-tick measurement model -------------------------------------------

def hop_penalties(dep: Deployment) -> Dict[Tuple[str, str], float]:
    """Paper §8.5 hop penalty for consecutive stages placed on disjoint NICs
    (pair detection shared with the defrag scorer: core.defrag)."""
    return {pair: HOP_US * 1e-6
            for pair in disjoint_pairs(dep.allocation, dep.profile.stages)}


def measure_tenant_tick(dep: Deployment, offered_gbps: float, dt_s: float,
                        backlog_pkts: float, max_sim_seqs: int = 96,
                        hop_pen: Optional[Dict[Tuple[str, str], float]] = None,
                        served_pkts: Optional[float] = None,
                        capacity_scale: float = 1.0,
                        return_samples: bool = False):
    """One tick of the latency/throughput model.

    Returns (p50_s, p99_s, achieved_gbps, new_backlog_pkts). Achieved rate is
    capped by the deployment's placed capacity — and, when the governor's
    DWRR scheduler granted this tenant a service share (``served_pkts``), by
    that grant. ``capacity_scale`` degrades the placed capacity without the
    allocator knowing (a gray failure: the runtime passes the pool's gray
    factor over the NICs the placement spans) — achieved throughput drops,
    backlog grows, and only that observable behavior can betray the sick
    NIC. The backlog models demand the placement could not serve this tick
    (drained when capacity exceeds offered load again); it is the ingress
    queue depth the governor schedules against next tick.

    With ``return_samples=True`` a fifth element is returned: the tick's
    individual per-sequence latency samples (backlog delay included), the
    raw stream the observability layer's histograms measure exact
    percentiles over — as opposed to the legacy p99 above, which is a
    percentile of one tick's simulated window plus a backlog *formula*.
    """
    cap_pps = (max(0.0, dep.achievable_gbps) * 1e9 / PKT_BITS
               * min(1.0, max(0.0, capacity_scale)))
    off_pps = max(0.0, offered_gbps) * 1e9 / PKT_BITS
    arriving = off_pps * dt_s + backlog_pkts
    served = min(arriving, cap_pps * dt_s)
    if served_pkts is not None:
        served = min(served, max(0.0, served_pkts))
    new_backlog = arriving - served
    achieved_gbps = (served / dt_s) * PKT_BITS / 1e9 if dt_s > 0 else 0.0

    if off_pps <= 0.0 or served <= 0.0:
        if return_samples:
            return 0.0, 0.0, achieved_gbps, new_backlog, np.zeros(0)
        return 0.0, 0.0, achieved_gbps, new_backlog

    # Per-packet stage latencies from the profile (l_s is per sequence batch).
    batch_pkts = dep.profile.batch_bits() / PKT_BITS
    l_pkt = {s: dep.profile.l_s[s] / batch_pkts for s in dep.profile.stages}
    R = {s: max(1, dep.r_s.get(s, 0)) for s in dep.profile.stages}
    n = int(min(max_sim_seqs, max(4, off_pps * dt_s)))
    res = sim.simulate(dep.profile.stages, l_pkt, R, num_seqs=n,
                       arrival_interval=1.0 / off_pps,
                       hop_penalty=(hop_pen if hop_pen is not None
                                    else hop_penalties(dep)))
    lat = np.asarray(res.latencies)
    # Queue carried over from earlier ticks delays everything behind it.
    backlog_delay = new_backlog / cap_pps if cap_pps > 0 else 0.0
    p50 = float(np.percentile(lat, 50)) + backlog_delay
    p99 = float(np.percentile(lat, 99)) + backlog_delay
    if return_samples:
        return p50, p99, achieved_gbps, new_backlog, lat + backlog_delay
    return p50, p99, achieved_gbps, new_backlog
