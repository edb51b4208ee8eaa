"""Chaos fault injection, gray-failure detection, and graceful recovery.

Meili's availability story (Appendix D) is one clean NIC crash followed by
snapshot-restore failover. Real pooled deployments see worse: correlated
rack outages, flapping links, and *gray* failures where a NIC silently
underperforms while still reporting full capacity (the DPU-variability
literature documents exactly this across SmartNIC classes). This module is
the harness that drives the existing failover/defrag/QoS machinery through
those fault sequences, plus the recovery policy that turns eviction into
graceful degradation:

  ``FaultPlan``/``ChaosEngine``  a seeded, declarative schedule of timed
      fault events (crash / revive / flap / gray / rack / mid_migration)
      executed against a ``ServiceRuntime`` — replaces the single-shot
      ``fail_at`` hook (kept as a shim).
  ``GrayFailureDetector``  per-NIC suspicion scoring over sustained
      achieved-vs-expected deviation, with exoneration: a NIC is only as
      suspicious as its happiest loaded tenant, so one degraded tenant
      cannot frame a healthy NIC it shares.
  ``RecoveryManager``  dead tenants are parked in a retry queue with
      exponential backoff + jitter and re-admitted through the governor's
      admission machinery when capacity revives; while anyone is parked the
      governor issues *brownout* partial grants so survivors shed the
      headroom the parked tenants need to come back.
  ``sentinel_check``  ledger + stage-liveness + flow-conservation invariants
      run after every chaos event, so drift under compound faults fails
      loudly at the injection site instead of ticks later.

Everything here is runtime-agnostic by duck typing (the runtime argument
needs ``ctrl``/``registry``/``telemetry``/``inject_failure``): the service
layer imports this module, never the reverse.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Set

# Fault kinds understood by the ChaosEngine.
CRASH = "crash"                  # whole-NIC failure -> Appendix-D failover
REVIVE = "revive"                # repair: NIC / rack / (neither) all failed
FLAP = "flap"                    # crash + scheduled revive after duration_ticks
GRAY = "gray"                    # silent degradation to `fraction` of capacity
RACK = "rack"                    # correlated crash of every NIC in one rack
MID_MIGRATION = "mid_migration"  # crash landed inside a make-before-break window


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``nic`` targets a member (None = busiest for a
    crash), ``rack`` targets a failure domain (RACK, or REVIVE of a whole
    rack), ``fraction`` is the GRAY capacity factor, ``duration_ticks`` is
    the FLAP outage length."""

    tick: int
    kind: str
    nic: Optional[str] = None
    rack: Optional[str] = None
    fraction: float = 1.0
    duration_ticks: int = 0


@dataclasses.dataclass
class FaultPlan:
    """A declarative, deterministic fault schedule (the chaos A/B needs the
    identical sequence on both arms; seed covers future randomized plans)."""

    events: List[FaultEvent]
    seed: int = 0

    def due(self, tick: int) -> List[FaultEvent]:
        return sorted((e for e in self.events if e.tick == tick),
                      key=lambda e: (e.kind, e.nic or "", e.rack or ""))


# ---------------------------------------------------------------------------
# Gray-failure detection
# ---------------------------------------------------------------------------

class GrayFailureDetector:
    """Suspicion scoring over observed service deviation.

    Each tick the runtime hands in, per NIC, the deviation
    ``1 - achieved/expected`` observed by every *loaded* tenant whose
    placement touches that NIC (idle tenants provide no evidence — a NIC
    serving a trough perfectly proves nothing). The NIC's evidence for the
    tick is the **minimum** across observers: exoneration. A single tenant
    degraded for its own reasons (backlog, overload) cannot frame a healthy
    NIC, because any other loaded tenant achieving full service pulls the
    minimum to zero. Suspicion is an EWMA of that evidence; a NIC becomes a
    suspect once suspicion exceeds the threshold for ``min_ticks``
    consecutive evidence-bearing ticks.
    """

    def __init__(self, threshold: float = 0.3, min_ticks: int = 3,
                 alpha: float = 0.5):
        self.threshold = threshold
        self.min_ticks = min_ticks
        self.alpha = alpha
        self.suspicion: Dict[str, float] = {}
        self.streak: Dict[str, int] = {}
        self.probation: Set[str] = set()
        # Observability: when a DecisionTrace is attached, every
        # suspicion increment and exoneration lands in the audit log, and
        # the most recent observer set per NIC is kept so a quarantine
        # verdict can name who testified.
        self.trace = None
        self.observers: Dict[str, List[str]] = {}
        # Acquittal watermarks: when localization drains one of
        # several identically-convicted NICs, the co-accused are *acquitted*
        # — parked at their current streak, evidence intact — rather than
        # wiped. See ``acquit``.
        self.watch: Dict[str, int] = {}

    def observe(self, blame: Dict[str, List[float]],
                observers: Optional[Dict[str, List[str]]] = None) -> None:
        """``blame``: nic -> deviations from each loaded tenant using it this
        tick. NICs absent from ``blame`` hold their streak (no evidence
        either way); NICs with any zero-deviation observer reset it.
        ``observers`` (optional) names the tenants behind each NIC's
        deviations, recorded for the audit trail."""
        for nic, devs in blame.items():
            if not devs:
                continue
            if observers is not None and nic in observers:
                self.observers[nic] = list(observers[nic])
            dev = min(devs)
            s = self.suspicion.get(nic, 0.0)
            self.suspicion[nic] = (1.0 - self.alpha) * s + self.alpha * dev
            if dev > self.threshold:
                self.streak[nic] = self.streak.get(nic, 0) + 1
                if self.trace is not None:
                    self.trace.event(
                        "gray_suspicion", nic=nic, kind="fault",
                        deviation=dev, suspicion=self.suspicion[nic],
                        streak=self.streak[nic],
                        observers=self.observers.get(nic, []))
            else:
                if self.streak.get(nic, 0) > 0 and self.trace is not None:
                    self.trace.event(
                        "gray_exonerated", nic=nic, kind="fault",
                        deviation=dev, suspicion=self.suspicion[nic],
                        observers=self.observers.get(nic, []))
                self.streak[nic] = 0
                self.watch.pop(nic, None)

    def suspects(self) -> List[str]:
        return sorted(
            n for n, s in self.suspicion.items()
            if s > self.threshold
            and self.streak.get(n, 0) >= self.min_ticks
            and self.streak.get(n, 0) > self.watch.get(n, -1)
            and n not in self.probation)

    def acquit(self, nic: str) -> None:
        """Localization verdict, not exoneration: the drained suspect's
        co-accused keep their suspicion and streak, but cannot convict again
        until *fresh* evidence arrives after the drain. If the shared witness
        recovers once the drained NIC is gone, the co-accused's evidence
        stops (streak held at the watermark, never above) and its tenants'
        full service exonerates it; if the witness still deviates on its
        post-drain placement, the surviving suspect convicts itself on the
        very next evidence tick — the drain made the evidence diagnostic."""
        self.watch[nic] = self.streak.get(nic, 0)

    def clear(self, nic: str) -> None:
        """Repair observed (revive): the NIC starts over with a clean record."""
        self.suspicion.pop(nic, None)
        self.streak.pop(nic, None)
        self.probation.discard(nic)
        self.observers.pop(nic, None)
        self.watch.pop(nic, None)


# ---------------------------------------------------------------------------
# Recovery: park + backoff + re-admission, brownout while parked
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveryConfig:
    """Policy knobs for post-failure tenant recovery.

    ``park=False`` reproduces the eviction-or-nothing baseline (a tenant
    whose placement cannot be restored is gone for good); ``park=True`` is
    the graceful path: retry with exponential backoff + jitter, re-admit
    when capacity revives. ``brownout`` clamps survivors' grants toward
    ``brownout_floor`` x contract (weight-proportionally) while anyone is
    parked, so scale-downs free the units re-admission needs.
    """

    park: bool = True
    base_backoff_ticks: int = 4
    max_backoff_ticks: int = 32
    jitter_frac: float = 0.25
    brownout: bool = True
    brownout_floor: float = 0.4
    seed: int = 0


@dataclasses.dataclass
class ParkedTenant:
    tenant: str
    parked_tick: int
    next_retry: int
    backoff: int
    retries: int = 0


class RecoveryManager:
    """Turns failover's unmet placements into parked-then-readmitted tenants.

    ``sweep`` evicts tenants a failure left dead (some stage at zero units)
    — into the parked retry queue when parking is on, permanently otherwise.
    ``step`` runs the due retries, heaviest-weight first, through the
    registry's re-admission path (quota re-registered, strict admission),
    and keeps the governor's brownout level in sync with the parked set.
    """

    def __init__(self, runtime, cfg: Optional[RecoveryConfig] = None):
        self.rt = runtime
        self.cfg = cfg or RecoveryConfig()
        self.parked: Dict[str, ParkedTenant] = {}
        self.evicted: List[str] = []              # permanent (park disabled)
        self.readmissions: List[tuple] = []       # (tenant, ticks parked)
        self._rng = random.Random(self.cfg.seed)

    # -- eviction of dead tenants ----------------------------------------------
    def sweep(self, tick: int) -> List[str]:
        """Evict every active tenant whose placement lost a whole stage —
        a pipeline with a zero-unit stage serves nothing, and holding its
        surviving units hostage only starves the tenants that could use
        them. Returns the tenants swept this call."""
        swept: List[str] = []
        for name in list(self.rt.registry.active()):
            dep = self.rt.registry.deployment(name)
            if all(dep.allocation.units(s) >= 1 for s in dep.profile.stages):
                continue
            swept.append(name)
            self.rt.registry.evict(name)
            self.rt._drop_plane(name)
            for d in (self.rt._demand, self.rt._backlog, self.rt._granted,
                      self.rt._cooldown):
                d.pop(name, None)
            if self.cfg.park:
                self.rt.registry.parked.add(name)
                self.parked[name] = ParkedTenant(
                    tenant=name, parked_tick=tick,
                    next_retry=tick + self.cfg.base_backoff_ticks,
                    backoff=self.cfg.base_backoff_ticks)
                self.rt.telemetry.record_fault(
                    tick, "parked", tenant=name,
                    shard=self.rt.ctrl.shard_of(name))
            else:
                # Never retried: the rejection note keeps churn's pending()
                # from silently re-admitting what policy just evicted.
                self.rt.registry.rejected[name] = "evicted (recovery disabled)"
                self.evicted.append(name)
                self.rt.telemetry.record_fault(
                    tick, "evicted", tenant=name,
                    shard=self.rt.ctrl.shard_of(name))
        if swept:
            self._update_brownout()
        return swept

    # -- the per-tick retry pass -----------------------------------------------
    def step(self, tick: int) -> None:
        self.sweep(tick)
        gov = self.rt.ctrl.governor
        due = [p for p in self.parked.values() if p.next_retry <= tick]
        for p in sorted(due, key=lambda q: -gov.weight(q.tenant)):
            name = p.tenant
            spec = self.rt.registry.specs[name]
            if spec.depart_tick is not None and spec.depart_tick <= tick:
                # Departed while parked: nothing left to restore.
                del self.parked[name]
                self.rt.registry.parked.discard(name)
                continue
            if self.rt.registry.readmit(name):
                del self.parked[name]
                self.rt.registry.parked.discard(name)
                waited = tick - p.parked_tick
                self.readmissions.append((name, waited))
                self.rt.telemetry.record_fault(
                    tick, "readmitted", tenant=name,
                    detail=f"after {waited} ticks, {p.retries + 1} tries",
                    shard=self.rt.ctrl.shard_of(name))
                self.rt._events[name] = "readmitted"
                self.rt._grace_until[name] = tick + self.rt.cfg.slo_grace_ticks
                self.rt._force_rescale.add(name)
            else:
                p.retries += 1
                p.backoff = min(self.cfg.max_backoff_ticks, p.backoff * 2)
                jitter = self._rng.randint(
                    0, max(0, int(self.cfg.jitter_frac * p.backoff)))
                p.next_retry = tick + p.backoff + jitter
        self._update_brownout()

    def _update_brownout(self) -> None:
        """Brownout level tracks how much contracted capacity is parked:
        survivors degrade (weight-proportionally, via the governor) by the
        share the parked tenants will need back, never below the floor."""
        gov = self.rt.ctrl.governor
        if not (self.cfg.brownout and self.parked):
            gov.set_brownout(None)
            return
        specs = self.rt.registry.specs
        parked_c = sum(specs[n].sla.target_gbps
                       for n in self.parked if n in specs)
        total_c = parked_c + sum(specs[n].sla.target_gbps
                                 for n in self.rt.registry.active()
                                 if n in specs)
        level = max(self.cfg.brownout_floor,
                    1.0 - parked_c / max(total_c, 1e-9))
        gov.set_brownout(level)

    def notify_capacity(self, tick: int) -> None:
        """Capacity returned to the pool (a NIC revived): retry every parked
        tenant on the next tick instead of waiting out the blind timer. The
        backoff state is kept — if the retry still fails, the exponential
        schedule resumes where it left off. Pure timer backoff made
        re-admission miss repair waves entirely: a retry that fired just
        before the revive pushed the next attempt a doubled backoff past it."""
        for p in self.parked.values():
            p.next_retry = min(p.next_retry, tick + 1)

    def mean_time_to_recover(self) -> Optional[float]:
        """Mean ticks parked across all re-admissions (None if none yet)."""
        if not self.readmissions:
            return None
        return sum(w for _, w in self.readmissions) / len(self.readmissions)


# ---------------------------------------------------------------------------
# Invariant sentinel
# ---------------------------------------------------------------------------

def sentinel_check(runtime) -> None:
    """Run after every chaos event: any drift fails at the injection site.

    Checks (1) the pool ledger (free + held == capacity, bandwidth within
    epsilon, dead NICs included), (2) stage liveness — every *active* tenant
    has at least one placed unit per stage (the recovery sweep must run
    first: it is what removes the legitimately-dead), and (3) flow
    conservation — every flow-table entry maps to a pipeline that exists,
    and no ingress backlog went negative.
    """
    runtime.ctrl.check_ledger()
    problems: List[str] = []
    for name in runtime.registry.active():
        dep = runtime.registry.deployment(name)
        for s in dep.profile.stages:
            if dep.allocation.units(s) < 1:
                problems.append(f"{name}/{s}: zero placed units")
        pids = {p.pid for p in dep.to.pipelines}
        for f, pid in dep.to.flow_table.items():
            if pid not in pids:
                problems.append(f"{name}: flow {f} -> missing pipeline {pid}")
    for t, b in runtime._backlog.items():
        if b < -1e-9:
            problems.append(f"{t}: negative backlog {b}")
    if problems:
        raise AssertionError("chaos sentinel: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class ChaosEngine:
    """Executes a FaultPlan against a bound ServiceRuntime, one tick at a
    time. After every fired event the recovery sweep runs (evict-or-park the
    dead) and the invariant sentinel validates the whole control plane."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rt = None
        self.fired: List[FaultEvent] = []
        self._revive_at: Dict[int, List[FaultEvent]] = {}

    def bind(self, runtime) -> None:
        self.rt = runtime

    def step(self, tick: int) -> None:
        # Scheduled flap revives fire before new faults: an event injecting
        # at the same tick sees the repaired pool, not the transient.
        for ev in self._revive_at.pop(tick, []):
            self._fire(tick, ev)
        for ev in self.plan.due(tick):
            self._fire(tick, ev)

    # -- dispatch ---------------------------------------------------------------
    def _fire(self, tick: int, ev: FaultEvent) -> None:
        rt = self.rt
        pool = rt.ctrl.pool
        if ev.kind == CRASH:
            self._crash(tick, ev.nic)
        elif ev.kind == FLAP:
            nic = self._crash(tick, ev.nic, kind=FLAP)
            if nic is not None:
                self._revive_at.setdefault(
                    tick + max(1, ev.duration_ticks), []).append(
                        FaultEvent(tick=tick, kind=REVIVE, nic=nic))
        elif ev.kind == REVIVE:
            # nic targets one member, rack a whole domain; neither = a full
            # repair wave — every NIC still down (crash victims included,
            # whichever the trajectory picked) is replaced.
            if ev.rack:
                members = pool.rack_members(ev.rack)
            elif ev.nic:
                members = [ev.nic]
            else:
                members = [n for n in pool.nics if not pool[n].alive]
            for n in members:
                pool.revive(n)
                rt.note_revive(n)
            rt.telemetry.record_fault(tick, REVIVE, nic=",".join(members))
        elif ev.kind == GRAY:
            # Ground truth only: the detector must find this from achieved
            # throughput, never by reading the pool's gray factor.
            pool.mark_gray(ev.nic, ev.fraction)
            rt.telemetry.record_fault(tick, GRAY, nic=ev.nic,
                                      detail=f"frac={ev.fraction:g}",
                                      shard=rt.ctrl.shard_of_nic(ev.nic))
        elif ev.kind == RACK:
            for n in pool.rack_members(ev.rack):
                if pool[n].alive:
                    self._crash(tick, n, note=False)
            members = pool.rack_members(ev.rack)
            rt.telemetry.record_fault(
                tick, RACK, nic=ev.rack,
                shard=rt.ctrl.shard_of_nic(members[0]) if members else None)
        elif ev.kind == MID_MIGRATION:
            self._mid_migration(tick)
        else:
            raise ValueError(f"unknown fault kind: {ev.kind!r}")
        self.fired.append(ev)
        rt.recovery.sweep(tick)
        try:
            sentinel_check(rt)
        except AssertionError:
            # Sentinel tripped: auto-dump the flight recorder's incident
            # bundle so the failing state is preserved. The dump
            # is exception-safe (``dump_safe`` never raises — a failed dump
            # logs a ``flight_dump_failed`` trace event instead) and the
            # original sentinel error always propagates unmasked.
            fl = getattr(rt, "flight", None)
            if fl is not None:
                fl.dump_safe(trigger="sentinel_failure", tick=tick)
            raise

    def _crash(self, tick: int, nic: Optional[str], note: bool = True,
               kind: str = CRASH) -> Optional[str]:
        failed, _ = self.rt.inject_failure(nic)
        if note and failed is not None:
            # Failure domains map to shard ownership: the record carries
            # the owning shard so the fault log localizes by rack.
            self.rt.telemetry.record_fault(
                tick, kind, nic=failed,
                shard=self.rt.ctrl.shard_of_nic(failed))
        return failed

    def _mid_migration(self, tick: int) -> None:
        """Arm the controller's one-shot hook, then force a migration: the
        injected crash lands between make-before-break begin and finish —
        flows buffered, ledger already swapped to the destination — the
        nastiest window the failover path can be hit in."""
        rt = self.rt

        def on_swap(app_name: str) -> None:
            dep = rt.ctrl.deployments[app_name]
            nics = sorted(dep.nics_used())
            if nics:
                rt.telemetry.record_fault(tick, MID_MIGRATION, nic=nics[0],
                                          tenant=dep.tenant,
                                          shard=rt.ctrl.shard_of_nic(nics[0]))
                rt.inject_failure(nics[0])

        rt.ctrl.mid_migration_hook = on_swap
        alive = rt.ctrl.pool.names()
        for name in sorted(rt.ctrl.deployments):
            if rt.ctrl.migrate(name, only_nics=alive, forced=True,
                               require_improvement=False) is not None:
                break
        if rt.ctrl.mid_migration_hook is not None:
            # No admissible migration anywhere: disarm and log the no-op so
            # the A/B's event accounting stays honest.
            rt.ctrl.mid_migration_hook = None
            rt.telemetry.record_fault(tick, MID_MIGRATION, detail="no-op")
