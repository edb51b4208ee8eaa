"""The discrete-time service loop + closed-loop autoscaler (Meili-Serve).

Each tick the runtime:

  1. handles tenant churn (admissions due this tick, departures, rejected
     admissions are logged and retried never — strict admission control);
  2. injects a NIC failure if one is scheduled, driving the controller's
     Appendix-D failover; impacted tenants get a re-place retry and a short
     SLO grace window;
  3. per active tenant: reads the tick's offered load, runs the autoscaler
     (the paper's §8.4 scale response is milliseconds — below one tick — so
     scaling acts within the tick it is decided), optionally pushes a
     representative PacketBatch through the tenant's fused ParallelDataPlane
     (tagged with the tenant for dispatch-stats attribution), and records
     telemetry from the calibrated latency model;
  4. snapshots cluster-level reserved units + utilization, and periodically
     replicates state to backup NICs (Appendix D).

The autoscaler is fast-attack / slow-decay: demand estimates jump to the
observed load (offered + queued backlog drain — the reactive loop scales on
what is waiting, not just what arrived) instantly but decay with EWMA
smoothing. Every capacity decision routes through the controller's
``ResourceGovernor`` (core.qos): the governor's ``ScaleVerdict`` applies
the tenant's quota, burst credits, and the pool's per-tick headroom ledger
(a partial grant under contention), and the runtime merely executes it via
``adaptive_scale``. Per-tick dispatch is the governor's deficit-weighted
round-robin over tenant ingress queues: the telemetry backlog is the queue
depth scheduled against, so an over-quota tenant queues behind its own
deficit instead of triggering pool-wide rescales.

On the port the runtime is host Python over the control plane, as in the
JAX package, with three things on the device it is given (``device=``, the
card by default; it never picks the CPU itself): each tenant's fused data
plane (``ParallelDataPlane``, whose stage chains launch the NIC kernels),
the packet batches pushed through it, and, with
``RuntimeConfig.vectorized_sched``, the governor's DWRR tick
(``core.sched_kernel.VectorizedScheduler``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.apps.profiles import PKT_BITS
from repro_torch.core.controller import MeiliController
from repro_torch.core.executor import ParallelDataPlane, _sync
from repro_torch.core.faults import (CRASH, ChaosEngine, FaultEvent,
                                     FaultPlan, GrayFailureDetector,
                                     RecoveryConfig, RecoveryManager)
from repro_torch.hw import resolve_device
from repro_torch.obs import (PAGE, WARN, BurnAlertManager, BurnRule,
                             FlightRecorder, Obs, SLOEngine)
from repro_torch.obs.alerts import FIRING
from repro_torch.service.tenants import AdmissionError, TenantRegistry
from repro_torch.service.telemetry import (ClusterTick, TelemetryLog,
                                           TenantTick, hop_penalties,
                                           measure_tenant_tick)
from repro_torch.service.workload import ScenarioWorkload

PKT_BYTES_F = PKT_BITS / 8.0


@dataclasses.dataclass
class RuntimeConfig:
    dt_s: float = 0.05                # simulated tick duration
    autoscale: bool = True
    headroom: float = 1.15            # provision = demand-estimate * headroom
    decay: float = 0.45               # EWMA decay on the way down
    floor_frac: float = 0.2           # never scale below floor_frac * contract
    rescale_threshold: float = 0.1    # relative gap that triggers a scale call
    scale_cooldown_ticks: int = 2
    dataplane_every: int = 1          # run the fused data plane every N ticks (0 = off)
    max_pkts_per_tick: int = 192
    pkt_bytes: int = 192
    replicate_every: int = 8          # Appendix-D replication cadence
    slo_tol: float = 0.1              # achieved >= (1-tol) * min(offered, contract)
    slo_grace_ticks: int = 3          # post-failover/migration grace window
    defrag_every: int = 0             # run a defrag pass every N ticks (0 = off)
    defrag_max_moves: int = 1         # migrations per defrag pass
    defrag_min_score: float = 1.0     # fragmentation score that justifies a move
    warmup_ticks: int = 2
    max_violation_frac: float = 0.05
    max_sim_seqs: int = 96
    # Shared ingress budget the governor's DWRR splits across tenants
    # (Gbps). None = uncapped: every tenant drains to its own placed
    # capacity and DWRR only decides the dispatch order (pre-QoS behavior).
    ingress_gbps: Optional[float] = None
    # Gray-failure detection (chaos layer): suspicion scoring on sustained
    # achieved-vs-expected deviation; suspects go on probation and are
    # drained via forced migration, then quarantined.
    gray_detect: bool = False
    gray_threshold: float = 0.3       # suspicion level + per-tick deviation bar
    gray_min_ticks: int = 3           # consecutive evidence ticks before drain
    gray_min_load_frac: float = 0.5   # offered/achievable for a tick to count
                                      # as evidence (idle tenants prove nothing)
    # Vectorized scheduling kernel: run the per-tick DWRR as one
    # tensor program over stacked tenant rows on the device (core.sched_kernel)
    # instead of the scalar dict walk. Default OFF: the scalar path is the
    # pinned reference oracle the kernel is property-tested against.
    vectorized_sched: bool = False
    # SLO error-budget engine + multi-window burn-rate alerting + flight
    # recorder. Default OFF so every pre-existing scenario is
    # bit-identical; when on, each recorded TenantTick is scored against
    # the tenant's SLA-derived budget, burn rules are evaluated per tick,
    # and a page-severity alert pre-arms the gray detector (lower per-NIC
    # evidence bar) + requests a proactive scale consult.
    slo_enabled: bool = False
    slo_horizon_ticks: int = 64       # rolling error-budget horizon
    alert_fast_window: int = 8        # "1h-equivalent" page window (ticks)
    alert_fast_confirm: int = 2
    alert_slow_window: int = 24       # "6h-equivalent" warn window (ticks)
    alert_slow_confirm: int = 6
    alert_page_burn: float = 4.0      # page-rule burn-rate multiple
    alert_warn_burn: float = 2.0      # warn-rule burn-rate multiple
    alert_holddown_ticks: int = 4     # clear streak required to resolve
    alert_prearm_ticks: int = 8       # page pre-arms implicated NICs this long
    alert_prearm_factor: float = 0.5  # × gray_min_load_frac while pre-armed
    # False = shadow mode: alerts still fire, trace, export metrics, and
    # auto-dump flight bundles, but pages take NO action (no detector
    # pre-arm, no forced scale consult). The observe-only deployment an
    # operator runs before trusting alert-driven automation — and what the
    # overhead A/B times, so mitigation work is not billed as recording.
    alert_actions: bool = True
    flight_capacity: int = 64         # snapshot ring length (ticks)
    flight_trace_window: int = 16     # trailing trace ticks in a dump bundle
    flight_dir: Optional[str] = None  # None = record, never auto-dump


class ServiceRuntime:
    def __init__(self, controller: MeiliController, registry: TenantRegistry,
                 workload: ScenarioWorkload,
                 cfg: Optional[RuntimeConfig] = None,
                 recovery: Optional[RecoveryConfig] = None,
                 obs: Optional[Obs] = None, device="cuda"):
        # Resolved once, before anything else: a missing card fails here,
        # even for a run that never pushes a batch (dataplane_every=0).
        self.device = resolve_device(device)
        self.ctrl = controller
        self.registry = registry
        self.workload = workload
        self.cfg = cfg or RuntimeConfig()
        # One observability context for the whole stack: reuse the
        # controller's (which the governor already audits into) unless the
        # caller supplies one. The telemetry log mirrors fault records into
        # the same trace, so chaos events, recovery transitions, governor
        # verdicts, and controller spans share one causal order.
        self.obs = obs or controller.obs
        self.telemetry = TelemetryLog(trace=self.obs.trace,
                                      warmup_ticks=self.cfg.warmup_ticks)
        self.tick_now = 0
        self._planes: Dict[str, ParallelDataPlane] = {}
        # Dispatch attribution carried across plane rebuilds (scale/failover
        # drops a tenant's plane; its counters must not vanish with it).
        self._dp_stats: Dict[str, Dict[str, int]] = {}
        self._demand: Dict[str, float] = {}      # EWMA demand estimate
        self._cooldown: Dict[str, int] = {}
        self._backlog: Dict[str, float] = {}     # ingress queue depth (pkts)
        self._granted: Dict[str, float] = {}     # last governor grant (Gbps)
        self._grace_until: Dict[str, int] = {}
        self._force_rescale: Set[str] = set()
        self._events: Dict[str, str] = {}        # tenant -> event this tick
        # Recovery policy: the default reproduces eviction-or-nothing (a
        # tenant whose placement cannot be restored is permanently evicted);
        # pass a RecoveryConfig with park=True for graceful degradation +
        # backoff re-admission.
        self.recovery = RecoveryManager(
            self, recovery or RecoveryConfig(park=False, brownout=False))
        self.gray = (GrayFailureDetector(threshold=self.cfg.gray_threshold,
                                         min_ticks=self.cfg.gray_min_ticks)
                     if self.cfg.gray_detect else None)
        # Sequential-probe bookkeeping: drained suspect -> the co-accused it
        # was convicted alongside, for vindication (see _drain_suspects).
        self._probe_history: Dict[str, List[str]] = {}
        if self.gray is not None:
            self.gray.trace = self.obs.trace
        # SLO / alerting / flight layer. The pre-arm ledger
        # exists unconditionally — with no alerts it stays empty and the
        # gray evidence bar is exactly the legacy one.
        self._gray_prearm: Dict[str, int] = {}   # nic -> armed until tick
        self.slo: Optional[SLOEngine] = None
        self.alerts: Optional[BurnAlertManager] = None
        self.flight: Optional[FlightRecorder] = None
        if self.cfg.slo_enabled:
            cfg = self.cfg
            self.slo = SLOEngine(self.obs,
                                 horizon_ticks=cfg.slo_horizon_ticks,
                                 warmup_ticks=cfg.warmup_ticks,
                                 shard_resolver=self.ctrl.shard_of)
            rules = (BurnRule(PAGE, cfg.alert_fast_window,
                              cfg.alert_fast_confirm, cfg.alert_page_burn),
                     BurnRule(WARN, cfg.alert_slow_window,
                              cfg.alert_slow_confirm, cfg.alert_warn_burn))
            self.alerts = BurnAlertManager(
                self.slo, self.obs, rules=rules,
                holddown_ticks=cfg.alert_holddown_ticks,
                shard_resolver=self.ctrl.shard_of)
            if cfg.alert_actions:
                self.alerts.on_page.append(self._on_page_alert)
            self.telemetry.subscribe(self._slo_feed)
            self.flight = FlightRecorder(
                self.obs, capacity=cfg.flight_capacity,
                out_dir=cfg.flight_dir,
                trace_window_ticks=cfg.flight_trace_window)
        if self.cfg.vectorized_sched:
            from repro_torch.core.sched_kernel import VectorizedScheduler
            controller.governor.attach_kernel(
                VectorizedScheduler(device=self.device))
        controller.add_hook(self._on_event)

    # -- SLO feed + early-warning hook ------------------------------
    def _slo_feed(self, tt: TenantTick) -> None:
        """Telemetry subscriber: score every recorded tick against the
        tenant's SLA-derived error budget, exactly once."""
        spec = self.registry.specs.get(tt.tenant)
        if spec is not None and self.slo is not None:
            self.slo.observe(tt, spec.sla)

    def _on_page_alert(self, tenant: str, tr) -> None:
        """A page-severity burn alert is the early warning the runtime acts
        on BEFORE the contract breaks: pre-arm the gray detector on the
        tenant's NICs (the per-NIC evidence bar drops by
        ``alert_prearm_factor`` so a sick-but-lightly-loaded NIC can still
        testify) and request a proactive scale consult next tick."""
        dep = self.ctrl.deployments.get(tenant)
        nics = sorted(dep.nics_used()) if dep is not None else []
        until = self.tick_now + self.cfg.alert_prearm_ticks
        for n in nics:
            self._gray_prearm[n] = max(self._gray_prearm.get(n, -1), until)
        self._force_rescale.add(tenant)
        self.obs.trace.event("gray_prearm", tenant=tenant, nics=nics,
                             until_tick=until,
                             burn_long=round(tr.burn_long, 6),
                             burn_short=round(tr.burn_short, 6))

    # -- controller feedback ---------------------------------------------------
    def _on_event(self, ev: dict) -> None:
        tenant = ev.get("tenant") or ev.get("app")
        if tenant is None:
            return
        if ev["event"] in ("scale", "failover", "migrate"):
            # Placement changed: the tenant's data plane is rebuilt lazily
            # with the new pipeline count (dispatch programs are shared
            # process-wide, so this is cheap).
            self._drop_plane(tenant)
            self._events[tenant] = ev["event"]
        if ev["event"] == "failover":
            self._grace_until[tenant] = self.tick_now + self.cfg.slo_grace_ticks
            self._force_rescale.add(tenant)
        if ev["event"] == "migrate":
            # Flows buffered through the make-before-break hand-off: give the
            # tenant the same short SLO grace a failover gets.
            self._grace_until[tenant] = self.tick_now + self.cfg.slo_grace_ticks

    def _drop_plane(self, tenant: str) -> None:
        dp = self._planes.pop(tenant, None)
        if dp is None:
            return
        for t, per in dp.dispatch_stats.get("by_tenant", {}).items():
            acc = self._dp_stats.setdefault(t, {"calls": 0, "packets": 0})
            acc["calls"] += per["calls"]
            acc["packets"] += per["packets"]

    def dataplane_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant dispatch attribution over the whole run: accumulated
        counters of dropped planes plus the live ones."""
        out = {t: dict(v) for t, v in self._dp_stats.items()}
        for dp in self._planes.values():
            for t, per in dp.dispatch_stats.get("by_tenant", {}).items():
                acc = out.setdefault(t, {"calls": 0, "packets": 0})
                acc["calls"] += per["calls"]
                acc["packets"] += per["packets"]
        return out

    def _plane(self, tenant: str) -> ParallelDataPlane:
        dp = self._planes.get(tenant)
        if dp is None:
            dep = self.registry.deployment(tenant)
            cap = self.ctrl._pipeline_capacity(dep.profile, dep.num_pipelines)
            dp = ParallelDataPlane(dep.app, num_pipelines=dep.num_pipelines,
                                   capacity_per_pipeline=cap,
                                   metrics=self.obs.metrics,
                                   trace=self.obs.trace,
                                   device=self.device)
            self._planes[tenant] = dp
        return dp

    # -- closed-loop autoscaler (capacity decisions live in the governor) ------
    def _queued_gbps(self, tenant: str) -> float:
        """The backlog as a drain rate: queued packets expressed in Gbps if
        they were to drain within one tick — the autoscaler's pressure
        signal covers offered + queued, not offered alone."""
        return (self._backlog.get(tenant, 0.0) * PKT_BITS
                / max(self.cfg.dt_s, 1e-9) / 1e9)

    def _autoscale(self, tenant: str, offered: float) -> None:
        spec = self.registry.specs[tenant]
        dep = self.registry.deployment(tenant)
        cfg = self.cfg
        load = offered + self._queued_gbps(tenant)
        prev = self._demand.get(tenant, load)
        est = load if load >= prev else (
            (1.0 - cfg.decay) * prev + cfg.decay * load)
        self._demand[tenant] = est
        if not cfg.autoscale:
            self._granted[tenant] = dep.target_gbps
            return
        need = dep.app.resource_needs()
        verdict = self.ctrl.governor.scale_verdict(
            tenant, est_gbps=est, offered_gbps=load,
            contract_gbps=spec.sla.target_gbps,
            current_gbps=dep.target_gbps,
            achievable_gbps=dep.achievable_gbps,
            unit_gbps=dep.profile.t_p,
            stage_kinds=sorted(need.values()),    # one entry PER stage
            held_units=self.ctrl.pool.reserved_units(tenant),
            headroom=cfg.headroom, floor_frac=cfg.floor_frac,
            rescale_threshold=cfg.rescale_threshold,
            cooldown_active=self._cooldown.get(tenant, 0) > 0,
            forced=tenant in self._force_rescale)
        self._granted[tenant] = verdict.target_gbps
        if verdict.brownout:
            # Degraded partial grant while parked tenants wait for capacity:
            # surfaced both per-tick (tenant event) and in the fault log.
            self._events.setdefault(tenant, "degraded")
            self.telemetry.record_fault(self.tick_now, "degraded",
                                        tenant=tenant,
                                        shard=self.ctrl.shard_of(tenant))
        if verdict.rescale:
            self.ctrl.adaptive_scale(tenant, verdict.target_gbps)
            self._cooldown[tenant] = cfg.scale_cooldown_ticks
            self._force_rescale.discard(tenant)
        else:
            # Clamp at zero: letting the counter march negative would make a
            # later cooldown reset meaningless after long quiet stretches.
            self._cooldown[tenant] = max(0, self._cooldown.get(tenant, 0) - 1)

    # -- failure injection -----------------------------------------------------
    def inject_failure(self, nic: Optional[str] = None
                       ) -> Tuple[Optional[str], List[str]]:
        """Fail one NIC (the busiest allocated one if unspecified) and run
        the controller's Appendix-D failover. When no NIC is named and no
        allocations exist anywhere (e.g. every tenant already evicted), the
        injection is a no-op — a ``failover_skipped`` fault event is logged
        and the tick loop continues instead of aborting the run."""
        if nic is None:
            load: Dict[str, int] = {}
            for dep in self.ctrl.deployments.values():
                for n, row in dep.allocation.A.items():
                    if self.ctrl.pool[n].alive:
                        load[n] = load.get(n, 0) + sum(row.values())
            if not load:
                self.telemetry.record_fault(self.tick_now, "failover_skipped",
                                            detail="no allocated NICs")
                return None, []
            nic = max(load, key=load.get)
        impacted = self.ctrl.handle_failure(nic)
        return nic, impacted

    def note_revive(self, nic: str) -> None:
        """A repaired NIC returned to the pool: the gray detector forgets any
        suspicion/probation so the NIC starts over with a clean record, and
        parked tenants get an immediate retry against the new capacity."""
        if self.gray is not None:
            self.gray.clear(nic)
        self._probe_history.pop(nic, None)
        if self.recovery is not None:
            self.recovery.notify_capacity(self.tick_now)

    # -- gray-failure detection ------------------------------------------------
    def _drain_suspects(self, tick: int) -> None:
        """Put each newly-suspect NIC on probation and drain it: forced
        migration of every deployment touching it onto healthy NICs (worth
        extra hops — the do-no-harm guard is bypassed), falling back to a
        hard failover for placements the healthy pool cannot re-home whole.
        Either way the NIC ends quarantined (dead to the allocator) until a
        revive repairs it.

        At most ONE quarantine per tick: when the only loaded observer of a
        sick NIC spans several NICs, its deviation convicts the whole
        placement identically — the evidence cannot localize. Drain the
        worst suspect and *acquit* the co-accused: their evidence is kept
        but parked at its current streak, so a genuinely sick survivor
        re-convicts itself on the first post-drain evidence tick (the
        witness was re-placed off the drained NIC — deviation that persists
        now points at the survivor alone), while a healthy one sees its
        evidence stop and is exonerated as soon as its tenants recover."""
        suspects = self.gray.suspects()
        if not suspects:
            return

        def at_stake(n: str) -> int:
            # Units the pool currently has riding on the suspect. When
            # suspicion is exactly tied (one witness convicting its whole
            # placement), drain the most-loaded suspect first: with a flat
            # prior over the tied suspects, expected damage removed by the
            # drain scales with the load the NIC carries.
            return sum(sum(row.values())
                       for dep in self.ctrl.deployments.values()
                       for m, row in dep.allocation.A.items() if m == n)

        for nic in [max(suspects,
                        key=lambda n: (self.gray.suspicion.get(n, 0.0),
                                       at_stake(n), n))]:
            co_accused = [n for n in suspects if n != nic]
            for other in co_accused:
                self.gray.acquit(other)
            # Vindication: this conviction came from evidence that persisted
            # AFTER an earlier probe drained a co-suspect on the same
            # testimony — the witness was re-placed and still deviates, so
            # the earlier drain hit an innocent NIC. Give it back.
            for prior, accused in list(self._probe_history.items()):
                if nic in accused and not self.ctrl.pool[prior].alive:
                    self.ctrl.pool.revive(prior)
                    self.gray.clear(prior)
                    del self._probe_history[prior]
                    self.obs.trace.event("gray_vindicated", nic=prior,
                                         convicted=nic)
                    self.telemetry.record_fault(
                        tick, "gray_vindicated", nic=prior,
                        detail=f"evidence persisted, convicted {nic}",
                        shard=self.ctrl.shard_of_nic(prior))
                    self.recovery.notify_capacity(tick)
            if co_accused:
                self._probe_history[nic] = co_accused
            self.gray.probation.add(nic)
            # The quarantine verdict, with everything an operator needs to
            # audit it: why this NIC, on whose testimony, who was acquitted.
            self.obs.trace.event(
                "quarantine_verdict", nic=nic,
                reason=(f"suspicion {self.gray.suspicion.get(nic, 0.0):.3f} "
                        f"> {self.gray.threshold:g} for "
                        f">= {self.gray.min_ticks} evidence ticks"),
                suspicion=self.gray.suspicion.get(nic, 0.0),
                streak=self.gray.streak.get(nic, 0),
                observers=self.gray.observers.get(nic, []),
                co_accused=co_accused)
            self.telemetry.record_fault(tick, "gray_probation", nic=nic,
                                        shard=self.ctrl.shard_of_nic(nic))
            with self.obs.trace.span("gray_drain", nic=nic) as sp:
                # Drain targets route through the controller: a sharded
                # facade prefers the sick NIC's shard-local healthy set
                # (failure domain = shard), falling back pool-wide.
                candidates = self.ctrl.drain_nic_candidates(
                    nic, exclude=self.gray.probation)
                victims = [name for name, dep in self.ctrl.deployments.items()
                           if nic in dep.nics_used()]
                for name in victims:
                    for healthy in candidates:
                        if self.ctrl.migrate(
                                name, only_nics=healthy, forced=True,
                                require_improvement=False) is not None:
                            break
                still = [name for name, dep in self.ctrl.deployments.items()
                         if nic in dep.nics_used()]
                if still:
                    self.inject_failure(nic)
                    self.telemetry.record_fault(tick, "gray_quarantined",
                                                nic=nic,
                                                detail="escalated to failover",
                                                shard=self.ctrl.shard_of_nic(nic))
                else:
                    self.ctrl.pool.mark_failed(nic)
                    self.telemetry.record_fault(tick, "gray_quarantined",
                                                nic=nic,
                                                shard=self.ctrl.shard_of_nic(nic))
                sp.note(victims=victims, escalated=bool(still))
            self.recovery.sweep(tick)

    # -- churn -----------------------------------------------------------------
    def _churn(self, tick: int) -> None:
        for name in self.registry.departing(tick):
            self.registry.evict(name)
            self._drop_plane(name)
            self._events[name] = "depart"
        for name in self.registry.pending(tick):
            try:
                self.registry.admit(name)
                self._events[name] = "admit"
            except AdmissionError:
                self._events[name] = "admission_rejected"

    # -- the loop --------------------------------------------------------------
    def run(self, num_ticks: int,
            fail_at: Optional[Tuple[int, Optional[str]]] = None,
            chaos: Optional[ChaosEngine] = None) -> TelemetryLog:
        cfg = self.cfg
        if fail_at is not None and chaos is None:
            # Legacy shim: the single-shot failure hook becomes a one-event
            # chaos plan (same injection point, same failover path).
            chaos = ChaosEngine(FaultPlan(
                [FaultEvent(tick=fail_at[0], kind=CRASH, nic=fail_at[1])]))
        if chaos is not None:
            chaos.bind(self)
        for _ in range(num_ticks):
            tick = self.tick_now
            self.obs.set_tick(tick)
            # Shard reconciliation: refresh headroom digests that
            # reached the staleness bound BEFORE this tick's admissions
            # consult them. No-op on the unsharded controller.
            self.ctrl.reconcile(tick)
            self._churn(tick)
            if chaos is not None:
                chaos.step(tick)
            # Recovery pass: evict-or-park tenants the faults left dead, run
            # due re-admission retries, keep the brownout level current.
            self.recovery.step(tick)
            if (cfg.defrag_every and tick > 0
                    and tick % cfg.defrag_every == 0):
                # Background re-placement between ticks: migrate the most
                # fragmented deployments onto compact NIC sets (make-before-
                # break inside the controller; tenants get SLO grace via the
                # migrate event hook above).
                self.ctrl.defragment(max_migrations=cfg.defrag_max_moves,
                                     min_score=cfg.defrag_min_score)

            gov = self.ctrl.governor
            active = [t for t in self.registry.active()
                      if t in self.workload.specs]
            gov.begin_tick(self.ctrl.pool, active, tick=tick)

            # Pass 1 — demand estimation + governor-granted scaling, in
            # priority order: under contention the headroom ledger is drawn
            # down heaviest-weight-first, so partial grants favor the
            # contracts the pool values most.
            offered_now: Dict[str, float] = {
                t: self.workload.offered_gbps(t, tick) for t in active}
            for tenant in gov.priority_order(active):
                self._autoscale(tenant, offered_now[tenant])

            # Pass 2 — the governor's DWRR over ingress queues decides the
            # dispatch order and, when a shared ingress budget is set, each
            # tenant's service share for the tick (backlog = queue depth).
            queues: Dict[str, float] = {}
            rate_caps: Dict[str, float] = {}
            gray_scale: Dict[str, float] = {}
            for tenant in active:
                dep = self.registry.deployment(tenant)
                arriving = (offered_now[tenant] * 1e9 / PKT_BITS * cfg.dt_s
                            + self._backlog.get(tenant, 0.0))
                queues[tenant] = arriving * PKT_BYTES_F
                # A gray NIC bottlenecks every pipeline chained through it:
                # the service ceiling (not the allocator's view) degrades.
                gray_scale[tenant] = self.ctrl.pool.capacity_frac(
                    dep.nics_used())
                rate_caps[tenant] = (max(0.0, dep.achievable_gbps)
                                     * gray_scale[tenant]
                                     * 1e9 / 8.0 * cfg.dt_s)
            ingress = (None if cfg.ingress_gbps is None
                       else cfg.ingress_gbps * 1e9 / 8.0 * cfg.dt_s)
            order, served_bytes = gov.dwrr_schedule(queues, rate_caps,
                                                    capacity_bytes=ingress)

            cluster_achieved = 0.0
            cluster_nics: set = set()
            cluster_hops = 0
            blame: Dict[str, List[float]] = {}   # nic -> observed deviations
            witnesses: Dict[str, List[str]] = {}  # nic -> testifying tenants
            for tenant in order:
                spec = self.registry.specs[tenant]
                offered = offered_now[tenant]
                dep = self.registry.deployment(tenant)

                if cfg.dataplane_every and tick % cfg.dataplane_every == 0:
                    batch = self.workload.batch_for(
                        tenant, tick, max_pkts=cfg.max_pkts_per_tick,
                        pkt_bytes=cfg.pkt_bytes, device=self.device)
                    if batch is not None:
                        self._plane(tenant).process(batch, tenant=tenant)
                        _sync(self.device)

                hop_pen = hop_penalties(dep)   # once per tenant per tick
                p50, p99, achieved, backlog, samples = measure_tenant_tick(
                    dep, offered, cfg.dt_s,
                    self._backlog.get(tenant, 0.0), cfg.max_sim_seqs,
                    hop_pen=hop_pen,
                    served_pkts=served_bytes[tenant] / PKT_BYTES_F,
                    capacity_scale=gray_scale.get(tenant, 1.0),
                    return_samples=True)
                self._backlog[tenant] = backlog
                cluster_achieved += achieved
                # Measured percentiles: the raw per-sequence
                # latency samples stream into a per-tenant histogram; the
                # p99 reported beside the legacy estimator is an exact (or
                # P²-approximate past reservoir capacity) percentile of the
                # run's whole sample distribution so far.
                hist = self.obs.metrics.histogram("tenant_latency_s",
                                                  tenant=tenant)
                if samples.size:
                    hist.observe_many(samples)
                p99_measured = hist.quantile(0.99) if hist.count else 0.0

                expect = min(offered, spec.sla.target_gbps)
                slo_ok = (achieved >= (1.0 - cfg.slo_tol) * expect
                          and p99 <= spec.sla.p99_latency_s)
                in_grace = tick < self._grace_until.get(tenant, -1)
                tenant_nics = dep.nics_used()
                tenant_hops = len(hop_pen)
                if self.gray is not None:
                    # Evidence only from loaded tenants: a tick whose offered
                    # load exercises a meaningful fraction of placed capacity
                    # either blames every NIC in the placement (service fell
                    # short) or exonerates them all (full service).
                    want = min(offered, max(0.0, dep.achievable_gbps))
                    # A tenant the shared-ingress DWRR budget starved this
                    # tick cannot testify: its shortfall is the scheduler's
                    # doing, not its NICs' — contention deviation would
                    # frame every NIC in the placement at once.
                    starved = (ingress is not None
                               and served_bytes.get(tenant, 0.0) + 1.0
                               < min(queues[tenant], rate_caps[tenant]))
                    if want > 0.1 and not in_grace and not starved:
                        dev = max(0.0, 1.0 - achieved / want)
                        ach_ref = max(dep.achievable_gbps, 1e-9)
                        for n in tenant_nics:
                            # Per-NIC evidence bar: a page-severity
                            # burn alert pre-arms the implicated NICs, cutting
                            # the "loaded enough to testify" bar so the
                            # detector gathers evidence sooner. With nothing
                            # pre-armed this is exactly the legacy
                            # whole-placement gray_min_load_frac check.
                            bar = cfg.gray_min_load_frac
                            if self._gray_prearm.get(n, -1) > tick:
                                bar *= cfg.alert_prearm_factor
                            if offered >= bar * ach_ref:
                                blame.setdefault(n, []).append(dev)
                                witnesses.setdefault(n, []).append(tenant)
                cluster_nics.update(tenant_nics)
                cluster_hops += tenant_hops
                self.telemetry.record(TenantTick(
                    tick=tick, tenant=tenant, offered_gbps=offered,
                    achieved_gbps=achieved, p50_s=p50, p99_s=p99,
                    units=self.ctrl.pool.reserved_units(tenant),
                    slo_ok=slo_ok, in_grace=in_grace,
                    event=self._events.pop(tenant, ""),
                    hop_pairs=tenant_hops, nics_used=len(tenant_nics),
                    granted_gbps=self._granted.get(tenant, dep.target_gbps),
                    backlog_pkts=backlog, p99_measured_s=p99_measured))

                if (spec.backup_nic is not None
                        and cfg.replicate_every
                        and tick % cfg.replicate_every == 0):
                    self.ctrl.replicate_for_failover(tenant)

            self.telemetry.record_cluster(ClusterTick(
                tick=tick, reserved_units=self.ctrl.pool.reserved_units(),
                achieved_gbps=cluster_achieved,
                nic_util={r: self.ctrl.pool.utilization(r)
                          for r in ("cpu", "regex", "crypto", "compression")},
                nics_used=len(cluster_nics), hop_pairs=cluster_hops))
            # Alert evaluation BEFORE the gray pass: a page that fires this
            # tick pre-arms the detector (via on_page) and its trace events
            # precede any quarantine verdict the evidence later produces.
            page_fired = False
            if self.alerts is not None:
                for tr in self.alerts.step(tick):
                    if tr.severity == PAGE and tr.state == FIRING:
                        page_fired = True
            if self.gray is not None and blame:
                self.gray.observe(blame, observers=witnesses)
                self._drain_suspects(tick)
            if self.flight is not None:
                # Snapshot end-of-tick state (grants, queues, headroom,
                # suspicion, budgets) into the ring; a page-severity alert
                # auto-dumps the incident bundle with this tick included.
                self.flight.snapshot(tick, self)
                if page_fired:
                    self.flight.dump_safe(trigger="page_alert", tick=tick)
            self._events.clear()
            self.tick_now += 1
        return self.telemetry

    # -- liveness --------------------------------------------------------------
    def alive_tenants(self) -> List[str]:
        """Tenants whose every stage still has at least one placed unit."""
        out = []
        for name in self.registry.active():
            dep = self.registry.deployment(name)
            if all(dep.allocation.units(s) >= 1 for s in dep.profile.stages):
                out.append(name)
        return out

    def slo_report(self) -> Dict[str, dict]:
        return self.telemetry.slo_report(self.cfg.warmup_ticks,
                                         self.cfg.max_violation_frac)
