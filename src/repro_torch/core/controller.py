"""Meili Controller + per-NIC Controller Agents (paper §3, §6, Appendix D).

The controller receives (program, throughput target) submissions
(``app_sub_thr``), derives the replication plan with Algorithm 1, computes
resource demand from the profiled throughputs, places units with
Algorithm 2/3, and deploys: per-pipeline ring buffers, TO flow tables,
executors. It keeps per-NIC state synchronized via CAs, performs adaptive
scaling when targets change, and fails over to backup NICs.

Demand formula (§6.1): with profile (t_p, l_p, t_s, l_s), Algorithm 1 gives
R; the R-allocation's throughput t_R is estimated from the replication-aware
pipeline rate; then

    r_s = R · ⌊t_t / t_R⌋            (whole R-granular pipeline groups)
        + I · ⌈(t_t − ⌊t_t/t_R⌋·t_R) / t_p⌉   (minimal-granularity remainder)

FCFS across applications; unsatisfiable targets are placed best-effort.

The JAX package's controller, line for line: every decision is host Python
over the pool's ledger, so events, allocations, ledgers and the ``obs``
trace compare with the reference's with ``==``. Each deployment's
``TrafficOrchestrator`` is host-only (no flow cache), as the reference
builds it; a data plane built from a deployment (``ParallelDataPlane`` with
``num_pipelines`` and ``_pipeline_capacity``) runs on the card.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core import allocation as alloc_mod
from repro_torch.core import defrag as defrag_mod
from repro_torch.core import replication
from repro_torch.core.allocation import (Allocation, commit, nic_charge,
                                         release, resource_alloc)
from repro_torch.core.graph import MeiliApp
from repro_torch.core.orchestrator import TrafficOrchestrator
from repro_torch.core.pool import Pool
from repro_torch.core.profiler import AppProfile
from repro_torch.core.qos import ResourceGovernor
from repro_torch.core.state_engine import StateService
from repro_torch.obs import Obs


@dataclasses.dataclass
class Deployment:
    app: MeiliApp
    target_gbps: float
    profile: AppProfile
    R: Dict[str, int]
    r_s: Dict[str, int]
    allocation: Allocation
    num_pipelines: int
    to: TrafficOrchestrator
    achievable_gbps: float
    backup_nic: Optional[str] = None
    state_snapshot: Optional[dict] = None
    # StateService.version at the last snapshot (None = never replicated):
    # the dirty flag that lets unchanged state skip the full re-traverse.
    replica_version: Optional[int] = None
    tenant: Optional[str] = None      # service-runtime owner (defaults to app name)

    def nics_used(self) -> List[str]:
        return [n for n, row in self.allocation.A.items()
                if any(v > 0 for v in row.values())]

    def usage(self) -> Dict[str, int]:
        """Resource kind -> units currently held (for pool attribution)."""
        need = self.app.resource_needs()
        out: Dict[str, int] = {}
        for s in self.profile.stages:
            kind = need[s]
            out[kind] = out.get(kind, 0) + self.allocation.units(s)
        return out


class ControllerAgent:
    """Per-NIC agent: Resource Manager + Runtime Manager (paper §3)."""

    def __init__(self, nic: str, pool: Pool):
        self.nic = nic
        self.pool = pool

    def status(self) -> dict:
        st = self.pool[self.nic]
        return {"nic": self.nic, "alive": st.alive, "free": dict(st.free),
                "free_bw_gbps": st.free_bw_gbps}


class MeiliController:
    def __init__(self, pool: Pool, clock: Callable[[], float] = time.monotonic,
                 governor: Optional[ResourceGovernor] = None,
                 obs: Optional[Obs] = None):
        self.pool = pool
        # Shared observability context: one metrics registry +
        # decision-audit trace for the whole pool. Controller operations
        # land as timed spans, governor verdicts as decision events, and a
        # service runtime layered on top reuses this same context so every
        # layer writes one causally-ordered log.
        self.obs = obs or Obs()
        # Every capacity/priority decision — admission clamp, scale grant,
        # migration do-no-harm, failover ordering — routes through one
        # governor (permissive defaults when no quotas are registered).
        self.governor = governor or ResourceGovernor()
        self.governor.bind(pool)
        self.governor.attach_obs(self.obs)
        self.agents = {n: ControllerAgent(n, pool) for n in pool.nics}
        self.deployments: Dict[str, Deployment] = {}
        self.state = StateService(list(pool.nics))
        self.clock = clock
        self.events: List[dict] = []    # controller action log (scaling/failover)
        # Service-runtime hooks: callables fired with every event dict the
        # controller logs (deploy/scale/failover/terminate), so a runtime
        # layered on top can react (rebuild data planes, retry placement)
        # without polling the event log.
        self.hooks: List[Callable[[dict], None]] = []
        # One-shot chaos hook: fired (then cleared) inside migrate() after the
        # allocation swap but before flows are re-homed — the exposed
        # make-before-break window a mid-migration fault lands in.
        self.mid_migration_hook: Optional[Callable[[str], None]] = None

    def add_hook(self, fn: Callable[[dict], None]) -> None:
        self.hooks.append(fn)

    def _emit(self, event: dict) -> None:
        self.events.append(event)
        labels = {"op": event.get("event", "")}
        shard = self.shard_of(event.get("tenant") or event.get("app"))
        if shard is not None:
            labels["shard"] = shard
        self.obs.metrics.counter("controller_ops_total", **labels).inc()
        for fn in self.hooks:
            fn(event)

    # -- shard facade hooks ----------------------------------------------------
    # The legacy controller IS the 0-shard layout: placement sees the whole
    # pool, reconciliation is a no-op, and nothing carries a shard label.
    # ``core.shard.ShardedController`` overrides these to route placement
    # through per-rack ControlShards.
    def shard_of(self, tenant: Optional[str]) -> Optional[str]:
        """Owning shard of a tenant (None in the unsharded layout)."""
        return None

    def shard_of_nic(self, nic: Optional[str]) -> Optional[str]:
        """Owning shard of a NIC (None in the unsharded layout)."""
        return None

    def reconcile(self, tick: Optional[int] = None) -> None:
        """Cross-shard reconciliation step (headroom digests, bounded
        staleness). The unsharded controller reads pool truth directly —
        nothing to reconcile."""
        return None

    def _alloc_for(self, tenant: str, stages, demand: Dict[str, int],
                   t_s, need: Dict[str, str], op: str = "place"):
        """Placement hook every allocation (submit / scale growth /
        failover re-place) routes through. The sharded controller
        restricts this to the owning shard's NICs, spilling cross-rack
        when the shard cannot fit the demand."""
        return resource_alloc(stages, demand, t_s, self.pool, need)

    def drain_nic_candidates(self, nic: str,
                             exclude: Optional[set] = None) -> List[List[str]]:
        """Candidate NIC sets for draining deployments off ``nic``
        (gray-failure probation), in preference order. The sharded
        controller prepends the sick NIC's shard-local healthy set so
        drains stay within the failure domain when possible."""
        exclude = exclude or set()
        return [[n for n in self.pool.names()
                 if n != nic and n not in exclude]]

    def _account(self, dep: Deployment) -> None:
        """Resync the pool's per-tenant usage ledger from the deployment's
        current allocation (idempotent; called after every mutation)."""
        self.pool.set_usage(dep.tenant or dep.app.name, dep.usage())

    def flight_state(self) -> Dict[str, dict]:
        """Per-NIC pool state for the flight recorder's per-tick snapshot.
        The unsharded layout carries no shard labels and no
        shard digests; ``ShardedController`` overrides to add both."""
        pool = self.pool
        nics: Dict[str, dict] = {}
        for n in sorted(pool.names()):
            st = pool[n]
            nics[n] = {"alive": st.alive, "free_bw_gbps": st.free_bw_gbps,
                       "gray_frac": st.gray_frac}
        return {"nics": nics, "shards": {}}

    # -- §6.1 demand calculation -------------------------------------------------
    def demand(self, profile: AppProfile, target_gbps: float
               ) -> tuple[Dict[str, int], Dict[str, int], float]:
        stages = profile.stages
        R = replication.num_replication(stages, profile.l_s)
        # throughput of one R-allocated pipeline group (Gbps)
        rate = replication.pipeline_throughput(stages, profile.l_s, R)  # seq/s
        t_R = rate * profile.batch_bits() / 1e9
        n_groups = int(math.floor(target_gbps / t_R))
        r_s = {s: R[s] * n_groups for s in stages}
        rem = target_gbps - n_groups * t_R
        if rem > 1e-9:
            n_min = int(math.ceil(rem / profile.t_p))
            for s in stages:
                r_s[s] += n_min  # I = one minimal unit per stage
        return R, r_s, t_R

    # -- submission (Meili.app_sub_thr) -------------------------------------------
    def submit(self, app: MeiliApp, target_gbps: float, profile: AppProfile,
               backup_nic: Optional[str] = None,
               tenant: Optional[str] = None) -> Deployment:
        with self.obs.trace.span("submit", tenant=tenant or app.name,
                                 app=app.name,
                                 asked_gbps=target_gbps) as sp:
            # Admission routes through the governor: a target above the
            # tenant's declared quota is clamped before any demand/placement
            # math runs.
            target_gbps = self.governor.admission_target(tenant or app.name,
                                                         target_gbps)
            R, r_s, t_R = self.demand(profile, target_gbps)
            need = app.resource_needs()
            alloc = self._alloc_for(tenant or app.name, profile.stages, r_s,
                                    profile.t_s, need, op="submit")
            commit(self.pool, alloc, need)
            achievable = self._achievable(profile, alloc, r_s)
            num_pipes = max(1, max((alloc.units(s) for s in profile.stages),
                                   default=1))
            cap = self._pipeline_capacity(profile, num_pipes)
            to = TrafficOrchestrator(num_pipelines=num_pipes,
                                     capacity_per_pipeline=cap)
            for name, decl in app.state_decls.items():
                self.state.declare(name, decl["pattern"])
            placed = {s: alloc.units(s) for s in profile.stages}
            dep = Deployment(app=app, target_gbps=target_gbps, profile=profile,
                             R=R, r_s=placed, allocation=alloc,
                             num_pipelines=num_pipes, to=to,
                             achievable_gbps=achievable, backup_nic=backup_nic,
                             tenant=tenant or app.name)
            self.deployments[app.name] = dep
            self._account(dep)
            sp.note(granted_gbps=target_gbps, achievable_gbps=achievable,
                    nics=sorted(dep.nics_used()))
            self._emit({"t": self.clock(), "event": "deploy", "app": app.name,
                        "tenant": dep.tenant, "target": target_gbps,
                        "achievable": achievable})
            return dep

    def terminate(self, app_name: str) -> None:
        dep = self.deployments.pop(app_name)
        release(self.pool, dep.allocation, dep.app.resource_needs(),
                dep.profile.t_s)
        self.pool.clear_usage(dep.tenant or dep.app.name)
        self._emit({"t": self.clock(), "event": "terminate",
                    "app": app_name, "tenant": dep.tenant})

    # -- §6.1 adaptive scaling ------------------------------------------------------
    def adaptive_scale(self, app_name: str, new_target_gbps: float) -> Deployment:
        """Recompute demand and adjust allocation incrementally: current
        runtime is kept; extra pipelines are added (or halted + flows
        migrated) to meet the new target."""
        t0 = self.clock()
        dep = self.deployments[app_name]
        with self.obs.trace.span("scale", tenant=dep.tenant, app=app_name,
                                 target_gbps=new_target_gbps) as sp:
            dep = self._adaptive_scale(dep, app_name, new_target_gbps, t0)
            sp.note(achievable_gbps=dep.achievable_gbps,
                    num_pipelines=dep.num_pipelines)
            return dep

    def _adaptive_scale(self, dep: Deployment, app_name: str,
                        new_target_gbps: float, t0: float) -> Deployment:
        need = dep.app.resource_needs()
        R, r_s_new, _ = self.demand(dep.profile, new_target_gbps)
        delta = {s: r_s_new[s] - dep.r_s.get(s, 0) for s in dep.profile.stages}

        if any(d > 0 for d in delta.values()):
            grow = {s: max(0, d) for s, d in delta.items()}
            extra = self._alloc_for(dep.tenant or app_name,
                                    dep.profile.stages, grow,
                                    dep.profile.t_s, need, op="scale")
            commit(self.pool, extra, need)
            dep.allocation.merge(extra)
        if any(d < 0 for d in delta.values()):
            self._shrink(dep, {s: -d for s, d in delta.items() if d < 0}, need)

        dep.r_s = {s: dep.allocation.units(s) for s in dep.profile.stages}
        new_pipes = max(1, max(dep.r_s.values(), default=1))
        cap = self._pipeline_capacity(dep.profile, new_pipes)
        while len(dep.to.pipelines) < new_pipes:
            dep.to.add_pipeline(cap)
        for p in dep.to.pipelines:
            p.capacity = cap
        if len([p for p in dep.to.pipelines if p.active]) > new_pipes:
            # Halt the surplus pipelines and spread their flows across the
            # least-loaded survivors (funnelling everything to pipeline 0
            # hot-spots it on every scale-down).
            for p in dep.to.pipelines[new_pipes:]:
                if p.active:
                    dep.to.halt_pipeline(p.pid)
            survivors = [p.pid for p in dep.to.pipelines if p.active]
            flow_count = {pid: 0 for pid in survivors}
            for f, pid in dep.to.flow_table.items():
                if pid in flow_count:
                    flow_count[pid] += 1
            for f, pid in list(dep.to.flow_table.items()):
                if pid in flow_count:
                    continue   # still on a surviving pipeline
                dst = min(survivors, key=lambda q: (flow_count[q], q))
                dep.to.begin_migration(f)
                dep.to.finish_migration(f, dst_pid=dst)
                flow_count[dst] += 1
        dep.num_pipelines = new_pipes
        dep.target_gbps = new_target_gbps
        dep.achievable_gbps = self._achievable(dep.profile, dep.allocation,
                                               dep.r_s)
        self._account(dep)
        self._emit({"t": self.clock(), "event": "scale", "app": app_name,
                    "tenant": dep.tenant, "target": new_target_gbps,
                    "response_s": self.clock() - t0})
        return dep

    def _shrink(self, dep: Deployment, give_back: Dict[str, int],
                need: Dict[str, str]) -> None:
        """Return units to the pool, mirroring the Algorithm-3 colocation
        credit on the way out: the bandwidth credited back is the canonical
        charge *delta* of the shrunk row (capped by what this deployment
        actually holds on the NIC), never the naive per-unit sum. Removing a
        stage that a colocated successor was crediting can make the row's
        charge go UP (the hand-off now crosses the link again) — that case
        takes the extra bandwidth from the pool instead of crediting."""
        alloc = dep.allocation
        t_s = dep.profile.t_s
        S = dep.profile.stages
        for s, cnt in give_back.items():
            left = cnt
            for nic, row in alloc.A.items():
                if left <= 0:
                    break
                have = row.get(s, 0)
                take = min(have, left)
                if take <= 0:
                    continue
                charge_before = nic_charge(row, S, t_s)
                row[s] = have - take
                charge_after = nic_charge(row, S, t_s)
                self.pool[nic].give(need[s], take)
                held = alloc.bw_charge.get(nic, 0.0)
                delta = charge_before - charge_after
                if delta > 0.0:
                    credit = min(delta, held)
                    self.pool[nic].give_bw(credit)
                    alloc.bw_charge[nic] = held - credit
                elif delta < 0.0:
                    extra = min(-delta, self.pool[nic].free_bw_gbps)
                    self.pool[nic].take_bw(extra)
                    alloc.bw_charge[nic] = held + extra
                left -= take
        # Resync the allocator's view with pool truth: no zero-unit rows, no
        # stale bw_after — a later resource_alloc + commit must see reality.
        for nic in list(alloc.A):
            row = alloc.A[nic]
            for s in [k for k, u in row.items() if u <= 0]:
                del row[s]
            if alloc.bw_charge.get(nic, 0.0) <= 1e-12:
                alloc.bw_charge.pop(nic, None)
            alloc.bw_after[nic] = self.pool[nic].free_bw_gbps

    # -- Appendix D: failover -----------------------------------------------------
    def replicate_for_failover(self, app_name: str) -> None:
        """Periodic state + packet-cache replication to the backup NIC.

        Dirty-flag gated: if no state API write landed since the last
        snapshot (``StateService.version`` unchanged), the snapshot is
        already current and the full cross-NIC traverse is skipped."""
        dep = self.deployments[app_name]
        if dep.backup_nic is None:
            return
        if dep.replica_version == self.state.version:
            return
        entries = self.state.traverse(local=dep.backup_nic)
        dep.state_snapshot = {e.s_name: e.value for e in entries}
        dep.replica_version = self.state.version

    def handle_failure(self, nic: str) -> List[str]:
        """NIC (or its link) failed: re-place affected stage units, restore
        state from the last synchronized snapshot, re-home flows.

        The lost units and bandwidth charge are returned to the *failed*
        NIC's ledger (it is dead, so they are unobservable until a revive —
        but a revived NIC must come back clean, and the pool-wide ledger
        invariant must keep holding). Each impacted tenant's failover
        response time is measured from the start of ITS OWN re-placement,
        not a shared epoch that inflates later tenants' numbers.

        Re-placement order and demand route through the governor: impacted
        tenants re-place heaviest-weight first (scarce surviving capacity
        goes to the contracts the pool values most), and the re-placed
        demand is clamped to the tenant's unit quota."""
        self.pool.mark_failed(nic)
        impacted: List[str] = []
        victims = [name for name, dep in self.deployments.items()
                   if any(u > 0
                          for u in dep.allocation.A.get(nic, {}).values())]
        order = self.governor.failover_order(victims)
        with self.obs.trace.span("failover", nic=nic,
                                 victims=list(order)) as fsp:
            for name in order:
                dep = self.deployments[name]
                lost = {s: u for s, u in dep.allocation.A.get(nic, {}).items()
                        if u > 0}
                t0 = self.clock()
                impacted.append(name)
                with self.obs.trace.span("replace", tenant=dep.tenant,
                                         nic=nic, app=name,
                                         lost=dict(lost)) as rsp:
                    need = dep.app.resource_needs()
                    # Return the lost ledger entries to the dead NIC...
                    st = self.pool[nic]
                    for s, u in lost.items():
                        st.give(need[s], u)
                    st.give_bw(dep.allocation.bw_charge.pop(nic, 0.0))
                    dep.allocation.A[nic] = {}
                    dep.allocation.bw_after[nic] = st.free_bw_gbps
                    # ...and re-place the units lost on it, quota-clamped.
                    held = sum(dep.allocation.units(s)
                               for s in dep.profile.stages)
                    capped = self.governor.replacement_demand(
                        dep.tenant or name, lost, held_units=held)
                    lost_demand = {s: capped.get(s, 0)
                                   for s in dep.profile.stages}
                    replacement = self._alloc_for(dep.tenant or name,
                                                  dep.profile.stages,
                                                  lost_demand,
                                                  dep.profile.t_s, need,
                                                  op="failover")
                    commit(self.pool, replacement, need)
                    dep.allocation.merge(replacement)
                    unmet = {s: u for s, u in replacement.unmet.items()
                             if u > 0}
                    dep.r_s = {s: dep.allocation.units(s)
                               for s in dep.profile.stages}
                    dep.achievable_gbps = self._achievable(
                        dep.profile, dep.allocation, dep.r_s)
                    if dep.state_snapshot:
                        for k, v in dep.state_snapshot.items():
                            self.state.fstate_set(k, v)
                    self._account(dep)
                    rsp.note(unmet=dict(unmet),
                             achievable_gbps=dep.achievable_gbps)
                    self._emit({"t": self.clock(), "event": "failover",
                                "app": name, "tenant": dep.tenant, "nic": nic,
                                "unmet": unmet,
                                "response_s": self.clock() - t0})
            fsp.note(impacted=list(impacted))
        return impacted

    # -- online re-placement / defragmentation (make-before-break) ----------------
    def migrate(self, app_name: str,
                only_nics: Optional[List[str]] = None,
                require_improvement: bool = True,
                forced: bool = False) -> Optional[dict]:
        """Re-place a live deployment onto a better-packed NIC set.

        Make-before-break: the destination units are allocated and committed
        *while the old placement still serves traffic*, flows are handed
        over through the TO's migration protocol (halt -> buffer -> re-home),
        and only then is the source placement released. A do-no-harm guard
        rejects any plan that would raise the deployment's hop count or
        lower its achievable throughput — rejected plans leave the pool
        untouched. ``forced`` skips that guard: a probation drain off a
        gray-failing NIC is worth extra hops, so only placement feasibility
        gates it. Returns the emitted migrate event, or None if no
        admissible plan exists.
        """
        t0 = self.clock()
        dep = self.deployments[app_name]
        with self.obs.trace.span("migrate", tenant=dep.tenant, app=app_name,
                                 forced=forced) as sp:
            ev = self._migrate(dep, app_name, only_nics, require_improvement,
                               forced, t0)
            if ev is None:
                sp.note(outcome="rejected")
            else:
                sp.note(outcome="committed",
                        nics_before=ev["nics_before"],
                        nics_after=ev["nics_after"],
                        hop_pairs_before=ev["hop_pairs_before"],
                        hop_pairs_after=ev["hop_pairs_after"])
            return ev

    def _migrate(self, dep: Deployment, app_name: str,
                 only_nics: Optional[List[str]], require_improvement: bool,
                 forced: bool, t0: float) -> Optional[dict]:
        need = dep.app.resource_needs()
        demand = {s: dep.allocation.units(s) for s in dep.profile.stages}
        if only_nics is None:
            shadow = defrag_mod.plan_migration(dep, self.pool)
        else:
            shadow = resource_alloc(dep.profile.stages, demand,
                                    dep.profile.t_s, self.pool, need,
                                    only_nics=only_nics)
        if shadow is None or not shadow.satisfied():
            return None
        # Do-no-harm guard, evaluated on the shadow plan before any commit —
        # the policy itself lives in the governor (migration_verdict).
        impact = defrag_mod.migration_impact(
            dep, shadow, self._achievable(dep.profile, shadow, demand))
        old_hops, new_hops = impact.hops_before, impact.hops_after
        new_achievable = impact.achievable_after
        if not forced and not self.governor.migration_verdict(
                hops_before=impact.hops_before, hops_after=impact.hops_after,
                achievable_before=impact.achievable_before,
                achievable_after=impact.achievable_after,
                nics_before=impact.nics_before, nics_after=impact.nics_after,
                require_improvement=require_improvement):
            return None

        # MAKE: commit the destination units (the pool now holds both).
        commit(self.pool, shadow, need)
        old_alloc = dep.allocation

        # Migrate flows via the TO: halt every flow (in-flight packets buffer
        # in the side ring), swap the allocation, release the source units —
        # then re-home the flows. The window between begin and finish is the
        # exposed make-before-break state the chaos layer's mid-migration
        # fault lands in: the one-shot hook below fires with every flow
        # buffered and the ledger already swapped to the destination, so an
        # injected failure must drain cleanly through handle_failure while
        # the hand-off is in flight.
        for f in list(dep.to.flow_table):
            dep.to.begin_migration(f)

        dep.allocation = shadow
        dep.r_s = {s: shadow.units(s) for s in dep.profile.stages}
        dep.achievable_gbps = new_achievable
        release(self.pool, old_alloc, need, dep.profile.t_s)
        self._account(dep)

        if self.mid_migration_hook is not None:
            hook, self.mid_migration_hook = self.mid_migration_hook, None
            hook(app_name)

        for f, pid in list(dep.to.flow_table.items()):
            dep.to.finish_migration(f, dst_pid=pid)
        event = {"t": self.clock(), "event": "migrate", "app": app_name,
                 "tenant": dep.tenant,
                 "nics_before": sorted(n for n, row in old_alloc.A.items()
                                       if any(v > 0 for v in row.values())),
                 "nics_after": sorted(dep.nics_used()),
                 "hop_pairs_before": old_hops, "hop_pairs_after": new_hops,
                 "response_s": self.clock() - t0}
        self._emit(event)
        return event

    def defragment(self, max_migrations: int = 1,
                   min_score: float = 1.0) -> List[dict]:
        """One background re-placement pass: score every deployment's
        fragmentation, try to migrate the worst offenders (score-descending)
        onto compact NIC sets, stop after ``max_migrations`` moves. Returns
        the migrate events of the moves that went through."""
        scores = self.governor.defrag_order(
            defrag_mod.fragmentation_score(dep, self.pool)
            for dep in self.deployments.values())
        moved: List[dict] = []
        for sc in scores:
            if sc.score < min_score or len(moved) >= max_migrations:
                break
            ev = self.migrate(sc.app)
            if ev is not None:
                moved.append(ev)
        return moved

    def check_ledger(self, strict: bool = True) -> List[str]:
        """Pool-truth invariant: per NIC and kind, free + Σ deployments'
        held units == capacity, and free bw + Σ recorded charges == link."""
        holdings = []
        charges = []
        for dep in self.deployments.values():
            need = dep.app.resource_needs()
            h: Dict[str, Dict[str, int]] = {}
            for n, row in dep.allocation.A.items():
                for s, u in row.items():
                    if u > 0:
                        kinds = h.setdefault(n, {})
                        kinds[need[s]] = kinds.get(need[s], 0) + u
            holdings.append(h)
            charges.append(dict(dep.allocation.bw_charge))
        return self.pool.check_ledger(holdings, charges, strict=strict)

    # -- CA synchronization (paper §3: periodic status sync) ------------------------
    def tick(self) -> dict:
        return {n: a.status() for n, a in self.agents.items()}

    # -- helpers ---------------------------------------------------------------------
    def _achievable(self, profile: AppProfile, alloc: Allocation,
                    r_s: Dict[str, int]) -> float:
        """Throughput the placed units sustain: per-stage placed capacity min."""
        caps = []
        for s in profile.stages:
            units = alloc.units(s)
            caps.append(units * profile.t_s[s])
        return min(caps) if caps else 0.0

    def _pipeline_capacity(self, profile: AppProfile, num_pipes: int) -> float:
        """Packets per partition round per pipeline (for the TO's flow table)."""
        return max(1.0, 1024.0 / max(1, num_pipes))
