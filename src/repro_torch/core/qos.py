"""Unified QoS governor: per-tenant quotas, weighted fair sharing, and
backlog-aware capacity verdicts.

The paper's pooling win (§8, 3.07x vs standalone) presumes tenants
multiplex *headroom* — one tenant's burst may borrow slack, but must never
starve another tenant's contracted SLO. Before this module the decisions
that enforce that were smeared across three layers: admission strictness in
the tenant registry, an ad-hoc capacity-pressure clamp in the service
runtime's autoscaler, and a do-no-harm guard inline in the controller's
migration path. The ``ResourceGovernor`` is the single policy object all
four choke points consult:

  admission   ``MeiliController.submit`` clamps the requested target to the
              tenant's quota; ``TenantRegistry.admit`` turns the placement
              outcome into an admit/reject verdict (the old inline
              ``allocation.satisfied()`` check).
  scaling     ``ServiceRuntime`` hands the governor its demand estimate and
              gets back a ``ScaleVerdict`` — quota-capped, burst-credited
              (token bucket), and *partially granted* when the pool's
              per-tick headroom ledger cannot support the full ask.
  defrag      ``MeiliController.migrate`` asks ``migration_verdict`` whether
              a shadow plan is harmless (and improving) before committing.
  failover    ``MeiliController.handle_failure`` re-places impacted tenants
              in governor priority order (weight-descending), so scarce
              post-failure capacity goes to the heaviest contracts first.

On the data-plane side the governor schedules the per-tick dispatch as a
deficit-weighted round-robin (DWRR, Shreedhar & Varghese) over the tenants'
ingress queues: the telemetry backlog *is* the queue depth scheduled
against, so an over-quota tenant queues behind its own deficit instead of
triggering pool-wide rescales. Weights come from the quota declaration
(default: the SLA priority), and long-run served bytes under saturation
converge to the weight ratios.

Quotas default to the tenant's contract (``quota_from_sla``), which makes
the governed system behave identically to the pre-governor runtime for any
in-contract workload — the efficiency bars do not move; only out-of-quota
bursts see new policy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.pool import Pool

# Service-rate epsilon for queue/capacity bookkeeping (bytes).
_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant resource-isolation contract, declared on ``TenantSpec``.

    ``max_gbps``   hard cap on the provision target the tenant may scale to
                   (None = uncapped); defaults to the SLA contract.
    ``max_units``  hard cap on placed resource units (None = uncapped).
    ``burst_gbps`` token-bucket depth: Gbps-ticks of credit the tenant may
                   spend to exceed ``max_gbps`` transiently.
    ``burst_refill_gbps``  credit refilled per tick, up to the depth.
    ``weight``     DWRR / contention-share weight (default 1.0).
    """

    max_gbps: Optional[float] = None
    max_units: Optional[int] = None
    burst_gbps: float = 0.0
    burst_refill_gbps: float = 0.0
    weight: float = 1.0


def quota_from_sla(sla) -> TenantQuota:
    """The default quota: the contract is the cap, priority is the weight."""
    return TenantQuota(max_gbps=sla.target_gbps,
                       weight=float(max(1, sla.priority)))


@dataclasses.dataclass
class AdmissionVerdict:
    admitted: bool
    reason: str = ""


@dataclasses.dataclass
class ScaleVerdict:
    """The governor's answer to "this tenant wants to re-target".

    ``target_gbps``  the granted provision target (quota/burst/headroom
                     clamped — may be below the ask: a partial grant).
    ``rescale``      whether the runtime should call ``adaptive_scale`` now.
    ``pressure``     offered+queued load is eating into placed capacity.
    ``granted_frac`` granted / asked growth (1.0 when nothing was clamped).
    ``burst_credit_spent``  Gbps-ticks drawn from the token bucket.
    ``brownout``     the grant was clamped by an active brownout (degraded
                     partial service while parked tenants wait for capacity).
    ``reason``       audit label naming the clamps that shaped the grant
                     ("granted" when nothing clamped; otherwise a comma-
                     joined subset of quota_clamp/burst/brownout/
                     headroom_clamp/unit_quota/pressure).
    """

    target_gbps: float
    rescale: bool
    pressure: bool = False
    granted_frac: float = 1.0
    burst_credit_spent: float = 0.0
    brownout: bool = False
    reason: str = "granted"


class ResourceGovernor:
    """One policy object for every capacity/priority decision in the pool.

    ``enabled=False`` turns quota enforcement, burst accounting, and
    weighted sharing OFF (every verdict is permissive, DWRR runs with equal
    weights) — the A/B baseline for the flash-crowd isolation benchmark.
    Note this removes the contract clamp too: the pre-governor runtime's
    ``min(contract, ...)`` *was* an implicit quota (the default
    ``quota_from_sla`` reproduces it exactly), so the disabled governor
    models a pool with no notion of entitlement at all — tenants may
    re-target arbitrarily far past contract, which is precisely the
    unguarded baseline the isolation A/B measures against. The migration
    do-no-harm guard stays active even when disabled: it is a correctness
    guard, not a QoS policy.
    """

    def __init__(self, enabled: bool = True, pressure_frac: float = 0.92):
        self.enabled = enabled
        self.pressure_frac = pressure_frac
        # Observability context: when attached, every verdict this
        # governor issues lands in the decision-audit trace with its reason
        # and the ledger state that produced it. None = silent (no-op).
        self.obs = None
        # Shard attribution: a sharded controller installs a
        # resolver (tenant -> shard name) so every verdict this governor
        # audits or counts carries the owning shard's label. None = the
        # legacy single-controller layout (no label, traces unchanged).
        self.shard_resolver = None
        # Vectorized scheduling kernel: when attached, the DWRR
        # dispatch runs as one array program over all tenants, on the device
        # (core.sched_kernel) instead of the scalar dict walk below — which
        # stays as the pinned reference oracle.
        self._kernel = None
        self.quotas: Dict[str, TenantQuota] = {}
        self.credits: Dict[str, float] = {}      # burst tokens (Gbps-ticks)
        self._pool: Optional[Pool] = None
        # DWRR state: persistent per-tenant deficit + ring order.
        self._deficit: Dict[str, float] = {}
        self._ring: List[str] = []
        # Per-tick free-unit ledger (resource kind -> units), snapshotted by
        # begin_tick and drawn down by scale grants within the tick.
        self._headroom: Optional[Dict[str, int]] = None
        # Brownout level (None = off): while tenants are parked after a
        # failure, grants are clamped toward this fraction of contract so the
        # survivors shed headroom the parked tenants can re-admit into.
        self._brownout: Optional[float] = None

    # -- registration ----------------------------------------------------------
    def bind(self, pool: Pool) -> None:
        """Attach the pool whose quota-ledger rows this governor maintains."""
        self._pool = pool

    def attach_obs(self, obs) -> None:
        """Attach the observability context verdicts are audited into."""
        self.obs = obs

    def attach_kernel(self, kernel) -> None:
        """Attach a ``sched_kernel.VectorizedScheduler``: subsequent
        ``dwrr_schedule`` calls run the array program (None
        detaches, restoring the scalar reference path)."""
        self._kernel = kernel

    def _shard_of(self, tenant: Optional[str]) -> Optional[str]:
        if tenant is None or self.shard_resolver is None:
            return None
        return self.shard_resolver(tenant)

    def _audit(self, name: str, tenant: Optional[str] = None,
               **detail) -> None:
        if self.obs is not None:
            shard = self._shard_of(tenant)
            if shard is not None:
                detail.setdefault("shard", shard)
            self.obs.trace.event(name, tenant=tenant, **detail)

    def register(self, tenant: str, quota: Optional[TenantQuota] = None) -> None:
        q = quota or TenantQuota()
        self.quotas[tenant] = q
        self.credits[tenant] = q.burst_gbps
        if self._pool is not None:
            self._pool.set_quota(tenant, max_units=q.max_units,
                                 max_gbps=q.max_gbps, weight=q.weight)

    def forget(self, tenant: str) -> None:
        self.quotas.pop(tenant, None)
        self.credits.pop(tenant, None)
        self._deficit.pop(tenant, None)
        if tenant in self._ring:
            self._ring.remove(tenant)
        if self._pool is not None:
            self._pool.clear_quota(tenant)

    def quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, TenantQuota())

    def weight(self, tenant: str) -> float:
        if not self.enabled:
            return 1.0
        return max(1e-9, self.quota(tenant).weight)

    # -- per-tick bookkeeping --------------------------------------------------
    def begin_tick(self, pool: Optional[Pool] = None,
                   active: Iterable[str] = (),
                   tick: Optional[int] = None) -> None:
        """Refill burst credits and snapshot the free-unit headroom ledger
        that this tick's scale grants will draw against. ``tick`` (when the
        caller knows it) stamps the observability trace so verdicts issued
        this tick land at the right place in the audit log."""
        if tick is not None and self.obs is not None:
            self.obs.set_tick(tick)
        for t in active:
            q = self.quota(t)
            if q.burst_gbps > 0.0:
                self.credits[t] = min(
                    q.burst_gbps,
                    self.credits.get(t, 0.0) + q.burst_refill_gbps)
        pool = pool or self._pool
        if pool is None:
            self._headroom = None
            return
        kinds = set()
        for name in pool.names():
            kinds.update(pool[name].free)
        self._headroom = {k: pool.free_total(k) for k in kinds}

    def headroom_snapshot(self) -> Dict[str, int]:
        """The current per-kind free-unit ledger (post any grants drawn this
        tick) — read by the flight recorder's per-tick snapshot. Empty
        before the first ``begin_tick``."""
        return dict(self._headroom) if self._headroom else {}

    # -- brownout --------------------------------------------------------------
    def set_brownout(self, level: Optional[float]) -> None:
        """Enter/leave degraded partial-grant mode. ``level`` is the base
        fraction of contract the *lowest-weight* tenant is clamped toward;
        None (or >= 1.0) clears the brownout entirely."""
        if level is None or level >= 1.0:
            self._brownout = None
        else:
            self._brownout = max(0.05, level)

    def brownout_factor(self, tenant: str) -> float:
        """Per-tenant grant multiplier under brownout: weight-proportional
        degradation, ``b + (1 - b) * w / w_max`` — the heaviest contract keeps
        full service, the lightest degrades to the base level ``b``. 1.0 when
        no brownout is active."""
        if not self.enabled or self._brownout is None:
            return 1.0
        wmax = max((q.weight for q in self.quotas.values()), default=1.0)
        b = self._brownout
        return b + (1.0 - b) * self.weight(tenant) / max(wmax, 1e-9)

    # -- admission -------------------------------------------------------------
    def admission_target(self, tenant: str, target_gbps: float) -> float:
        """Clamp a submission's throughput target to the tenant's quota
        (consulted by ``MeiliController.submit``)."""
        q = self.quota(tenant)
        if not self.enabled or q.max_gbps is None:
            return target_gbps
        if target_gbps > q.max_gbps:
            self._audit("admission_clamp", tenant=tenant,
                        asked_gbps=target_gbps, granted_gbps=q.max_gbps,
                        reason="target above quota")
        return min(target_gbps, q.max_gbps)

    def admission_verdict(self, tenant: str, allocation) -> AdmissionVerdict:
        """Strict-admission check (moved from the tenant registry): a tenant
        whose contracted target could not be fully placed is rejected."""
        if not allocation.satisfied():
            unmet = {s: u for s, u in allocation.unmet.items() if u > 0}
            self._audit("admission_verdict", tenant=tenant, admitted=False,
                        reason=f"unplaceable at contract: {unmet}")
            return AdmissionVerdict(False, f"unplaceable at contract: {unmet}")
        self._audit("admission_verdict", tenant=tenant, admitted=True,
                    reason="placed at contract")
        return AdmissionVerdict(True)

    # -- scaling ---------------------------------------------------------------
    def _quota_cap_gbps(self, tenant: str, desired: float) -> Tuple[float, float]:
        """(granted cap, burst credit spent): the hard quota plus whatever
        the token bucket can cover this tick."""
        q = self.quota(tenant)
        if not self.enabled or q.max_gbps is None or desired <= q.max_gbps:
            return desired, 0.0
        burn = min(desired - q.max_gbps, self.credits.get(tenant, 0.0))
        return q.max_gbps + burn, burn

    def scale_verdict(self, tenant: str, *, est_gbps: float,
                      offered_gbps: float, contract_gbps: float,
                      current_gbps: float, achievable_gbps: float,
                      unit_gbps: float = 0.0,
                      stage_kinds: Sequence[str] = (),
                      held_units: int = 0,
                      headroom: float = 1.15, floor_frac: float = 0.2,
                      rescale_threshold: float = 0.1,
                      cooldown_active: bool = False,
                      forced: bool = False) -> ScaleVerdict:
        """The capacity decision the runtime's autoscaler used to inline.

        ``offered_gbps`` is offered + queued drain rate (backlog-aware: the
        reactive loop scales on what is waiting, not just what arrived).
        ``unit_gbps``/``stage_kinds``/``held_units`` let the governor convert
        a Gbps grant into a unit draw against the headroom ledger and the
        ``max_units`` quota; pass 0/() to skip unit accounting.
        ``stage_kinds`` is one entry PER STAGE (repeats meaningful): an app
        with two crypto stages needs two crypto units per pipeline of growth.
        """
        reasons: List[str] = []
        desired = max(floor_frac * contract_gbps, est_gbps * headroom)
        # Capacity pressure: load (incl. queued) is eating into the *placed*
        # capacity — re-target above it before the backlog compounds.
        pressure = offered_gbps > self.pressure_frac * max(achievable_gbps,
                                                           1e-9)
        if pressure:
            desired = max(desired, offered_gbps * headroom)
            reasons.append("pressure")
        cap, burn = self._quota_cap_gbps(tenant, desired)
        granted = min(desired, cap)
        if granted < desired - _EPS:
            reasons.append("quota_clamp")
        if burn > 0.0:
            reasons.append("burst")

        # Brownout clamp: while tenants are parked post-failure, survivors
        # are granted only a weight-proportional fraction of contract (never
        # below the floor) so their scale-downs free the units the parked
        # tenants need to re-admit. Burst credit cannot buy out a brownout.
        browned = False
        bfac = self.brownout_factor(tenant)
        if bfac < 1.0:
            bcap = max(floor_frac * contract_gbps, bfac * contract_gbps)
            if granted > bcap + _EPS:
                granted, browned, burn = bcap, True, 0.0
                reasons.append("brownout")

        # Partial grant under contention: growth beyond the pool's free-unit
        # headroom (or the tenant's max_units quota) is not granted — the
        # tenant queues instead of thrashing the allocator with futile
        # rescales that would strip headroom other tenants are entitled to.
        # The ledger draw is computed here but only committed below, once
        # the verdict actually triggers a rescale: a no-op verdict must not
        # phantom-reserve units against later tenants in the same tick.
        draw: Dict[str, int] = {}
        grow = granted - current_gbps
        if grow > _EPS and unit_gbps > 0.0 and stage_kinds:
            mult: Dict[str, int] = {}           # kind -> stages of that kind
            for kind in stage_kinds:
                mult[kind] = mult.get(kind, 0) + 1
            pipes_want = int(math.ceil(grow / unit_gbps))
            pipes_ok = pipes_want
            if self._headroom is not None:
                for kind, m in mult.items():
                    pipes_ok = min(pipes_ok,
                                   max(0, self._headroom.get(kind, 0)) // m)
            if pipes_ok < pipes_want:
                reasons.append("headroom_clamp")
            pipes_ledger = pipes_ok
            q = self.quota(tenant)
            if self.enabled and q.max_units is not None:
                room = max(0, q.max_units - held_units)
                pipes_ok = min(pipes_ok, room // max(1, len(stage_kinds)))
            if pipes_ok < pipes_ledger:
                reasons.append("unit_quota")
            if pipes_ok < pipes_want:
                granted = current_gbps + pipes_ok * unit_gbps
            if granted > current_gbps + _EPS:
                draw = {kind: pipes_ok * m for kind, m in mult.items()}

        asked_grow = max(0.0, desired - current_gbps)
        got_grow = max(0.0, granted - current_gbps)
        frac = got_grow / asked_grow if asked_grow > _EPS else 1.0
        gap = abs(granted - current_gbps) / max(contract_gbps, 1e-9)
        scaling_up = granted > current_gbps + 1e-9
        # Fast-attack: scale-UP is never cooldown-blocked (a blocked scale-up
        # is an SLO violation waiting to happen); the cooldown only rate-
        # limits scale-downs so troughs don't thrash the allocator.
        rescale = bool(
            forced
            or (scaling_up and (pressure or gap > rescale_threshold))
            or (not scaling_up and not cooldown_active
                and gap > rescale_threshold))
        # Commit side effects only for verdicts that execute: a no-op verdict
        # must neither phantom-reserve headroom units nor drain the burst
        # bucket (credit pays for grants actually taken, not for asks).
        if rescale and scaling_up:
            if draw and self._headroom is not None:
                for kind, units in draw.items():
                    self._headroom[kind] = self._headroom.get(kind, 0) - units
            if burn > 0.0:
                q = self.quota(tenant)
                over = q.max_gbps if q.max_gbps is not None else granted
                used = max(0.0, min(burn, granted - over))
                self.credits[tenant] = max(
                    0.0, self.credits.get(tenant, 0.0) - used)
                burn = used
        else:
            burn = 0.0
        reason = ",".join(reasons) if reasons else "granted"
        self._audit("scale_verdict", tenant=tenant, reason=reason,
                    desired_gbps=desired, granted_gbps=granted,
                    current_gbps=current_gbps, rescale=rescale,
                    pressure=pressure, granted_frac=frac, brownout=browned,
                    burst_credit_spent=burn,
                    burst_credit_left=self.credits.get(tenant, 0.0),
                    headroom=dict(self._headroom) if self._headroom else {})
        if self.obs is not None:
            labels = {"tenant": tenant, "reason": reason}
            shard = self._shard_of(tenant)
            if shard is not None:
                labels["shard"] = shard
            self.obs.metrics.counter("governor_scale_verdicts_total",
                                     **labels).inc()
        return ScaleVerdict(target_gbps=granted, rescale=rescale,
                            pressure=pressure, granted_frac=frac,
                            burst_credit_spent=burn, brownout=browned,
                            reason=reason)

    # -- defrag / migration ----------------------------------------------------
    def migration_verdict(self, *, hops_before: int, hops_after: int,
                          achievable_before: float, achievable_after: float,
                          nics_before: int, nics_after: int,
                          require_improvement: bool = True) -> bool:
        """Do-no-harm guard (moved from ``MeiliController.migrate``): a
        re-placement must not lose capacity or locality, and — unless the
        caller pinned the targets — must strictly improve packing. Active
        even when the governor is disabled: this is correctness, not QoS."""
        harmless = (hops_after <= hops_before
                    and achievable_after >= achievable_before - 1e-9)
        improves = (nics_after < nics_before or hops_after < hops_before)
        allowed = harmless and (improves or not require_improvement)
        self._audit("migration_verdict", allowed=allowed,
                    reason=("allowed" if allowed
                            else ("harmful" if not harmless
                                  else "no improvement")),
                    hops_before=hops_before, hops_after=hops_after,
                    achievable_before=achievable_before,
                    achievable_after=achievable_after,
                    nics_before=nics_before, nics_after=nics_after)
        return allowed

    def defrag_order(self, scored: Iterable) -> List:
        """Order defrag candidates: worst fragmentation first; at equal
        score, disturb the lowest-weight tenant first (migration costs the
        tenant an SLO-grace window — spend that on cheap contracts)."""
        return sorted(scored, key=lambda sc: (-sc.score,
                                              self.weight(sc.tenant),
                                              sc.tenant))

    # -- priority ordering (failover re-placement, scale grants) ---------------
    def priority_order(self, tenants: Iterable[str]) -> List[str]:
        """Heaviest weight first; ties break by tenant NAME, not dict
        insertion order (a determinism fix: sharded and legacy
        controllers iterate tenants in different orders, so any
        registration-order dependence would make their decisions diverge).
        Used for failover re-placement and for the order scale grants draw
        down the per-tick headroom ledger: under scarcity the contracts
        the pool values most are served first."""
        return sorted(tenants, key=lambda t: (-self.weight(t), t))

    failover_order = priority_order

    def replacement_demand(self, tenant: str, lost: Dict[str, int],
                           held_units: int) -> Dict[str, int]:
        """Clamp a failover re-placement so the tenant does not come back
        above its ``max_units`` quota (quotas may shrink while deployed).
        Room is dealt round-robin across the lost stages — a greedy clamp
        could hand everything to the first stage and zero a later one,
        killing the tenant when an even split would keep every stage alive."""
        q = self.quota(tenant)
        if not self.enabled or q.max_units is None:
            return dict(lost)
        room = max(0, q.max_units - held_units)
        out = {s: 0 for s in lost}
        while room > 0:
            wanting = [s for s, u in lost.items() if out[s] < u]
            if not wanting:
                break
            for s in wanting:
                if room <= 0:
                    break
                out[s] += 1
                room -= 1
        return out

    # -- DWRR dispatch ---------------------------------------------------------
    def dwrr_schedule(self, queue_bytes: Dict[str, float],
                      rate_caps: Optional[Dict[str, float]] = None,
                      capacity_bytes: Optional[float] = None,
                      max_rounds: int = 1024
                      ) -> Tuple[List[str], Dict[str, float]]:
        """One tick of deficit-weighted round-robin over tenant ingress
        queues. Returns (dispatch order, served bytes per tenant).

        ``queue_bytes``  per-tenant queue depth (backlog + this tick's
                         arrivals) — the telemetry backlog as ingress depth.
        ``rate_caps``    per-tenant service ceiling for the tick in bytes
                         (placed capacity x dt); None = uncapped.
        ``capacity_bytes``  shared ingress budget; None = uncapped (every
                         queue drains to its own rate cap, as before the
                         governor — DWRR then only decides the order).

        Deficits persist across ticks; a tenant whose queue empties loses
        its deficit (classic DRR), so weights shape *long-run* service under
        saturation: weights 2:1:1 converge to ~2:1:1 served bytes.

        With a kernel attached (``attach_kernel``) the whole tick runs as
        one array program over stacked tenant rows
        (``core.sched_kernel``); this scalar body is the pinned reference
        oracle the kernel is property-tested against.
        """
        if self._kernel is not None:
            return self._kernel.schedule(
                queue_bytes, rate_caps, capacity_bytes,
                weights={t: self.weight(t) for t in queue_bytes},
                max_rounds=max_rounds)
        queues = {t: max(0.0, q) for t, q in queue_bytes.items()}
        caps = {t: (rate_caps.get(t, math.inf) if rate_caps else math.inf)
                for t in queues}
        # Ring maintenance: keep relative order, drop leavers, append
        # arrivals in pinned priority order — weight descending then name
        # (the determinism fix: dict insertion order must not leak
        # into who gets the head-of-ring edge).
        self._ring = [t for t in self._ring if t in queues]
        in_ring = set(self._ring)
        for t in sorted((t for t in queues if t not in in_ring),
                        key=lambda t: (-self.weight(t), t)):
            self._ring.append(t)

        if capacity_bytes is None:
            # Uncapped shared link: no contention to arbitrate — every queue
            # drains to its own rate cap and DWRR only decides the dispatch
            # order (most-owed first: weighted backlog descending).
            served = {t: min(queues[t], caps[t]) for t in queues}
            order = sorted(queues,
                           key=lambda t: (-queues[t] * self.weight(t), t))
            return order, served

        served = {t: 0.0 for t in queues}
        order: List[str] = []
        budget = max(0.0, capacity_bytes)
        total_w = sum(self.weight(t) for t in queues) or 1.0
        # Adaptive quantum: ~8 full rounds exhaust the budget, so weights
        # stay expressed (one giant quantum would hand the whole budget to
        # whoever the ring visits first) while rounds stay bounded.
        quantum = budget / (8.0 * total_w + 1e-9)

        def runnable(t: str) -> bool:
            return queues[t] > _EPS and served[t] < caps[t] - _EPS

        for _ in range(max_rounds):
            if budget <= _EPS or not any(runnable(t) for t in self._ring):
                break
            for t in list(self._ring):
                if not runnable(t):
                    self._deficit[t] = 0.0       # DRR: idle queues forfeit
                    continue
                self._deficit[t] = (self._deficit.get(t, 0.0)
                                    + quantum * self.weight(t))
                take = min(queues[t], self._deficit[t],
                           caps[t] - served[t], budget)
                if take > _EPS:
                    if t not in order:
                        order.append(t)
                    queues[t] -= take
                    served[t] += take
                    self._deficit[t] -= take
                    budget -= take
                if budget <= _EPS:
                    break
            # Rotate so arrival order confers no standing head-of-line edge.
            if self._ring:
                self._ring.append(self._ring.pop(0))
        # Unserved tenants trail in pinned priority order (same determinism
        # fix as the ring: no dict-order dependence in the dispatch order).
        seen = set(order)
        for t in sorted((t for t in queues if t not in seen),
                        key=lambda t: (-self.weight(t), t)):
            order.append(t)
        return order, served
