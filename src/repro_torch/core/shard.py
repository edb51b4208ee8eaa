"""Sharded control plane: per-rack ControlShards under a thin global facade.

Following *Wave* (resource management offloaded next to the data path) and
the OVS slow-path/fast-path split, the controller is split along the pool's
failure domains: each ``ControlShard`` owns the disjoint NIC subset of one
rack and handles admission, scale growth, and failover re-placement for the
tenants placed within it. Shards exchange state through an explicit
eventual-consistency step — ``reconcile()`` refreshes each shard's
*headroom digest* (free units + bandwidth, by kind) at a bounded staleness
(``staleness_ticks``), and cross-rack decisions consult the digests, never
another shard's live pool rows.

Consequences the tests pin down:

  * Placement is shard-local first: a tenant's growth and failover
    re-placement are restricted to its owning shard's NICs; only when the
    shard cannot fit the demand does the facade spill pool-wide, audited
    as a ``cross_rack_placement`` decision with the ``shard`` label
    (``DecisionTrace.why`` then explains the placement end to end).
  * Failure domains map to shard ownership: a NIC's shard is its rack,
    gray-drain targets prefer the sick NIC's shard, and fault records
    carry the owning shard.
  * Bit-compatibility contract: with ONE shard the facade is the legacy
    ``MeiliController`` — same placements, same trace event sequence (the
    ``shard`` labels aside), same telemetry. ``tests/test_shard.py``
    byte-compares the two.

Stale digests are a feature, not a bug: the digest may claim headroom the
pool no longer has (another shard placed into the window). The spill path
absorbs the miss — placement falls back to pool truth — so staleness costs
a cross-rack hop, never correctness.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.allocation import resource_alloc
from repro_torch.core.controller import Deployment, MeiliController
from repro_torch.core.pool import Pool
from repro_torch.core.qos import ResourceGovernor
from repro_torch.obs import Obs


class ControlShard:
    """One rack's control-plane slice: the NIC subset it owns, the tenants
    placed within it, and its (possibly stale) headroom digest."""

    def __init__(self, name: str, nics: List[str]):
        self.name = name
        self.nics = list(nics)
        self.tenants: Set[str] = set()
        self.digest: Dict[str, int] = {}       # kind -> free units
        self.digest_bw_gbps: float = 0.0
        self.digest_tick: int = -1             # when the digest was taken

    def refresh(self, pool: Pool, tick: int) -> None:
        """Re-snapshot the digest from pool truth (the reconcile step)."""
        free: Dict[str, int] = {}
        bw = 0.0
        for n in self.nics:
            st = pool[n]
            if not st.alive:
                continue
            for kind, units in st.free.items():
                free[kind] = free.get(kind, 0) + units
            bw += st.free_bw_gbps
        self.digest = free
        self.digest_bw_gbps = bw
        self.digest_tick = tick

    def digest_fit(self, demand_by_kind: Dict[str, int]) -> bool:
        """Does the digest CLAIM the demand fits? (Eventually consistent —
        the answer may be stale; the spill path absorbs wrong yeses.)"""
        return all(self.digest.get(kind, 0) >= units
                   for kind, units in demand_by_kind.items())

    def score(self, demand_by_kind: Dict[str, int]) -> float:
        """Headroom score for placement choice: the binding kind's slack
        ratio (how many copies of the demand the digest claims to hold)."""
        ratios = [self.digest.get(kind, 0) / units
                  for kind, units in demand_by_kind.items() if units > 0]
        return min(ratios) if ratios else float(sum(self.digest.values()))


class ShardedController(MeiliController):
    """Thin global facade over per-rack ControlShards.

    The facade still owns the global ``deployments`` map and the pool
    ledger (pool truth stays single-writer through commit/release); what
    shards own is *decision scope*: which NICs a tenant's placements may
    touch, and which shard's label every verdict about it carries.
    """

    def __init__(self, pool: Pool,
                 clock: Callable[[], float] = time.monotonic,
                 governor: Optional[ResourceGovernor] = None,
                 obs: Optional[Obs] = None,
                 staleness_ticks: int = 4):
        super().__init__(pool, clock, governor, obs)
        racks = sorted({st.spec.rack for st in pool.nics.values()})
        self.shards: Dict[str, ControlShard] = {
            r: ControlShard(r, pool.rack_members(r)) for r in racks}
        self.staleness_ticks = max(1, int(staleness_ticks))
        self._owner: Dict[str, str] = {}       # tenant -> shard name
        self.last_shard: Dict[str, str] = {}   # sticky through park/evict
        self._tick = 0
        # Governor verdicts carry the owning shard's label from here on.
        self.governor.shard_resolver = self.shard_of
        for sh in self.shards.values():
            sh.refresh(pool, -1)

    # -- shard facade hooks ----------------------------------------------------
    def shard_of(self, tenant: Optional[str]) -> Optional[str]:
        if tenant is None:
            return None
        return self._owner.get(tenant) or self.last_shard.get(tenant)

    def shard_of_nic(self, nic: Optional[str]) -> Optional[str]:
        if nic is None or nic not in self.pool.nics:
            return None
        return self.pool.nics[nic].spec.rack

    def reconcile(self, tick: Optional[int] = None) -> None:
        """The eventual-consistency step: refresh every digest whose age
        reached the staleness bound. Between reconciles shards decide on
        the stale snapshot — that is the consistency model, and the spill
        path is what makes it safe. Multi-shard refreshes are audited as a
        ``reconcile`` span (single-shard reconciliation is vacuous and
        stays silent: the 1-shard trace is the legacy trace)."""
        if tick is not None:
            self._tick = tick
        tick = self._tick
        stale = [sh for _, sh in sorted(self.shards.items())
                 if tick - sh.digest_tick >= self.staleness_ticks]
        if not stale:
            return
        if len(self.shards) <= 1:
            for sh in stale:
                sh.refresh(self.pool, tick)
            return
        with self.obs.trace.span(
                "reconcile", tick=tick,
                shards=[sh.name for sh in stale]) as sp:
            ages = {sh.name: tick - sh.digest_tick for sh in stale}
            for sh in stale:
                sh.refresh(self.pool, tick)
            sp.note(staleness_bound=self.staleness_ticks, ages=ages,
                    digests={sh.name: dict(sh.digest) for sh in stale})

    # -- placement routing -----------------------------------------------------
    def _demand_by_kind(self, stages, demand: Dict[str, int],
                        need: Dict[str, str]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in stages:
            u = demand.get(s, 0)
            if u > 0:
                kind = need[s]
                out[kind] = out.get(kind, 0) + u
        return out

    def _choose_shard(self, tenant: str, by_kind: Dict[str, int]) -> str:
        """Admission-time shard choice, from digests alone (cross-rack
        state is only ever consulted through the reconcile snapshot)."""
        return max(sorted(self.shards),
                   key=lambda r: self.shards[r].score(by_kind))

    def _alloc_for(self, tenant: str, stages, demand: Dict[str, int],
                   t_s, need: Dict[str, str], op: str = "place"):
        by_kind = self._demand_by_kind(stages, demand, need)
        shard = self._owner.get(tenant)
        if shard is None:
            shard = self._choose_shard(tenant, by_kind)
            self._owner[tenant] = shard
            self.shards[shard].tenants.add(tenant)
            self.last_shard[tenant] = shard
        local = self.shards[shard].nics
        alloc = resource_alloc(stages, demand, t_s, self.pool, need,
                               only_nics=local)
        if alloc.satisfied() or len(self.shards) <= 1:
            return alloc
        # Cross-rack spill: the shard (or its stale digest) could not fit
        # the demand — re-place pool-wide and audit the verdict so
        # ``why(tenant, tick)`` explains the cross-rack placement.
        unmet = {s: u for s, u in alloc.unmet.items() if u > 0}
        spilled = resource_alloc(stages, demand, t_s, self.pool, need)
        self.obs.trace.event(
            "cross_rack_placement", tenant=tenant, shard=shard, op=op,
            unmet_local=unmet,
            digest_claimed_fit=self.shards[shard].digest_fit(by_kind),
            reason="shard headroom exhausted; placed pool-wide")
        return spilled

    # -- ownership maintenance -------------------------------------------------
    def _account(self, dep: Deployment) -> None:
        super()._account(dep)
        tenant = dep.tenant or dep.app.name
        units_by_rack: Dict[str, int] = {}
        for nic, row in dep.allocation.A.items():
            held = sum(u for u in row.values() if u > 0)
            if held > 0:
                rack = self.pool.nics[nic].spec.rack
                units_by_rack[rack] = units_by_rack.get(rack, 0) + held
        if not units_by_rack:
            return
        owner = max(sorted(units_by_rack),
                    key=lambda r: units_by_rack[r])
        prev = self._owner.get(tenant)
        if owner != prev:
            if prev is not None:
                self.shards[prev].tenants.discard(tenant)
            self._owner[tenant] = owner
            self.shards[owner].tenants.add(tenant)
            self.last_shard[tenant] = owner
            if prev is not None and len(self.shards) > 1:
                # Migration/failover moved the placement's center of mass
                # across racks: ownership follows the units.
                self.obs.trace.event("shard_handoff", tenant=tenant,
                                     shard=owner, shard_from=prev,
                                     units_by_rack=units_by_rack)

    def terminate(self, app_name: str) -> None:
        dep = self.deployments.get(app_name)
        tenant = (dep.tenant or app_name) if dep is not None else app_name
        super().terminate(app_name)
        owner = self._owner.pop(tenant, None)
        if owner is not None:
            self.shards[owner].tenants.discard(tenant)
            self.last_shard[tenant] = owner

    # -- flight recorder -------------------------------------------------------
    def flight_state(self) -> Dict[str, dict]:
        """Shard-labeled flight snapshot: every NIC row carries
        its owning shard and each shard reports its digest age + tenant
        count — so an incident bundle taken under the sharded controller
        reconstructs which failure domain the incident lived in."""
        state = super().flight_state()
        for n, row in state["nics"].items():
            row["shard"] = self.shard_of_nic(n)
        state["shards"] = {
            name: {"digest_tick": sh.digest_tick,
                   "tenants": len(sh.tenants),
                   "digest_bw_gbps": sh.digest_bw_gbps}
            for name, sh in sorted(self.shards.items())}
        return state

    # -- gray-drain routing ----------------------------------------------------
    def drain_nic_candidates(self, nic: str,
                             exclude: Optional[set] = None) -> List[List[str]]:
        """Drains route through the owning shard first: keeping the
        re-placement inside the sick NIC's failure domain preserves the
        rack's locality and leaves the other shards' headroom untouched —
        the pool-wide healthy set is the fallback."""
        base = super().drain_nic_candidates(nic, exclude)
        shard = self.shard_of_nic(nic)
        if shard is None or len(self.shards) <= 1:
            return base
        local = [n for n in base[0]
                 if self.pool.nics[n].spec.rack == shard]
        if local and local != base[0]:
            return [local] + base
        return base
