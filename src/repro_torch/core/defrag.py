"""Online re-placement / defragmentation planning (ROADMAP follow-on).

Algorithm 2's locality preference is only as good as the pool looked at
submission time: tenant churn (departures, scale-downs, failovers) punches
holes into the packing, consecutive stages drift onto disjoint NICs, and the
~4.5 µs hop penalty starts dominating tail latency (the DPU measurement
study, arXiv 2301.06070, finds exactly this cross-NIC hop to be the largest
offload cost). This module scores that decay per deployment and plans a
re-placement onto a compact target NIC set; the controller executes the plan
make-before-break (``MeiliController.migrate``) so the ledger sees a plain
commit + release cycle and traffic never loses its placed capacity.

Fragmentation score per deployment (dimensionless, higher = worse):

    score = (nics_used - minimal_nics)          # excess spread
          + hop_pairs                            # consecutive stages split
          + stranded_bw / link_bw                # bandwidth paying full
                                                 # crossing price on
                                                 # colocation-free NICs

``plan_migration`` packs the deployment's *current* unit counts (capacity is
preserved, never resized here) onto the smallest free-capacity NIC prefix
that admits a full placement. Planning is pure — nothing here mutates the
pool; the commit/guard/rollback protocol lives in the controller.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.allocation import Allocation, resource_alloc
from repro_torch.core.pool import Pool

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.core.controller import Deployment


def disjoint_pairs(alloc: Allocation,
                   stages: Sequence[str]) -> List[Tuple[str, str]]:
    """Consecutive stage pairs placed on fully disjoint NIC sets — each such
    pair forces every hand-off across the network (paper §8.5 hop penalty).
    The single definition of the predicate: the defrag guard and the
    latency model (service/telemetry.hop_penalties) both build on it."""
    pairs = []
    for a, b in zip(stages, stages[1:]):
        na = set(alloc.nics_for(a))
        nb = set(alloc.nics_for(b))
        if na and nb and not (na & nb):
            pairs.append((a, b))
    return pairs


def hop_pair_count(alloc: Allocation, stages: Sequence[str]) -> int:
    return len(disjoint_pairs(alloc, stages))


def minimal_nics(dep: "Deployment", pool: Pool) -> int:
    """Capacity lower bound on the NICs this deployment needs: for each
    resource kind, its total units over the largest per-NIC capacity in the
    pool; the max over kinds (kinds can share NICs, so this is a floor)."""
    need = dep.app.resource_needs()
    demand: Dict[str, int] = {}
    for s in dep.profile.stages:
        kind = need[s]
        demand[kind] = demand.get(kind, 0) + dep.allocation.units(s)
    floor = 1
    for kind, units in demand.items():
        if units <= 0:
            continue
        per_nic = max((pool[n].spec.capacity(kind) for n in pool.names()),
                      default=0)
        if per_nic > 0:
            floor = max(floor, -(-units // per_nic))
    return floor


def stranded_bw_gbps(dep: "Deployment") -> float:
    """Bandwidth charges held on NICs where the deployment colocates no
    consecutive stage pair: every hand-off in or out of such a NIC crosses
    the link, so its whole charge pays the full crossing price."""
    stages = dep.profile.stages
    stranded = 0.0
    for n, row in dep.allocation.A.items():
        placed = [s for s in stages if row.get(s, 0) > 0]
        if not placed:
            continue
        colocated = any(row.get(a, 0) > 0 and row.get(b, 0) > 0
                        for a, b in zip(stages, stages[1:]))
        if not colocated:
            stranded += dep.allocation.bw_charge.get(n, 0.0)
    return stranded


@dataclasses.dataclass
class FragmentationScore:
    app: str
    tenant: str
    nics_used: int
    min_nics: int
    hop_pairs: int
    stranded_bw_gbps: float
    score: float


def fragmentation_score(dep: "Deployment", pool: Pool) -> FragmentationScore:
    nics_used = dep.allocation.num_nics_used()
    floor = minimal_nics(dep, pool)
    hops = hop_pair_count(dep.allocation, dep.profile.stages)
    stranded = stranded_bw_gbps(dep)
    link = max((pool[n].spec.bandwidth_gbps for n in pool.nics), default=1.0)
    score = max(0, nics_used - floor) + hops + stranded / max(link, 1e-9)
    return FragmentationScore(app=dep.app.name,
                              tenant=dep.tenant or dep.app.name,
                              nics_used=nics_used, min_nics=floor,
                              hop_pairs=hops, stranded_bw_gbps=stranded,
                              score=score)


@dataclasses.dataclass(frozen=True)
class MigrationImpact:
    """What a shadow re-placement would change — the pure inputs the QoS
    governor's do-no-harm verdict (``ResourceGovernor.migration_verdict``)
    decides on. Computed before any commit so a rejection costs nothing."""

    hops_before: int
    hops_after: int
    achievable_before: float
    achievable_after: float
    nics_before: int
    nics_after: int


def migration_impact(dep: "Deployment", shadow: Allocation,
                     achievable_after: float) -> MigrationImpact:
    stages = dep.profile.stages
    return MigrationImpact(
        hops_before=hop_pair_count(dep.allocation, stages),
        hops_after=hop_pair_count(shadow, stages),
        achievable_before=dep.achievable_gbps,
        achievable_after=achievable_after,
        nics_before=dep.allocation.num_nics_used(),
        nics_after=shadow.num_nics_used())


def _pack_order(dep: "Deployment", pool: Pool) -> List[str]:
    """Candidate destination NICs, best packing candidates first: most free
    units of the kinds this deployment needs, then most free bandwidth."""
    need = dep.app.resource_needs()
    kinds = set(need.values())

    def key(n: str):
        st = pool[n]
        return (-sum(st.available(k) for k in kinds), -st.free_bw_gbps)

    return sorted(pool.names(), key=key)


def plan_migration(dep: "Deployment", pool: Pool) -> Optional[Allocation]:
    """Shadow re-placement of the deployment's current units onto the
    smallest admissible NIC prefix (make-phase input for the controller).

    Only *free* capacity counts — the deployment still holds its source
    units while the destination is allocated, so a plan that needs the
    space the deployment itself occupies is simply not admissible yet.
    Returns None when no prefix places the full demand.
    """
    demand = {s: dep.allocation.units(s) for s in dep.profile.stages}
    if not any(demand.values()):
        return None
    need = dep.app.resource_needs()
    order = _pack_order(dep, pool)
    for k in range(1, len(order) + 1):
        shadow = resource_alloc(dep.profile.stages, demand, dep.profile.t_s,
                                pool, need, only_nics=order[:k])
        if shadow.satisfied():
            return shadow
    return None
