"""Algorithms 2 & 3 — Locality-aware resource allocation (paper §6.1, App. E).

Meili Controller places each pipeline stage's replicas onto pool members
(SmartNICs / device groups) with a three-level NIC preference:

  (1) NICs already hosting the *preceding* stage s+ (locality: consecutive
      stages on one NIC avoid inter-stage traffic on the network),
  (2) NICs with the most available bandwidth,
  (3) NICs with the most available resources for this stage.

Bandwidth accounting follows Algorithm 3: when s colocates with s+, the
bandwidth s+ consumed is credited back (local hand-off does not cross the
link twice); allocations are capped so allocated-throughput <= available
bandwidth, splitting across NICs otherwise (`allocate_on_bw`). The credit
is applied at most once per (NIC, stage) pair — the allocation loop may
revisit a NIC for the same stage, and re-crediting would conjure bandwidth.

Every Allocation records its per-NIC **net bandwidth charge** (`bw_charge`):
exactly what `resource_alloc` subtracted from each NIC's free bandwidth,
colocation credits and bandwidth-capped placements included. `commit` takes
that charge from the pool and `release` credits back exactly that — never
the naive `units * t_s` sum, which over-credits whenever colocated stages
shared bandwidth (the drift this module used to mask with a capacity clamp).

The paper applies the three preferences lexicographically ("three steps",
§6.1); we implement them as one stable lexicographic sort. Termination
guard added for pool exhaustion (paper: "best-effort placement").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.pool import Pool


@dataclasses.dataclass
class Allocation:
    """Result of resource_alloc: the paper's allocation matrix A plus leftovers."""

    A: Dict[str, Dict[str, int]]          # nic -> stage -> allocated units
    unmet: Dict[str, int]                  # stage -> units that could not be placed
    bw_after: Dict[str, float]             # nic -> remaining bandwidth (Gbps)
    # nic -> net Gbps this allocation took from the NIC's free bandwidth
    # (colocation credits and bandwidth-capped placements already netted out).
    # This is the authoritative ledger entry: release credits exactly this.
    bw_charge: Dict[str, float] = dataclasses.field(default_factory=dict)

    def nics_for(self, stage: str) -> List[str]:
        return [n for n, row in self.A.items() if row.get(stage, 0) > 0]

    def units(self, stage: str) -> int:
        return sum(row.get(stage, 0) for row in self.A.values())

    def satisfied(self) -> bool:
        return not any(self.unmet.values())

    def num_nics_used(self) -> int:
        return sum(1 for row in self.A.values() if any(v > 0 for v in row.values()))

    def merge(self, extra: "Allocation") -> None:
        """Fold an incremental allocation (scale-up / failover replacement /
        migration make-phase) into this one: unit rows add, bandwidth charges
        add, and the remaining-bandwidth view adopts the newer computation."""
        for n, row in extra.A.items():
            for s, u in row.items():
                if u > 0:
                    self.A.setdefault(n, {})[s] = \
                        self.A.get(n, {}).get(s, 0) + u
        for n, c in extra.bw_charge.items():
            if c > 0.0:
                self.bw_charge[n] = self.bw_charge.get(n, 0.0) + c
        self.bw_after.update(extra.bw_after)


def _alloc_get(A: Dict[str, Dict[str, int]], n: str, s: Optional[str]) -> int:
    if s is None:
        return 0
    return A.get(n, {}).get(s, 0)


def find_next_nic(N: Sequence[str],
                  r_nic: Dict[str, int],
                  b_nic: Dict[str, float],
                  A: Dict[str, Dict[str, int]],
                  s: str, s_prev: Optional[str],
                  excluded: frozenset = frozenset()) -> Optional[str]:
    """Algorithm 2, lines 15-28: pick the next NIC for stage s."""
    # location_sort -> bw_sort -> resource_sort, lexicographic (see module doc).
    order = sorted(
        N,
        key=lambda n: (
            -(1 if _alloc_get(A, n, s_prev) > 0 else 0),  # (1) locality w.r.t. s+
            -b_nic[n],                                     # (2) available bandwidth
            -r_nic[n],                                     # (3) available resources
        ),
    )
    for n in order:
        if n in excluded:
            continue
        if r_nic[n] <= 0:
            continue  # no available resource (line 20-22)
        if _alloc_get(A, n, s_prev) <= 0 and b_nic[n] <= 0:
            continue  # no sharable BW from s+ and no available BW (line 23-26)
        return n
    return None


def _update_bw(b_nic: Dict[str, float], t_s: Dict[str, float],
               n: str, s: str, newly: int) -> None:
    """Charge the bandwidth consumed by `newly` units of stage s on NIC n."""
    b_nic[n] = max(0.0, b_nic[n] - newly * t_s[s])


def _allocate_on_bw(r_s: Dict[str, int], t_s: Dict[str, float],
                    r_nic: Dict[str, int], b_nic: Dict[str, float],
                    A: Dict[str, Dict[str, int]], n: str, s: str) -> int:
    """Algorithm 3, lines 31-36: allocate only up to the bandwidth limit.

    Boundary extension to the paper's pseudocode: a unit whose peak
    throughput exceeds the NIC's remaining bandwidth (floor == 0) may still
    be placed when bandwidth remains — it simply runs bandwidth-capped
    (otherwise such stages could never be placed at all)."""
    d = int(math.floor(b_nic[n] / t_s[s]))
    if d == 0 and b_nic[n] > 0:
        d = 1
    d = min(d, r_nic[n], r_s[s])
    A.setdefault(n, {})[s] = A.get(n, {}).get(s, 0) + d
    r_nic[n] -= d
    r_s[s] -= d
    _update_bw(b_nic, t_s, n, s, d)
    return d


def alloc_one_nic(r_s: Dict[str, int], t_s: Dict[str, float],
                  r_nic: Dict[str, int], b_nic: Dict[str, float],
                  A: Dict[str, Dict[str, int]],
                  n: str, s: str, s_prev: Optional[str],
                  credited: Optional[Set[Tuple[str, str]]] = None) -> int:
    """Algorithm 3 (App. E): allocate stage s's units on the chosen NIC n.

    Returns the number of units placed (0 => NIC unusable for s right now).
    `credited` tracks (nic, stage) pairs whose colocation credit has already
    been applied: the allocation loop can revisit a NIC for the same stage
    (bandwidth exhausted but cores left), and re-applying the credit would
    mint bandwidth out of nothing and over-allocate past the link.
    """
    credit = 0.0
    if _alloc_get(A, n, s_prev) > 0 and (credited is None
                                         or (n, s) not in credited):
        # s+ and s colocate on n => s may reuse the bandwidth s+ consumed
        # (the hand-off is local; credit it back). Algorithm 3 lines 10-12.
        credit = _alloc_get(A, n, s_prev) * t_s[s_prev]
        b_nic[n] += credit
        if credited is not None:
            credited.add((n, s))

    if r_s[s] >= r_nic[n]:
        if r_nic[n] * t_s[s] <= b_nic[n]:
            d = r_nic[n]
            A.setdefault(n, {})[s] = A.get(n, {}).get(s, 0) + d
            r_s[s] -= d
            r_nic[n] = 0
            _update_bw(b_nic, t_s, n, s, d)
            return d
        d = _allocate_on_bw(r_s, t_s, r_nic, b_nic, A, n, s)
    else:
        if r_s[s] * t_s[s] <= b_nic[n]:
            d = r_s[s]
            A.setdefault(n, {})[s] = A.get(n, {}).get(s, 0) + d
            r_nic[n] -= d
            r_s[s] = 0
            _update_bw(b_nic, t_s, n, s, d)
            return d
        d = _allocate_on_bw(r_s, t_s, r_nic, b_nic, A, n, s)
    if d == 0 and credit > 0.0:
        # Nothing placed after all (cannot happen while the forced d=1
        # boundary extension holds, since the credit leaves b_nic > 0 —
        # but a phantom credit surviving a failed placement would silently
        # understate bw_charge, so roll it back defensively).
        b_nic[n] -= credit
        if credited is not None:
            credited.discard((n, s))
    return d


def resource_alloc(S: Sequence[str],
                   r_s: Dict[str, int],
                   t_s: Dict[str, float],
                   pool: Pool,
                   need: Dict[str, str],
                   only_nics: Optional[Sequence[str]] = None) -> Allocation:
    """Algorithm 2: place every stage's required units onto the pool.

    Args:
      S: pipeline stages in order.
      r_s: total per-stage required units (controller demand calc, §6.1).
      t_s: profiled per-unit stage throughput in Gbps.
      pool: the NIC pool (only `alive` members are considered).
      need: stage -> resource kind it consumes ("cpu" or an accelerator name).
      only_nics: restrict placement to this subset of the pool — used by the
        defragmenter to pack a deployment onto a chosen compact target set.

    Returns an Allocation; `unmet` is non-empty iff the pool could not satisfy
    the demand (best-effort placement, paper §6.1).
    """
    N = pool.names()
    if only_nics is not None:
        allowed = set(only_nics)
        N = [n for n in N if n in allowed]
    remaining = {s: int(r_s[s]) for s in S}
    bw_before = {n: pool[n].free_bw_gbps for n in N}
    b_nic = dict(bw_before)
    A: Dict[str, Dict[str, int]] = {n: {} for n in N}
    credited: Set[Tuple[str, str]] = set()
    # Per-stage availability view: r_nic[n] depends on the resource kind the
    # *current* stage needs, so rebuild per stage; shared kinds (two CPU
    # stages) see each other's consumption through `taken`.
    taken: Dict[str, Dict[str, int]] = {n: {} for n in N}

    for idx, s in enumerate(S):
        s_prev = S[idx - 1] if idx > 0 else None
        kind = need[s]
        r_nic = {n: max(0, pool[n].available(kind) - taken[n].get(kind, 0)) for n in N}
        excluded: set = set()
        while remaining[s] > 0:
            n = find_next_nic(N, r_nic, b_nic, A, s, s_prev, frozenset(excluded))
            if n is None:
                break  # pool exhausted -> best-effort
            placed = alloc_one_nic(remaining, t_s, r_nic, b_nic, A, n, s,
                                   s_prev, credited)
            if placed == 0:
                excluded.add(n)  # bandwidth floor(d)=0: NIC unusable for s
                continue
            taken[n][kind] = taken[n].get(kind, 0) + placed

    return Allocation(A=A, unmet={s: remaining[s] for s in S if remaining[s] > 0},
                      bw_after=b_nic,
                      bw_charge={n: max(0.0, bw_before[n] - b_nic[n])
                                 for n in N})


def nic_charge(row: Dict[str, int], S: Sequence[str],
               t_s: Dict[str, float]) -> float:
    """Canonical Algorithm-3 net bandwidth charge for one NIC's stage rows.

    Each placed stage is charged ``units * t_s``; a stage immediately
    following another stage placed on the same NIC credits back the
    predecessor's full charge (the hand-off stays local). Used to compute
    charge *deltas* when a row shrinks — the recorded ``bw_charge`` stays
    the authoritative total.
    """
    charge = 0.0
    for i, s in enumerate(S):
        u = row.get(s, 0)
        if u <= 0:
            continue
        charge += u * t_s[s]
        if i > 0:
            p = S[i - 1]
            if row.get(p, 0) > 0:
                charge -= row[p] * t_s[p]
    return max(0.0, charge)


def commit(pool: Pool, alloc: Allocation, need: Dict[str, str]) -> None:
    """Apply an allocation to the pool (controller deploy step).

    Strict: unit takes and bandwidth charges raise if the pool cannot cover
    them — an allocation computed against stale pool state must fail loudly,
    not silently clamp."""
    for n, row in alloc.A.items():
        for s, units in row.items():
            if units > 0:
                pool[n].take(need[s], units)
        pool[n].take_bw(alloc.bw_charge.get(n, 0.0))


def release(pool: Pool, alloc: Allocation, need: Dict[str, str],
            t_s: Optional[Dict[str, float]] = None) -> None:
    """Reclaim an application's resources on termination (paper §6.1 FCFS).

    Bandwidth is credited from the allocation's recorded per-NIC net charge —
    exactly what commit subtracted — not the naive per-unit sum, which
    over-credits whenever colocated consecutive stages shared bandwidth via
    the Algorithm-3 credit. (`t_s` is kept for signature compatibility; the
    recorded charge already reflects the profiled throughputs.)
    """
    for n, row in alloc.A.items():
        for s, units in row.items():
            if units > 0:
                pool[n].give(need[s], units)
        pool[n].give_bw(alloc.bw_charge.get(n, 0.0))
