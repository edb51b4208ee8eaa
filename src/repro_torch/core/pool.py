"""Resource-pool model: SmartNICs and device groups as poolable resources.

The paper (§3, §6) manages a rack of heterogeneous SmartNICs as one pool.
Each NIC exposes SoC cores ("resource units"), domain-specific accelerators
(regex / crypto / compression) and link bandwidth. ``Pool`` is the
controller's ledger of what each member has free: strict unit and
bandwidth takes and gives, failure domains (racks), gray failures, per-tenant
usage and quota rows, ``check_ledger`` and the CA status ``snapshot``.

``paper_cluster`` is the paper's evaluation cluster; ``tpu_pod_pool`` is the
JAX package's named inventory of a TPU v5e pod seen as device groups, kept
as it is there so that plans placed over it compare with the reference's.
It describes that inventory, not the card this port runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

# Tolerance for floating-point bandwidth bookkeeping. The ledger invariant
# (free + held == capacity, per NIC) is enforced to this epsilon; anything
# larger is an accounting bug, not rounding.
BW_EPS = 1e-6

# Resource type for CPU-like general cores (paper: ARM A72 "resource units").
CPU = "cpu"

# Accelerator kinds that appear in the paper's cluster.
REGEX = "regex"
CRYPTO = "crypto"          # paper: AES accelerator (Pensando)
COMPRESSION = "compression"
# Device-group capabilities of model tenants (beyond the paper).
ATTENTION = "attention"
SSD = "ssd"


@dataclasses.dataclass
class NicSpec:
    """Static description of one pool member (SmartNIC or device group)."""

    name: str
    kind: str                       # e.g. "bf2", "bf1", "pensando", "tpu-v5e-group"
    cores: int                      # resource units
    accelerators: Dict[str, int]    # accel kind -> count
    bandwidth_gbps: float           # NIC link bandwidth (a device group: its egress)
    core_mem_gb: float = 4.0        # paper: 1 core + 4 GB = one resource unit
    rack: str = "rack0"             # failure domain: one rack outage takes
                                    # every member down together (chaos layer)

    def has(self, resource: str) -> bool:
        if resource == CPU:
            return self.cores > 0
        return self.accelerators.get(resource, 0) > 0

    def capacity(self, resource: str) -> int:
        if resource == CPU:
            return self.cores
        return self.accelerators.get(resource, 0)


@dataclasses.dataclass
class NicState:
    """Mutable, controller-tracked view of one pool member (CA-synced, §3)."""

    spec: NicSpec
    free: Dict[str, int] = dataclasses.field(default_factory=dict)
    free_bw_gbps: float = 0.0
    alive: bool = True
    # Gray failure: the NIC silently delivers only this fraction of its
    # compute/bandwidth. Deliberately invisible to the allocator — `free`,
    # `take`, `give` are unchanged — so placement math stays oblivious while
    # achieved throughput (service/telemetry) degrades. Detection must come
    # from observed behavior, never from reading this field (the runtime's
    # suspicion scorer treats it as ground truth it cannot see).
    gray_frac: float = 1.0

    def __post_init__(self) -> None:
        if not self.free:
            self.free = {CPU: self.spec.cores, **dict(self.spec.accelerators)}
        if not self.free_bw_gbps:
            self.free_bw_gbps = self.spec.bandwidth_gbps

    def available(self, resource: str) -> int:
        return self.free.get(resource, 0) if self.alive else 0

    def take(self, resource: str, n: int) -> None:
        have = self.free.get(resource, 0)
        if n > have:
            raise ValueError(f"{self.spec.name}: cannot take {n} {resource}, only {have} free")
        self.free[resource] = have - n

    def give(self, resource: str, n: int) -> None:
        have = self.free.get(resource, 0)
        cap = self.spec.capacity(resource)
        if have + n > cap:
            raise ValueError(
                f"{self.spec.name}: over-credit of {resource}: "
                f"{have}+{n} exceeds capacity {cap}")
        self.free[resource] = have + n

    # -- strict bandwidth ledger (no clamp masking; raise on violation) --------
    def take_bw(self, gbps: float) -> None:
        """Charge link bandwidth. Raises if the charge exceeds what is free —
        a caller committing an allocation computed against stale pool state."""
        if gbps <= 0.0:
            return
        if gbps > self.free_bw_gbps + BW_EPS:
            raise ValueError(
                f"{self.spec.name}: cannot take {gbps:.6f} Gbps, only "
                f"{self.free_bw_gbps:.6f} free (ledger drift?)")
        self.free_bw_gbps = max(0.0, self.free_bw_gbps - gbps)

    def give_bw(self, gbps: float) -> None:
        """Credit link bandwidth back. Raises if the credit would push free
        bandwidth above the link capacity — an over-credit that the old
        ``min(.., cap)`` clamp used to silently mask."""
        if gbps <= 0.0:
            return
        cap = self.spec.bandwidth_gbps
        if self.free_bw_gbps + gbps > cap + BW_EPS:
            raise ValueError(
                f"{self.spec.name}: bandwidth over-credit: "
                f"{self.free_bw_gbps:.6f}+{gbps:.6f} exceeds link {cap} Gbps")
        self.free_bw_gbps = min(cap, self.free_bw_gbps + gbps)


class Pool:
    """The cluster-wide SmartNIC/device-group pool (one per rack, paper §3)."""

    def __init__(self, nics: List[NicSpec]):
        self.nics: Dict[str, NicState] = {s.name: NicState(spec=s) for s in nics}
        # Per-tenant usage ledger (resource kind -> units currently held),
        # maintained by the controller after every allocation mutation
        # (deploy / scale / failover / terminate). It is attribution only:
        # `free` above stays the single source of truth for capacity.
        self.usage: Dict[str, Dict[str, int]] = {}
        # Per-tenant quota rows beside the usage ledger: what each
        # tenant is *entitled* to, written by the ResourceGovernor when a
        # quota is declared. Attribution/reporting only — enforcement lives
        # in the governor's verdicts, never down here in the pool.
        self.quota: Dict[str, Dict[str, float]] = {}

    def names(self) -> List[str]:
        return [n for n, st in self.nics.items() if st.alive]

    def __getitem__(self, name: str) -> NicState:
        return self.nics[name]

    def mark_failed(self, name: str) -> None:
        self.nics[name].alive = False

    def revive(self, name: str) -> None:
        """Bring a NIC back. A revive models a repair/replacement, so any
        gray degradation is healed too — a revived NIC is a healthy NIC."""
        st = self.nics[name]
        st.alive = True
        st.gray_frac = 1.0

    # -- failure domains + gray degradation (chaos layer) ---------------------
    def rack_members(self, rack: str) -> List[str]:
        """Every pool member in one failure domain, alive or not."""
        return [n for n, st in self.nics.items() if st.spec.rack == rack]

    def mark_gray(self, name: str, fraction: float) -> None:
        """Silently degrade a NIC to ``fraction`` of its performance. The
        allocator keeps seeing full capacity — that is the point of a gray
        failure — only the achieved-throughput model reads the factor."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"gray fraction must be in (0, 1], got {fraction}")
        self.nics[name].gray_frac = fraction

    def clear_gray(self, name: str) -> None:
        self.nics[name].gray_frac = 1.0

    def capacity_frac(self, nics: Iterable[str]) -> float:
        """Effective capacity factor of a placement spanning ``nics``: the
        worst gray factor among them (stages chain through every member, so
        one sick NIC bottlenecks the whole pipeline)."""
        fr = [self.nics[n].gray_frac for n in nics if self.nics[n].alive]
        return min(fr) if fr else 1.0

    def total(self, resource: str) -> int:
        return sum(st.spec.capacity(resource) for st in self.nics.values() if st.alive)

    def free_total(self, resource: str) -> int:
        return sum(st.available(resource) for st in self.nics.values() if st.alive)

    def utilization(self, resource: str) -> float:
        tot = self.total(resource)
        if tot == 0:
            return 0.0
        return 1.0 - self.free_total(resource) / tot

    # -- per-tenant usage attribution (service runtime) -----------------------
    def set_usage(self, tenant: str, usage: Dict[str, int]) -> None:
        """Overwrite one tenant's attributed usage (controller resync)."""
        usage = {r: int(n) for r, n in usage.items() if n > 0}
        if usage:
            self.usage[tenant] = usage
        else:
            self.usage.pop(tenant, None)

    def clear_usage(self, tenant: str) -> None:
        self.usage.pop(tenant, None)

    # -- per-tenant quota rows (QoS governor) ---------------------------------
    def set_quota(self, tenant: str, max_units: Optional[int] = None,
                  max_gbps: Optional[float] = None,
                  weight: float = 1.0) -> None:
        """Record one tenant's entitlement beside its usage row."""
        row: Dict[str, float] = {"weight": float(weight)}
        if max_units is not None:
            row["max_units"] = float(max_units)
        if max_gbps is not None:
            row["max_gbps"] = float(max_gbps)
        self.quota[tenant] = row

    def clear_quota(self, tenant: str) -> None:
        self.quota.pop(tenant, None)

    def quota_row(self, tenant: str) -> Dict[str, float]:
        return dict(self.quota.get(tenant, {}))

    def reserved_units(self, tenant: Optional[str] = None) -> int:
        """Attributed units held by one tenant (or all tenants combined),
        counting every resource kind — a core and an accelerator engine are
        each one 'resource unit' in the paper's efficiency accounting."""
        if tenant is not None:
            return sum(self.usage.get(tenant, {}).values())
        return sum(sum(u.values()) for u in self.usage.values())

    def usage_snapshot(self) -> Dict[str, Dict[str, int]]:
        return {t: dict(u) for t, u in self.usage.items()}

    # -- ledger invariants -----------------------------------------------------
    def check_ledger(self,
                     unit_holdings: Iterable[Dict[str, Dict[str, int]]] = (),
                     bw_charges: Iterable[Dict[str, float]] = (),
                     strict: bool = True) -> List[str]:
        """Verify pool truth against the holders' view of what they own.

        ``unit_holdings``: per-holder nic -> kind -> units currently held.
        ``bw_charges``:   per-holder nic -> net Gbps currently charged.

        Invariant, per NIC and resource kind:  free + Σ held == capacity, and
        free bandwidth + Σ charges == link bandwidth (within BW_EPS). Dead
        NICs are checked too — failover must return the lost ledger entries
        so a revived NIC comes back clean. Returns the list of violations
        (raises instead when ``strict``).
        """
        held_units: Dict[str, Dict[str, int]] = {}
        for holding in unit_holdings:
            for nic, kinds in holding.items():
                row = held_units.setdefault(nic, {})
                for k, u in kinds.items():
                    row[k] = row.get(k, 0) + u
        held_bw: Dict[str, float] = {}
        for charge in bw_charges:
            for nic, g in charge.items():
                held_bw[nic] = held_bw.get(nic, 0.0) + g

        problems: List[str] = []
        for name, st in self.nics.items():
            kinds = set(st.free) | set(held_units.get(name, {}))
            for k in kinds:
                free = st.free.get(k, 0)
                held = held_units.get(name, {}).get(k, 0)
                cap = st.spec.capacity(k)
                if free < 0 or free + held != cap:
                    problems.append(
                        f"{name}/{k}: free {free} + held {held} != cap {cap}")
            bw_free = st.free_bw_gbps
            bw_held = held_bw.get(name, 0.0)
            bw_cap = st.spec.bandwidth_gbps
            if bw_free < -BW_EPS or abs(bw_free + bw_held - bw_cap) > 1e-3:
                problems.append(
                    f"{name}/bw: free {bw_free:.6f} + held {bw_held:.6f}"
                    f" != link {bw_cap}")
        if strict and problems:
            raise AssertionError("pool ledger drift: " + "; ".join(problems))
        return problems

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Controller-agent status sync (paper §3: CA <-> Meili Controller)."""
        out = {}
        for name, st in self.nics.items():
            out[name] = {"alive": st.alive, "free_bw_gbps": st.free_bw_gbps, **st.free}
        return out


def paper_cluster(n_bf2: int = 8, n_bf1: int = 4, n_pensando: int = 4,
                  bw_gbps: float = 100.0, racks: int = 4) -> Pool:
    """The paper's evaluation cluster (§8 Methodology).

    8x BlueField-2 (8 ARM cores, regex + compression), 4x BlueField-1
    (16 cores, no accelerators), 4x Pensando (16 cores, AES + compression),
    all with 100 GbE links. One core per NIC is reserved for the TO
    (paper §8.1), so the usable core counts are 7/15/15.

    NICs are spread over ``racks`` failure domains, each kind in contiguous
    blocks, so every rack holds a slice of every NIC class — a rack outage
    removes a proportional cut of each resource kind, never a whole kind.
    """
    racks = max(1, racks)

    def rack_of(i: int, n: int) -> str:
        return f"rack{i * racks // max(1, n)}"

    nics: List[NicSpec] = []
    for i in range(n_bf2):
        nics.append(NicSpec(f"bf2-{i}", "bf2", cores=7,
                            accelerators={REGEX: 1, COMPRESSION: 1},
                            bandwidth_gbps=bw_gbps, rack=rack_of(i, n_bf2)))
    for i in range(n_bf1):
        nics.append(NicSpec(f"bf1-{i}", "bf1", cores=15, accelerators={},
                            bandwidth_gbps=bw_gbps, rack=rack_of(i, n_bf1)))
    for i in range(n_pensando):
        nics.append(NicSpec(f"pensando-{i}", "pensando", cores=15,
                            accelerators={CRYPTO: 1, COMPRESSION: 1},
                            bandwidth_gbps=bw_gbps,
                            rack=rack_of(i, n_pensando)))
    return Pool(nics)


def tpu_pod_pool(groups: int = 16, chips_per_group: int = 16,
                 ici_gbps_per_group: float = 4 * 50 * 8) -> Pool:
    """A TPU v5e pod viewed as a Meili pool: each mesh row = one device group.

    Chips stand in for "cores"; every group exposes the kernel capabilities
    (attention / ssd / regex / crypto / compression).
    Group egress bandwidth = 4 ICI links x 50 GB/s, expressed in Gbps. The
    JAX package's inventory, unchanged: the port's serving plans place
    segments over it so that they compare with the reference's.
    """
    nics = [
        NicSpec(
            f"group-{i}", "tpu-v5e-group", cores=chips_per_group,
            accelerators={ATTENTION: chips_per_group, SSD: chips_per_group,
                          REGEX: chips_per_group, CRYPTO: chips_per_group,
                          COMPRESSION: chips_per_group},
            bandwidth_gbps=ici_gbps_per_group,
            rack=f"rack{i * 4 // max(1, groups)}",
        )
        for i in range(groups)
    ]
    return Pool(nics)
