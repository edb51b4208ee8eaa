"""Tenant model, SLAs, and admission control (Meili-Serve).

A *tenant* is one customer of the NIC-pool service: an application chain
(``MeiliApp``), an offline profile, and an SLA (contracted peak throughput,
p99 latency SLO, priority). The registry routes admissions through
``MeiliController.submit`` — Algorithm 1 derives replication, Algorithm 2/3
place units — and enforces strict admission: a tenant whose contracted peak
cannot be placed is rolled back and rejected rather than silently degraded
(the paper's FCFS submission model, §6.1, with priority classes layered on
top: higher priority admits first; FCFS within a class).

``default_tenant_mix`` is the 6-tenant evaluation mix (one tenant per paper
app, Appendix F) used by the resource-efficiency benchmark.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.apps.nf import ALL_APPS
from repro_torch.apps.profiles import paper_profile
from repro_torch.core.controller import Deployment, MeiliController
from repro_torch.core.graph import MeiliApp
from repro_torch.core.profiler import AppProfile
from repro_torch.core.qos import TenantQuota, quota_from_sla


class AdmissionError(RuntimeError):
    """Raised when a tenant's contracted target cannot be placed."""


@dataclasses.dataclass(frozen=True)
class TenantSLA:
    target_gbps: float            # contracted peak throughput
    p99_latency_s: float          # latency SLO on the sim-model p99
    priority: int = 1             # higher admits first (FCFS within a class)
    # Error-budget terms: a tick is SLI-good when achieved
    # throughput holds min_tput_frac of min(offered, target) and p99 stays
    # under the latency target; budget_frac of the rolling horizon may be
    # bad before the contract is broken. Defaults keep older call sites
    # (positional construction) behaviorally identical.
    min_tput_frac: float = 0.9    # SLI throughput floor (fraction of contract)
    budget_frac: float = 0.05     # allowed bad-tick fraction of the horizon


@dataclasses.dataclass
class TenantSpec:
    name: str
    app: MeiliApp
    profile: AppProfile
    sla: TenantSLA
    backup_nic: Optional[str] = None   # Appendix-D failover replication target
    arrive_tick: int = 0               # churn: when the tenant shows up
    depart_tick: Optional[int] = None  # churn: when it leaves (None = never)
    # QoS quota: caps + burst credits + fair-share weight enforced
    # by the ResourceGovernor. None derives the default from the SLA — the
    # contract is the cap, the priority is the weight (quota_from_sla).
    quota: Optional[TenantQuota] = None

    def effective_quota(self) -> TenantQuota:
        return self.quota if self.quota is not None else quota_from_sla(self.sla)


class TenantRegistry:
    """Catalog of tenants + admission control over one MeiliController."""

    def __init__(self, controller: MeiliController):
        self.controller = controller
        self.specs: Dict[str, TenantSpec] = {}
        self.admitted: Dict[str, Deployment] = {}
        self.rejected: Dict[str, str] = {}    # tenant -> reason
        # Evicted-but-retrying tenants (chaos recovery): excluded from
        # churn's pending() so re-admission happens only through the
        # RecoveryManager's backoff schedule, never as a silent re-arrival.
        self.parked: set = set()

    def register(self, spec: TenantSpec) -> None:
        if spec.name in self.specs:
            raise ValueError(f"tenant {spec.name} already registered")
        # Deployments are keyed by app name; give every tenant its own key so
        # two tenants may run the same application independently.
        spec.app.name = spec.name
        self.specs[spec.name] = spec
        # Declare the tenant's quota to the governor up front: admission,
        # scaling, and dispatch all consult the same policy rows.
        self.controller.governor.register(spec.name, spec.effective_quota())

    def admit(self, name: str, strict: bool = True) -> Deployment:
        spec = self.specs[name]
        if name in self.admitted:
            return self.admitted[name]
        dep = self.controller.submit(spec.app, spec.sla.target_gbps,
                                     spec.profile, backup_nic=spec.backup_nic,
                                     tenant=name)
        verdict = self.controller.governor.admission_verdict(name,
                                                             dep.allocation)
        if strict and not verdict.admitted:
            self.controller.terminate(spec.app.name)
            self.rejected[name] = verdict.reason
            raise AdmissionError(f"{name}: {self.rejected[name]}")
        self.admitted[name] = dep
        return dep

    def admit_all(self, strict: bool = True) -> List[str]:
        """Admit every registered tenant due at tick 0, highest priority
        first (FCFS within a priority class = registration order)."""
        out = []
        for name in self.pending(tick=0):
            try:
                self.admit(name, strict=strict)
                out.append(name)
            except AdmissionError:
                pass
        return out

    def evict(self, name: str) -> None:
        if name in self.admitted:
            self.controller.terminate(name)
            self.controller.governor.forget(name)
            del self.admitted[name]

    def readmit(self, name: str) -> bool:
        """Retry admission for a parked (previously evicted) tenant.

        Eviction forgot the tenant's governor quota, so it is re-registered
        first; a failed retry cleans up after itself — the quota is forgotten
        again and the rejection note ``admit`` wrote is cleared, so a later
        retry is not mistaken for a permanent rejection. Returns True when
        the tenant is back in service."""
        spec = self.specs[name]
        self.controller.governor.register(name, spec.effective_quota())
        try:
            self.admit(name, strict=True)
        except AdmissionError:
            self.rejected.pop(name, None)
            self.controller.governor.forget(name)
            return False
        self.parked.discard(name)
        return True

    def pending(self, tick: int) -> List[str]:
        """Registered, not yet admitted/rejected, due to arrive by `tick`."""
        due = [n for n, s in self.specs.items()
               if n not in self.admitted and n not in self.rejected
               and n not in self.parked
               and s.arrive_tick <= tick
               and (s.depart_tick is None or s.depart_tick > tick)]
        return sorted(due, key=lambda n: (-self.specs[n].sla.priority,
                                          list(self.specs).index(n)))

    def departing(self, tick: int) -> List[str]:
        return [n for n in self.admitted
                if self.specs[n].depart_tick is not None
                and self.specs[n].depart_tick <= tick]

    def active(self) -> List[str]:
        return list(self.admitted)

    def deployment(self, name: str) -> Deployment:
        return self.controller.deployments[name]


# -- the default 6-tenant evaluation mix --------------------------------------

# (app key, contract Gbps, p99 SLO, priority). Contracts are sized so the mix
# comfortably multiplexes onto the paper cluster in pooled mode while the
# standalone mode must dedicate most of the rack (ISG alone pins one BF-2 for
# regex plus two Pensandos for sha+aes).
DEFAULT_MIX = (
    ("ID", 8.0, 400e-6, 2),
    ("ICG", 8.0, 400e-6, 1),
    ("ISG", 5.0, 600e-6, 2),
    ("FW", 10.0, 600e-6, 1),
    ("FM", 8.0, 600e-6, 1),
    ("LLB", 12.0, 300e-6, 2),
)

BACKUP_NICS = ("bf1-0", "bf1-1", "bf1-2", "bf1-3")


def default_tenant_mix(impl: Optional[str] = None) -> List[TenantSpec]:
    """One tenant per paper app. ``impl=None`` runs each tenant's stages on
    the kernels for packets on the card and on the plain versions for
    packets on the CPU; ``"torch"`` forces the plain versions."""
    apps = ALL_APPS(impl=impl)
    mix = []
    for i, (key, gbps, p99, prio) in enumerate(DEFAULT_MIX):
        mix.append(TenantSpec(
            name=f"t-{key.lower()}", app=apps[key],
            profile=paper_profile(key),
            sla=TenantSLA(target_gbps=gbps, p99_latency_s=p99, priority=prio),
            backup_nic=BACKUP_NICS[i % len(BACKUP_NICS)]))
    return mix


def contracts(mix: List[TenantSpec]) -> Dict[str, float]:
    return {s.name: s.sla.target_gbps for s in mix}


def churn_tenant_mix(ticks: int = 96, impl: Optional[str] = None
                     ) -> List[TenantSpec]:
    """A churn-heavy variant of the evaluation mix: two first-wave tenants
    depart mid-run and a second wave arrives into the holes they leave.
    Deterministic; arrival/departure ticks scale with the run length so the
    same mix works for smoke and full benchmark runs."""
    mix = default_tenant_mix(impl=impl)
    # First wave: ICG and FM leave, opening mid-run holes in the packing.
    mix[1] = dataclasses.replace(mix[1], depart_tick=max(2, int(0.30 * ticks)))
    mix[4] = dataclasses.replace(mix[4], depart_tick=max(3, int(0.45 * ticks)))
    # Second wave: fresh tenants (their own app instances — deployments are
    # keyed per tenant) arriving staggered into the fragmented pool.
    wave2 = (
        ("ID", 6.0, 400e-6, 1, 0.35),
        ("FW", 8.0, 600e-6, 1, 0.50),
        ("LLB", 8.0, 300e-6, 2, 0.60),
    )
    for i, (key, gbps, p99, prio, frac) in enumerate(wave2):
        apps = ALL_APPS(impl=impl)
        mix.append(TenantSpec(
            name=f"t-{key.lower()}-w2", app=apps[key],
            profile=paper_profile(key),
            sla=TenantSLA(target_gbps=gbps, p99_latency_s=p99, priority=prio),
            backup_nic=BACKUP_NICS[i % len(BACKUP_NICS)],
            arrive_tick=max(1, int(frac * ticks))))
    return mix
