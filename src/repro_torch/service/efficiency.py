"""Deployment-mode comparator: pooled vs standalone vs microservice (§8).

The paper's headline consolidation claim: the pooled SmartNIC service is
~3× more resource-efficient than standalone per-tenant NICs and ~1.4× more
than microservice deployments. We reproduce the *protocol*: the same tenant
mix and the same deterministic traffic run under three provisioning models,
and efficiency = (achieved Gbps · ticks) / (reserved resource units · ticks):

  pooled        one shared pool, Algorithm 2/3 placement, closed-loop
                autoscaling; reserved = units currently committed;
  standalone    every tenant owns whole NICs (the smallest dedicated set
                that places its contract); reserved = ALL units of those
                NICs, always — the NICs cannot be shared, so idle cores and
                dark accelerators are still paid for;
  microservice  shared pool + stage-granular placement, but per-stage
                replica counts are FIXED at the contracted peak (no
                elasticity) — the disaggregated-container baseline.

Standalone therefore pays NIC-quantization waste (ISG alone pins a BF-2 for
regex plus Pensandos for sha/aes) and microservice pays peak-provisioning
waste across diurnal troughs and burst gaps; pooled pays neither.

Every runtime the comparator builds runs on ``device`` (the card by
default): the pooled mode pushes its tenants' batches through their data
planes there.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.controller import MeiliController
from repro_torch.core.pool import CPU, NicSpec, Pool, paper_cluster
from repro_torch.service.runtime import RuntimeConfig, ServiceRuntime
from repro_torch.service.tenants import (TenantRegistry, TenantSpec,
                                         contracts, default_tenant_mix)
from repro_torch.service.workload import make_scenario

MODES = ("pooled", "standalone", "microservice")


def _nic_units(spec: NicSpec) -> int:
    return spec.cores + sum(spec.accelerators.values())


def provision_standalone(spec: TenantSpec, inventory: List[NicSpec]
                         ) -> Tuple[MeiliController, List[NicSpec]]:
    """Dedicate the smallest whole-NIC set (greedy) that places the tenant's
    contract; NICs are consumed from the shared inventory."""
    spec.app.name = spec.name     # deployments keyed by tenant, as in admit()
    need = spec.app.resource_needs()
    taken: List[NicSpec] = []
    while True:
        # Grow the dedicated set until a trial submission places the full
        # contract; each round prefers NICs supplying the kinds the previous
        # trial left unmet (accelerators are the scarce axis, then cores).
        if taken:
            ctrl = MeiliController(Pool([copy.deepcopy(n) for n in taken]))
            dep = ctrl.submit(spec.app, spec.sla.target_gbps, spec.profile,
                              tenant=spec.name)
            if dep.allocation.satisfied() or not inventory:
                # satisfied, or inventory exhausted -> best-effort (the
                # paper's point: some mixes are simply infeasible standalone)
                return ctrl, taken
            unmet_kinds = {need[s] for s in dep.allocation.unmet}
        else:
            if not inventory:
                # Nothing left to dedicate: submit on an empty pool so the
                # caller still gets a (fully unmet) deployment to account.
                ctrl = MeiliController(Pool([]))
                ctrl.submit(spec.app, spec.sla.target_gbps, spec.profile,
                            tenant=spec.name)
                return ctrl, taken
            unmet_kinds = set(need.values())

        def score(n: NicSpec) -> tuple:
            accel = sum(n.accelerators.get(k, 0)
                        for k in unmet_kinds if k != CPU)
            cores = n.cores if CPU in unmet_kinds else 0
            return (-accel, -cores, -n.cores)

        nic = min(inventory, key=score)
        inventory.remove(nic)
        taken.append(nic)


def _run_shared_mode(mix: List[TenantSpec], scenario: str, ticks: int,
                     cfg: RuntimeConfig, autoscale: bool, seed: int,
                     fail_at: Optional[Tuple[int, Optional[str]]] = None,
                     device="cuda") -> dict:
    """Pooled / microservice: one shared paper cluster; microservice is the
    same placement machinery with elasticity disabled (fixed peak replicas)."""
    cfg = dataclasses.replace(cfg, autoscale=autoscale)
    ctrl = MeiliController(paper_cluster())
    registry = TenantRegistry(ctrl)
    for spec in mix:
        registry.register(spec)
    wl = make_scenario(scenario, contracts(mix), seed=seed)
    rt = ServiceRuntime(ctrl, registry, wl, cfg, device=device)
    registry.admit_all()
    rt.run(ticks, fail_at=fail_at)
    ach, res = rt.telemetry.totals()
    return {
        "achieved_gbps_ticks": ach,
        "reserved_unit_ticks": res,
        "slo": rt.slo_report(),
        "summary": rt.telemetry.summary(),
        "alive_tenants": rt.alive_tenants(),
        "events": [e for e in ctrl.events
                   if e["event"] in ("scale", "failover")],
        "runtime": rt,
    }


def _run_standalone(mix: List[TenantSpec], scenario: str, ticks: int,
                    cfg: RuntimeConfig, seed: int, device="cuda") -> dict:
    """Standalone: one dedicated mini-pool + controller per tenant; reserved
    units are the whole dedicated NICs, not just the committed slices."""
    cfg = dataclasses.replace(cfg, autoscale=False, dataplane_every=0)
    inventory = [st.spec for st in paper_cluster().nics.values()]
    wl_all = make_scenario(scenario, contracts(mix), seed=seed)
    total_ach = 0.0
    total_res = 0.0
    slo: Dict[str, dict] = {}
    summary: Dict[str, dict] = {}
    dedicated: Dict[str, int] = {}
    for spec in mix:
        ctrl, taken = provision_standalone(spec, inventory)
        registry = TenantRegistry(ctrl)
        # already submitted by provision_standalone: adopt the deployment
        registry.specs[spec.name] = spec
        registry.admitted[spec.name] = ctrl.deployments[spec.name]
        rt = ServiceRuntime(ctrl, registry, wl_all, cfg, device=device)
        rt.run(ticks)
        ach, _ = rt.telemetry.totals()
        total_ach += ach
        nic_units = sum(_nic_units(n) for n in taken)
        dedicated[spec.name] = nic_units
        total_res += nic_units * ticks          # whole NICs, every tick
        slo.update(rt.slo_report())
        summary.update(rt.telemetry.summary())
    return {
        "achieved_gbps_ticks": total_ach,
        "reserved_unit_ticks": total_res,
        "slo": slo,
        "summary": summary,
        "dedicated_units": dedicated,
        "alive_tenants": [s.name for s in mix],
    }


def run_comparison(mix: Optional[List[TenantSpec]] = None,
                   scenarios: Tuple[str, ...] = ("bursty", "diurnal"),
                   ticks: int = 120,
                   cfg: Optional[RuntimeConfig] = None,
                   fail_scenario: Optional[str] = "bursty",
                   fail_tick_frac: float = 0.55,
                   seed: int = 0, device="cuda") -> dict:
    """Run the tenant mix through every mode and scenario; returns the
    Fig-13-style efficiency ratios plus per-scenario SLO and failover records.

    The NIC failure is injected only into the pooled run of `fail_scenario`
    (the baselines have no failover story to exercise — standalone tenants
    simply lose their NIC in the paper)."""
    mix = mix if mix is not None else default_tenant_mix()
    cfg = cfg or RuntimeConfig()
    agg = {m: {"ach": 0.0, "res": 0.0} for m in MODES}
    out: dict = {"scenarios": {}, "tenants": contracts(mix)}

    for scenario in scenarios:
        fail_at = (int(ticks * fail_tick_frac), None) \
            if scenario == fail_scenario else None
        pooled = _run_shared_mode(mix, scenario, ticks, cfg, autoscale=True,
                                  seed=seed, fail_at=fail_at, device=device)
        micro_cfg = dataclasses.replace(cfg, dataplane_every=0)
        micro = _run_shared_mode(mix, scenario, ticks, micro_cfg,
                                 autoscale=False, seed=seed, device=device)
        alone = _run_standalone(mix, scenario, ticks, cfg, seed=seed,
                                device=device)

        for mode, r in (("pooled", pooled), ("microservice", micro),
                        ("standalone", alone)):
            agg[mode]["ach"] += r["achieved_gbps_ticks"]
            agg[mode]["res"] += r["reserved_unit_ticks"]

        rec: dict = {}
        for mode, r in (("pooled", pooled), ("microservice", micro),
                        ("standalone", alone)):
            rec[mode] = {
                "achieved_gbps_mean": r["achieved_gbps_ticks"] / ticks,
                "reserved_units_mean": r["reserved_unit_ticks"] / ticks,
                "slo": r["slo"],
                "slo_pass": all(v["pass"] for v in r["slo"].values()),
                "summary": r["summary"],
            }
        if fail_at is not None:
            failover_events = [e for e in pooled["events"]
                               if e["event"] == "failover"]
            rec["failover"] = {
                "injected_tick": fail_at[0],
                "failed_nic": failover_events[0]["nic"]
                if failover_events else None,
                "impacted": sorted({e["tenant"] for e in failover_events}),
                "tenants_alive_after": len(pooled["alive_tenants"]),
                "survived": len(pooled["alive_tenants"]) == len(mix),
            }
        if "dedicated_units" in alone:
            rec["standalone"]["dedicated_units"] = alone["dedicated_units"]
        out["scenarios"][scenario] = rec

    eff = {m: (agg[m]["ach"] / agg[m]["res"] if agg[m]["res"] else 0.0)
           for m in MODES}
    out["efficiency"] = eff
    out["ratios"] = {
        "pooled_vs_standalone": (eff["pooled"] / eff["standalone"]
                                 if eff["standalone"] else float("inf")),
        "pooled_vs_microservice": (eff["pooled"] / eff["microservice"]
                                   if eff["microservice"] else float("inf")),
    }
    return out
