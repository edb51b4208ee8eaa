"""The port's deployment-mode comparator (``repro_torch.service.efficiency``)
held against the JAX package's ``repro.service.efficiency``.

* The cases of ``test_efficiency_modes.py`` run on the port with their own
  asserts, all but ``test_bench_service_fast_writes_json``: it drives
  ``benchmarks.bench_service``, whose port waits for the benchmarks.
* ``run_comparison`` (pooled, standalone and microservice over bursty and
  diurnal traffic, a NIC failure in the pooled bursty run) and
  ``provision_standalone`` over every tenant of the mix give the same
  results in both packages on the CPU, compared with ``==``: efficiencies,
  ratios, per-scenario SLO reports and summaries, the failover record and
  the dedicated units.
"""
import copy

import pytest

import _torch_service_pair as sp
from repro_torch.core.pool import CPU, paper_cluster
from repro_torch.service.efficiency import (MODES, provision_standalone,
                                            run_comparison)
from repro_torch.service.runtime import RuntimeConfig
from repro_torch.service.tenants import default_tenant_mix

# -- test_efficiency_modes.py's cases on the port ------------------------------

FAST = RuntimeConfig(dataplane_every=0, max_sim_seqs=32)


@pytest.fixture(scope="module")
def comparison():
    return run_comparison(ticks=40, cfg=FAST, seed=0, device="cpu")


def test_efficiency_ratios_meet_paper_bars(comparison):
    r = comparison["ratios"]
    assert r["pooled_vs_standalone"] >= 2.0, r
    assert r["pooled_vs_microservice"] >= 1.2, r


def test_all_slos_pass_in_every_mode(comparison):
    for scenario, rec in comparison["scenarios"].items():
        for mode in MODES:
            assert rec[mode]["slo_pass"], (scenario, mode, rec[mode]["slo"])


def test_failover_drops_no_tenant(comparison):
    fo = comparison["scenarios"]["bursty"]["failover"]
    assert fo["survived"]
    assert fo["tenants_alive_after"] == len(comparison["tenants"])
    assert fo["failed_nic"] is not None
    assert fo["impacted"]          # the busiest NIC hosted someone


def test_reserved_ordering(comparison):
    # standalone pays whole NICs; microservice pays fixed peak; pooled
    # breathes below both.
    for rec in comparison["scenarios"].values():
        pooled = rec["pooled"]["reserved_units_mean"]
        micro = rec["microservice"]["reserved_units_mean"]
        alone = rec["standalone"]["reserved_units_mean"]
        assert pooled < micro < alone


def test_standalone_provisioner_covers_resource_kinds():
    inventory = [st.spec for st in paper_cluster().nics.values()]
    isg = next(s for s in default_tenant_mix() if s.name == "t-isg")
    ctrl, taken = provision_standalone(isg, inventory)
    dep = ctrl.deployments["t-isg"]
    assert dep.allocation.satisfied()
    kinds_needed = {r for r in isg.app.resource_needs().values() if r != CPU}
    kinds_have = {k for n in taken for k, c in n.accelerators.items() if c > 0}
    assert kinds_needed <= kinds_have
    # the mixed accel demand (regex + crypto) forces a multi-NIC dedication
    assert len(taken) >= 2


def test_standalone_provisioner_handles_exhausted_inventory():
    isg = next(s for s in default_tenant_mix() if s.name == "t-isg")
    ctrl, taken = provision_standalone(isg, [])
    assert taken == []
    dep = ctrl.deployments["t-isg"]      # deployment exists, fully unmet
    assert not dep.allocation.satisfied()
    assert dep.achievable_gbps == 0.0


# -- the comparator in both packages -------------------------------------------

@pytest.mark.parametrize("ticks,scenarios,fail,seed", [
    (40, ("bursty", "diurnal"), "bursty", 0),
    (24, ("steady", "churn"), "churn", 3),
], ids=["paper", "steady_churn"])
def test_run_comparison_equals_reference(ticks, scenarios, fail, seed):
    out = {}
    for pkg in sp.PKGS:
        kw = dict(device="cpu") if pkg is sp.PORT else {}
        cfg = pkg.runtime.RuntimeConfig(**sp.FAST)
        out[pkg.name] = pkg.eff.run_comparison(
            ticks=ticks, scenarios=scenarios, cfg=cfg, fail_scenario=fail,
            seed=seed, **kw)
    assert out["port"] == out["ref"]
    assert out["port"]["scenarios"][fail]["failover"]["failed_nic"]


def test_provision_standalone_equals_reference():
    """Every tenant of the mix provisioned in turn from one shrinking
    inventory, and the last from an empty one."""
    out = {}
    for pkg in sp.PKGS:
        inventory = [st.spec for st in pkg.pool.paper_cluster().nics.values()]
        rows = []
        for spec in pkg.tenants.default_tenant_mix() * 2:
            spec = copy.copy(spec)
            ctrl, taken = pkg.eff.provision_standalone(spec, inventory)
            dep = ctrl.deployments[spec.name]
            rows.append(([n.name for n in taken], dep.allocation.A,
                         dep.allocation.unmet, dep.achievable_gbps,
                         [n.name for n in inventory]))
        out[pkg.name] = rows
    assert out["port"] == out["ref"]
    assert out["port"][-1][0] == []
