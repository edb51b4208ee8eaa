"""The port's chaos layer (``repro_torch.core.faults``) held against the
JAX package's ``repro.core.faults``, through the port's service runtime.

* Every case of ``test_faults.py`` runs on the port with its own asserts,
  and so do ``test_ledger_roundtrip.py``'s two chaos cases (a flap through
  the whole runtime, and an over-capacity crash that evicts the lightest
  tenants first).
* Seeded fault plans (a crash, a flap, a gray NIC, a crash inside a
  make-before-break migration, a rack outage and a repair wave, with
  recovery on and off, gray detection on and off) run in both packages on
  the CPU, and everything the runs leave behind is compared with ``==``
  (``_torch_service_pair.record``): tenant and cluster ticks, fault
  records, the recovery queue, the pool's rows, the controller's events,
  and the ``obs`` trace and metrics as bytes. ``RecoveryManager`` draws
  its backoff jitter from ``random.Random(seed)`` in both packages, so the
  retries land on the same ticks.
"""
import dataclasses

import pytest

import _torch_service_pair as sp
from repro_torch.apps.nf import ALL_APPS
from repro_torch.apps.profiles import paper_profile
from repro_torch.core.controller import MeiliController
from repro_torch.core.faults import (CRASH, FLAP, GRAY, MID_MIGRATION, REVIVE,
                                     ChaosEngine, FaultEvent, FaultPlan,
                                     GrayFailureDetector, RecoveryConfig,
                                     sentinel_check)
from repro_torch.core.pool import paper_cluster
from repro_torch.core.qos import ResourceGovernor, TenantQuota
from repro_torch.service.runtime import RuntimeConfig, ServiceRuntime
from repro_torch.service.tenants import (TenantRegistry, TenantSLA,
                                         TenantSpec, contracts,
                                         default_tenant_mix)
from repro_torch.service.workload import make_scenario

# -- test_faults.py's cases on the port ---------------------------------------

FAST = RuntimeConfig(dataplane_every=0, max_sim_seqs=32)


def make_runtime(scenario="bursty", mix=None, cfg=FAST, seed=0,
                 recovery=None, pool=None):
    mix = mix or default_tenant_mix()
    ctrl = MeiliController(pool or paper_cluster())
    registry = TenantRegistry(ctrl)
    for spec in mix:
        registry.register(spec)
    wl = make_scenario(scenario, contracts(mix), seed=seed)
    rt = ServiceRuntime(ctrl, registry, wl, cfg, recovery=recovery,
                        device="cpu")
    registry.admit_all()
    return rt


def busiest_nic(ctrl):
    usage = {}
    for dep in ctrl.deployments.values():
        for n, row in dep.allocation.A.items():
            usage[n] = usage.get(n, 0) + sum(row.values())
    return max(usage, key=lambda n: (usage[n], n))


# -- fail_at shim vs explicit plan --------------------------------------------

def test_fail_at_shim_matches_explicit_crash_plan():
    """The legacy single-shot hook must be byte-equivalent to a one-event
    CRASH plan: same NIC failed, same survivors, same fault log."""
    rt_shim = make_runtime(seed=3)
    rt_shim.run(24, fail_at=(10, None))
    rt_plan = make_runtime(seed=3)
    rt_plan.run(24, chaos=ChaosEngine(FaultPlan(
        [FaultEvent(tick=10, kind=CRASH)])))
    shim_faults = [(f.tick, f.kind, f.nic) for f in rt_shim.telemetry.faults()]
    plan_faults = [(f.tick, f.kind, f.nic) for f in rt_plan.telemetry.faults()]
    assert shim_faults == plan_faults
    assert sorted(rt_shim.alive_tenants()) == sorted(rt_plan.alive_tenants())
    rt_shim.ctrl.check_ledger()
    rt_plan.ctrl.check_ledger()


# -- gray-failure detection ----------------------------------------------------

def test_gray_failure_detected_and_drained():
    """A silently degraded NIC (allocator still sees full capacity) must be
    convicted from achieved-throughput deviation alone, drained, and
    quarantined — with the ledger clean throughout."""
    cfg = dataclasses.replace(FAST, gray_detect=True)
    rt = make_runtime(scenario="steady", cfg=cfg, seed=1)
    sick = busiest_nic(rt.ctrl)
    rt.run(24, chaos=ChaosEngine(FaultPlan(
        [FaultEvent(tick=4, kind=GRAY, nic=sick, fraction=0.25)])))
    probations = [f.nic for f in rt.telemetry.faults("gray_probation")]
    assert sick in probations
    assert sick in {f.nic for f in rt.telemetry.faults("gray_quarantined")}
    # Quarantined = dead to the allocator, nothing left placed on it.
    assert not rt.ctrl.pool[sick].alive
    assert all(sick not in dep.nics_used()
               for dep in rt.ctrl.deployments.values())
    rt.ctrl.check_ledger()


def test_gray_detector_exoneration_and_localization():
    """One degraded observer cannot convict a NIC a full-service observer
    shares (min-across-observers); absent evidence holds a streak rather
    than resetting it."""
    det = GrayFailureDetector(threshold=0.3, min_ticks=2)
    for _ in range(4):
        det.observe({"sick": [0.6, 0.5], "shared": [0.6, 0.0]})
    assert det.suspects() == ["sick"]
    assert det.suspicion["shared"] < det.threshold
    streak = det.streak["sick"]
    det.observe({"other": [0.1]})         # no evidence for "sick" this tick
    assert det.streak["sick"] == streak   # held, not reset
    det.clear("sick")
    assert det.suspects() == []


# -- recovery: park -> backoff -> readmit -------------------------------------

def test_parked_tenant_readmitted_after_revive():
    """A tenant whose placement cannot be restored is parked, retried with
    exponential backoff, and re-admitted once the crashed NIC revives."""
    # One ISG tenant on a minimal pool: the contract needs BOTH crypto
    # NICs, so losing one leaves the tenant unplaceable until the revive.
    mix = [dataclasses.replace(default_tenant_mix()[2], backup_nic=None)]
    pool = paper_cluster(n_bf2=1, n_bf1=1, n_pensando=2)
    rt = make_runtime(mix=mix, pool=pool,
                      recovery=RecoveryConfig(park=True, seed=0))
    assert rt.registry.active() == ["t-isg"]
    rt.run(40, chaos=ChaosEngine(FaultPlan([
        FaultEvent(tick=4, kind=CRASH, nic="pensando-0"),
        FaultEvent(tick=18, kind=REVIVE, nic="pensando-0"),
    ])))
    assert [f.tenant for f in rt.telemetry.faults("parked")] == ["t-isg"]
    readmits = rt.telemetry.faults("readmitted")
    assert [f.tenant for f in readmits] == ["t-isg"]
    assert readmits[0].tick >= 18          # only possible after the revive
    assert rt.recovery.parked == {}
    assert rt.recovery.mean_time_to_recover() is not None
    assert rt.registry.active() == ["t-isg"]
    rt.ctrl.check_ledger()


def test_recovery_disabled_evicts_permanently():
    mix = [dataclasses.replace(default_tenant_mix()[2], backup_nic=None)]
    pool = paper_cluster(n_bf2=1, n_bf1=1, n_pensando=2)
    rt = make_runtime(mix=mix, pool=pool,
                      recovery=RecoveryConfig(park=False, brownout=False))
    rt.run(40, chaos=ChaosEngine(FaultPlan([
        FaultEvent(tick=4, kind=CRASH, nic="pensando-0"),
        FaultEvent(tick=18, kind=REVIVE, nic="pensando-0"),
    ])))
    assert rt.recovery.evicted == ["t-isg"]
    assert rt.telemetry.faults("readmitted") == []
    assert rt.registry.active() == []      # revive does not resurrect policy
    rt.ctrl.check_ledger()


# -- brownout ------------------------------------------------------------------

def test_brownout_factor_monotone_in_weight():
    gov = ResourceGovernor()
    gov.register("light", TenantQuota(max_gbps=10.0, weight=1.0))
    gov.register("heavy", TenantQuota(max_gbps=10.0, weight=3.0))
    assert gov.brownout_factor("light") == 1.0    # no brownout set
    gov.set_brownout(0.5)
    light, heavy = gov.brownout_factor("light"), gov.brownout_factor("heavy")
    assert 0.5 <= light < heavy <= 1.0
    gov.set_brownout(None)
    assert gov.brownout_factor("heavy") == 1.0


def test_scale_verdict_clamps_under_brownout():
    gov = ResourceGovernor()
    gov.register("t", TenantQuota(max_gbps=10.0, weight=1.0))
    # A heavier peer: brownout is weight-proportional, the heaviest tenant
    # keeps its full grant while lighter ones shed toward the level.
    gov.register("vip", TenantQuota(max_gbps=10.0, weight=4.0))
    gov.set_brownout(0.5)
    v = gov.scale_verdict("t", est_gbps=10.0, offered_gbps=10.0,
                          contract_gbps=10.0, current_gbps=10.0,
                          achievable_gbps=10.0)
    assert v.brownout
    assert v.target_gbps <= gov.brownout_factor("t") * 10.0 + 1e-9
    gov.set_brownout(None)
    v2 = gov.scale_verdict("t", est_gbps=10.0, offered_gbps=10.0,
                           contract_gbps=10.0, current_gbps=10.0,
                           achievable_gbps=10.0)
    assert not v2.brownout
    assert v2.target_gbps > v.target_gbps


# -- invariant sentinel --------------------------------------------------------

def test_sentinel_catches_flow_and_backlog_corruption():
    rt = make_runtime()
    rt.run(4)
    sentinel_check(rt)                     # healthy: no complaint
    dep = rt.registry.deployment("t-fw")
    dep.to.flow_table[999] = 424242        # flow mapped to missing pipeline
    with pytest.raises(AssertionError, match="missing pipeline"):
        sentinel_check(rt)
    del dep.to.flow_table[999]
    rt._backlog["t-fw"] = -1.0
    with pytest.raises(AssertionError, match="negative backlog"):
        sentinel_check(rt)


# -- mid-migration fault -------------------------------------------------------

def test_mid_migration_fault_conserves_flows_and_ledger():
    """A crash landed between make-before-break begin and finish (flows
    buffered, ledger already swapped) must leave no orphan flow and no
    ledger drift; the run itself sentinels after the event."""
    rt = make_runtime(seed=2)
    rt.run(24, chaos=ChaosEngine(FaultPlan(
        [FaultEvent(tick=8, kind=MID_MIGRATION)])))
    assert rt.telemetry.faults("mid_migration")   # fired (or honest no-op)
    for name in rt.registry.active():
        dep = rt.registry.deployment(name)
        pids = {p.pid for p in dep.to.pipelines}
        assert all(pid in pids for pid in dep.to.flow_table.values()), name
    rt.ctrl.check_ledger()


# -- failover no-op path -------------------------------------------------------

def test_inject_failure_with_nothing_allocated_is_noop():
    """No allocations anywhere: the failover path must record a no-op event
    instead of raising (chaos plans may fire into an empty pool)."""
    ctrl = MeiliController(paper_cluster())
    registry = TenantRegistry(ctrl)
    wl = make_scenario("steady", {})
    rt = ServiceRuntime(ctrl, registry, wl, FAST, device="cpu")
    failed, impacted = rt.inject_failure(None)
    assert failed is None and impacted == []
    assert rt.telemetry.faults("failover_skipped")
    ctrl.check_ledger()


# -- flap through the runtime --------------------------------------------------

def test_flap_schedules_revive_and_heals():
    rt = make_runtime(seed=4)
    sick = busiest_nic(rt.ctrl)
    rt.run(20, chaos=ChaosEngine(FaultPlan([
        FaultEvent(tick=5, kind=FLAP, nic=sick, duration_ticks=3)])))
    assert [f.nic for f in rt.telemetry.faults("flap")] == [sick]
    revives = rt.telemetry.faults("revive")
    assert revives and revives[0].tick == 8
    assert rt.ctrl.pool[sick].alive
    rt.ctrl.check_ledger()


# -- test_ledger_roundtrip.py's chaos cases on the port -----------------------

def snapshot(pool):
    return {n: (dict(st.free), st.free_bw_gbps)
            for n, st in pool.nics.items()}


def _service_runtime(mix, pool, recovery=None, scenario="steady", seed=0):
    ctrl = MeiliController(pool)
    registry = TenantRegistry(ctrl)
    for spec in mix:
        registry.register(spec)
    wl = make_scenario(scenario, contracts(mix), seed=seed)
    rt = ServiceRuntime(ctrl, registry, wl,
                        RuntimeConfig(dataplane_every=0, max_sim_seqs=32),
                        recovery=recovery, device="cpu")
    registry.admit_all()
    return rt


def test_flapping_nic_roundtrip_leaves_pool_at_baseline():
    """A flap (crash + scheduled revive) driven through the full service
    runtime — failover, autoscaling, re-placement — must keep the ledger
    exact every tick and return the pool to its empty baseline once every
    tenant terminates."""
    pool = paper_cluster()
    base = snapshot(pool)
    rt = _service_runtime(default_tenant_mix(), pool, seed=5)
    load = {}
    for dep in rt.ctrl.deployments.values():
        for n, row in dep.allocation.A.items():
            load[n] = load.get(n, 0) + sum(row.values())
    sick = max(load, key=lambda n: (load[n], n))
    rt.run(20, chaos=ChaosEngine(FaultPlan(
        [FaultEvent(tick=6, kind=FLAP, nic=sick, duration_ticks=4)])))
    rt.ctrl.check_ledger()
    assert rt.ctrl.pool[sick].alive
    for name in list(rt.ctrl.deployments):
        rt.ctrl.terminate(name)
    rt.ctrl.check_ledger()
    assert rt.ctrl.pool.usage_snapshot() == {}
    for n, (free, bw) in base.items():
        st = rt.ctrl.pool[n]
        assert st.free == free, f"{n}: unit drift {st.free} != {free}"
        assert st.free_bw_gbps == pytest.approx(bw, abs=1e-6)


def test_over_capacity_failure_evicts_lowest_weight_first():
    """Five equal-size CPU-only tenants with distinct weights on two NICs;
    crashing the fuller NIC leaves surviving capacity for exactly one of its
    three victims. The governor's failover order hands that capacity to the
    heaviest contract, so the evicted set is exactly the lowest-weight
    victims — and the pool still round-trips to baseline, dead NIC
    included."""
    pool = paper_cluster(n_bf2=2, n_bf1=0, n_pensando=0)
    base = snapshot(pool)
    mix = []
    for i in range(5):
        app = ALL_APPS()["FW"]
        mix.append(TenantSpec(
            name=f"t{i + 1}", app=app, profile=paper_profile("FW"),
            sla=TenantSLA(target_gbps=2.0, p99_latency_s=600e-6,
                          priority=i + 1)))
    rt = _service_runtime(mix, pool,
                          recovery=RecoveryConfig(park=False, brownout=False))
    assert len(rt.registry.active()) == 5
    hosted = {}
    for name in rt.registry.active():
        for n in rt.registry.deployment(name).nics_used():
            hosted.setdefault(n, set()).add(name)
    victim_nic = max(hosted, key=lambda n: (len(hosted[n]), n))
    victims = hosted[victim_nic]
    assert len(victims) >= 2, "packing premise: the fuller NIC is shared"
    weight = {s.name: float(s.sla.priority) for s in mix}
    rt.run(16, chaos=ChaosEngine(FaultPlan(
        [FaultEvent(tick=4, kind=CRASH, nic=victim_nic)])))
    evicted = set(rt.recovery.evicted)
    survivors = victims - evicted
    assert evicted and evicted < victims    # over capacity, but not for all
    # Strict weight order: every evicted victim is lighter than every
    # surviving one (heaviest-first re-placement over equal-size demands).
    assert max(weight[t] for t in evicted) < \
        min(weight[t] for t in survivors)
    assert survivors <= set(rt.registry.active())
    rt.ctrl.check_ledger()
    for name in list(rt.ctrl.deployments):
        rt.ctrl.terminate(name)
    rt.ctrl.check_ledger()
    assert rt.ctrl.pool.usage_snapshot() == {}
    for n, (free, bw) in base.items():
        st = rt.ctrl.pool[n]
        assert st.free == free, f"{n}: unit drift {st.free} != {free}"
        assert st.free_bw_gbps == pytest.approx(bw, abs=1e-6)


# -- seeded fault plans in both packages ---------------------------------------

ISG_ALONE = dict(pool_kw=dict(n_bf2=1, n_bf1=1, n_pensando=2),
                 mix=lambda pkg: [dataclasses.replace(
                     pkg.tenants.default_tenant_mix()[2], backup_nic=None)])
PLANS = {
    # the fail_at shim's single crash of the busiest NIC
    "crash": dict(ticks=24, seed=3, events=[dict(tick=10, kind="crash")]),
    "flap": dict(ticks=20, seed=4, events=[
        dict(tick=5, kind="flap", nic="bf2-4", duration_ticks=3)]),
    "gray_detect": dict(ticks=24, seed=1, scenario="steady",
                        cfg=dict(gray_detect=True), events=[
                            dict(tick=4, kind="gray", nic="bf2-4",
                                 fraction=0.25)]),
    "mid_migration": dict(ticks=24, seed=2, events=[
        dict(tick=8, kind="mid_migration")]),
    "rack_and_repair": dict(
        ticks=32, scenario="chaos",
        recovery=dict(park=True, brownout=True, seed=1), events=[
            dict(tick=6, kind="rack", rack="rack1"),
            dict(tick=20, kind="revive")]),
    "park_readmit": dict(
        ticks=40, recovery=dict(park=True, seed=0), events=[
            dict(tick=4, kind="crash", nic="pensando-0"),
            dict(tick=18, kind="revive", nic="pensando-0")], **ISG_ALONE),
    "evict": dict(
        ticks=40, recovery=dict(park=False, brownout=False), events=[
            dict(tick=4, kind="crash", nic="pensando-0"),
            dict(tick=18, kind="revive", nic="pensando-0")], **ISG_ALONE),
}
for _on in (True, False):
    PLANS["chaos_recovery_" + ("on" if _on else "off")] = dict(
        ticks=44, scenario="chaos", mix=sp.chaos_mix,
        pool_kw=dict(sp.CHAOS_POOL, racks=2),
        cfg=dict(gray_detect=_on, max_sim_seqs=48),
        recovery=(dict(park=True, brownout=True, seed=0) if _on
                  else dict(park=False, brownout=False)),
        events=[dict(tick=4, kind="flap", nic="bf2-0", duration_ticks=3),
                dict(tick=12, kind="gray", nic="bf2-1", fraction=0.25),
                dict(tick=19, kind="mid_migration"),
                dict(tick=24, kind="rack", rack="rack1"),
                dict(tick=31, kind="revive")])


@pytest.mark.parametrize("plan", list(PLANS))
def test_fault_plan_run_equals_reference(plan, tmp_path):
    kw = dict(PLANS[plan])
    ticks = kw.pop("ticks")
    got, want, rt = sp.run_pair(tmp_path, ticks, **kw)
    assert got["faults"], "the plan fired nothing"
    sp.assert_same(got, want)


def test_fault_plans_reach_every_recovery_path(tmp_path):
    """The plans above between them crash, flap, gray, rack-fail and revive
    NICs, park, re-admit, evict, brown out and quarantine: each recovery
    reaction the comparison is meant to hold shows up in some run."""
    kinds = set()
    for plan, kw in PLANS.items():
        kw = dict(kw)
        rt = sp.build(sp.PORT, **{k: v for k, v in kw.items()
                                  if k not in ("ticks", "events")})
        rt.run(kw["ticks"], chaos=sp.engine(sp.PORT, kw["events"]))
        kinds |= {f.kind for f in rt.telemetry.faults()}
    assert {"crash", "flap", "gray", "mid_migration", "rack", "revive",
            "parked", "readmitted", "evicted", "degraded", "gray_probation",
            "gray_quarantined"} <= kinds, kinds
