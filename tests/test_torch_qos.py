"""The port's QoS governor (``repro_torch.core.qos``) held against the JAX
package's ``repro.core.qos``.

The governor is host Python over floats, dicts and the pool's quota rows,
and the port keeps the reference's code and float order, so everything is
compared with ``==``: each package gets the same seeded calls in one
process, through its own pool (``paper_cluster()``) and its own ``Obs``
under a fixed clock, and the verdicts (``dataclasses.asdict``), credits,
headroom ledgers, brownout factors, orders, replacement demands, DWRR
dispatch orders and served bytes, the pool's quota rows, and the audit
trace and metrics as bytes must be equal.

Every case of ``test_qos.py`` also runs on the port with its own asserts
(its registry builds the port's ``service.tenants.TenantRegistry``, and
its flash-crowd runs the port's ``ServiceRuntime`` on the CPU).
"""
import dataclasses
import itertools
import random
import types

import pytest

import repro.obs as jobs
from repro.core import pool as jpool
from repro.core import qos as jqos
from repro_torch import obs
from repro_torch.core import pool, qos
from repro_torch.core.controller import MeiliController
from repro_torch.core.pool import paper_cluster
from repro_torch.core.qos import ResourceGovernor, TenantQuota, quota_from_sla
from repro_torch.service.runtime import RuntimeConfig, ServiceRuntime
from repro_torch.service.tenants import (AdmissionError, TenantRegistry,
                                         TenantSLA, TenantSpec, contracts,
                                         default_tenant_mix)
from repro_torch.service.workload import make_scenario

PORT = types.SimpleNamespace(name="port", pool=pool, qos=qos, obs=obs)
REF = types.SimpleNamespace(name="ref", pool=jpool, qos=jqos, obs=jobs)
KINDS = ("cpu", "cpu", "regex", "crypto", "crypto", "compression")


def _clock():
    """A fixed clock: 0.0, 0.25, 0.5, ... one step per reading."""
    steps = itertools.count()
    return lambda: 0.25 * next(steps)


def _quota(pkg, rng):
    return pkg.qos.TenantQuota(
        max_gbps=rng.choice([None, rng.uniform(2.0, 30.0)]),
        max_units=rng.choice([None, rng.randint(2, 24)]),
        burst_gbps=rng.choice([0.0, rng.uniform(1.0, 10.0)]),
        burst_refill_gbps=rng.uniform(0.0, 3.0),
        weight=rng.choice([0.5, 1.0, 1.0, 2.0, 3.0, 5.0]))


def _governor(pkg, rng, n, enabled=True):
    gov = pkg.qos.ResourceGovernor(enabled=enabled,
                                   pressure_frac=rng.uniform(0.8, 0.95))
    p = pkg.pool.paper_cluster()
    gov.bind(p)
    o = pkg.obs.Obs(clock=_clock())
    gov.attach_obs(o)
    names = [f"q{i:02d}" for i in range(n)]
    for t in names:
        gov.register(t, _quota(pkg, rng))
    return gov, p, o, names


def _verdict_args(rng):
    return dict(
        est_gbps=rng.uniform(0.0, 40.0), offered_gbps=rng.uniform(0.0, 40.0),
        contract_gbps=rng.uniform(2.0, 25.0),
        current_gbps=rng.uniform(0.0, 30.0),
        achievable_gbps=rng.uniform(0.5, 30.0),
        unit_gbps=rng.choice([0.0, rng.uniform(0.5, 6.0)]),
        stage_kinds=tuple(rng.choice(KINDS)
                          for _ in range(rng.randint(0, 4))),
        held_units=rng.randint(0, 20),
        headroom=rng.choice([1.15, rng.uniform(1.0, 1.5)]),
        floor_frac=rng.choice([0.2, rng.uniform(0.05, 0.5)]),
        rescale_threshold=rng.choice([0.1, rng.uniform(0.01, 0.3)]),
        cooldown_active=rng.random() < 0.3, forced=rng.random() < 0.1)


def _script(pkg, seed, enabled, tmp_path):
    """A seeded run through every governor entry point; returns what each
    call answered and the state and artifacts it left."""
    rng = random.Random(seed)
    gov, p, o, names = _governor(pkg, rng, rng.randint(3, 10), enabled)
    out = []
    for tick in range(12):
        active = rng.sample(names, rng.randint(1, len(names)))
        gov.begin_tick(active=active, tick=tick)
        out.append(("tick", tick, dict(gov.credits),
                    gov.headroom_snapshot()))
        gov.set_brownout(rng.choice([None, None, rng.uniform(0.0, 1.2)]))
        out.append(("brownout", [gov.brownout_factor(t) for t in names]))
        for t in rng.sample(names, rng.randint(1, len(names))):
            v = gov.scale_verdict(t, **_verdict_args(rng))
            out.append(("scale", t, dataclasses.asdict(v), dict(gov.credits),
                        gov.headroom_snapshot()))
        t = rng.choice(names)
        out.append(("admit_target", gov.admission_target(
            t, rng.uniform(0.0, 40.0))))
        unmet = {f"s{i}": rng.choice([0, 0, 1, 3]) for i in range(3)}
        alloc = types.SimpleNamespace(
            unmet=unmet, satisfied=lambda u=unmet: not any(u.values()))
        out.append(("admit", dataclasses.asdict(
            gov.admission_verdict(t, alloc))))
        out.append(("migrate", gov.migration_verdict(
            hops_before=rng.randint(0, 3), hops_after=rng.randint(0, 3),
            achievable_before=rng.uniform(1.0, 20.0),
            achievable_after=rng.choice([rng.uniform(1.0, 20.0), 20.0]),
            nics_before=rng.randint(1, 6), nics_after=rng.randint(1, 6),
            require_improvement=rng.random() < 0.7)))
        lost = {f"s{i}": rng.randint(0, 4) for i in range(rng.randint(1, 4))}
        out.append(("replace", gov.replacement_demand(
            t, lost, held_units=rng.randint(0, 20))))
        shuffled = rng.sample(names, len(names))
        out.append(("order", gov.priority_order(shuffled),
                    gov.failover_order(shuffled)))
        scored = [types.SimpleNamespace(score=rng.choice([0.0, 1.5, 3.0]),
                                        tenant=t) for t in shuffled]
        out.append(("defrag", [sc.tenant for sc in gov.defrag_order(scored)]))
        queues = {t: rng.uniform(0.0, 2e4) for t in active}
        caps = rng.choice([None, {t: rng.choice([rng.uniform(1e2, 1.5e4),
                                                 float("inf")])
                                  for t in active}])
        budget = rng.choice([None, rng.uniform(1e2, 5e4)])
        out.append(("dwrr", gov.dwrr_schedule(queues, caps, budget),
                    dict(gov._deficit), list(gov._ring)))
        if rng.random() < 0.3:                    # churn: leave and return
            t = rng.choice(names)
            gov.forget(t)
            out.append(("forget", t, p.quota_row(t), list(gov._ring)))
            gov.register(t, _quota(pkg, rng))
        out.append(("rows", {t: p.quota_row(t) for t in names}))
    gov.obs.trace.dump_jsonl(tmp_path / f"{pkg.name}.jsonl")
    gov.obs.metrics.dump_jsonl(tmp_path / f"{pkg.name}_metrics.jsonl")
    return (out, (tmp_path / f"{pkg.name}.jsonl").read_bytes(),
            (tmp_path / f"{pkg.name}_metrics.jsonl").read_bytes(),
            o.metrics.render_prometheus())


@pytest.mark.parametrize("seed", range(16))
@pytest.mark.parametrize("enabled", [True, False],
                         ids=["enabled", "disabled"])
def test_governor_script_equals_reference(seed, enabled, tmp_path):
    got = _script(PORT, seed, enabled, tmp_path)
    want = _script(REF, seed, enabled, tmp_path)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1]            # the audit trace's bytes
    assert got[2:] == want[2:]                     # metrics, both renderings


@pytest.mark.parametrize("capped", [True, False], ids=["capped", "uncapped"])
def test_dwrr_schedule_12_ticks_equals_reference(capped):
    """The scalar DWRR over 12 ticks with persistent deficits and ring,
    weights from quotas, tenants joining and leaving: equal orders, served
    bytes, deficits and rings."""
    def run(pkg):
        rng = random.Random(21)
        gov = pkg.qos.ResourceGovernor()
        names = [f"d{i:02d}" for i in range(12)]
        for t in names:
            gov.register(t, pkg.qos.TenantQuota(
                weight=rng.choice([0.5, 1.0, 2.0, 3.0])))
        out = []
        for tick in range(12):
            live = [t for t in names if rng.random() < 0.85]
            queues = {t: rng.uniform(0.0, 8e3) for t in live}
            caps = {t: rng.uniform(5e2, 6e3) for t in live}
            out.append((gov.dwrr_schedule(
                queues, caps if capped else None,
                rng.uniform(2e3, 2e4) if capped else None),
                dict(gov._deficit), list(gov._ring)))
        return out
    assert run(PORT) == run(REF)


def test_quota_from_sla_and_defaults_equal_reference():
    """``quota_from_sla`` takes any object with the SLA's fields."""
    for priority, weight in ((0, 1.0), (3, 3.0)):
        sla = types.SimpleNamespace(target_gbps=12.5, priority=priority)
        got = dataclasses.asdict(qos.quota_from_sla(sla))
        assert got == dataclasses.asdict(jqos.quota_from_sla(sla)) == {
            "max_gbps": 12.5, "max_units": None, "burst_gbps": 0.0,
            "burst_refill_gbps": 0.0, "weight": weight}
    assert dataclasses.asdict(qos.ScaleVerdict(1.0, True)) == \
        dataclasses.asdict(jqos.ScaleVerdict(1.0, True))
    assert qos._EPS == jqos._EPS


# -- test_qos.py's cases on the port -------------------------------------------

FAST = RuntimeConfig(dataplane_every=0, max_sim_seqs=32)
QOS_POOL = dict(n_bf2=3, n_bf1=1, n_pensando=2)


def _registry(pool=None, governor=None):
    ctrl = MeiliController(pool or paper_cluster(),
                           governor=governor or ResourceGovernor())
    return ctrl, TenantRegistry(ctrl)


# -- quota admission + ledger roundtrip ---------------------------------------

def test_quota_clamps_submission_target_and_ledger_roundtrips():
    ctrl, registry = _registry()
    spec = default_tenant_mix()[3]           # t-fw, contract 10
    spec = dataclasses.replace(spec, quota=TenantQuota(max_gbps=4.0))
    registry.register(spec)
    baseline = {n: dict(ctrl.pool[n].free) for n in ctrl.pool.nics}
    dep = registry.admit(spec.name)
    # submit routed through the governor: the placed target is the quota,
    # not the contract, and the pool quota row records the entitlement.
    assert dep.target_gbps == pytest.approx(4.0)
    assert ctrl.pool.quota_row(spec.name)["max_gbps"] == pytest.approx(4.0)
    ctrl.check_ledger()
    registry.evict(spec.name)
    ctrl.check_ledger()
    assert {n: dict(ctrl.pool[n].free) for n in ctrl.pool.nics} == baseline
    assert ctrl.pool.quota_row(spec.name) == {}   # forget() cleared the row


def test_admission_rejection_routes_through_governor_verdict():
    ctrl, registry = _registry()
    spec = default_tenant_mix()[2]
    spec = dataclasses.replace(
        spec, name="t-huge",
        sla=TenantSLA(target_gbps=500.0, p99_latency_s=1e-3))
    registry.register(spec)
    with pytest.raises(AdmissionError):
        registry.admit("t-huge")
    assert "unplaceable" in registry.rejected["t-huge"]
    ctrl.check_ledger()
    assert ctrl.pool.usage_snapshot() == {}


# -- burst credits (token bucket) ---------------------------------------------

def test_burst_credits_spend_and_refill_roundtrip():
    gov = ResourceGovernor()
    gov.register("t", TenantQuota(max_gbps=5.0, burst_gbps=3.0,
                                  burst_refill_gbps=1.0))
    assert gov.credits["t"] == pytest.approx(3.0)
    # Over-quota ask: granted = quota + full bucket; bucket drains.
    v = gov.scale_verdict("t", est_gbps=20.0, offered_gbps=20.0,
                          contract_gbps=5.0, current_gbps=5.0,
                          achievable_gbps=5.0)
    assert v.target_gbps == pytest.approx(8.0)        # 5 + 3 credits
    assert v.burst_credit_spent == pytest.approx(3.0)
    assert gov.credits["t"] == pytest.approx(0.0)
    # Idle ticks refill the bucket at the declared rate, up to the depth.
    for expect in (1.0, 2.0, 3.0, 3.0):
        gov.begin_tick(active=["t"])
        assert gov.credits["t"] == pytest.approx(expect)
    # In-quota asks never burn credit.
    v = gov.scale_verdict("t", est_gbps=2.0, offered_gbps=2.0,
                          contract_gbps=5.0, current_gbps=5.0,
                          achievable_gbps=5.0)
    assert v.burst_credit_spent == 0.0
    assert gov.credits["t"] == pytest.approx(3.0)


def test_noop_verdict_burns_no_credit():
    """A verdict that does not trigger a rescale must not drain the bucket:
    credit pays for grants actually taken, not for asks."""
    gov = ResourceGovernor()
    gov.register("t", TenantQuota(max_gbps=10.0, burst_gbps=3.0))
    # Demand hovering just over quota, target already there: no pressure,
    # gap below threshold -> rescale=False every tick.
    for _ in range(5):
        v = gov.scale_verdict("t", est_gbps=9.5, offered_gbps=9.5,
                              contract_gbps=10.0, current_gbps=10.5,
                              achievable_gbps=12.0)
        assert not v.rescale
        assert v.burst_credit_spent == 0.0
    assert gov.credits["t"] == pytest.approx(3.0)


# -- partial grant under contention -------------------------------------------

def test_scale_verdict_partially_grants_against_headroom_ledger():
    pool = paper_cluster(n_bf2=0, n_bf1=1, n_pensando=0)   # 15 cpu units
    gov = ResourceGovernor()
    gov.bind(pool)
    gov.register("a", TenantQuota(weight=2.0))
    gov.register("b", TenantQuota(weight=1.0))
    pool["bf1-0"].take("cpu", 9)                            # 6 units free
    gov.begin_tick(pool, ["a", "b"])
    # Each unit is worth 2 Gbps; both tenants ask for ~5 units of growth.
    va = gov.scale_verdict("a", est_gbps=10.0, offered_gbps=10.0,
                           contract_gbps=20.0, current_gbps=0.0,
                           achievable_gbps=0.1, unit_gbps=2.0,
                           stage_kinds=["cpu"])
    vb = gov.scale_verdict("b", est_gbps=10.0, offered_gbps=10.0,
                           contract_gbps=20.0, current_gbps=0.0,
                           achievable_gbps=0.1, unit_gbps=2.0,
                           stage_kinds=["cpu"])
    # First asker drains the ledger; the second is partially granted.
    assert va.granted_frac == pytest.approx(1.0)
    assert vb.target_gbps < va.target_gbps
    assert vb.granted_frac < 1.0


def test_quota_max_units_caps_growth():
    gov = ResourceGovernor()
    gov.register("t", TenantQuota(max_units=3))
    v = gov.scale_verdict("t", est_gbps=100.0, offered_gbps=100.0,
                          contract_gbps=100.0, current_gbps=2.0,
                          achievable_gbps=2.0, unit_gbps=2.0,
                          stage_kinds=["cpu"], held_units=2)
    # 1 unit of room -> at most +2 Gbps of growth granted.
    assert v.target_gbps <= 4.0 + 1e-9


# -- DWRR ---------------------------------------------------------------------

def test_dwrr_weighted_fairness_under_saturation():
    gov = ResourceGovernor()
    for t, w in (("a", 2.0), ("b", 1.0), ("c", 1.0)):
        gov.register(t, TenantQuota(weight=w))
    served = {t: 0.0 for t in "abc"}
    backlog = {t: 0.0 for t in "abc"}
    cap = 100.0
    for _ in range(200):
        # Persistent saturation: every tenant offers the full link each tick.
        queues = {t: backlog[t] + cap for t in served}
        _, got = gov.dwrr_schedule(queues, capacity_bytes=cap)
        for t in served:
            served[t] += got[t]
            backlog[t] = queues[t] - got[t]
    assert served["a"] / served["b"] == pytest.approx(2.0, rel=0.1)
    assert served["b"] / served["c"] == pytest.approx(1.0, rel=0.1)


def test_dwrr_uncapped_drains_to_rate_caps_in_backlog_order():
    gov = ResourceGovernor()
    for t in ("x", "y"):
        gov.register(t, TenantQuota())
    queues = {"x": 50.0, "y": 500.0}
    caps = {"x": 100.0, "y": 200.0}
    order, served = gov.dwrr_schedule(queues, caps, capacity_bytes=None)
    assert served == {"x": 50.0, "y": 200.0}   # min(queue, rate cap) each
    assert order[0] == "y"                      # biggest weighted backlog first


def test_dwrr_disabled_governor_ignores_weights():
    gov = ResourceGovernor(enabled=False)
    gov.register("a", TenantQuota(weight=8.0))
    gov.register("b", TenantQuota(weight=1.0))
    served = {"a": 0.0, "b": 0.0}
    backlog = {"a": 0.0, "b": 0.0}
    for _ in range(100):
        queues = {t: backlog[t] + 100.0 for t in served}
        _, got = gov.dwrr_schedule(queues, capacity_bytes=100.0)
        for t in served:
            served[t] += got[t]
            backlog[t] = queues[t] - got[t]
    assert served["a"] / served["b"] == pytest.approx(1.0, rel=0.05)


# -- relocated policies -------------------------------------------------------

def test_migration_verdict_is_do_no_harm():
    gov = ResourceGovernor()
    ok = dict(hops_before=2, hops_after=1, achievable_before=5.0,
              achievable_after=5.0, nics_before=3, nics_after=2)
    assert gov.migration_verdict(**ok)
    assert not gov.migration_verdict(**{**ok, "hops_after": 3})
    assert not gov.migration_verdict(**{**ok, "achievable_after": 4.0})
    # no improvement -> rejected unless the caller pinned the targets
    same = dict(hops_before=1, hops_after=1, achievable_before=5.0,
                achievable_after=5.0, nics_before=2, nics_after=2)
    assert not gov.migration_verdict(**same)
    assert gov.migration_verdict(**same, require_improvement=False)
    # the guard holds even with QoS policy disabled
    assert not ResourceGovernor(enabled=False).migration_verdict(
        **{**ok, "hops_after": 3})


def test_replacement_demand_splits_room_across_stages():
    """A binding unit quota deals re-placement room round-robin so no lost
    stage is zeroed (a zeroed stage kills the tenant outright)."""
    gov = ResourceGovernor()
    gov.register("t", TenantQuota(max_units=6))
    out = gov.replacement_demand("t", {"sha": 2, "aes": 2}, held_units=4)
    assert out == {"sha": 1, "aes": 1}        # room 2, split 1/1
    # Uncapped (or disabled) passes the demand through untouched.
    gov2 = ResourceGovernor()
    gov2.register("u", TenantQuota())
    assert gov2.replacement_demand("u", {"a": 3}, held_units=99) == {"a": 3}


def test_failover_order_is_weight_descending_stable():
    gov = ResourceGovernor()
    gov.register("lo1", TenantQuota(weight=1.0))
    gov.register("hi", TenantQuota(weight=3.0))
    gov.register("lo2", TenantQuota(weight=1.0))
    assert gov.failover_order(["lo1", "hi", "lo2"]) == ["hi", "lo1", "lo2"]
    # disabled -> every tenant weighs 1.0, so the (weight, name) tie-break
    # pins name order regardless of how the list was handed in
    assert ResourceGovernor(enabled=False).failover_order(
        ["lo1", "hi", "lo2"]) == ["hi", "lo1", "lo2"]


def test_ordering_is_invariant_to_registration_order():
    """Determinism fix: priority_order and dwrr_schedule tie-break
    by (weight, name), never by dict insertion order — any registration
    shuffle of the same quotas yields byte-identical decisions."""
    import random

    quotas = {f"t{i:02d}": TenantQuota(weight=float(1 + i % 3))
              for i in range(12)}
    queues = {t: 1000.0 * (1 + i % 5) for i, t in enumerate(quotas)}
    caps = {t: 4000.0 for t in quotas}
    baseline = None
    rng = random.Random(8)
    for trial in range(6):
        names = list(quotas)
        rng.shuffle(names)
        gov = ResourceGovernor()
        for t in names:
            gov.register(t, quotas[t])
        order, served = gov.dwrr_schedule(dict(queues), dict(caps),
                                          capacity_bytes=9000.0)
        got = (gov.priority_order(list(quotas)), order,
               sorted(served.items()))
        if baseline is None:
            baseline = got
        else:
            assert got == baseline, f"shuffle {trial} diverged"


# -- flash-crowd isolation ----------------------------------------------------

def _flash_run(seed: int, ticks: int = 48):
    mix = [dataclasses.replace(s, backup_nic=None)
           for s in default_tenant_mix()]
    ctrl, registry = _registry(pool=paper_cluster(**QOS_POOL))
    for spec in mix:
        registry.register(spec)
    wl = make_scenario("flash_crowd", contracts(mix), seed=seed,
                       surge=8.0, crowd="t-fw")
    rt = ServiceRuntime(ctrl, registry, wl, FAST, device="cpu")
    registry.admit_all()
    rt.run(ticks)
    ctrl.check_ledger()
    return ctrl, rt


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flash_crowd_cannot_break_in_quota_tenants(seed):
    """A crowd tenant at 8x its quota queues behind its own deficit: every
    other (in-quota) tenant stays within SLO, the crowd's provision target
    never exceeds its quota, and its excess shows up as its own backlog."""
    ctrl, rt = _flash_run(seed)
    report = rt.slo_report()
    for tenant, r in report.items():
        if tenant != "t-fw":
            assert r["pass"], (seed, tenant, r)
    crowd = rt.telemetry.series("t-fw")
    quota = ctrl.governor.quota("t-fw").max_gbps
    assert max(t.granted_gbps for t in crowd) <= quota + 1e-6
    assert max(t.backlog_pkts for t in crowd) > 0.0
