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

``test_qos.py`` itself waits for the service runtime's port: its registry
builds ``service.tenants.TenantRegistry``.
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
