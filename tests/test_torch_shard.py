"""The port's sharded control plane (``repro_torch.core.shard``) held
against the JAX package's ``repro.core.shard``.

* Every case of ``test_shard.py`` (with its parameters) runs on the port
  with its own asserts: the 1-shard facade is the port's own legacy
  controller, byte for byte once the ``shard`` labels and span durations
  are dropped, as the reference's test drops them.
* Seeded runs under a 2-shard and a 4-shard ``ShardedController`` (with
  and without a fault plan, at two digest staleness bounds) run in both
  packages on the CPU with fixed clocks, and everything they leave behind
  is compared with ``==`` (``_torch_service_pair.record``), the
  ``reconcile`` spans, ``shard_handoff`` and ``cross_rack_placement``
  events in the trace bytes included. Each shard's owner map and digest
  are compared too.
"""
from __future__ import annotations

import dataclasses
import json

import pytest

import _torch_service_pair as sp
from repro_torch.core.controller import MeiliController
from repro_torch.core.faults import (FLAP, GRAY, MID_MIGRATION, RACK, REVIVE,
                                     ChaosEngine, FaultEvent, FaultPlan,
                                     RecoveryConfig)
from repro_torch.core.pool import paper_cluster
from repro_torch.core.shard import ControlShard, ShardedController
from repro_torch.obs import RECONCILE
from repro_torch.service.runtime import RuntimeConfig, ServiceRuntime
from repro_torch.service.tenants import (TenantRegistry, contracts,
                                         default_tenant_mix)
from repro_torch.service.workload import make_scenario

# -- test_shard.py's cases on the port ----------------------------------------

FAST = RuntimeConfig(dataplane_every=0, max_sim_seqs=32)


# -- helpers -------------------------------------------------------------------

def _normalized_events(trace):
    """Trace events minus the sanctioned sharding differences: the
    ``shard``-ish detail labels and wall-clock stamps."""
    out = []
    for e in trace.events:
        d = {k: v for k, v in e.detail.items()
             if k not in ("shard", "shard_from")}
        d.pop("duration_s", None)
        out.append((e.tick, e.kind, e.name, e.tenant, e.nic, e.span_id,
                    e.parent_id, e.phase, json.dumps(d, sort_keys=True)))
    return out


def _normalized_faults(tele):
    return [dataclasses.replace(f, shard=None) for f in tele.faults()]


def _run_pair(scenario, seed=0, ticks=40, pool_kw=None, chaos_plan=None,
              recovery=None, backups=None):
    """Run the same seeded scenario under the legacy and the 1-shard
    sharded controller; return both runtimes."""
    pool_kw = dict(pool_kw or {})
    pool_kw["racks"] = 1
    out = []
    for cls in (MeiliController, ShardedController):
        ctrl = cls(paper_cluster(**pool_kw))
        registry = TenantRegistry(ctrl)
        mix = default_tenant_mix()
        if backups is not None:
            mix = [dataclasses.replace(s, backup_nic=backups[i % len(backups)])
                   for i, s in enumerate(mix)]
        for spec in mix:
            registry.register(spec)
        wl = make_scenario(scenario, contracts(default_tenant_mix()),
                           seed=seed)
        rt = ServiceRuntime(ctrl, registry, wl, FAST, recovery=recovery,
                            device="cpu")
        registry.admit_all()
        engine = ChaosEngine(chaos_plan) if chaos_plan is not None else None
        rt.run(ticks, chaos=engine)
        ctrl.check_ledger()
        out.append(rt)
    return out


def _assert_identical(rt_legacy, rt_sharded):
    assert (json.dumps(rt_legacy.telemetry.summary(), sort_keys=True)
            == json.dumps(rt_sharded.telemetry.summary(), sort_keys=True))
    assert rt_legacy.slo_report() == rt_sharded.slo_report()
    assert (_normalized_faults(rt_legacy.telemetry)
            == _normalized_faults(rt_sharded.telemetry))
    assert (_normalized_events(rt_legacy.obs.trace)
            == _normalized_events(rt_sharded.obs.trace))


# -- 1-shard bit-compatibility -------------------------------------------------

@pytest.mark.parametrize("scenario", ["bursty", "diurnal"])
def test_one_shard_is_legacy_controller(scenario):
    rt_l, rt_s = _run_pair(scenario, seed=0, ticks=40)
    assert len(rt_s.ctrl.shards) == 1
    _assert_identical(rt_l, rt_s)


def test_one_shard_is_legacy_controller_under_chaos():
    """The chaos --fast scenario (flap + gray + mid-migration crash + rack
    outage + repair wave) on a single-rack pool: recovery parking, brownout,
    gray detection — every decision byte-identical across controllers."""
    ticks = 48
    plan = FaultPlan([
        FaultEvent(tick=5, kind=FLAP, nic="bf2-1", duration_ticks=4),
        FaultEvent(tick=13, kind=GRAY, nic="bf2-2", fraction=0.25),
        FaultEvent(tick=21, kind=MID_MIGRATION),
        FaultEvent(tick=27, kind=RACK, rack="rack0"),
        FaultEvent(tick=34, kind=REVIVE, rack="rack0"),
        FaultEvent(tick=34, kind=REVIVE, nic="bf2-2"),
    ])
    cfgs = dict(
        scenario="chaos", seed=0, ticks=ticks,
        pool_kw=dict(n_bf2=4, n_bf1=2, n_pensando=2),
        chaos_plan=plan,
        recovery=RecoveryConfig(park=True, brownout=True, seed=0),
        backups=("bf1-0", "bf1-1"))
    rt_l, rt_s = _run_pair(**cfgs)
    assert rt_s.telemetry.faults(), "chaos plan did not fire"
    _assert_identical(rt_l, rt_s)


def test_one_shard_trace_has_no_reconcile_spans():
    """Single-shard reconciliation is vacuous and must stay silent — the
    1-shard trace is the legacy trace."""
    _, rt_s = _run_pair("bursty", ticks=20)
    assert rt_s.obs.trace.spans(name=RECONCILE) == []


# -- multi-shard routing -------------------------------------------------------

def _sharded_runtime(ticks=24, scenario="bursty", seed=0, staleness=4):
    pool = paper_cluster()          # 4 racks
    ctrl = ShardedController(pool, staleness_ticks=staleness)
    registry = TenantRegistry(ctrl)
    for spec in default_tenant_mix():
        registry.register(spec)
    wl = make_scenario(scenario, contracts(default_tenant_mix()), seed=seed)
    rt = ServiceRuntime(ctrl, registry, wl, FAST, device="cpu")
    registry.admit_all()
    rt.run(ticks)
    ctrl.check_ledger()
    return rt


def test_multi_shard_assigns_owners_and_reconciles():
    rt = _sharded_runtime()
    ctrl = rt.ctrl
    assert len(ctrl.shards) == 4
    for t in rt.alive_tenants():
        shard = ctrl.shard_of(t)
        assert shard in ctrl.shards
    # Every shard digest was refreshed within the staleness bound.
    for sh in ctrl.shards.values():
        assert rt.obs.trace.now_tick - sh.digest_tick <= ctrl.staleness_ticks
    spans = rt.obs.trace.spans(name=RECONCILE)
    assert spans, "multi-shard run must audit reconcile spans"
    for sp in spans:
        assert sp.detail["staleness_bound"] == ctrl.staleness_ticks
        assert all(age <= ctrl.staleness_ticks + 1
                   for age in sp.detail["ages"].values())


def test_multi_shard_tick_equals_legacy_tenant_outcomes():
    """Sharding changes placement scope, not workload accounting: the same
    scenario admits the same tenants and keeps them alive."""
    pool_legacy = paper_cluster()
    ctrl_l = MeiliController(pool_legacy)
    reg_l = TenantRegistry(ctrl_l)
    for spec in default_tenant_mix():
        reg_l.register(spec)
    reg_l.admit_all()
    rt = _sharded_runtime()
    assert sorted(rt.registry.admitted) == sorted(reg_l.admitted)
    assert sorted(rt.alive_tenants()) == sorted(rt.registry.admitted)


def test_cross_rack_spill_is_audited():
    """A tenant whose demand exceeds any one rack's headroom spills
    pool-wide, and the spill is a traced decision ``why()`` can explain."""
    # One rack of the small pool cannot hold the whole default mix: keep
    # admitting until some placement must cross racks.
    pool = paper_cluster(n_bf2=4, n_bf1=2, n_pensando=2, racks=2)
    ctrl = ShardedController(pool)
    registry = TenantRegistry(ctrl)
    mix = []
    for i in range(6):
        for spec in default_tenant_mix():
            mix.append(dataclasses.replace(
                spec, name=f"{spec.name}-{i}", backup_nic=None))
    for spec in mix:
        registry.register(spec)
    registry.admit_all()
    events = ctrl.obs.trace.query(name="cross_rack_placement")
    assert events, "over-packed 2-rack pool must spill cross-rack"
    ev = events[0]
    assert ev.detail["shard"] in ctrl.shards
    assert ev.detail["reason"].startswith("shard headroom exhausted")
    # why(tenant, tick) surfaces the spill decision end to end.
    assert any(e.name == "cross_rack_placement"
               for e in ctrl.obs.trace.why(ev.tenant, ev.tick))


def test_drain_candidates_prefer_owning_shard():
    pool = paper_cluster()
    ctrl = ShardedController(pool)
    nic = pool.names()[0]
    rack = pool.nics[nic].spec.rack
    cands = ctrl.drain_nic_candidates(nic)
    assert len(cands) >= 2
    # First candidate set: the sick NIC's shard minus itself.
    assert cands[0]
    assert all(pool.nics[n].spec.rack == rack for n in cands[0])
    assert nic not in cands[0]
    # Fallback: the pool-wide healthy set.
    assert set(cands[0]) < set(cands[-1])


def test_control_shard_digest_and_score():
    pool = paper_cluster(n_bf2=2, n_bf1=1, n_pensando=1, racks=1)
    sh = ControlShard("rack0", pool.rack_members("rack0"))
    sh.refresh(pool, tick=3)
    assert sh.digest_tick == 3
    assert sh.digest.get("cpu", 0) > 0
    assert sh.digest_fit({"cpu": 1})
    assert not sh.digest_fit({"cpu": 10 ** 6})
    # score = binding kind's slack ratio
    cpu_free = sh.digest["cpu"]
    assert sh.score({"cpu": 2}) == pytest.approx(cpu_free / 2)


# -- seeded sharded runs in both packages --------------------------------------

def _shards(ctrl):
    return ({n: (sh.nics, sorted(sh.tenants), sh.digest, sh.digest_bw_gbps,
                 sh.digest_tick) for n, sh in ctrl.shards.items()},
            dict(ctrl._owner), dict(ctrl.last_shard))


SHARDED = {
    "bursty_2": dict(scenario="bursty", pool_kw=dict(racks=2)),
    "diurnal_4": dict(scenario="diurnal"),
    "churn_4_stale1": dict(scenario="churn", staleness=1,
                           mix=lambda pkg: pkg.tenants.churn_tenant_mix(
                               ticks=32),
                           cfg=dict(defrag_every=8, defrag_max_moves=2)),
    "adversarial_2_stale8": dict(
        scenario="adversarial_churn", staleness=8, pool_kw=dict(racks=2),
        mix=lambda pkg: pkg.tenants.churn_tenant_mix(ticks=32)),
    "chaos_2": dict(scenario="chaos", mix=sp.chaos_mix,
                    pool_kw=dict(sp.CHAOS_POOL, racks=2),
                    cfg=dict(gray_detect=True, slo_enabled=True),
                    recovery=dict(park=True, brownout=True, seed=0),
                    events=[dict(e) for e in sp.CHAOS_EVENTS[:3]] + [
                        dict(tick=27, kind="rack", rack="rack1"),
                        dict(tick=34, kind="revive")]),
}


@pytest.mark.parametrize("case", list(SHARDED))
def test_sharded_run_equals_reference(case, tmp_path):
    got, want, rt = sp.run_pair(tmp_path, 32, sharded=True, **SHARDED[case])
    sp.assert_same(got, want)
    assert len(rt.ctrl.shards) > 1
    assert rt.obs.trace.spans(name=RECONCILE)
    ref = sp.build(sp.REF, sharded=True, **{
        k: v for k, v in SHARDED[case].items() if k != "events"})
    ref.run(32, chaos=sp.engine(sp.REF, SHARDED[case].get("events")))
    assert _shards(rt.ctrl) == _shards(ref.ctrl)


def test_cross_rack_spill_equals_reference(tmp_path):
    """The over-packed 2-rack pool of ``test_cross_rack_spill_is_audited``
    in both packages: the same tenants spill, with the same audit."""
    out = {}
    for pkg in sp.PKGS:
        ctrl = pkg.shard.ShardedController(
            pkg.pool.paper_cluster(n_bf2=4, n_bf1=2, n_pensando=2, racks=2),
            clock=sp.fixed_clock(), obs=pkg.obs.Obs(clock=sp.fixed_clock()))
        registry = pkg.tenants.TenantRegistry(ctrl)
        for i in range(6):
            for spec in pkg.tenants.default_tenant_mix():
                registry.register(dataclasses.replace(
                    spec, name=f"{spec.name}-{i}", backup_nic=None))
        registry.admit_all()
        ctrl.obs.trace.dump_jsonl(tmp_path / f"{pkg.name}.jsonl")
        out[pkg.name] = (sorted(registry.admitted), dict(registry.rejected),
                         _shards(ctrl),
                         (tmp_path / f"{pkg.name}.jsonl").read_bytes())
    assert out["port"] == out["ref"]
    assert b"cross_rack_placement" in out["port"][3]
