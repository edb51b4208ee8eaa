"""The port's service runtime (``repro_torch.service``: workload, tenants,
telemetry, runtime) held against the JAX package's ``repro.service``.

* Every case of ``test_service_runtime.py`` runs on the port with its own
  asserts (``device="cpu"``: the runtime defaults to the card).
* Each of the eight scenarios runs in both packages on the CPU, seeded,
  with fixed clocks, and everything the runs leave behind is compared with
  ``==`` (``_torch_service_pair.record``): every ``TenantTick`` and
  ``ClusterTick``, fault records, ``dataplane_stats()``, the controller's
  events, the pool's rows, and the ``obs`` trace and metrics as bytes.
  One run pushes every tenant's batches (64 packets a tick) through its
  data plane in both packages, and the planes' outputs are compared too.
  ``ScenarioWorkload.batch_for`` draws the same packets in both packages
  (numpy ``default_rng((seed, tenant, tick))``).
* Device: a runtime built without ``device`` asks for the card, and raises
  on a machine without one. The DWRR tick on tensors
  (``vectorized_sched=True``) is held to the scalar one: tenant events,
  admissions and fault records with ``==``, floats within ``F32_TOL``
  (below); and to itself with ``==``.

``F32_TOL``. With uncapped ingress (the default) the tensor tick serves
each tenant ``min(queue, cap)`` over queues and caps rounded to f32; the
scalar walk keeps Python floats. So one tick's served bytes differ by at
most 2**-24 of what was served, and the backlog left behind by that many
packets. The residue is carried into the next tick's queue and the
autoscaler's load, and the ticks of a run add up: over T ticks each tenant
field is held to R = T * 2**-24 of its scale, where the scale is the run's
largest achieved rate for the rates (offered, achieved, granted), its
largest served packets a tick for the backlog, and the tick ``dt_s`` for
the latencies (the residue drains at the placed rate, which serves at
least what was served: at most R of a tick). The cluster's achieved rate
sums the tenants' and gets their sum of tolerances. Ticks, tenants, units,
SLO flags, events, hop pairs, admissions and fault records are held with
``==``. Under a shared ingress budget (``ingress_gbps``) the DWRR rounds
themselves run in f32 and the dispatch order can part from the scalar
walk's at a near tie; ``test_torch_sched_kernel.py`` holds that mode to the
scheduler's contract, and here it is held only to itself.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_service_pair as sp
from repro_torch.apps.profiles import paper_profile
from repro_torch.core.controller import MeiliController
from repro_torch.core.pool import paper_cluster
from repro_torch.service.runtime import RuntimeConfig, ServiceRuntime
from repro_torch.service.tenants import (AdmissionError, TenantRegistry,
                                         TenantSLA, TenantSpec,
                                         churn_tenant_mix, contracts,
                                         default_tenant_mix)
from repro_torch.service.workload import (ScenarioWorkload, TrafficSpec,
                                          make_scenario)

# -- test_service_runtime.py's cases on the port ------------------------------

FAST = RuntimeConfig(dataplane_every=0, max_sim_seqs=32)


def make_runtime(scenario="bursty", mix=None, cfg=FAST, seed=0):
    mix = mix or default_tenant_mix()
    ctrl = MeiliController(paper_cluster())
    registry = TenantRegistry(ctrl)
    for spec in mix:
        registry.register(spec)
    wl = make_scenario(scenario, contracts(mix), seed=seed)
    rt = ServiceRuntime(ctrl, registry, wl, cfg, device="cpu")
    registry.admit_all()
    return rt


# -- workload -----------------------------------------------------------------

def test_workload_deterministic():
    mix = default_tenant_mix()
    wl1 = make_scenario("bursty", contracts(mix), seed=3)
    wl2 = make_scenario("bursty", contracts(mix), seed=3)
    for t in wl1.tenants():
        for tick in range(20):
            assert wl1.offered_gbps(t, tick) == wl2.offered_gbps(t, tick)
    b1 = wl1.batch_for("t-fw", 5, device="cpu")
    b2 = wl2.batch_for("t-fw", 5, device="cpu")
    np.testing.assert_array_equal(np.asarray(b1.payload),
                                  np.asarray(b2.payload))
    np.testing.assert_array_equal(np.asarray(b1.five_tuple),
                                  np.asarray(b2.five_tuple))


def test_workload_patterns():
    specs = {
        "c": TrafficSpec(pattern="constant", peak_gbps=10.0, jitter_frac=0.0),
        "b": TrafficSpec(pattern="bursty", peak_gbps=10.0, duty=0.5,
                         period_ticks=8, trough_frac=0.2, jitter_frac=0.0),
        "d": TrafficSpec(pattern="diurnal", peak_gbps=10.0, period_ticks=16,
                         trough_frac=0.25, jitter_frac=0.0),
    }
    wl = ScenarioWorkload(specs)
    assert all(wl.offered_gbps("c", t) == 10.0 for t in range(16))
    burst = [wl.offered_gbps("b", t) for t in range(8)]
    assert burst[:4] == [10.0] * 4 and burst[4:] == [2.0] * 4
    diurnal = [wl.offered_gbps("d", t) for t in range(16)]
    assert min(diurnal) == pytest.approx(2.5)
    assert max(diurnal) == pytest.approx(10.0)


def test_workload_heavy_tailed_flows_and_disjoint_flow_space():
    mix = default_tenant_mix()
    wl = make_scenario("steady", contracts(mix), seed=1)
    b_fw = wl.batch_for("t-fw", 0, max_pkts=512, device="cpu")
    b_fm = wl.batch_for("t-fm", 0, max_pkts=512, device="cpu")
    # heavy tail: the busiest flow carries far more than a uniform share
    _, counts = np.unique(np.asarray(b_fw.five_tuple)[:, 0],
                          return_counts=True)
    assert counts.max() > 3 * counts.mean()
    # per-tenant flow-id spaces never collide
    fw_src = set(np.asarray(b_fw.five_tuple)[:, 0].tolist())
    fm_src = set(np.asarray(b_fm.five_tuple)[:, 0].tolist())
    assert not (fw_src & fm_src)


# -- admission ----------------------------------------------------------------

def test_admission_rejects_unplaceable_and_rolls_back():
    ctrl = MeiliController(paper_cluster())
    registry = TenantRegistry(ctrl)
    mix = default_tenant_mix()
    big = dataclasses.replace(
        mix[2], name="t-huge",
        sla=TenantSLA(target_gbps=500.0, p99_latency_s=1e-3))
    registry.register(big)
    free_before = ctrl.pool.free_total("cpu")
    with pytest.raises(AdmissionError):
        registry.admit("t-huge")
    assert ctrl.pool.free_total("cpu") == free_before
    assert "t-huge" not in ctrl.deployments
    assert "t-huge" in registry.rejected
    assert ctrl.pool.usage_snapshot() == {}


def test_admission_priority_order():
    ctrl = MeiliController(paper_cluster())
    registry = TenantRegistry(ctrl)
    for spec in default_tenant_mix():
        registry.register(spec)
    order = registry.admit_all()
    prios = [registry.specs[n].sla.priority for n in order]
    assert prios == sorted(prios, reverse=True)


# -- closed loop --------------------------------------------------------------

def test_autoscaler_tracks_diurnal_load():
    rt = make_runtime("diurnal")
    peak_provision = rt.ctrl.pool.reserved_units()   # admitted at contract
    rt.run(60)
    s = rt.telemetry.series("t-fw")
    units = {t.tick: t.units for t in s}
    offered = {t.tick: t.offered_gbps for t in s}
    peak_tick = max(offered, key=offered.get)
    trough_tick = min((t for t in offered if t > 10), key=offered.get)
    assert units[peak_tick] > units[trough_tick]
    assert any(e["event"] == "scale" for e in rt.ctrl.events)
    # the elastic footprint stays below the fixed contract provision; the
    # *cluster* series barely breathes — staggered tenant phases multiplex,
    # which is exactly the consolidation win the comparator measures.
    reserved = [c.reserved_units for c in rt.telemetry.cluster_ticks]
    assert max(reserved) <= peak_provision
    assert np.mean(reserved) < 0.9 * peak_provision


def test_slo_holds_under_bursty_and_diurnal():
    for scenario in ("bursty", "diurnal"):
        rt = make_runtime(scenario)
        rt.run(48)
        report = rt.slo_report()
        assert report, scenario
        for tenant, r in report.items():
            assert r["pass"], (scenario, tenant, r)


def test_fixed_mode_never_scales():
    cfg = dataclasses.replace(FAST, autoscale=False)
    rt = make_runtime("diurnal", cfg=cfg)
    rt.run(30)
    assert not any(e["event"] == "scale" for e in rt.ctrl.events)
    reserved = {c.reserved_units for c in rt.telemetry.cluster_ticks}
    assert len(reserved) == 1


# -- failover -----------------------------------------------------------------

def test_failover_keeps_all_tenants_alive():
    rt = make_runtime("bursty")
    rt.run(30, fail_at=(12, None))
    assert any(e["event"] == "failover" for e in rt.ctrl.events)
    assert len(rt.alive_tenants()) == len(rt.registry.active()) == 6
    for tenant, r in rt.slo_report().items():
        assert r["pass"], (tenant, r)
    # post-failover ticks for impacted tenants got the grace flag
    impacted = {e["tenant"] for e in rt.ctrl.events
                if e["event"] == "failover"}
    graced = {t.tenant for t in rt.telemetry.tenant_ticks if t.in_grace}
    assert impacted and impacted <= graced


# -- churn --------------------------------------------------------------------

def test_tenant_churn_admits_and_refunds():
    mix = default_tenant_mix()
    mix[1] = dataclasses.replace(mix[1], arrive_tick=5)
    mix[3] = dataclasses.replace(mix[3], depart_tick=10)
    rt = make_runtime("steady", mix=mix)
    departing, arriving = mix[3].name, mix[1].name
    assert arriving not in rt.registry.active()
    rt.run(16)
    assert arriving in rt.registry.active()
    assert departing not in rt.registry.active()
    assert rt.ctrl.pool.usage_snapshot().get(departing) is None
    arr = rt.telemetry.series(arriving)
    assert arr and min(t.tick for t in arr) >= 5
    dep = rt.telemetry.series(departing)
    assert dep and max(t.tick for t in dep) < 10


# -- defragmentation ----------------------------------------------------------

def test_runtime_defrag_recovers_locality_under_churn():
    """The background re-placement loop: same churning mix + seeded traffic
    with defrag off vs on. On must migrate, recover locality (fewer NICs,
    no more hop pairs than off), grace the migrated tenants, and leave the
    pool ledger exact."""
    TICKS = 48
    runs = {}
    for defrag_on in (False, True):
        mix = churn_tenant_mix(ticks=TICKS)
        cfg = dataclasses.replace(FAST, defrag_every=8 if defrag_on else 0,
                                  defrag_max_moves=2)
        ctrl = MeiliController(paper_cluster())
        registry = TenantRegistry(ctrl)
        for spec in mix:
            registry.register(spec)
        wl = make_scenario("churn", contracts(mix), seed=0)
        rt = ServiceRuntime(ctrl, registry, wl, cfg, device="cpu")
        registry.admit_all()
        rt.run(TICKS)
        ctrl.check_ledger()
        runs[defrag_on] = (rt, ctrl)

    rt_off, _ = runs[False]
    rt_on, ctrl_on = runs[True]
    migrated = {e["tenant"] for e in ctrl_on.events if e["event"] == "migrate"}
    assert migrated, "defrag loop never migrated under churn"
    tail = int(0.7 * TICKS)
    loc_off = rt_off.telemetry.locality(from_tick=tail)
    loc_on = rt_on.telemetry.locality(from_tick=tail)
    assert loc_on["nics_used_mean"] < loc_off["nics_used_mean"]
    assert loc_on["hop_pairs_mean"] <= loc_off["hop_pairs_mean"]
    # migrated tenants got the SLO grace window and the migrate event tag
    graced = {t.tenant for t in rt_on.telemetry.tenant_ticks if t.in_grace}
    tagged = {t.tenant for t in rt_on.telemetry.tenant_ticks
              if t.event == "migrate"}
    assert migrated <= graced
    assert migrated & tagged
    # no tenant that passes SLO without defrag regresses with it
    off_pass = {t: r["pass"] for t, r in rt_off.slo_report().items()}
    on_pass = {t: r["pass"] for t, r in rt_on.slo_report().items()}
    assert not [t for t, ok in off_pass.items()
                if ok and not on_pass.get(t, False)]


# -- attribution --------------------------------------------------------------

def test_pool_usage_attribution_tracks_allocation():
    rt = make_runtime("steady")
    for name in rt.registry.active():
        dep = rt.registry.deployment(name)
        assert rt.ctrl.pool.usage_snapshot()[name] == dep.usage()
    total = sum(sum(u.values()) for u in rt.ctrl.pool.usage_snapshot().values())
    assert total == rt.ctrl.pool.reserved_units()
    rt.registry.evict("t-fw")
    assert "t-fw" not in rt.ctrl.pool.usage_snapshot()


def test_dataplane_by_tenant_tagging_survives_rescale():
    cfg = dataclasses.replace(FAST, dataplane_every=1, max_pkts_per_tick=64,
                              pkt_bytes=64)
    mix = [s for s in default_tenant_mix() if s.name in ("t-fw", "t-fm")]
    rt = make_runtime("steady", mix=mix, cfg=cfg)
    rt.run(3)
    stats = rt.dataplane_stats()
    for name in ("t-fw", "t-fm"):
        assert stats[name]["calls"] == 3
        assert stats[name]["packets"] > 0
    # a scale event rebuilds the plane; accumulated attribution must survive
    rt.ctrl.adaptive_scale("t-fw", 5.0)
    assert "t-fw" not in rt._planes
    rt.run(2)
    stats = rt.dataplane_stats()
    assert stats["t-fw"]["calls"] == 5
    assert stats["t-fm"]["calls"] == 5


# -- the eight scenarios in both packages --------------------------------------

SCENARIOS = {
    "steady": {}, "bursty": {}, "diurnal": {},
    "churn": dict(mix=lambda pkg: pkg.tenants.churn_tenant_mix(ticks=32),
                  cfg=dict(defrag_every=8, defrag_max_moves=2)),
    "flash_crowd": dict(scenario_kw=dict(surge=8.0, crowd="t-fw"),
                        pool_kw=dict(n_bf2=3, n_bf1=1, n_pensando=2),
                        mix=lambda pkg: [
                            dataclasses.replace(s, backup_nic=None)
                            for s in pkg.tenants.default_tenant_mix()]),
    "adversarial_churn": dict(
        mix=lambda pkg: pkg.tenants.churn_tenant_mix(ticks=32)),
    "chaos": dict(cfg=dict(ingress_gbps=40.0)),
    "megaflow": {},
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scenario_run_equals_reference(scenario, tmp_path):
    got, want, _ = sp.run_pair(tmp_path, 32, scenario=scenario, seed=1,
                               **SCENARIOS[scenario])
    sp.assert_same(got, want)


def _record_planes(monkeypatch, pkg, to_numpy):
    """Wrap ``ParallelDataPlane.process`` so every output is kept."""
    seen = []
    orig = pkg.runtime.ParallelDataPlane.process

    def process(self, batch, tenant=None):
        out = orig(self, batch, tenant=tenant)
        seen.append((tenant, to_numpy(out)))
        return out

    monkeypatch.setattr(pkg.runtime.ParallelDataPlane, "process", process)
    return seen


def test_dataplane_run_equals_reference(monkeypatch, tmp_path):
    """Every tenant's plane on every tick (64 packets of 192 B a tick):
    the runs, and each plane output, equal the reference's."""
    import jax

    from repro_torch import convert
    outs = {
        "port": _record_planes(monkeypatch, sp.PORT, convert.leaves_to_numpy),
        "ref": _record_planes(monkeypatch, sp.REF, lambda o: [
            np.asarray(x) for x in jax.tree.leaves(o)])}
    cfg = dict(dataplane_every=1, max_pkts_per_tick=64)
    got, want, rt = sp.run_pair(tmp_path, 6, scenario="bursty", cfg=cfg)
    sp.assert_same(got, want)
    assert len(outs["port"]) == len(outs["ref"]) == 6 * 6
    for (t1, a), (t2, b) in zip(outs["port"], outs["ref"]):
        assert t1 == t2 and len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert all(v["calls"] == 6 for v in got["dataplane"].values())


# -- the device --------------------------------------------------------------------

def test_runtime_without_device_asks_for_the_card():
    """The runtime resolves its device in ``__init__``, even when it will
    never push a batch (``dataplane_every=0``): the card, and on a machine
    without one it raises; ``batch_for`` defaults to the card too."""
    ctrl = MeiliController(paper_cluster())
    registry = TenantRegistry(ctrl)
    wl = make_scenario("steady", contracts(default_tenant_mix()))
    if torch.cuda.is_available():
        assert ServiceRuntime(ctrl, registry, wl, FAST).device.type == "cuda"
        assert wl.batch_for("t-fw", 0).payload.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServiceRuntime(ctrl, registry, wl, FAST)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wl.batch_for("t-fw", 0)
    rt = ServiceRuntime(ctrl, registry, wl, FAST, device="cpu")
    assert rt.device == torch.device("cpu")


def test_tenant_mixes_default_to_device_dispatch(monkeypatch):
    """``impl=None``: every tenant's stages take the kernels for packets on
    the card and the plain versions for packets on the CPU (a default of
    ``"torch"`` would keep the planes off the kernels on the card)."""
    import inspect

    from repro_torch.apps import synth_packets
    from repro_torch.core.graph import run_pipeline
    from repro_torch.kernels import ops
    for fn in (default_tenant_mix, churn_tenant_mix):
        assert inspect.signature(fn).parameters["impl"].default is None
    seen = []
    check = ops._check_impl
    monkeypatch.setattr(ops, "_check_impl",
                        lambda impl: (seen.append(impl), check(impl)))
    batch = synth_packets(batch=32, num_flows=8, pkt_bytes=192, device="cpu")
    for mix in (default_tenant_mix(), churn_tenant_mix(ticks=16)):
        for spec in mix:
            run_pipeline(spec.app, batch)
    assert len(seen) == 2 * 4 + 1 and set(seen) == {None}


F32_FIELDS_GBPS = ("offered_gbps", "achieved_gbps", "granted_gbps")
F32_FIELDS_S = ("p50_s", "p99_s", "p99_measured_s")
EXACT_FIELDS = ("tick", "tenant", "units", "slo_ok", "in_grace", "event",
                "hop_pairs", "nics_used")


def _assert_within_f32(vec, ref, cfg, ticks):
    """``vec`` (a vectorized run) against ``ref`` (the scalar run) as the
    module docstring states ``F32_TOL``."""
    from repro_torch.apps.profiles import PKT_BITS
    r = 2.0 ** -24 * ticks
    ach = max(t.achieved_gbps for t in ref.telemetry.tenant_ticks)
    served_pkts = ach * 1e9 / PKT_BITS * cfg.dt_s
    tol = {**{k: ach for k in F32_FIELDS_GBPS},
           **{k: cfg.dt_s for k in F32_FIELDS_S}, "backlog_pkts": served_pkts}
    a, b = vec.telemetry.tenant_ticks, ref.telemetry.tenant_ticks
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = dataclasses.asdict(x), dataclasses.asdict(y)
        assert {k: x[k] for k in EXACT_FIELDS} == {
            k: y[k] for k in EXACT_FIELDS}
        for k, scale in tol.items():
            assert abs(x[k] - y[k]) <= r * scale, (k, x, y)
    for x, y in zip(vec.telemetry.cluster_ticks, ref.telemetry.cluster_ticks):
        assert (x.tick, x.reserved_units, x.nic_util, x.nics_used,
                x.hop_pairs) == (y.tick, y.reserved_units, y.nic_util,
                                 y.nics_used, y.hop_pairs)
        assert abs(x.achieved_gbps - y.achieved_gbps) <= r * len(
            vec.registry.specs) * ach
    assert vec.telemetry.fault_events == ref.telemetry.fault_events
    assert sorted(vec.registry.admitted) == sorted(ref.registry.admitted)
    assert vec.registry.rejected == ref.registry.rejected
    assert [e["event"] for e in vec.ctrl.events] == [
        e["event"] for e in ref.ctrl.events]


VEC_RUNS = {
    "steady": {}, "bursty": {}, "diurnal": {}, "megaflow": {},
    "churn": dict(mix=lambda pkg: pkg.tenants.churn_tenant_mix(ticks=40)),
    "flash_crowd": dict(scenario_kw=dict(surge=8.0, crowd="t-fw")),
    "chaos": dict(mix=sp.chaos_mix, pool_kw=dict(sp.CHAOS_POOL, racks=2),
                  cfg=dict(gray_detect=True, slo_enabled=True),
                  recovery=dict(park=True, brownout=True, seed=0),
                  events=[dict(tick=4, kind="flap", nic="bf2-0",
                               duration_ticks=3),
                          dict(tick=12, kind="gray", nic="bf2-1",
                               fraction=0.25),
                          dict(tick=19, kind="mid_migration"),
                          dict(tick=24, kind="rack", rack="rack1"),
                          dict(tick=31, kind="revive")]),
}


def _vec_run(scenario, vectorized, ticks=40):
    kw = dict(VEC_RUNS[scenario])
    events = kw.pop("events", None)
    kw["cfg"] = dict(kw.get("cfg", {}), vectorized_sched=vectorized)
    rt = sp.build(sp.PORT, scenario=scenario, **kw)
    rt.run(ticks, chaos=sp.engine(sp.PORT, events))
    rt.ctrl.check_ledger()
    return rt


@pytest.mark.parametrize("scenario", list(VEC_RUNS))
def test_vectorized_runtime_within_f32_of_scalar(scenario, tmp_path):
    """Uncapped ingress (the runtime's default): the DWRR tick on tensors
    serves each tenant ``min(queue, cap)`` in f32. Decisions, events,
    admissions and fault records equal the scalar run's; floats sit within
    ``F32_TOL``; and a second vectorized run equals the first with ``==``,
    trace and metrics bytes included."""
    ticks = 40
    vec = _vec_run(scenario, True, ticks)
    ref = _vec_run(scenario, False, ticks)
    _assert_within_f32(vec, ref, vec.cfg, ticks)
    again = _vec_run(scenario, True, ticks)
    sp.assert_same(sp.record(vec, tmp_path / "a"),
                   sp.record(again, tmp_path / "b"))
    assert vec.ctrl.governor._kernel is not None
    assert vec.ctrl.governor._kernel.device == torch.device("cpu")


def test_vectorized_runtime_under_ingress_budget_repeats(tmp_path):
    """A shared ingress budget runs the DWRR rounds on tensors
    (``dwrr_step``): two runs on the CPU equal each other with ``==``."""
    recs = []
    for i in range(2):
        rt = sp.build(sp.PORT, scenario="flash_crowd",
                      scenario_kw=dict(surge=8.0, crowd="t-fw"),
                      cfg=dict(vectorized_sched=True, ingress_gbps=20.0))
        rt.run(40)
        recs.append(sp.record(rt, tmp_path / str(i)))
    sp.assert_same(*recs)
    assert any(t["backlog_pkts"] > 0 for t in recs[0]["tenant_ticks"])
