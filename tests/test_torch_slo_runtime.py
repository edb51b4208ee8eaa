"""The port's SLO engine, burn-rate alerts and flight recorder driven by
its service runtime, held against the JAX package's.

* Every case of ``test_slo.py`` and ``test_obs_runtime.py`` runs on the
  port with its own asserts. ``test_obs_runtime.py``'s first case reads the
  artifact of the chaos benchmark's fast arm
  (``benchmarks.bench_service._run_chaos_arm``), whose port waits for the
  benchmarks; ``_run_chaos_arm`` below is that arm on the port, the same
  mix, pool, fault plan and recovery policy.
* Seeded runs with the SLO layer on (chaos plans, gray detection, page
  pre-arming on and in shadow mode, flight bundles dumped) run in both
  packages on the CPU with fixed clocks, and everything they leave behind
  is compared with ``==`` (``_torch_service_pair.record``): the alert
  transitions, every tenant tick, the fault records, the ``obs`` trace and
  metrics as bytes, each tenant's budget, and every flight bundle the run
  dumped, byte for byte.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import pytest

import _torch_service_pair as sp
from repro_torch.core.controller import MeiliController
from repro_torch.core.faults import (FLAP, GRAY, MID_MIGRATION, RACK, REVIVE,
                                     ChaosEngine, FaultEvent, FaultPlan,
                                     RecoveryConfig)
from repro_torch.core.pool import paper_cluster
from repro_torch.core.shard import ShardedController
from repro_torch.obs import (Obs, SLOEngine, BurnAlertManager, BurnRule, PAGE,
                             WARN, load_trace)
from repro_torch.obs.alerts import FIRING, RESOLVED
from repro_torch.obs.flight import load_bundle
from repro_torch.service.runtime import RuntimeConfig, ServiceRuntime
from repro_torch.service.telemetry import TelemetryLog, TenantTick
from repro_torch.service.tenants import (TenantRegistry, TenantSLA, contracts,
                                         default_tenant_mix)
from repro_torch.service.workload import make_scenario

# -- test_slo.py's cases on the port ------------------------------------------

FAST = RuntimeConfig(dataplane_every=0, max_sim_seqs=32)


def _tick(tick, tenant="t", offered=10.0, achieved=10.0, p99=1e-4,
          in_grace=False, p99_measured=0.0):
    return TenantTick(tick=tick, tenant=tenant, offered_gbps=offered,
                      achieved_gbps=achieved, p50_s=p99 / 2, p99_s=p99,
                      units=4, slo_ok=True, in_grace=in_grace,
                      p99_measured_s=p99_measured)


SLA = TenantSLA(target_gbps=10.0, p99_latency_s=1e-3)


# -- budget math ---------------------------------------------------------------

def test_budget_math_and_burn_rate():
    eng = SLOEngine(Obs(), horizon_ticks=20)
    # 20-tick horizon at the default 5% budget -> exactly 1 bad tick allowed
    for t in range(10):
        bad = eng.observe(_tick(t, achieved=10.0 if t < 8 else 1.0), SLA)
        assert bad == (t >= 8)
    b = eng.budgets["t"]
    assert b.burned() == 2
    assert b.allowance() == pytest.approx(1.0)
    assert b.remaining_frac() == 0.0          # clamped: burned > allowance
    # burn over the trailing 4 ticks: 2/4 bad at budget_frac 0.05 -> 10x
    assert eng.burn_rate("t", 4) == pytest.approx(10.0)
    assert eng.burn_rate("t", 10) == pytest.approx(2 / 10 / 0.05)
    assert eng.burn_rate("missing", 4) == 0.0
    assert b.burned_ticks() == [8, 9]


def test_budget_warmup_burns_nothing_but_grace_burns():
    eng = SLOEngine(Obs(), horizon_ticks=16, warmup_ticks=2)
    assert not eng.observe(_tick(0, achieved=0.0), SLA)      # warmup
    assert not eng.observe(_tick(1, achieved=0.0), SLA)      # warmup
    # Grace is the pool forgiving itself in slo_report accounting; the
    # tenant still experienced the degradation, so the budget burns.
    assert eng.observe(_tick(2, achieved=0.0, in_grace=True), SLA)
    assert eng.budgets["t"].samples[-1].in_grace
    assert eng.budgets["t"].burned() == 1


def test_budget_p99_sli_prefers_measured_with_legacy_fallback():
    eng = SLOEngine(Obs(), horizon_ticks=16)
    # measured present and over target -> bad, even though legacy is fine
    assert eng.observe(_tick(0, p99=1e-4, p99_measured=5e-3), SLA)
    assert eng.budgets["t"].samples[-1].reason == "p99"
    # measured absent (0.0) -> fall back to the legacy estimator
    assert not eng.observe(_tick(1, p99=1e-4, p99_measured=0.0), SLA)
    assert eng.observe(_tick(2, p99=5e-3, p99_measured=0.0), SLA)
    # throughput shortfall is scored against min(offered, target)
    assert eng.observe(_tick(3, offered=20.0, achieved=8.5), SLA)
    assert eng.budgets["t"].samples[-1].reason == "tput"
    # under-offered tenant is not punished for low absolute throughput
    assert not eng.observe(_tick(4, offered=1.0, achieved=0.95), SLA)


# -- alert lifecycle -----------------------------------------------------------

def _manager(obs=None, holddown=3):
    obs = obs or Obs()
    eng = SLOEngine(obs, horizon_ticks=32)
    rules = (BurnRule(PAGE, window_ticks=4, confirm_ticks=2,
                      burn_threshold=4.0),)
    return eng, BurnAlertManager(eng, obs, rules=rules,
                                 holddown_ticks=holddown)


def test_alert_fires_once_dedups_and_resolves_after_holddown():
    eng, mgr = _manager(holddown=3)
    tick = 0
    # burn hard: every tick bad -> burn 20x over both windows
    for _ in range(4):
        eng.observe(_tick(tick, achieved=0.0), SLA)
        mgr.step(tick)
        tick += 1
    firing = [t for t in mgr.transitions if t.state == FIRING]
    assert len(firing) == 1 and firing[0].severity == PAGE
    assert mgr.active() == [("t", PAGE)]
    # recover: the clear streak must reach the holddown before resolving,
    # and a mid-streak relapse resets it (no flapping)
    for i in range(2):
        eng.observe(_tick(tick, achieved=10.0), SLA)
        mgr.step(tick)
        tick += 1
    assert mgr.active() == [("t", PAGE)]       # holddown not reached
    eng.observe(_tick(tick, achieved=0.0), SLA)   # relapse...
    mgr.step(tick)
    tick += 1
    # ...but one bad tick in a 4-tick window is only 5x... still >= 4x hot:
    # dedup keeps the alert firing without a second transition
    assert len([t for t in mgr.transitions if t.state == FIRING]) == 1
    for _ in range(8):
        eng.observe(_tick(tick, achieved=10.0), SLA)
        mgr.step(tick)
        tick += 1
    resolved = [t for t in mgr.transitions if t.state == RESOLVED]
    assert len(resolved) == 1 and mgr.active() == []
    # metrics + trace carried every transition
    obs = mgr.obs
    assert obs.metrics.get("slo_alert_transitions_total",
                           severity=PAGE, state=FIRING).value == 1
    assert obs.metrics.get("slo_alert_transitions_total",
                           severity=PAGE, state=RESOLVED).value == 1
    assert len(obs.trace.query(name="slo_alert")) == 2


def test_on_page_callback_and_sequence_json():
    eng, mgr = _manager()
    seen = []
    mgr.on_page.append(lambda tenant, tr: seen.append((tenant, tr.tick)))
    for t in range(3):
        eng.observe(_tick(t, achieved=0.0), SLA)
        mgr.step(t)
    # trailing windows divide by min(window, samples): one fully-bad sample
    # already reads as a 20x burn on both windows, so the page is immediate
    assert seen == [("t", 0)]
    seq = json.loads(mgr.sequence())
    assert seq[0]["tenant"] == "t" and seq[0]["state"] == FIRING
    assert set(seq[0]) == {"tick", "tenant", "severity", "state",
                           "burn_long", "burn_short"}   # no wall-clock


# -- determinism ---------------------------------------------------------------

def _chaos_runtime(ctrl_cls, seed=0, ticks=48, **cfg_kw):
    """The chaos plan replayed with the SLO layer on (flight dumps off:
    recording must not perturb determinism comparisons)."""
    plan = FaultPlan([
        FaultEvent(tick=5, kind=FLAP, nic="bf2-1", duration_ticks=4),
        FaultEvent(tick=13, kind=GRAY, nic="bf2-2", fraction=0.25),
        FaultEvent(tick=21, kind=MID_MIGRATION),
        FaultEvent(tick=27, kind=RACK, rack="rack0"),
        FaultEvent(tick=34, kind=REVIVE, rack="rack0"),
        FaultEvent(tick=34, kind=REVIVE, nic="bf2-2"),
    ])
    cfg = dataclasses.replace(FAST, gray_detect=True, slo_enabled=True,
                              **cfg_kw)
    ctrl = ctrl_cls(paper_cluster(n_bf2=4, n_bf1=2, n_pensando=2, racks=1))
    registry = TenantRegistry(ctrl)
    mix = [dataclasses.replace(s, backup_nic=("bf1-0", "bf1-1")[i % 2])
           for i, s in enumerate(default_tenant_mix())]
    for spec in mix:
        registry.register(spec)
    wl = make_scenario("chaos", contracts(default_tenant_mix()), seed=seed)
    rt = ServiceRuntime(ctrl, registry, wl, cfg, device="cpu",
                        recovery=RecoveryConfig(park=True, brownout=True,
                                                seed=seed))
    registry.admit_all()
    rt.run(ticks, chaos=ChaosEngine(plan))
    return rt


def test_shadow_mode_records_pages_but_takes_no_action():
    """``alert_actions=False`` (the overhead benchmark's shadow arm):
    pages still fire and land in the trace, but the runtime takes no
    mitigation — no gray pre-arm, no forced scale consult."""
    live = _chaos_runtime(MeiliController)
    shadow = _chaos_runtime(MeiliController, alert_actions=False)
    for rt in (live, shadow):
        assert any(t.severity == PAGE and t.state == FIRING
                   for t in rt.alerts.transitions)
    assert live.obs.trace.query(name="gray_prearm")
    assert not shadow.obs.trace.query(name="gray_prearm")


def test_alert_sequence_deterministic_across_replays():
    a = _chaos_runtime(MeiliController)
    b = _chaos_runtime(MeiliController)
    assert a.alerts.transitions, "chaos replay produced no alerts"
    assert a.alerts.sequence() == b.alerts.sequence()   # byte-identical


def test_alert_sequence_identical_on_one_shard_sharded_controller():
    legacy = _chaos_runtime(MeiliController)
    sharded = _chaos_runtime(ShardedController)
    assert len(sharded.ctrl.shards) == 1
    assert legacy.alerts.transitions
    assert legacy.alerts.sequence() == sharded.alerts.sequence()
    # shard labels ride only in trace detail, never in the sequence
    ev = sharded.obs.trace.query(name="slo_alert")
    assert ev and all("shard" in e.detail for e in ev)
    ev_l = legacy.obs.trace.query(name="slo_alert")
    assert ev_l and all("shard" not in e.detail for e in ev_l)


# -- flight recorder -----------------------------------------------------------

def _steady_slo_runtime(flight_dir=None, **cfg_kw):
    cfg = dataclasses.replace(FAST, gray_detect=True, slo_enabled=True,
                              flight_dir=flight_dir, **cfg_kw)
    ctrl = MeiliController(paper_cluster())
    registry = TenantRegistry(ctrl)
    mix = default_tenant_mix()
    for spec in mix:
        registry.register(spec)
    wl = make_scenario("steady", contracts(mix), seed=0)
    rt = ServiceRuntime(ctrl, registry, wl, cfg, device="cpu",
                        recovery=RecoveryConfig(park=True, brownout=True,
                                                seed=0))
    registry.admit_all()
    return rt


def test_flight_ring_is_bounded_and_snapshots_live_state(tmp_path):
    rt = _steady_slo_runtime(flight_capacity=8)
    rt.run(20)
    ring = list(rt.flight.ring)
    assert len(ring) == 8                      # bounded: capacity, not ticks
    assert [s["tick"] for s in ring] == list(range(12, 20))
    snap = ring[-1]
    assert snap["queues_pkts"] and snap["grants_gbps"]
    assert snap["budgets_remaining"]
    assert set(snap["flight_state"]["nics"]) == set(rt.ctrl.pool.names())
    assert all(v["alive"] for v in snap["flight_state"]["nics"].values())
    # no dump directory configured -> recording on, dumping a silent no-op
    assert rt.flight.dump_safe(trigger="manual", tick=19) is None
    assert rt.flight.dumps == []


def test_flight_dump_bundle_roundtrip(tmp_path):
    rt = _steady_slo_runtime(flight_dir=str(tmp_path))
    rt.run(10)
    path = rt.flight.dump("manual", tick=9)
    bundle = load_bundle(path)
    head = bundle["header"][0]
    assert head["trigger"] == "manual" and head["tick"] == 9
    assert len(bundle["snapshot"]) == head["snapshots"] > 0
    assert len(bundle["trace"]) == head["trace_events"] > 0
    assert bundle["metric_delta"]              # first dump: deltas = absolutes
    # a second immediate dump carries only what changed since the first
    path2 = rt.flight.dump("manual", tick=9)
    assert load_bundle(path2)["metric_delta"] == []


def test_sentinel_failure_dumps_flight_bundle(tmp_path):
    rt = _steady_slo_runtime(flight_dir=str(tmp_path))
    rt.run(4)
    rt._backlog[sorted(rt._backlog)[0]] = -1.0      # trip flow conservation
    engine = ChaosEngine(FaultPlan(
        [FaultEvent(tick=rt.tick_now, kind=FLAP, nic="bf2-0",
                    duration_ticks=2)]))
    with pytest.raises(AssertionError, match="chaos sentinel"):
        rt.run(1, chaos=engine)
    assert len(rt.flight.dumps) == 1
    bundle = load_bundle(rt.flight.dumps[0])
    assert bundle["header"][0]["trigger"] == "sentinel_failure"


def test_failed_flight_dump_never_masks_the_sentinel_error(tmp_path):
    # point the dump directory at an existing FILE: mkdir will fail
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    rt = _steady_slo_runtime(flight_dir=str(blocker))
    rt.run(4)
    rt._backlog[sorted(rt._backlog)[0]] = -1.0
    engine = ChaosEngine(FaultPlan(
        [FaultEvent(tick=rt.tick_now, kind=FLAP, nic="bf2-0",
                    duration_ticks=2)]))
    # the ORIGINAL sentinel error propagates, not the dump's IO error
    with pytest.raises(AssertionError, match="chaos sentinel"):
        rt.run(1, chaos=engine)
    assert rt.flight.dumps == []
    failed = rt.obs.trace.query(name="flight_dump_failed")
    assert len(failed) == 1
    assert failed[0].detail["trigger"] == "sentinel_failure"
    assert "Error" in failed[0].detail["error"]


# -- the acceptance criterion: incident reconstruction -------------------------

def test_incident_reconstructed_from_artifacts_alone(tmp_path):
    """Gray failure burns budget in-grace -> page fires BEFORE the first
    SLO-violating tick outside grace -> pre-armed detector quarantines the
    NIC -> alert resolves -> ``why_slo`` and the auto-dumped flight bundle
    tell the same causally-ordered story."""
    # Loose p99 targets isolate the SLI to throughput: the cumulative
    # measured-p99 stream would otherwise keep burning long after the
    # incident and the alert could never resolve.
    rt = _steady_slo_runtime(slo_grace_ticks=6, flight_dir=str(tmp_path))
    mix = {s.name: s for s in default_tenant_mix()}
    for name, spec in rt.registry.specs.items():
        rt.registry.specs[name] = dataclasses.replace(
            spec, sla=dataclasses.replace(spec.sla, p99_latency_s=1.0))

    # Fault targets: one tenant whose placement spans >= 2 NICs — flap one
    # (grants the failover grace window), gray another at the same tick.
    victim, nics = next(
        (t, sorted(d.nics_used())) for t, d in rt.ctrl.deployments.items()
        if len(d.nics_used()) >= 2)
    flap_nic, gray_nic = nics[0], nics[1]
    t0 = 8
    plan = FaultPlan([   # due() sorts by kind: the flap (grace) fires first
        FaultEvent(tick=t0, kind=FLAP, nic=flap_nic, duration_ticks=6),
        FaultEvent(tick=t0, kind=GRAY, nic=gray_nic, fraction=0.25),
    ])
    rt.run(64, chaos=ChaosEngine(plan))

    tr = rt.obs.trace
    # -- the page fired BEFORE the first outside-grace SLO violation -------
    pages = [t for t in rt.alerts.transitions
             if t.tenant == victim and t.severity == PAGE]
    assert pages and pages[0].state == FIRING
    page_tick = pages[0].tick
    violations = [t.tick for t in rt.telemetry.series(victim)
                  if t.tick >= rt.cfg.warmup_ticks and not t.in_grace
                  and not t.slo_ok]
    assert violations, "the gray failure must violate the SLO post-grace"
    assert page_tick < violations[0]
    # and the burn that drove it happened in-grace (budget burns, SLO
    # accounting forgives — that is what makes it an early warning)
    burns = tr.query(name="slo_burn", tenant=victim)
    assert burns and burns[0].detail["in_grace"]

    # -- causal order: fault -> burn -> page -> pre-arm -> quarantine ------
    seq_fault = tr.query(name="gray", nic=gray_nic, kind="fault")[0].seq
    seq_burn = burns[0].seq
    seq_page = next(e.seq for e in tr.query(name="slo_alert", tenant=victim)
                    if e.detail["severity"] == PAGE
                    and e.detail["state"] == FIRING)
    prearm = tr.query(name="gray_prearm", tenant=victim)[0]
    quar = tr.query(name="quarantine_verdict", nic=gray_nic)
    assert quar, "the pre-armed detector must quarantine the gray NIC"
    assert (seq_fault < seq_burn < seq_page < prearm.seq < quar[0].seq)
    assert gray_nic in prearm.detail["nics"]

    # -- the alert resolves once the drain restores service ----------------
    resolved = [t for t in rt.alerts.transitions
                if t.tenant == victim and t.severity == PAGE
                and t.state == RESOLVED]
    assert resolved and resolved[0].tick > quar[0].tick

    # -- why_slo tells the same story ---------------------------------------
    story = rt.slo.why_slo(victim)
    assert story["tracked"] and story["burned_ticks"]
    assert story["burned_ticks"][0] >= t0
    assert story["remaining_frac"] < 1.0
    names = [e["name"] for e in story["events"]]
    assert names.index("slo_burn") < names.index("slo_alert")
    assert "gray_prearm" in names

    # -- the auto-dumped bundle agrees, from the file alone -----------------
    dump = pathlib.Path(tmp_path) / f"flight_{page_tick}.jsonl"
    assert str(dump) in rt.flight.dumps
    bundle = load_bundle(dump)
    assert bundle["header"][0]["trigger"] == "page_alert"
    snaps = bundle["snapshot"]
    assert snaps[-1]["tick"] == page_tick
    # the bundle's own snapshots show the victim's budget draining and the
    # page active at dump time
    assert snaps[-1]["budgets_remaining"][victim] < 1.0
    assert [victim, PAGE] in snaps[-1]["alerts_active"]
    # the trailing trace window carries the in-grace burn and the page
    tail = {(r["name"], r.get("tenant")) for r in bundle["trace"]}
    assert ("slo_burn", victim) in tail and ("slo_alert", victim) in tail


# -- test_obs_runtime.py's cases on the port -----------------------------------

# The chaos benchmark's fast arm (benchmarks/bench_service.py), on the port.
CHAOS_FAST_TICKS = 48
CHAOS_POOL = dict(n_bf2=4, n_bf1=2, n_pensando=2, racks=2)
CHAOS_RACK = "rack1"


def _chaos_plan(ticks, flap_nic, gray_nic):
    T = ticks
    return FaultPlan([
        FaultEvent(tick=max(2, int(0.11 * T)), kind=FLAP, nic=flap_nic,
                   duration_ticks=max(2, T // 16)),
        FaultEvent(tick=int(0.28 * T), kind=GRAY, nic=gray_nic,
                   fraction=0.25),
        FaultEvent(tick=int(0.44 * T), kind=MID_MIGRATION),
        FaultEvent(tick=int(0.55 * T), kind=RACK, rack=CHAOS_RACK),
        FaultEvent(tick=int(0.72 * T), kind=REVIVE),
    ])


def _run_chaos_arm(recovery_on, ticks, seed, obs_dir=None):
    cfg = RuntimeConfig(dataplane_every=0, max_sim_seqs=48,
                        gray_detect=recovery_on)
    mix = [dataclasses.replace(s, backup_nic=("bf1-0", "bf1-1")[i % 2])
           for i, s in enumerate(default_tenant_mix())]
    ctrl = MeiliController(paper_cluster(**CHAOS_POOL))
    registry = TenantRegistry(ctrl)
    for spec in mix:
        registry.register(spec)
    wl = make_scenario("chaos", contracts(mix), seed=seed)
    rec_cfg = (RecoveryConfig(park=True, brownout=True, seed=seed)
               if recovery_on else RecoveryConfig(park=False, brownout=False))
    rt = ServiceRuntime(ctrl, registry, wl, cfg, recovery=rec_cfg,
                        device="cpu")
    registry.admit_all()
    usage: dict = {}
    for dep in ctrl.deployments.values():
        for n, nic_row in dep.allocation.A.items():
            usage[n] = usage.get(n, 0) + sum(nic_row.values())
    flap_nic = max(usage, key=lambda n: (usage[n], n))
    rack0 = [n for n in ctrl.pool.rack_members("rack0") if n != flap_nic]
    gray_nic = max(rack0, key=lambda n: (usage.get(n, 0), n))
    rt.run(ticks, chaos=ChaosEngine(_chaos_plan(ticks, flap_nic, gray_nic)))
    ctrl.check_ledger()
    artifacts = None
    if obs_dir is not None:
        rt.obs.snapshot_compile_caches(planes=rt._planes.values())
        arm_dir = (pathlib.Path(obs_dir)
                   / ("chaos_on" if recovery_on else "chaos_off"))
        artifacts = rt.obs.dump(arm_dir)
    return {"gray_nic": gray_nic, "obs_artifacts": artifacts,
            "readmissions": len(rt.recovery.readmissions)}


def make_runtime(scenario="steady", cfg=FAST, seed=0):
    ctrl = MeiliController(paper_cluster())
    registry = TenantRegistry(ctrl)
    mix = default_tenant_mix()
    for spec in mix:
        registry.register(spec)
    wl = make_scenario(scenario, contracts(mix), seed=seed)
    rt = ServiceRuntime(ctrl, registry, wl, cfg, device="cpu")
    registry.admit_all()
    return rt


# -- the acceptance criterion -------------------------------------------------

def test_chaos_artifact_reconstructs_gray_story(tmp_path):
    """Run the same fast chaos arm ``make bench-chaos`` runs (here on the
    port, ``_run_chaos_arm`` below), then drop every live object and answer
    the post-mortem entirely from trace.jsonl."""
    rec = _run_chaos_arm(True, CHAOS_FAST_TICKS, seed=0,
                         obs_dir=str(tmp_path))
    sick = rec["gray_nic"]
    path = pathlib.Path(rec["obs_artifacts"]["trace"])
    assert path.exists()

    tr = load_trace(path)                      # the file is the only witness

    # 0) the injected fault itself is on the record
    inj = tr.query(name="gray", nic=sick, kind="fault")
    assert inj and "frac" in inj[0].detail["detail"]

    # 1) suspicion ramp: evidence ticks with a rising streak, each naming
    #    the tenants whose shortfall testified against the NIC
    susp = tr.query(name="gray_suspicion", nic=sick)
    assert len(susp) >= 3
    streaks = [e.detail["streak"] for e in susp]
    assert max(streaks) >= 3 and streaks[0] == 1
    assert all(e.detail["observers"] for e in susp)
    assert all(e.tick >= inj[0].tick for e in susp)

    # 2) quarantine verdict: a decision with a human-readable reason and
    #    the observer set that convicted the NIC
    verdicts = tr.query(name="quarantine_verdict", nic=sick)
    assert len(verdicts) == 1
    v = verdicts[0]
    assert "suspicion" in v.detail["reason"] and ">" in v.detail["reason"]
    assert v.detail["suspicion"] >= 0.3 and v.detail["streak"] >= 3
    assert set(v.detail["observers"]) <= {e.tenant for e in tr.events
                                          if e.tenant}
    assert v.seq > susp[0].seq                 # verdict follows the evidence

    # 3) drain: a gray_drain span on the sick NIC whose CHILDREN are the
    #    forced migrate spans (and any escalation failover) it caused
    drains = [s for s in tr.spans(name="gray_drain") if s.nic == sick]
    assert len(drains) == 1 and drains[0].tick_begin == v.tick
    kids = [s for s in tr.spans() if s.parent_id == drains[0].span_id]
    assert kids and all(k.name in ("migrate", "failover") for k in kids)
    assert any(k.name == "migrate" and k.detail.get("forced") for k in kids)

    # 4) re-admission: the quarantined NIC revives in the repair wave, and
    #    every parked tenant is readmitted — all after the verdict
    revives = [e for e in tr.query(name="revive", kind="fault")
               if sick in (e.nic or "")]
    assert revives and revives[0].tick > v.tick
    parked = tr.query(name="parked", kind="fault")
    readmitted = tr.query(name="readmitted", kind="fault")
    assert {e.tenant for e in parked} == {e.tenant for e in readmitted}
    assert len(readmitted) == rec["readmissions"]

    # the whole story is causally ordered by seq
    chapter = [inj[0].seq, susp[0].seq, v.seq, revives[0].seq]
    assert chapter == sorted(chapter)


# -- measured p99 beside the legacy estimator ---------------------------------

def test_measured_p99_recorded_beside_legacy():
    rt = make_runtime(scenario="bursty", seed=2)
    rt.run(16)
    for tenant in rt.registry.active():
        s = rt.telemetry.series(tenant)
        assert s and all(t.p99_measured_s > 0 for t in s if t.p99_s > 0)
        # the recorded value IS the registry histogram's quantile (the
        # cumulative sample stream), not a copy of the per-tick estimator
        hist = rt.obs.metrics.get("tenant_latency_s", tenant=tenant)
        assert hist is not None and hist.count > 0
        assert s[-1].p99_measured_s == pytest.approx(hist.quantile(0.99))
    summ = rt.telemetry.summary()
    for tenant, row in summ.items():
        assert row["p99_measured_s_max"] > 0
        assert row["p99_s_max"] > 0


# -- telemetry single-pass consistency -----------------------------------------

def _obs_tick(tick, tenant, ok, grace=False, p99=0.01):
    return TenantTick(tick=tick, tenant=tenant, offered_gbps=1.0,
                      achieved_gbps=1.0, p50_s=p99 / 2, p99_s=p99, units=1,
                      slo_ok=ok, in_grace=grace, p99_measured_s=p99)


def test_summary_and_slo_report_share_warmup_window():
    log = TelemetryLog(warmup_ticks=4)
    for tick in range(10):
        log.record(_obs_tick(tick, "t-a", ok=(tick != 6)))
        log.record(_obs_tick(tick, "t-b", ok=True, grace=(tick == 5)))
    rep = log.slo_report()                     # defaults to warmup_ticks=4
    assert rep["t-a"] == {"ticks": 6, "violations": 1,
                          "violation_frac": pytest.approx(1 / 6),
                          "pass": False}
    assert rep["t-b"]["ticks"] == 5            # grace tick not counted
    assert log.slo_tick_count() == 5 + 5
    summ = log.summary()
    assert summ["t-a"]["ticks"] == 6 and summ["t-b"]["ticks"] == 6
    # explicit override still wins over the shared default
    assert log.slo_report(warmup_ticks=0)["t-a"]["ticks"] == 10
    assert log.summary(warmup_ticks=0)["t-a"]["ticks"] == 10


def test_incremental_grouping_stays_correct_under_interleaving():
    """series()/summary() may be called mid-run; records appended afterwards
    must still land in the one-pass index."""
    log = TelemetryLog()
    log.record(_obs_tick(0, "t-a", ok=True))
    assert len(log.series("t-a")) == 1         # builds the index early
    log.record(_obs_tick(1, "t-a", ok=True))
    log.record(_obs_tick(1, "t-b", ok=False))
    assert [t.tick for t in log.series("t-a")] == [0, 1]
    assert len(log.series("t-b")) == 1
    assert log.summary()["t-a"]["ticks"] == 2
    assert log.slo_report()["t-b"]["violations"] == 1


def test_fault_records_mirror_into_trace():
    obs = Obs()
    log = TelemetryLog(trace=obs.trace)
    log.record_fault(7, "crash", nic="bf2-0", tenant="t-a", detail="boom")
    ev = obs.trace.query(name="crash", kind="fault")
    assert len(ev) == 1 and ev[0].tick == 7 and ev[0].nic == "bf2-0"
    assert ev[0].detail["detail"] == "boom"
    assert log.faults("crash")[0].tenant == "t-a"


# -- gray detector events without a full chaos run ----------------------------

def test_runtime_gray_quarantine_events_match_telemetry(tmp_path):
    """The compact gray scenario from test_faults, seen through the trace:
    the dumped artifact alone carries suspicion -> verdict -> drain."""
    cfg = dataclasses.replace(FAST, gray_detect=True)
    rt = make_runtime(scenario="steady", cfg=cfg, seed=1)
    usage = {}
    for dep in rt.ctrl.deployments.values():
        for n, row in dep.allocation.A.items():
            usage[n] = usage.get(n, 0) + sum(row.values())
    sick = max(usage, key=lambda n: (usage[n], n))
    rt.run(24, chaos=ChaosEngine(FaultPlan(
        [FaultEvent(tick=4, kind=GRAY, nic=sick, fraction=0.25)])))

    art = rt.obs.dump(tmp_path)
    tr = load_trace(art["trace"])
    quarantined = {f.nic for f in rt.telemetry.faults("gray_quarantined")}
    assert {e.nic for e in tr.query(name="gray_quarantined")} == quarantined
    if sick in quarantined:
        assert tr.query(name="quarantine_verdict", nic=sick)
        assert [s for s in tr.spans(name="gray_drain") if s.nic == sick]


# -- SLO-layer runs in both packages ---------------------------------------------

SLO_RUNS = {
    "chaos_live": dict(alert_actions=True),
    "chaos_shadow": dict(alert_actions=False),
    "chaos_sharded2": dict(alert_actions=True, sharded=True, racks=2),
    "steady_incident": dict(alert_actions=True, incident=True),
}


def _slo_run(pkg, case, out_dir):
    kw = dict(SLO_RUNS[case])
    incident = kw.pop("incident", False)
    racks = kw.pop("racks", 1)
    sharded = kw.pop("sharded", False)
    cfg = dict(gray_detect=True, slo_enabled=True, flight_dir=str(out_dir),
               flight_capacity=16, **kw)
    if incident:
        rt = sp.build(pkg, "steady", cfg=dict(cfg, slo_grace_ticks=6),
                      recovery=dict(park=True, brownout=True, seed=0))
        for name, spec in rt.registry.specs.items():
            rt.registry.specs[name] = dataclasses.replace(
                spec, sla=dataclasses.replace(spec.sla, p99_latency_s=1.0))
        victim, nics = next(
            (t, sorted(d.nics_used()))
            for t, d in rt.ctrl.deployments.items()
            if len(d.nics_used()) >= 2)
        events = [dict(tick=8, kind="flap", nic=nics[0], duration_ticks=6),
                  dict(tick=8, kind="gray", nic=nics[1], fraction=0.25)]
        ticks = 48
    else:
        rt = sp.build(pkg, "chaos", mix=sp.chaos_mix, sharded=sharded,
                      pool_kw=dict(sp.CHAOS_POOL, racks=racks), cfg=cfg,
                      recovery=dict(park=True, brownout=True, seed=0))
        events, ticks = sp.CHAOS_EVENTS, 44
    rt.run(ticks, chaos=sp.engine(pkg, events))
    rt.ctrl.check_ledger()
    return rt


@pytest.mark.parametrize("case", list(SLO_RUNS))
def test_slo_run_equals_reference(case, tmp_path):
    rts = {pkg.name: _slo_run(pkg, case, tmp_path / pkg.name / "flight")
           for pkg in sp.PKGS}
    recs = {name: sp.record(rt, tmp_path / name / "obs")
            for name, rt in rts.items()}
    sp.assert_same(recs["port"], recs["ref"])
    port, ref = rts["port"], rts["ref"]
    assert port.alerts.transitions, "the run fired no alert"
    assert ([dataclasses.asdict(t) for t in port.alerts.transitions]
            == [dataclasses.asdict(t) for t in ref.alerts.transitions])
    assert ({t: (b.burned(), b.burned_ticks(), b.remaining_frac())
             for t, b in port.slo.budgets.items()}
            == {t: (b.burned(), b.burned_ticks(), b.remaining_frac())
                for t, b in ref.slo.budgets.items()})
    assert list(port.flight.ring) == list(ref.flight.ring)
    names = [pathlib.Path(p).name for p in port.flight.dumps]
    assert names == [pathlib.Path(p).name for p in ref.flight.dumps]
    for a, b in zip(port.flight.dumps, ref.flight.dumps):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    if SLO_RUNS[case]["alert_actions"]:
        assert names, "a page fired but no bundle was dumped"
