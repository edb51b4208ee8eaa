"""The port's observability layer (``repro_torch.obs``) held against the JAX
package's ``repro.obs``.

Both packages get the same inputs in one process, each through its own
objects, and each test asserts the reference test's property on the port
and equality with the reference:

* percentiles: ``Reservoir`` (the same seeded numpy draws) and
  ``P2Quantile`` give equal numbers;
* the metrics registry: ``render_prometheus`` and ``dump_jsonl`` write the
  same bytes;
* the decision trace and ``Obs.dump``: the same bytes under a fixed clock
  (the trace's clock is injectable; the default, ``time.monotonic``, is
  never equal across two runs), and the round trip through JSONL answers
  ``query``/``why``/``spans`` as the live trace does, on a trace the port's
  own data plane wrote;
* the SLO engine and burn alerts (``test_slo.py``'s budget and alert cases,
  then a seeded tick stream): the same verdicts, budgets, burn rates,
  ``why_slo`` stories and byte-identical ``sequence()``;
* the flight recorder: byte-identical bundles from a stub runtime;
* ``ParallelDataPlane.process`` with the flow cache on, each package's
  plane writing to its own ``Obs``: equal trace events and equal counters
  and gauges (the timing histograms excepted).

A histogram's reservoir seed is ``hash((seed,) + key)``, and Python salts
string hashes per process: both packages draw the same per-series seed in
one process, neither repeats it in another. The tests compare within one
process, as the reference's own A/B comparisons do.

The reference tests that need the controller (``test_obs.py``'s span
story and trace round trip of a migration) wait for the controller's port;
those of ``test_slo.py`` and ``test_obs_runtime.py`` that drive the
service runtime wait for the runtime's.
"""
import itertools
import json
import types

import numpy as np
import pytest

import repro.obs as jobs
from repro.apps import ALL_APPS as JALL_APPS
from repro.apps import synth_packets as jsynth
from repro.core.executor import ParallelDataPlane as JPlane
from repro.obs import flight as jflight
from repro.service.telemetry import TenantTick
from repro.service.tenants import TenantSLA
from repro_torch import obs
from repro_torch.apps import ALL_APPS, synth_packets
from repro_torch.core import graph
from repro_torch.core.executor import ParallelDataPlane
from repro_torch.obs import flight
from repro_torch.obs.runlog import RunLogger

PKGS = (obs, jobs)


def _clock():
    """A fixed clock: 0.0, 0.25, 0.5, ... one step per reading."""
    steps = itertools.count()
    return lambda: 0.25 * next(steps)


def _both(fn):
    """``fn`` run once on each package: (port's result, reference's)."""
    return fn(obs), fn(jobs)


# -- percentiles --------------------------------------------------------------

def test_reservoir_exact_below_capacity():
    xs = np.random.default_rng(3).normal(5.0, 2.0, size=1000)

    def run(pkg):
        r = pkg.Reservoir(capacity=4096, seed=0)
        r.observe_many(xs)
        assert r.exact
        return [r.quantile(q) for q in (0.5, 0.9, 0.99)]
    got, want = _both(run)
    assert got == want
    for g, q in zip(got, (0.5, 0.9, 0.99)):
        assert g == pytest.approx(float(np.quantile(xs, q)), rel=1e-12,
                                  abs=1e-12)


def test_reservoir_sampled_above_capacity_equals_reference():
    """Past capacity the retained sample is a seeded draw: the same seed
    retains the same samples in both packages, so every quantile and the
    sample itself are equal, and p99 stays within 5% of the stream's."""
    xs = np.random.default_rng(4).lognormal(0.0, 0.5, size=50_000)

    def run(pkg):
        r = pkg.Reservoir(capacity=4096, seed=1)
        for chunk in np.array_split(xs, 37):
            r.observe_many(chunk)
            r.quantile(0.5)                    # mid-stream, pending window
        assert not r.exact and r.count == 50_000
        return [r.quantile(q) for q in (0.5, 0.9, 0.99)], r.samples()
    (got, gs), (want, ws) = _both(run)
    assert got == want
    np.testing.assert_array_equal(gs, ws)
    assert got[2] == pytest.approx(float(np.quantile(xs, 0.99)), rel=0.05)


def test_p2_tracks_numpy_quantile():
    xs = np.random.default_rng(5).lognormal(0.0, 0.4, size=20_000)

    def run(pkg):
        est = pkg.P2Quantile(0.99)
        small = pkg.P2Quantile(0.5)
        for x in xs:
            est.observe(float(x))
        for x in xs[:3]:
            small.observe(float(x))
        return est.value(), small.value(), pkg.P2Quantile(0.9).value()
    got, want = _both(run)
    assert got == want and got[2] is None
    assert got[0] == pytest.approx(float(np.quantile(xs, 0.99)), rel=0.05)
    assert got[1] == pytest.approx(float(np.median(xs[:3])))


# -- metrics registry ---------------------------------------------------------

def _registry(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("reqs_total", tenant="a").inc()
    reg.counter("reqs_total", tenant="a").inc(2)
    reg.counter("reqs_total", tenant="b").inc()
    assert reg.counter("dual", x="1", y="2") is reg.counter("dual", y="2",
                                                            x="1")
    h = reg.histogram("lat_us", tenant="a")
    h.observe_many(np.arange(1.0, 101.0))
    reg.counter("plain", tenant="a").inc()
    reg.gauge("pool_headroom_gbps", nic="bf2-0").set(7.5)
    hp = reg.histogram("lat_s", p2=True, tenant="t")
    for v in np.random.default_rng(2).exponential(0.01, size=5000):
        hp.observe(v)
    return reg


def test_registry_label_model_and_prometheus_render():
    reg, jreg = _both(_registry)
    assert reg.get("reqs_total", tenant="a").value == 3
    assert reg.get("reqs_total", tenant="b").value == 1
    assert reg.get("reqs_total", tenant="zzz") is None
    assert len(reg.series("reqs_total")) == 2
    h = reg.get("lat_us", tenant="a")
    assert h.count == 100 and h.quantile(0.5) == pytest.approx(50.5,
                                                               rel=0.02)
    text = reg.render_prometheus()
    assert 'reqs_total{tenant="a"} 3' in text
    assert "reqs_total_total" not in text
    assert "# TYPE reqs_total counter" in text
    assert 'plain_total{tenant="a"} 1' in text
    assert "# TYPE lat_us histogram" in text
    assert 'lat_us_bucket{le="+Inf",tenant="a"} 100' in text
    assert 'lat_us_bucket{le="10",tenant="a"} 10' in text
    assert 'lat_us_count{tenant="a"} 100' in text
    assert 'lat_us_sum{tenant="a"} 5050' in text
    assert "quantile=" not in text
    assert text == jreg.render_prometheus()
    # the reservoir past its capacity (5,000 > 4,096) drew alike
    hp, jhp = reg.get("lat_s", tenant="t"), jreg.get("lat_s", tenant="t")
    assert not hp.reservoir.exact
    assert [hp.quantile(q) for q in hp.quantiles] == \
        [jhp.quantile(q) for q in jhp.quantiles]
    assert [hp.p2_quantile(q) for q in hp.quantiles] == \
        [jhp.p2_quantile(q) for q in jhp.quantiles]


def test_histogram_cumulative_buckets_monotone():
    def run(pkg):
        h = pkg.MetricsRegistry().histogram("x_s", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v)
        h.observe_many([0.2, 20.0])
        return h.cumulative_buckets(), h.mean, h.min, h.max
    got, want = _both(run)
    assert got == want
    assert got[0] == [("0.1", 1), ("1", 4), ("10", 5), ("+Inf", 7)]


def test_metrics_jsonl_dump_is_byte_identical(tmp_path):
    paths = {}
    for pkg in PKGS:
        paths[pkg] = tmp_path / f"{pkg.__name__}.jsonl"
        _registry(pkg).dump_jsonl(paths[pkg])
    text = paths[obs].read_text()
    assert text == paths[jobs].read_text()
    recs = [json.loads(line) for line in text.splitlines()]
    by = {(r["name"], tuple(sorted(r["labels"].items()))): r for r in recs}
    assert by[("pool_headroom_gbps", (("nic", "bf2-0"),))]["value"] == 7.5
    assert by[("lat_s", (("tenant", "t"),))]["count"] == 5000
    assert by[("lat_s", (("tenant", "t"),))]["p2"]


# -- decision trace -----------------------------------------------------------

def _nested_trace(pkg):
    tr = pkg.DecisionTrace(clock=_clock())
    tr.set_tick(7)
    with tr.span("migrate", tenant="t-a") as outer:
        tr.event("scale_verdict", tenant="t-a", reason="granted",
                 nics={"bf2-1", "bf2-0"}, pair=("a", 1),
                 gbps=np.float32(2.5))
        with tr.span("failover", nic="bf2-1", tenant="t-a"):
            tr.event("replace_unit", tenant="t-a", nic="bf2-2", kind="fault")
        outer.note(outcome="committed")
    return tr


def test_trace_span_nesting_and_why():
    tr, jtr = _both(_nested_trace)
    spans = tr.spans()
    mig = next(s for s in spans if s.name == "migrate")
    fo = next(s for s in spans if s.name == "failover")
    assert fo.parent_id == mig.span_id and fo.span_id in mig.children
    assert mig.detail["outcome"] == "committed"
    assert mig.duration_s is not None and mig.duration_s >= 0
    ev = tr.query(name="replace_unit")[0]
    assert ev.parent_id == fo.span_id and ev.tick == 7
    assert tr.query(name="scale_verdict")[0].detail["nics"] == ["bf2-0",
                                                                "bf2-1"]
    why = tr.why("t-a", 7)
    assert [e.name for e in why if e.phase != "end"] == [
        "migrate", "scale_verdict", "failover", "replace_unit"]
    assert tr.why("t-a", 8) == []
    assert [e.to_json() for e in tr.events] == \
        [e.to_json() for e in jtr.events]
    assert [vars(s) for s in spans] == [vars(s) for s in jtr.spans()]


def test_why_tick_range_is_span_closed():
    def run(pkg):
        tr = pkg.DecisionTrace(clock=_clock())
        tr.set_tick(3)
        tr.event("slo_burn", tenant="t-a", reason="p99")
        tr.set_tick(5)
        with tr.span("gray_drain", tenant="t-a", nic="bf2-2"):
            tr.set_tick(9)
            tr.event("quarantine_verdict", tenant="t-a", nic="bf2-2")
        tr.set_tick(12)
        tr.event("slo_alert", tenant="t-a", state="resolved")
        tr.event("other", tenant="t-b")
        return tr
    tr, jtr = _both(run)
    sel = tr.why("t-a", tick_lo=3, tick_hi=6)
    names = [(e.name, e.phase) for e in sel]
    assert ("slo_burn", "") in names
    assert ("gray_drain", "begin") in names and ("gray_drain", "end") in names
    assert not any(e.name == "slo_alert" for e in sel)
    assert not any(e.tenant == "t-b" for e in sel)
    assert [e.seq for e in sel] == sorted(e.seq for e in sel)
    assert [e.name for e in tr.why("t-a", 12)] == ["slo_alert"]
    assert len(tr.why("t-a")) == 5
    for kw in ({"tick_lo": 3, "tick_hi": 6}, {"tick": 12}, {}):
        assert [e.to_json() for e in tr.why("t-a", **kw)] == \
            [e.to_json() for e in jtr.why("t-a", **kw)]


def _read_dir(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_obs_dump_artifacts_are_byte_identical(tmp_path):
    """``Obs.dump``'s three files, and ``RunLogger``'s rows beside them,
    under a fixed clock: the same bytes from both packages, and the dumped
    trace loads back with the same answers."""
    from repro.obs.runlog import RunLogger as JRunLogger
    for pkg, logger in ((obs, RunLogger), (jobs, JRunLogger)):
        o = pkg.Obs(seed=3, clock=_clock())
        o.metrics.counter("c_total").inc()
        o.metrics.histogram("lat_s", tenant="t").observe_many([0.1, 0.2])
        o.set_tick(4)
        o.trace.event("hello", tenant="t")
        paths = o.dump(tmp_path / pkg.__name__ / "art", prefix="run")
        assert sorted(paths) == ["metrics", "prom", "trace"]
        tr = pkg.load_trace(paths["trace"])
        assert tr.query(name="hello")[0].tenant == "t"
        log = logger("r", out_dir=str(tmp_path / pkg.__name__ / "log"),
                     echo=None)
        log.emit("x,1.5,ok")
        log.emit("a note")
        log.artifact(o, "obs")
        log.close()
    got = _read_dir(tmp_path / "repro_torch.obs" / "art")
    assert got == _read_dir(tmp_path / "repro.obs" / "art")
    assert b"c_total 1" in got["run.metrics.prom"]
    logs = [json.loads(p.read_text()) for p in
            (tmp_path / "repro_torch.obs" / "log" / "meta.json",
             tmp_path / "repro.obs" / "log" / "meta.json")]
    assert logs[0]["rows"] == logs[1]["rows"] == 2
    assert [(tmp_path / d / "log" / "rows.jsonl").read_text()
            for d in ("repro_torch.obs", "repro.obs")] == \
        ['{"name": "x", "us_per_call": 1.5, "derived": "ok"}\n'
         '{"note": "a note"}\n'] * 2


def test_snapshot_compile_caches_reads_the_ports_graph():
    o = obs.Obs()
    dp = ParallelDataPlane(ALL_APPS()["FW"], num_pipelines=2, device="cpu")
    dp.process(synth_packets(batch=32, num_flows=4, seed=0, device="cpu"))
    o.snapshot_compile_caches([dp])
    for cache, stats in graph.compile_cache_stats().items():
        for field, v in stats.items():
            assert o.metrics.get("compile_cache_" + field,
                                 cache=cache).value == v
    assert o.metrics.get("dataplane_dispatch_calls").value == 1
    assert o.metrics.get("dataplane_dispatch_compiles").value == 1


# -- SLO budgets and burn alerts (test_slo.py's cases) ------------------------

SLA = TenantSLA(target_gbps=10.0, p99_latency_s=1e-3)


def _tick(tick, tenant="t", offered=10.0, achieved=10.0, p99=1e-4,
          in_grace=False, p99_measured=0.0):
    return TenantTick(tick=tick, tenant=tenant, offered_gbps=offered,
                      achieved_gbps=achieved, p50_s=p99 / 2, p99_s=p99,
                      units=4, slo_ok=True, in_grace=in_grace,
                      p99_measured_s=p99_measured)


def test_budget_math_and_burn_rate():
    def run(pkg):
        eng = pkg.SLOEngine(pkg.Obs(clock=_clock()), horizon_ticks=20)
        verdicts = [eng.observe(_tick(t, achieved=10.0 if t < 8 else 1.0),
                                SLA) for t in range(10)]
        b = eng.budgets["t"]
        return (verdicts, b.burned(), b.allowance(), b.remaining_frac(),
                eng.burn_rate("t", 4), eng.burn_rate("t", 10),
                eng.burn_rate("missing", 4), b.burned_ticks(),
                json.dumps(eng.why_slo("t"), sort_keys=True))
    got, want = _both(run)
    assert got == want
    verdicts, burned, allow, left, b4, b10, missing, ticks, _ = got
    assert verdicts == [t >= 8 for t in range(10)]
    assert burned == 2 and allow == pytest.approx(1.0) and left == 0.0
    assert b4 == pytest.approx(10.0) and b10 == pytest.approx(2 / 10 / 0.05)
    assert missing == 0.0 and ticks == [8, 9]


def test_budget_warmup_burns_nothing_but_grace_burns():
    def run(pkg):
        eng = pkg.SLOEngine(pkg.Obs(), horizon_ticks=16, warmup_ticks=2)
        v = [eng.observe(_tick(0, achieved=0.0), SLA),
             eng.observe(_tick(1, achieved=0.0), SLA),
             eng.observe(_tick(2, achieved=0.0, in_grace=True), SLA)]
        b = eng.budgets["t"]
        return v, b.samples[-1].in_grace, b.burned()
    got, want = _both(run)
    assert got == want == ([False, False, True], True, 1)


def test_budget_p99_sli_prefers_measured_with_legacy_fallback():
    def run(pkg):
        eng = pkg.SLOEngine(pkg.Obs(), horizon_ticks=16)
        out = []
        for tt in (_tick(0, p99=1e-4, p99_measured=5e-3),
                   _tick(1, p99=1e-4, p99_measured=0.0),
                   _tick(2, p99=5e-3, p99_measured=0.0),
                   _tick(3, offered=20.0, achieved=8.5),
                   _tick(4, offered=1.0, achieved=0.95)):
            bad = eng.observe(tt, SLA)
            out.append((bad, eng.budgets["t"].samples[-1].reason))
        return out
    got, want = _both(run)
    assert got == want
    assert got == [(True, "p99"), (False, "p99"), (True, "p99"),
                   (True, "tput"), (False, "tput")]


def _manager(pkg, holddown=3):
    o = pkg.Obs(clock=_clock())
    eng = pkg.SLOEngine(o, horizon_ticks=32)
    rules = (pkg.BurnRule(pkg.PAGE, window_ticks=4, confirm_ticks=2,
                          burn_threshold=4.0),)
    return eng, pkg.BurnAlertManager(eng, o, rules=rules,
                                     holddown_ticks=holddown)


def test_alert_fires_once_dedups_and_resolves_after_holddown(tmp_path):
    def run(pkg):
        eng, mgr = _manager(pkg)
        achieved = [0.0] * 4 + [10.0] * 2 + [0.0] + [10.0] * 8
        active = []
        for tick, a in enumerate(achieved):
            eng.observe(_tick(tick, achieved=a), SLA)
            mgr.step(tick)
            active.append(mgr.active())
        mgr.obs.dump(tmp_path / pkg.__name__)
        return mgr, active
    (mgr, active), (jmgr, jactive) = _both(run)
    assert active == jactive
    assert mgr.sequence() == jmgr.sequence()
    states = [(t.severity, t.state) for t in mgr.transitions]
    assert states == [(obs.PAGE, obs.FIRING), (obs.PAGE, obs.RESOLVED)]
    assert active[5] == [("t", obs.PAGE)] and active[-1] == []
    m = mgr.obs.metrics
    assert m.get("slo_alert_transitions_total", severity=obs.PAGE,
                 state=obs.FIRING).value == 1
    assert m.get("slo_alert_transitions_total", severity=obs.PAGE,
                 state=obs.RESOLVED).value == 1
    assert len(mgr.obs.trace.query(name="slo_alert")) == 2
    assert _read_dir(tmp_path / "repro_torch.obs") == \
        _read_dir(tmp_path / "repro.obs")


def test_on_page_callback_and_sequence_json():
    def run(pkg):
        eng, mgr = _manager(pkg)
        seen = []
        mgr.on_page.append(lambda tenant, tr: seen.append((tenant, tr.tick)))
        for t in range(3):
            eng.observe(_tick(t, achieved=0.0), SLA)
            mgr.step(t)
        return seen, mgr.sequence()
    got, want = _both(run)
    assert got == want
    seen, seq = got
    assert seen == [("t", 0)]
    first = json.loads(seq)[0]
    assert first["tenant"] == "t" and first["state"] == obs.FIRING
    assert set(first) == {"tick", "tenant", "severity", "state",
                          "burn_long", "burn_short"}


def test_seeded_tick_stream_budgets_and_alerts_byte_identical(tmp_path):
    """Five tenants over 200 ticks of seeded bursts of bad throughput and
    latency (grace windows too), scored by the default rules with a shard
    resolver: each tick's verdicts, budgets and burn rates, every
    tenant's ``why_slo``, ``sequence()`` and the dumped artifacts are the
    same from both packages."""
    rng = np.random.default_rng(11)
    tenants = [f"t{i}" for i in range(5)]
    slas = {t: TenantSLA(target_gbps=5.0 + i, p99_latency_s=1e-3 * (i + 1),
                         budget_frac=0.05 + 0.01 * i)
            for i, t in enumerate(tenants)}
    storm = rng.random((200, 5)) < np.repeat(rng.random((20, 5)) < 0.3,
                                             10, axis=0)
    ticks = [[_tick(k, tenant=t, offered=float(rng.uniform(4, 12)),
                    achieved=float(rng.uniform(0, 5) if storm[k, i]
                                   else 12.0),
                    p99=float(rng.exponential(1e-3 * (i + 1))),
                    p99_measured=float(rng.choice([0.0, 5e-4, 8e-3])),
                    in_grace=bool(rng.random() < 0.05))
              for i, t in enumerate(tenants)] for k in range(200)]

    def run(pkg):
        o = pkg.Obs(seed=5, clock=_clock())
        shard = lambda tenant: f"rack{int(tenant[1:]) % 2}"
        eng = pkg.SLOEngine(o, horizon_ticks=48, warmup_ticks=3,
                            shard_resolver=shard)
        mgr = pkg.BurnAlertManager(eng, o, shard_resolver=shard)
        pages = []
        mgr.on_page.append(lambda tenant, tr: pages.append(tr.tick))
        log = []
        for k, row in enumerate(ticks):
            o.set_tick(k)
            bad = [eng.observe(tt, slas[tt.tenant]) for tt in row]
            out = mgr.step(k)
            log.append((bad, [t.key() for t in out],
                        {t: (b.burned(), b.remaining_frac(),
                             b.burn_rates((2, 6, 8, 24)))
                         for t, b in sorted(eng.budgets.items())}))
        stories = [json.dumps(eng.why_slo(t), sort_keys=True)
                   for t in tenants + ["absent"]]
        o.dump(tmp_path / pkg.__name__)
        return log, stories, mgr.sequence(), pages
    got, want = _both(run)
    assert got == want
    log, _, seq, pages = got
    assert len(json.loads(seq)) >= 4 and pages
    assert any(any(bad) for bad, *_ in log)
    assert _read_dir(tmp_path / "repro_torch.obs") == \
        _read_dir(tmp_path / "repro.obs")


# -- flight recorder ----------------------------------------------------------

def _stub_runtime(pkg, tick):
    """What ``FlightRecorder.snapshot`` reads of a service runtime: backlog
    and grants over 40 tenants (past ``max_entries``, so thinned), gray
    suspicion, an SLO engine and alert manager, per-tenant planes with
    flow-cache stats, and the controller's governor and flight state."""
    o = pkg.Obs(clock=_clock())
    eng, mgr = _manager(pkg)
    for k in range(tick + 1):
        eng.observe(_tick(k, achieved=0.0 if k % 3 else 10.0), SLA)
        mgr.step(k)
    planes = {f"t{i}": types.SimpleNamespace(flow_cache_stats=(
        lambda i=i: {"hits": 10 * i + tick, "misses": i, "fast": 1}))
              for i in range(3)}
    gov = types.SimpleNamespace(headroom_snapshot=lambda: {"bf2-0": 3.5,
                                                           "bf2-1": 1})
    ctrl = types.SimpleNamespace(governor=gov, flight_state=lambda: {
        "nics": {"bf2-0": {"alive": True}, "bf2-1": {"alive": tick < 5}}})
    rt = types.SimpleNamespace(
        _backlog={f"t{i:02d}": float(i * tick) for i in range(40)},
        _granted={f"t{i:02d}": 0.5 * i for i in range(40)},
        gray=types.SimpleNamespace(suspicion={"bf2-1": 0.25 * tick},
                                   probation={"bf2-1"}),
        slo=eng, alerts=mgr, _planes=planes, ctrl=ctrl)
    return o, eng, rt


def test_flight_bundle_byte_identical(tmp_path):
    def run(pkg):
        o, eng, _ = _stub_runtime(pkg, 0)
        fr = pkg.FlightRecorder(eng.obs, capacity=4, seed=9,
                                out_dir=str(tmp_path / pkg.__name__),
                                max_entries=8)
        for k in range(7):
            eng.obs.set_tick(k)
            fr.snapshot(k, _stub_runtime(pkg, k)[2])
            eng.obs.metrics.counter("ticks_total").inc()
            eng.obs.trace.event("tick_done", kind="mark", tenants={"b", "a"})
        first = open(fr.dump("manual", tick=6), "rb").read()
        second = open(fr.dump("page", tick=7), "rb").read()
        none = pkg.FlightRecorder(o).dump_safe("manual", 6)
        blocked = tmp_path / f"{pkg.__name__}.file"
        blocked.write_text("x")
        failed = pkg.FlightRecorder(o, out_dir=str(blocked)).dump_safe(
            "sentinel_failure", 6)
        return fr, first, second, none, failed, o
    got, want = _both(run)
    fr, first, second, none, failed, o = got
    assert none is None and failed is None
    assert o.trace.query(name="flight_dump_failed")
    assert len(fr.ring) == 4 and [s["tick"] for s in fr.ring] == [3, 4, 5, 6]
    assert fr.ring[-1]["queues_pkts"]["_thinned_from"] == 40
    assert (first, second) == want[1:3]
    assert fr.dumps == [str(tmp_path / "repro_torch.obs" / f"flight_{k}"
                            ".jsonl") for k in (6, 7)]
    bundle = flight.load_bundle(fr.dumps[0].replace("_6", "_7"))
    assert bundle == jflight.load_bundle(want[0].dumps[1])
    assert bundle["header"][0]["trigger"] == "page"
    assert bundle["metric_delta"] == []
    path = tmp_path / "first.jsonl"
    path.write_bytes(first)
    bundle = flight.load_bundle(path)
    head = bundle["header"][0]
    assert head["trigger"] == "manual" and head["snapshots"] == 4
    assert len(bundle["trace"]) == head["trace_events"] > 0
    assert bundle["metric_delta"]
    assert [e.to_json().replace("repro_torch.obs.file", "repro.obs.file")
            for e in o.trace.events] == \
        [e.to_json() for e in want[5].trace.events]


# -- the data plane writes to the port's Obs ----------------------------------

KW = dict(num_flows=40, pkt_bytes=128)


def _dataplane_run(pkg, plane_cls, apps, synth, name, **kw):
    """Six rounds of seeded traffic through a plane with the flow cache on
    (a flow table capped at 24 entries, so pruning runs) writing to its own
    ``Obs``; tenants tag the rounds."""
    o = pkg.Obs(seed=2, clock=_clock())
    dp = plane_cls(apps[name], num_pipelines=3, capacity_per_pipeline=32,
                   metrics=o.metrics, trace=o.trace, profile=True,
                   table_cap=24, **kw)
    for k in range(6):
        o.set_tick(k)
        dp.process(synth(batch=64 + 16 * (k % 2), seed=k % 4, **KW),
                   tenant=f"t{k % 2}")
    return o, dp


def _events(o):
    return [(e.kind, e.name, e.tenant, json.dumps(e.detail, sort_keys=True),
             e.tick) for e in o.trace.events]


def _counters_and_gauges(o):
    return [r for r in o.metrics.to_records() if r["kind"] != "histogram"]


@pytest.mark.parametrize("name", ["ISG", "FW"])
def test_dataplane_trace_and_counters_equal_reference(name, tmp_path):
    o, dp = _dataplane_run(obs, ParallelDataPlane, ALL_APPS(),
                           lambda **kw: synth_packets(device="cpu", **kw),
                           name, device="cpu")
    jo, jdp = _dataplane_run(jobs, JPlane, JALL_APPS(impl="ref"), jsynth,
                             name)
    names = {e[1] for e in _events(o)}
    assert {"slow_path_place", "flow_cache_batch"} <= names
    assert _events(o) == _events(jo)
    assert _counters_and_gauges(o) == _counters_and_gauges(jo)
    fc, app = dp.to.flow_cache.stats, dp.app.name
    assert o.metrics.get("flow_cache_hits_total", app=app).value == \
        fc["hits"] > 0
    assert o.metrics.get("dataplane_dispatch_calls_total",
                         app=app).value == 6
    assert "flow_table_prune" in names
    hist = o.metrics.get("dataplane_dispatch_us", app=app)
    assert hist.count == 6 and hist.reservoir.exact
    # the trace the port's own plane wrote, through its JSONL round trip
    path = tmp_path / "trace.jsonl"
    o.trace.dump_jsonl(path)
    loaded = obs.load_trace(path)
    assert [e.to_json() for e in loaded.events] == \
        [e.to_json() for e in o.trace.events]
    for q in ({"name": "flow_cache_batch"}, {"tenant": "t1"},
              {"kind": "decision"}, {"tick": 3}, {"since": 2, "until": 4}):
        assert [e.to_json() for e in loaded.query(**q)] == \
            [e.to_json() for e in o.trace.query(**q)]
    for t in ("t0", "t1"):
        assert [e.to_json() for e in loaded.why(t, 2)] == \
            [e.to_json() for e in o.trace.why(t, 2)]
    assert loaded.spans() == o.trace.spans()
    before = {e.seq for e in loaded.events}
    loaded.event("post_mortem_note", kind="mark")
    assert loaded.events[-1].seq not in before
