"""The port's controller (``repro_torch.core.controller``) held against the
JAX package's ``repro.core.controller``.

* Every case of ``test_controller.py``, the pool-only cases of
  ``test_ledger_roundtrip.py`` (the random lifecycle at all 8 seeds, the
  colocated release, the shrink resync), ``test_system.py``'s §2.2
  workflow and ``test_obs.py``'s controller cases (the span story of a
  mid-migration crash, the trace's JSONL round trip) run on the port with
  their own asserts. ``test_ledger_roundtrip.py``'s two chaos cases drive
  ``core.faults`` and ``service.runtime``: they run in
  ``test_torch_faults.py``.
* A seeded lifecycle script (24 seeds, over ``paper_cluster()`` and a
  4-NIC one) runs submit (some tenants under quotas, some with a backup
  NIC), adaptive scale up and down, migrate, defragment, a migration with a
  NIC failing mid-way, failover, state replication, revive and terminate
  in both packages, with fixed clocks. Compared with ``==``: the events,
  every deployment's ``R``, ``r_s``, ``allocation.A``, ``bw_charge``,
  ``bw_after``, ``unmet``, ``achievable_gbps``, ``num_pipelines`` and its
  TO's pipelines, the pool's snapshot, usage and quota rows,
  ``check_ledger(strict=False)`` after every step, the CA status, and the
  ``obs`` trace and metrics as bytes.
"""
import itertools
import random
import types

import pytest

import repro.obs as jobs
from repro.apps import ALL_APPS as JALL_APPS
from repro.apps import profiles as jprofiles
from repro.core import controller as jctrl
from repro.core import pool as jpool
from repro.core import qos as jqos
from repro_torch import obs
from repro_torch.apps import ALL_APPS, profiles
from repro_torch.core import allocation
from repro_torch.core import controller as ctrl_mod
from repro_torch.core import pool as pool_mod
from repro_torch.core import qos
from repro_torch.core import replication as repl
from repro_torch.core.controller import MeiliController
from repro_torch.core.pool import CPU, NicSpec, Pool, paper_cluster
from repro_torch.core.profiler import synthetic_profile
from repro_torch.core.qos import TenantQuota
from repro_torch.obs import load_trace

BITS = 1500 * 8 * 256.0
ISG_LAT = {"ddos_check": 400e-6, "url_check": 300e-6, "ipsec_encap": 150e-6,
           "sha": 250e-6, "aes": 350e-6}
APP_KEYS = ("ID", "ICG", "ISG", "FW", "FM", "LLB")

PORT = types.SimpleNamespace(name="port", ctrl=ctrl_mod, pool=pool_mod,
                             qos=qos, obs=obs, apps=lambda: ALL_APPS(),
                             profiles=profiles)
REF = types.SimpleNamespace(name="ref", ctrl=jctrl, pool=jpool, qos=jqos,
                            obs=jobs, apps=lambda: JALL_APPS(impl="ref"),
                            profiles=jprofiles)


def make_ctrl():
    return MeiliController(paper_cluster())


def isg_profile():
    app = ALL_APPS()["ISG"]
    return app, synthetic_profile(app.stage_names(), ISG_LAT, BITS)


def t_R_of(prof):
    R = repl.num_replication(prof.stages, prof.l_s)
    rate = repl.pipeline_throughput(prof.stages, prof.l_s, R)
    return rate * prof.batch_bits() / 1e9


def snapshot(pool):
    return {n: (dict(st.free), st.free_bw_gbps)
            for n, st in pool.nics.items()}


# -- test_controller.py's cases on the port ------------------------------------

def test_demand_formula_matches_paper():
    ctrl = make_ctrl()
    app, prof = isg_profile()
    R, r_s, t_R = ctrl.demand(prof, target_gbps=2 * t_R_of(prof))
    n_groups = int(2 * t_R_of(prof) // t_R)
    for s in prof.stages:
        assert r_s[s] >= R[s] * n_groups


def test_submit_meets_small_target():
    ctrl = make_ctrl()
    app, prof = isg_profile()
    dep = ctrl.submit(app, target_gbps=5.0, profile=prof)
    assert dep.achievable_gbps >= 5.0
    assert dep.allocation.satisfied()
    assert all(n.startswith("bf2")
               for n in dep.allocation.nics_for("url_check"))
    assert all(n.startswith("pensando")
               for n in dep.allocation.nics_for("aes"))


def test_adaptive_scale_up_and_down():
    ctrl = make_ctrl()
    app, prof = isg_profile()
    ctrl.submit(app, target_gbps=5.0, profile=prof)
    dep = ctrl.adaptive_scale(app.name, 10.0)
    assert dep.achievable_gbps >= 10.0
    units_up = dict(dep.r_s)
    dep = ctrl.adaptive_scale(app.name, 3.0)
    assert dep.achievable_gbps >= 3.0
    assert sum(dep.r_s.values()) <= sum(units_up.values())


def test_failover_replaces_lost_units():
    ctrl = make_ctrl()
    app, prof = isg_profile()
    dep = ctrl.submit(app, target_gbps=5.0, profile=prof)
    nic = dep.allocation.nics_for("aes")[0]
    impacted = ctrl.handle_failure(nic)
    assert app.name in impacted
    dep2 = ctrl.deployments[app.name]
    assert nic not in dep2.allocation.nics_for("aes")
    assert dep2.allocation.units("aes") >= 1
    assert any(e["event"] == "failover" for e in ctrl.events)


def test_failover_meets_recomputed_targets_and_restores_state():
    ctrl = make_ctrl()
    app, prof = isg_profile()
    app.declare_state("isg_sa_table", "full-access")
    dep = ctrl.submit(app, target_gbps=5.0, profile=prof, backup_nic="bf1-0")
    units_before = {s: dep.allocation.units(s) for s in prof.stages}
    victim = dep.allocation.nics_for("aes")[0]
    ctrl.state.ne_set("isg_sa_table", 0xC0FFEE, local=victim)
    ctrl.replicate_for_failover(app.name)
    assert dep.state_snapshot == {"isg_sa_table": 0xC0FFEE}

    ctrl.handle_failure(victim)
    dep2 = ctrl.deployments[app.name]
    failover_ev = [e for e in ctrl.events if e["event"] == "failover"][-1]
    assert failover_ev["unmet"] == {}
    for s in prof.stages:
        assert dep2.allocation.units(s) >= units_before[s], s
        assert victim not in dep2.allocation.nics_for(s), s
    assert dep2.achievable_gbps >= dep2.target_gbps
    for nic in ctrl.pool.names():
        assert ctrl.state.get("isg_sa_table", local=nic) == 0xC0FFEE
    assert ctrl.pool.usage_snapshot()[app.name] == dep2.usage()


def test_terminate_reclaims_resources():
    ctrl = make_ctrl()
    app, prof = isg_profile()
    before = ctrl.pool.free_total("cpu")
    ctrl.submit(app, target_gbps=5.0, profile=prof)
    assert ctrl.pool.free_total("cpu") < before
    ctrl.terminate(app.name)
    assert ctrl.pool.free_total("cpu") == before


def test_fcfs_multi_app():
    ctrl = make_ctrl()
    apps = ALL_APPS()
    lat_fw = {"rule_match": 200e-6, "conn_track": 150e-6}
    prof_fw = synthetic_profile(apps["FW"].stage_names(), lat_fw, BITS)
    app, prof = isg_profile()
    d1 = ctrl.submit(app, 5.0, prof)
    d2 = ctrl.submit(apps["FW"], 20.0, prof_fw)
    assert d1.allocation.satisfied() and d2.allocation.satisfied()
    assert len(ctrl.deployments) == 2


def test_replication_dirty_flag_skips_unchanged_snapshots():
    ctrl = make_ctrl()
    app, prof = isg_profile()
    app.declare_state("isg_sa_table", "full-access")
    dep = ctrl.submit(app, target_gbps=5.0, profile=prof, backup_nic="bf1-0")
    victim = dep.allocation.nics_for("aes")[0]
    ctrl.state.ne_set("isg_sa_table", 1, local=victim)

    ctrl.replicate_for_failover(app.name)
    assert dep.state_snapshot == {"isg_sa_table": 1}
    reads_after_first = ctrl.state.transport.reads
    ctrl.replicate_for_failover(app.name)
    assert ctrl.state.transport.reads == reads_after_first
    assert dep.state_snapshot == {"isg_sa_table": 1}
    ctrl.state.ne_set("isg_sa_table", 2, local=victim)
    ctrl.replicate_for_failover(app.name)
    assert ctrl.state.transport.reads > reads_after_first
    assert dep.state_snapshot == {"isg_sa_table": 2}


# -- test_ledger_roundtrip.py's pool-only cases on the port --------------------

def _submit_one(ctrl, rng, counter):
    key = rng.choice(APP_KEYS)
    app = ALL_APPS()[key]
    app.name = f"{key.lower()}-{counter}"
    dep = ctrl.submit(app, target_gbps=rng.uniform(1.0, 8.0),
                      profile=profiles.paper_profile(key))
    if not dep.allocation.satisfied():
        ctrl.terminate(app.name)        # strict-admission rollback path
        return None
    return app.name


@pytest.mark.parametrize("seed", range(8))
def test_random_lifecycle_conserves_pool(seed):
    rng = random.Random(seed)
    ctrl = MeiliController(paper_cluster())
    base = snapshot(ctrl.pool)
    live = []
    counter = 0
    failures = 0
    for _ in range(32):
        ops = ["submit", "submit"]
        if live:
            ops += ["scale_up", "scale_down", "terminate", "migrate"]
            if failures < 2:
                ops.append("failover")
        op = rng.choice(ops)
        if op == "submit":
            name = _submit_one(ctrl, rng, counter)
            counter += 1
            if name:
                live.append(name)
        elif op == "scale_up":
            name = rng.choice(live)
            ctrl.adaptive_scale(
                name, ctrl.deployments[name].target_gbps
                + rng.uniform(0.5, 5.0))
        elif op == "scale_down":
            name = rng.choice(live)
            ctrl.adaptive_scale(
                name, max(0.5, ctrl.deployments[name].target_gbps
                          * rng.uniform(0.2, 0.8)))
        elif op == "migrate":
            ctrl.migrate(rng.choice(live))
        elif op == "terminate":
            name = live.pop(rng.randrange(len(live)))
            ctrl.terminate(name)
        elif op == "failover":
            used = sorted({n for d in ctrl.deployments.values()
                           for n in d.nics_used() if ctrl.pool[n].alive})
            if used:
                ctrl.handle_failure(rng.choice(used))
                failures += 1
        ctrl.check_ledger()

    for name in list(ctrl.deployments):
        ctrl.terminate(name)
    ctrl.check_ledger()
    assert ctrl.pool.usage_snapshot() == {}
    for n, (free, bw) in base.items():
        st = ctrl.pool[n]
        assert st.free == free, f"{n}: unit drift {st.free} != {free}"
        assert st.free_bw_gbps == pytest.approx(bw, abs=1e-6)


def test_colocated_release_does_not_overcredit():
    pool = Pool([NicSpec("n0", "x", 16, {}, bandwidth_gbps=20.0)])
    S = ["s1", "s2"]
    need = {s: CPU for s in S}
    t_s = {"s1": 5.0, "s2": 5.0}
    a = allocation.resource_alloc(S, {"s1": 2, "s2": 2}, t_s, pool, need)
    allocation.commit(pool, a, need)
    assert pool["n0"].free_bw_gbps == pytest.approx(10.0)
    b = allocation.resource_alloc(["s1"], {"s1": 2}, t_s, pool, need)
    allocation.commit(pool, b, need)
    assert pool["n0"].free_bw_gbps == pytest.approx(0.0)
    allocation.release(pool, a, need, t_s)
    assert pool["n0"].free_bw_gbps == pytest.approx(10.0)
    allocation.release(pool, b, need, t_s)
    assert pool["n0"].free_bw_gbps == pytest.approx(20.0)
    assert pool["n0"].free == {CPU: 16}


def test_shrink_resyncs_allocator_view():
    ctrl = MeiliController(paper_cluster())
    app = ALL_APPS()["FW"]
    prof = synthetic_profile(
        app.stage_names(),
        {"rule_match": 200e-6, "conn_track": 150e-6}, 1500 * 8 * 256.0)
    ctrl.submit(app, target_gbps=20.0, profile=prof)
    dep = ctrl.adaptive_scale(app.name, 2.0)
    for nic, row in dep.allocation.A.items():
        assert all(u > 0 for u in row.values()), (nic, row)
        assert dep.allocation.bw_after[nic] == \
            pytest.approx(ctrl.pool[nic].free_bw_gbps)
    ctrl.check_ledger()


# -- test_system.py's §2.2 workflow and test_obs.py's controller cases ---------

def test_paper_workflow_end_to_end():
    """§2.2 style scenario: three apps at 20 Gbps targets multiplex onto the
    pool; every deployment meets its target; failover keeps apps placed."""
    bits = 1500 * 8 * 256.0
    ctrl = MeiliController(paper_cluster())
    apps = ALL_APPS()
    lats = {
        "ICG": {"ipcomp_encap": 120e-6, "compress": 260e-6},
        "FW": {"rule_match": 180e-6, "conn_track": 140e-6},
        "FM": {"flow_ext": 90e-6, "flow_metrics": 150e-6},
    }
    deps = {}
    for name, lat in lats.items():
        prof = synthetic_profile(apps[name].stage_names(), lat, bits)
        deps[name] = ctrl.submit(apps[name], target_gbps=20.0, profile=prof)
    for name, dep in deps.items():
        assert dep.achievable_gbps >= 20.0, name
    used = {n for d in deps.values() for n in d.nics_used()}
    assert len(used) <= 6
    victim = next(iter(used))
    ctrl.handle_failure(victim)
    for name in deps:
        dep = ctrl.deployments[deps[name].app.name]
        assert dep.allocation.units(dep.profile.stages[0]) >= 1


def test_controller_submit_migrate_failover_span_story():
    ctrl = MeiliController(paper_cluster())
    app, prof = isg_profile()
    ctrl.governor.register("t-isg", TenantQuota(max_gbps=5.0))
    ctrl.submit(app, target_gbps=7.0, profile=prof, tenant="t-isg")

    def on_swap(app_name):
        nic = sorted(ctrl.deployments[app_name].nics_used())[0]
        ctrl.handle_failure(nic)

    ctrl.mid_migration_hook = on_swap
    ev = ctrl.migrate(app.name, forced=True, require_improvement=False)
    assert ev is not None

    tr = ctrl.obs.trace
    sub = tr.spans(name="submit")[0]
    mig = tr.spans(name="migrate")[0]
    fo = tr.spans(name="failover")[0]
    assert sub.parent_id is None and sub.span_id < mig.span_id
    assert fo.parent_id == mig.span_id          # crash landed mid-migration
    assert mig.detail["outcome"] == "committed"
    assert sub.detail["granted_gbps"] >= 5.0
    clamp = tr.query(name="admission_verdict", tenant="t-isg") or \
        tr.query(name="admission_clamp", tenant="t-isg")
    assert clamp and clamp[0].parent_id == sub.span_id
    assert clamp[0].detail["granted_gbps"] == pytest.approx(5.0)


def test_trace_jsonl_round_trip_identical_queries(tmp_path):
    ctrl = MeiliController(paper_cluster())
    app, prof = isg_profile()
    ctrl.submit(app, target_gbps=5.0, profile=prof, tenant="t-isg")
    ctrl.obs.trace.set_tick(3)
    ctrl.migrate(app.name, forced=True, require_improvement=False)
    live = ctrl.obs.trace
    path = tmp_path / "trace.jsonl"
    live.dump_jsonl(path)
    loaded = load_trace(path)
    assert [e.to_json() for e in loaded.events] == \
           [e.to_json() for e in live.events]
    for q in ({"name": "migrate"}, {"tenant": "t-isg"},
              {"kind": "decision"}, {"tick": 3}):
        assert [e.to_json() for e in loaded.query(**q)] == \
               [e.to_json() for e in live.query(**q)]
    assert [e.to_json() for e in loaded.why("t-isg", 3)] == \
           [e.to_json() for e in live.why("t-isg", 3)]
    assert loaded.spans() == live.spans()
    before = {e.seq for e in loaded.events}
    loaded.event("post_mortem_note", kind="mark")
    assert loaded.events[-1].seq not in before


# -- a seeded lifecycle script against the reference ---------------------------

def _clock():
    """A fixed clock: 0.0, 0.25, 0.5, ... one step per reading."""
    steps = itertools.count()
    return lambda: 0.25 * next(steps)


def _dep_fields(d):
    a = d.allocation
    return (d.R, d.r_s, a.A, a.bw_charge, a.bw_after, a.unmet,
            d.achievable_gbps, d.num_pipelines, d.target_gbps, d.tenant,
            d.backup_nic, d.state_snapshot, d.replica_version,
            [(p.pid, p.capacity, p.active, p.load) for p in d.to.pipelines],
            d.to.flow_table, d.to.halted_flows)


def _lifecycle(pkg, seed, small, tmp_path):
    """Every controller operation in a seeded order; all randomness is drawn
    here, so both packages see the same calls."""
    rng = random.Random(seed)
    pool = (pkg.pool.paper_cluster(n_bf2=2, n_bf1=1, n_pensando=1) if small
            else pkg.pool.paper_cluster())
    o = pkg.obs.Obs(clock=_clock())
    ctrl = pkg.ctrl.MeiliController(pool, clock=_clock(), obs=o)
    base = snapshot(pool)
    live, steps, counter, failures = [], [], 0, 0
    for step in range(24):
        ops = ["submit", "submit"]
        if live:
            ops += ["scale_up", "scale_down", "migrate", "defrag",
                    "mid_fail", "replicate", "terminate"]
            if failures < 3:
                ops.append("failover")
        dead = sorted(n for n in pool.nics if not pool[n].alive)
        if dead:
            ops.append("revive")
        op = rng.choice(ops)
        o.set_tick(step)
        if op == "submit":
            key = rng.choice(APP_KEYS)
            app = pkg.apps()[key]
            app.name = f"{key.lower()}-{counter}"
            tenant = rng.choice([None, f"t{counter}"])
            if tenant is not None and rng.random() < 0.6:
                ctrl.governor.register(tenant, pkg.qos.TenantQuota(
                    max_gbps=rng.uniform(1.0, 6.0),
                    max_units=rng.choice([None, rng.randint(4, 16)]),
                    weight=rng.choice([1.0, 2.0, 3.0])))
            counter += 1
            dep = ctrl.submit(app, target_gbps=rng.uniform(0.5, 8.0),
                              profile=pkg.profiles.paper_profile(key),
                              backup_nic=rng.choice([None, "bf1-0"]),
                              tenant=tenant)
            if dep.allocation.satisfied():
                live.append(app.name)
            else:
                ctrl.terminate(app.name)
        elif op in ("scale_up", "scale_down"):
            name = rng.choice(live)
            t = ctrl.deployments[name].target_gbps
            ctrl.adaptive_scale(name, t + rng.uniform(0.5, 5.0)
                                if op == "scale_up"
                                else max(0.5, t * rng.uniform(0.2, 0.8)))
        elif op == "migrate":
            steps.append(ctrl.migrate(
                rng.choice(live), require_improvement=rng.random() < 0.5))
        elif op == "defrag":
            steps.append(ctrl.defragment(max_migrations=rng.randint(1, 3),
                                         min_score=rng.choice([0.5, 1.0])))
        elif op == "mid_fail":
            def on_swap(app_name):
                nic = sorted(ctrl.deployments[app_name].nics_used())[0]
                steps.append(("mid", ctrl.handle_failure(nic)))
            ctrl.mid_migration_hook = on_swap
            steps.append(ctrl.migrate(rng.choice(live), forced=True,
                                      require_improvement=False))
            ctrl.mid_migration_hook = None
            failures += 1
        elif op == "failover":
            used = sorted({n for d in ctrl.deployments.values()
                           for n in d.nics_used() if pool[n].alive})
            if used:
                steps.append(ctrl.handle_failure(rng.choice(used)))
                failures += 1
        elif op == "replicate":
            name = rng.choice(live)
            dep = ctrl.deployments[name]
            for s_name in dep.app.state_decls:
                nic = rng.choice(sorted(pool.nics))
                if rng.random() < 0.5:
                    ctrl.state.ne_set(s_name, rng.randint(0, 1 << 20),
                                      local=nic)
            ctrl.replicate_for_failover(name)
            steps.append(dep.state_snapshot)
        elif op == "revive":
            pool.revive(rng.choice(dead))
        elif op == "terminate":
            ctrl.terminate(live.pop(rng.randrange(len(live))))
        steps.append((op, ctrl.check_ledger(strict=False), ctrl.tick(),
                      {n: _dep_fields(d)
                       for n, d in ctrl.deployments.items()},
                      pool.snapshot(), pool.usage_snapshot(),
                      dict(pool.quota)))
    for name in list(ctrl.deployments):
        ctrl.terminate(name)
    end = (ctrl.check_ledger(strict=False), pool.usage_snapshot(),
           snapshot(pool), base, ctrl.flight_state())
    o.trace.dump_jsonl(tmp_path / f"{pkg.name}.jsonl")
    o.metrics.dump_jsonl(tmp_path / f"{pkg.name}_m.jsonl")
    return (ctrl.events, steps, end,
            (tmp_path / f"{pkg.name}.jsonl").read_bytes(),
            (tmp_path / f"{pkg.name}_m.jsonl").read_bytes(),
            o.metrics.render_prometheus())


@pytest.mark.parametrize("seed", range(24))
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_lifecycle_script_equals_reference(seed, small, tmp_path):
    got = _lifecycle(PORT, seed, small, tmp_path)
    want = _lifecycle(REF, seed, small, tmp_path)
    assert got[0] == want[0]                  # events
    assert got[1] == want[1]                  # every step's state
    assert got[2] == want[2]
    assert got[3] == want[3] and got[3]       # the trace, byte for byte
    assert got[4:] == want[4:]                # metrics, both renderings
    ledger, usage, free, base, _ = got[2]
    assert ledger == [] and usage == {}
    for n, (units, bw) in base.items():       # dead NICs included
        assert free[n][0] == units
        assert free[n][1] == pytest.approx(bw, abs=1e-6)


def test_lifecycle_script_exercises_every_operation(tmp_path):
    """The seeds above reach every operation, commit migrations, fail NICs
    mid-migration and revive them (else the comparison is vacuous)."""
    ops, mids, moves = set(), 0, 0
    for seed in range(24):
        for small in (False, True):
            _, steps, *_ = _lifecycle(PORT, seed, small, tmp_path)
            ops |= {s[0] for s in steps if isinstance(s, tuple)
                    and len(s) == 7}
            mids += sum(1 for s in steps if isinstance(s, tuple)
                        and s[0] == "mid")
            moves += sum(1 for s in steps if isinstance(s, dict)
                         and s.get("event") == "migrate")
    assert ops == {"submit", "scale_up", "scale_down", "migrate", "defrag",
                   "mid_fail", "replicate", "terminate", "failover",
                   "revive"}
    assert mids >= 5 and moves >= 10
