"""The port's online re-placement (``repro_torch.core.defrag`` and
``MeiliController.migrate``/``defragment``) held against the JAX package's.

* Every case of ``test_defrag.py`` runs on the port with its own asserts
  (scoring, plan quality, ledger discipline, the do-no-harm rollback, flow
  affinity and the migration side buffer).
* Seeded fragmented pools (random NICs of several kinds and bandwidths,
  random chains, a third to a half of the deployments terminated to punch
  holes) in both packages: every deployment's ``fragmentation_score``,
  ``minimal_nics``, ``stranded_bw_gbps``, ``disjoint_pairs``,
  ``plan_migration`` (``A``, ``unmet``, ``bw_after``, ``bw_charge``) and
  ``migration_impact``, then ``defragment``'s events, allocations, pool
  snapshot and ledger check, all with ``==`` (the port keeps the reference's
  code and float order). After a migration the TO's ``partition_assign``
  of the same packets must give equal arrays in the two packages.
"""
import dataclasses
import itertools
import random
import types

import pytest

from repro.apps.packets import synth_packets as jsynth
from repro.core import controller as jctrl
from repro.core import defrag as jdefrag
from repro.core import graph as jgraph
from repro.core import pool as jpool
from repro.core import profiler as jprof
from repro.core import replication as jrepl
from repro_torch.apps.packets import synth_packets
from repro_torch.core import controller as ctrl_mod
from repro_torch.core import defrag, graph
from repro_torch.core import pool as pool_mod
from repro_torch.core import profiler, replication
from repro_torch.core.controller import MeiliController
from repro_torch.core.orchestrator import ASSIGN_HALTED, flow_ids
from repro_torch.core.pool import NicSpec, Pool

BITS = 1500 * 8 * 256.0

PORT = types.SimpleNamespace(
    name="port", ctrl=ctrl_mod, defrag=defrag, graph=graph, pool=pool_mod,
    prof=profiler, repl=replication,
    synth=lambda **kw: synth_packets(device="cpu", **kw))
REF = types.SimpleNamespace(
    name="ref", ctrl=jctrl, defrag=jdefrag, graph=jgraph, pool=jpool,
    prof=jprof, repl=jrepl, synth=jsynth)


def mk_app(name, stages, pkg=PORT, kinds=None):
    app = pkg.graph.MeiliApp(name)
    for s in stages:
        app.stages.append(pkg.graph.Function(
            s, "pkt_trans", lambda b: b,
            resource=(kinds or {}).get(s, pkg.pool.CPU)))
    return app


def prof(stages, lat=100e-6, pkg=PORT):
    return pkg.prof.synthetic_profile(list(stages),
                                      {s: lat for s in stages}, BITS)


def target_units(p, k, pkg=PORT):
    """Target throughput that makes the §6.1 demand formula place exactly
    k units per stage (k-1 whole groups + one minimal-granularity unit)."""
    R = pkg.repl.num_replication(p.stages, p.l_s)
    rate = pkg.repl.pipeline_throughput(p.stages, p.l_s, R)
    t_R = rate * p.batch_bits() / 1e9
    return (k - 0.5) * t_R


def pool_snapshot(pool):
    return {n: (dict(st.free), st.free_bw_gbps) for n, st in pool.nics.items()}


def fragmented_controller():
    """5 NICs x 4 cores; fillers leave 1 free core per NIC so the victim's
    2+2 units land scattered (a on n0/n1, b on n2/n3 — a fully disjoint
    consecutive pair); terminating three fillers then opens the holes a
    defrag pass can re-pack into."""
    pool = Pool([NicSpec(f"n{i}", "x", 4, {}, 1000.0) for i in range(5)])
    ctrl = MeiliController(pool)
    for i in range(5):
        fp = prof([f"f{i}"])
        ctrl.submit(mk_app(f"filler{i}", [f"f{i}"]), target_units(fp, 3), fp)
    vp = prof(["a", "b"])
    dep = ctrl.submit(mk_app("victim", ["a", "b"]), target_units(vp, 2), vp)
    assert dep.allocation.satisfied()
    for i in range(3):
        ctrl.terminate(f"filler{i}")
    return ctrl


# -- test_defrag.py's cases on the port ----------------------------------------

def test_fragmentation_score_flags_scattered_placement():
    ctrl = fragmented_controller()
    dep = ctrl.deployments["victim"]
    sc = defrag.fragmentation_score(dep, ctrl.pool)
    assert sc.nics_used == 4
    assert sc.min_nics == 1
    assert sc.hop_pairs == 1              # a on {n0,n1}, b on {n2,n3}
    assert sc.stranded_bw_gbps > 0.0      # every NIC colocation-free
    assert sc.score > 3.0
    # a compact deployment on a fresh pool scores ~0
    pool2 = Pool([NicSpec("m0", "x", 8, {}, 1000.0)])
    ctrl2 = MeiliController(pool2)
    vp = prof(["a", "b"])
    dep2 = ctrl2.submit(mk_app("compact", ["a", "b"]), target_units(vp, 2), vp)
    sc2 = defrag.fragmentation_score(dep2, pool2)
    assert sc2.hop_pairs == 0 and sc2.nics_used == 1
    assert sc2.score < 1.0


def test_defragment_recovers_locality_and_conserves_ledger():
    ctrl = fragmented_controller()
    dep = ctrl.deployments["victim"]
    before = defrag.fragmentation_score(dep, ctrl.pool)
    achievable_before = dep.achievable_gbps
    units_before = {s: dep.allocation.units(s) for s in dep.profile.stages}

    moved = ctrl.defragment(max_migrations=1, min_score=1.0)
    assert len(moved) == 1 and moved[0]["app"] == "victim"

    dep = ctrl.deployments["victim"]
    after = defrag.fragmentation_score(dep, ctrl.pool)
    assert after.nics_used < before.nics_used
    assert after.hop_pairs == 0
    assert {s: dep.allocation.units(s) for s in dep.profile.stages} \
        == units_before
    assert dep.achievable_gbps >= achievable_before - 1e-9
    ctrl.check_ledger()
    assert ctrl.pool.usage_snapshot()["victim"] == dep.usage()
    assert any(e["event"] == "migrate" for e in ctrl.events)


def test_defragment_converges_then_stops():
    ctrl = fragmented_controller()
    passes = 0
    while ctrl.defragment(max_migrations=2, min_score=1.0):
        passes += 1
        assert passes <= 4, "defragment did not converge"
    assert passes >= 1
    dep = ctrl.deployments["victim"]
    sc = defrag.fragmentation_score(dep, ctrl.pool)
    assert sc.score < 1.0
    assert ctrl.defragment(max_migrations=2, min_score=1.0) == []
    ctrl.check_ledger()


def test_migrate_rejects_plan_that_raises_hops_and_rolls_back():
    pool = Pool([NicSpec("n0", "x", 4, {}, 1000.0),
                 NicSpec("n1", "x", 1, {}, 1000.0),
                 NicSpec("n2", "x", 1, {}, 1000.0)])
    ctrl = MeiliController(pool)
    vp = prof(["a", "b"])
    dep = ctrl.submit(mk_app("victim", ["a", "b"]), target_units(vp, 1), vp)
    assert dep.allocation.nics_for("a") == dep.allocation.nics_for("b") \
        == ["n0"]
    snap = pool_snapshot(pool)
    assert ctrl.migrate("victim", only_nics=["n1", "n2"]) is None
    assert pool_snapshot(pool) == snap
    assert dep.allocation.nics_for("a") == ["n0"]
    ctrl.check_ledger()


def test_migrate_rejects_unplaceable_targets():
    ctrl = fragmented_controller()
    snap = pool_snapshot(ctrl.pool)
    assert ctrl.migrate("victim", only_nics=["n4"]) is None
    assert pool_snapshot(ctrl.pool) == snap


def test_migrate_requires_improvement_by_default():
    pool = Pool([NicSpec("n0", "x", 8, {}, 1000.0),
                 NicSpec("n1", "x", 8, {}, 1000.0)])
    ctrl = MeiliController(pool)
    vp = prof(["a", "b"])
    ctrl.submit(mk_app("victim", ["a", "b"]), target_units(vp, 2), vp)
    snap = pool_snapshot(pool)
    assert ctrl.migrate("victim") is None
    assert pool_snapshot(pool) == snap


def test_flow_affinity_preserved_across_migration():
    ctrl = fragmented_controller()
    dep = ctrl.deployments["victim"]
    pkts = synth_packets(batch=64, num_flows=8, pkt_bytes=64, device="cpu")
    assign_before = dep.to.partition_assign(pkts)
    homes_before = dict(dep.to.flow_table)
    assert homes_before

    moved = ctrl.defragment(max_migrations=1)
    assert moved
    dep = ctrl.deployments["victim"]
    assert set(dep.to.flow_table) == set(homes_before)
    assert dep.to.halted_flows == {}
    active = {p.pid for p in dep.to.pipelines if p.active}
    assert set(dep.to.flow_table.values()) <= active
    assign_after = dep.to.partition_assign(pkts)
    assert assign_after.shape == assign_before.shape
    fids = flow_ids(pkts)
    for f, pid in dep.to.flow_table.items():
        sel = assign_after[fids == f]
        assert len(sel) == 0 or (sel == pid).all() or \
            set(sel.tolist()) <= active


def test_migration_buffers_and_releases_inflight_flows():
    ctrl = fragmented_controller()
    dep = ctrl.deployments["victim"]
    pkts = synth_packets(batch=32, num_flows=4, pkt_bytes=64, device="cpu")
    dep.to.partition_assign(pkts)
    flow = next(iter(dep.to.flow_table))
    dep.to.begin_migration(flow)
    assign = dep.to.partition_assign(pkts)
    halted = assign[flow_ids(pkts) == flow]
    assert len(halted) and (halted == ASSIGN_HALTED).all()
    buffered = dep.to.finish_migration(flow, dst_pid=0)
    assert buffered and all(sb.pid == 0 for sb in buffered)
    assert sum(len(sb.indices) for sb in buffered) == len(halted)
    assert dep.to.flow_table[flow] == 0


# -- seeded fragmented pools against the reference -----------------------------

def _clock():
    steps = itertools.count()
    return lambda: 0.25 * next(steps)


def _alloc_fields(a):
    return None if a is None else (a.A, a.unmet, a.bw_after, a.bw_charge)


def _fragmented(pkg, seed):
    """A random pool and chain mix, then holes: the same draws in either
    package (all randomness is in this function)."""
    rng = random.Random(seed)
    kinds = (pkg.pool.CPU, pkg.pool.REGEX, pkg.pool.CRYPTO)
    specs = []
    for i in range(rng.randint(3, 7)):
        accel = {k: rng.randint(1, 4) for k in kinds[1:]
                 if rng.random() < 0.4}
        specs.append(pkg.pool.NicSpec(f"n{i}", rng.choice(["x", "y"]),
                                      rng.randint(2, 6), accel,
                                      rng.choice([40.0, 100.0, 400.0])))
    ctrl = pkg.ctrl.MeiliController(pkg.pool.Pool(specs), clock=_clock())
    live = []
    for j in range(rng.randint(4, 9)):
        stages = [f"s{j}_{k}" for k in range(rng.randint(1, 3))]
        need = {s: rng.choice(kinds) if rng.random() < 0.3 else kinds[0]
                for s in stages}
        p = prof(stages, rng.choice([50e-6, 100e-6, 200e-6]), pkg)
        app = mk_app(f"app{j}", stages, pkg, need)
        dep = ctrl.submit(app, target_units(p, rng.randint(1, 3), pkg), p)
        if dep.allocation.satisfied():
            live.append(app.name)
        else:
            ctrl.terminate(app.name)
    for name in rng.sample(live, len(live) // 2 + rng.randint(0, 1)):
        if name in ctrl.deployments:
            ctrl.terminate(name)
    return ctrl


def _defrag_story(pkg, seed):
    ctrl = _fragmented(pkg, seed)
    out = []
    for name, dep in ctrl.deployments.items():
        sc = pkg.defrag.fragmentation_score(dep, ctrl.pool)
        plan = pkg.defrag.plan_migration(dep, ctrl.pool)
        impact = None
        if plan is not None:
            demand = {s: dep.allocation.units(s) for s in dep.profile.stages}
            impact = dataclasses.asdict(pkg.defrag.migration_impact(
                dep, plan, ctrl._achievable(dep.profile, plan, demand)))
        out.append((name, dataclasses.asdict(sc),
                    pkg.defrag.minimal_nics(dep, ctrl.pool),
                    pkg.defrag.stranded_bw_gbps(dep),
                    pkg.defrag.disjoint_pairs(dep.allocation,
                                              dep.profile.stages),
                    _alloc_fields(plan), impact))
    # flows homed before the pass, then the same traffic after it
    pkts = pkg.synth(batch=96, num_flows=12, pkt_bytes=64, seed=seed)
    before = {n: d.to.partition_assign(pkts).tolist()
              for n, d in ctrl.deployments.items()}
    moved = ctrl.defragment(max_migrations=3, min_score=0.5)
    after = {n: d.to.partition_assign(pkts).tolist()
             for n, d in ctrl.deployments.items()}
    deps = {n: (_alloc_fields(d.allocation), d.r_s, d.achievable_gbps,
                d.num_pipelines, dict(d.to.flow_table), d.to.halted_flows)
            for n, d in ctrl.deployments.items()}
    return (out, before, moved, after, deps, pool_snapshot(ctrl.pool),
            ctrl.pool.usage_snapshot(), ctrl.check_ledger(strict=False),
            ctrl.events)


@pytest.mark.parametrize("seed", range(24))
def test_fragmented_pool_scores_plans_and_moves_equal_reference(seed):
    got, want = _defrag_story(PORT, seed), _defrag_story(REF, seed)
    assert got == want
    assert got[7] == []                     # the ledger holds after the pass


def test_seeded_pools_exercise_migrations():
    """The seeded pools above are not all already compact: some plans exist
    and some passes move deployments (else the comparison is vacuous)."""
    stories = [_defrag_story(PORT, seed) for seed in range(24)]
    assert sum(len(s[2]) for s in stories) >= 5
    assert sum(1 for s in stories for row in s[0] if row[5] is not None) >= 10
    # a moved deployment's flows keep their pipelines (make-before-break)
    moved = [(s, ev["app"]) for s in stories for ev in s[2]]
    assert all(s[3][app] == s[1][app] and s[3][app] for s, app in moved)
