"""Port data plane (rings, orchestrator, fused dispatch) held against the JAX
package.

``ParallelDataPlane.process`` of the port and of the reference get the same
seeded batches over several rounds, with spill (capacity 8 << batch),
flow migration, pipeline halt and the all-flows-halted empty result; every
output leaf, the orchestrator's tables and the flow cache's counters must
be equal. The stacked rings are compared with the reference's
``push_many``/``pop_many``. All compared values are integer, bool or byte
arrays, so the tolerance is 0: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as JALL_APPS
from repro.apps import synth_packets as jsynth
from repro.core import ringbuffer as jring
from repro.core.executor import ParallelDataPlane as JPlane
from repro_torch import convert
from repro_torch.apps import ALL_APPS, synth_packets
from repro_torch.core import graph, ringbuffer
from repro_torch.core.executor import (MIN_BUCKET, ParallelDataPlane,
                                       PipelineRunner, _bucket)
from repro_torch.core.graph import chain_runner, run_pipeline, stage_runner
from repro_torch.core.orchestrator import flow_ids
from repro_torch.obs import Obs

APPS = ["ID", "ICG", "ISG", "FW", "FM", "LLB"]
KW = dict(batch=96, num_flows=12, pkt_bytes=128, seed=7)
PKTS = synth_packets(device="cpu", **KW)
JPKTS = jsynth(**KW)


def _assert_leaves_equal(ours, theirs):
    a = convert.leaves_to_numpy(ours)
    b = [np.asarray(x) for x in jax.tree.leaves(theirs)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _assert_same_tables(a, b):
    assert a.to.flow_table == b.to.flow_table
    assert a.to.spill_table == b.to.spill_table
    assert [p.load for p in a.to.pipelines] == [p.load for p in b.to.pipelines]
    assert a.to.fast_stats == b.to.fast_stats
    assert a.dispatch_stats["calls"] == b.dispatch_stats["calls"]


def _planes(name, **kw):
    return (ParallelDataPlane(ALL_APPS()[name], device="cpu", **kw),
            JPlane(JALL_APPS(impl="ref")[name], **kw))


# -- rings ------------------------------------------------------------------------

def test_push_pop_many_equal_reference_with_wraparound():
    proto = {"x": torch.zeros(2, dtype=torch.int32),
             "u": torch.zeros((), dtype=torch.uint32)}
    jproto = {"x": jnp.zeros((2,), jnp.int32), "u": jnp.zeros((), jnp.uint32)}
    ring = ringbuffer.make_rings(proto, cap=8, lanes=3)
    jr = jring.make_rings(jproto, cap=8, lanes=3)
    rng = np.random.default_rng(0)
    for wave in range(6):                     # 6 waves of up to 5 rows > cap
        n = np.array([5, 3, wave % 2], np.int32)
        x = (np.arange(30, dtype=np.int32) + 1000 * wave).reshape(3, 5, 2)
        u = rng.integers(0, 2 ** 32, (3, 5), dtype=np.uint64).astype(np.uint32)
        ringbuffer.push_many(ring, {"x": torch.from_numpy(x),
                                    "u": torch.from_numpy(u)},
                             torch.from_numpy(n))
        jr = jring.push_many(jr, {"x": jnp.asarray(x), "u": jnp.asarray(u)},
                             jnp.asarray(n))
        np.testing.assert_array_equal(ring.occupancy.numpy(),
                                      np.asarray(jr.occupancy))
        k = 4 if wave % 3 else 5
        _, rows, valid = ringbuffer.pop_many(ring, k)
        jr, jrows, jvalid = jring.pop_many(jr, k)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        for key in ("x", "u"):
            ours, theirs = rows[key].numpy(), np.asarray(jrows[key])
            np.testing.assert_array_equal(ours[valid.numpy()],
                                          theirs[np.asarray(jvalid)])
        for key in ("x", "u"):
            np.testing.assert_array_equal(ring.data[key].numpy(),
                                          np.asarray(jr.data[key]))
        np.testing.assert_array_equal(ring.head.numpy(), np.asarray(jr.head))
        np.testing.assert_array_equal(ring.tail.numpy(), np.asarray(jr.tail))


def test_single_lane_ring_equals_reference():
    ring = ringbuffer.make_ring({"x": torch.zeros(3, dtype=torch.int32)}, 8)
    jr = jring.make_ring({"x": jnp.zeros((3,), jnp.int32)}, 8)
    for wave in range(5):
        x = np.arange(18, dtype=np.int32).reshape(6, 3) + 100 * wave
        ringbuffer.push(ring, {"x": torch.from_numpy(x)}, 4 + wave % 2)
        jr = jring.push(jr, {"x": jnp.asarray(x)}, 4 + wave % 2)
        rows, valid = ringbuffer.peek(ring, 3)
        jrows, jvalid = jring.peek(jr, 3)
        np.testing.assert_array_equal(rows["x"].numpy(), np.asarray(jrows["x"]))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        _, rows, valid = ringbuffer.pop(ring, 6)
        jr, jrows, jvalid = jring.pop(jr, 6)
        np.testing.assert_array_equal(rows["x"].numpy()[valid.numpy()],
                                      np.asarray(jrows["x"])[np.asarray(jvalid)])
        assert int(ring.occupancy) == int(jr.occupancy)


def test_ring_cursors_wrap_past_int32():
    """Slots stay exact when the int32 cursors wrap (cap divides 2^32)."""
    ring = ringbuffer.make_rings({"x": torch.zeros((), dtype=torch.int32)},
                                 cap=4, lanes=1)
    ring.head.fill_(2 ** 31 - 2)
    ring.tail.fill_(2 ** 31 - 2)
    ringbuffer.push_many(ring, {"x": torch.arange(4, dtype=torch.int32)[None]},
                         torch.tensor([4], dtype=torch.int32))
    assert int(ring.tail[0]) == -2 ** 31 + 2           # wrapped
    _, rows, valid = ringbuffer.pop_many(ring, 4)
    assert rows["x"][0].tolist() == [0, 1, 2, 3] and bool(valid.all())


# -- process == reference process, three rounds, per scenario ------------------------

@pytest.mark.parametrize("name", APPS)
def test_process_equals_reference_with_spill(name):
    """capacity 8 << 96 packets: every flow spills."""
    ours, ref = _planes(name, num_pipelines=4, capacity_per_pipeline=8)
    oracle = run_pipeline(ALL_APPS()[name], PKTS)
    for _ in range(3):                        # state carries across rounds
        got = ours.process(PKTS)
        _assert_leaves_equal(got, ref.process(JPKTS))
        for x, y in zip(convert.leaves_to_numpy(got),
                        convert.leaves_to_numpy(oracle)):
            np.testing.assert_array_equal(x, y)
        _assert_same_tables(ours, ref)
    assert ours.to.spill_table


@pytest.mark.parametrize("name", APPS)
def test_process_equals_reference_with_migration(name):
    ours, ref = _planes(name, num_pipelines=3, capacity_per_pipeline=64)
    _assert_leaves_equal(ours.process(PKTS), ref.process(JPKTS))
    f = sorted(ours.to.flow_table)[0]
    ours.to.begin_migration(f), ref.to.begin_migration(f)
    got = ours.process(PKTS)
    _assert_leaves_equal(got, ref.process(JPKTS))
    keep = np.nonzero(flow_ids(PKTS) != f)[0]
    assert got.batch == keep.size < PKTS.batch
    a = ours.to.finish_migration(f, 1)
    b = ref.to.finish_migration(f, 1)
    assert [s.indices.tolist() for s in a] == [s.indices.tolist() for s in b]
    _assert_leaves_equal(ours.process(PKTS), ref.process(JPKTS))
    _assert_same_tables(ours, ref)
    assert ours.to.flow_cache.stats == ref.to.flow_cache.stats


@pytest.mark.parametrize("name", APPS)
def test_process_equals_reference_with_halt(name):
    ours, ref = _planes(name, num_pipelines=3, capacity_per_pipeline=48)
    _assert_leaves_equal(ours.process(PKTS), ref.process(JPKTS))
    assert ours.to.halt_pipeline(1) == ref.to.halt_pipeline(1)
    for _ in range(2):
        _assert_leaves_equal(ours.process(PKTS), ref.process(JPKTS))
        _assert_same_tables(ours, ref)
    assert ours.to.pipelines[1].load == 0


@pytest.mark.parametrize("name", APPS)
def test_all_flows_halted_gives_empty_result(name):
    ours, ref = _planes(name, num_pipelines=2, capacity_per_pipeline=64)
    ours.process(PKTS), ref.process(JPKTS)
    for f in sorted(ours.to.flow_table):
        ours.to.begin_migration(f), ref.to.begin_migration(f)
    got, want = ours.process(PKTS), ref.process(JPKTS)
    assert got.batch == 0
    _assert_leaves_equal(got, want)
    got_u = ours.process_unfused(PKTS)
    _assert_leaves_equal(got_u, ref.process_unfused(JPKTS))


# -- fused vs unfused, compile counting ----------------------------------------------

@pytest.mark.parametrize("name", ["FW", "ISG"])
def test_process_equals_process_unfused(name):
    dp = ParallelDataPlane(ALL_APPS()[name], num_pipelines=3,
                           capacity_per_pipeline=16, device="cpu")
    a = dp.process(PKTS)
    b = dp.process_unfused(PKTS)
    for x, y in zip(convert.leaves_to_numpy(a), convert.leaves_to_numpy(b)):
        np.testing.assert_array_equal(x, y)


def test_zero_steady_state_recompiles():
    dp = ParallelDataPlane(ALL_APPS()["FW"], num_pipelines=4,
                           capacity_per_pipeline=32, device="cpu")
    for _ in range(5):
        dp.process(PKTS)
    assert dp.dispatch_stats["calls"] == 5
    assert dp.dispatch_stats["compiles"] == 1


def test_no_recompiles_after_warmup_via_cache_counters():
    dp = ParallelDataPlane(ALL_APPS()["ID"], num_pipelines=2,
                           capacity_per_pipeline=32, device="cpu")
    dp.process(PKTS)
    warm = dp.dispatch_stats["compiles"]
    graph.reset_compile_cache_stats()
    for _ in range(4):
        dp.process(PKTS)
    assert dp.dispatch_stats["compiles"] == warm
    stats = graph.compile_cache_stats()
    assert stats["dispatch"]["miss"] == 0 and stats["dispatch"]["hit"] >= 4


def test_bucketing_bounds_shapes():
    assert _bucket(1) == MIN_BUCKET
    assert (_bucket(16), _bucket(17), _bucket(1000)) == (16, 32, 1024)
    app = ALL_APPS()["FW"]
    dp = ParallelDataPlane(app, num_pipelines=2, capacity_per_pipeline=1000,
                           device="cpu")
    for b in (64, 64, 96, 96, 64):
        dp.process(synth_packets(batch=b, num_flows=4, pkt_bytes=64,
                                 device="cpu"))
    assert dp.dispatch_stats["compiles"] == 2
    # batch-size drift WITHIN a bucket shares one shape (B, egress length
    # and M are all bucketed)
    dp2 = ParallelDataPlane(ALL_APPS()["FW"], num_pipelines=2,
                            capacity_per_pipeline=1000, device="cpu")
    dp2.process(synth_packets(batch=100, num_flows=4, pkt_bytes=64,
                              device="cpu"))
    base = dp2.dispatch_stats["compiles"]
    for b in (120, 100, 97):
        out = dp2.process(synth_packets(batch=b, num_flows=4, pkt_bytes=64,
                                        device="cpu"))
        assert out.batch == b
    assert base == 1 and dp2.dispatch_stats["compiles"] == base


def test_replicas_and_deployments_share_programs():
    app = ALL_APPS()["FW"]
    runners = [PipelineRunner(app) for _ in range(4)]
    assert len({id(r._chain) for r in runners}) == 1
    assert chain_runner(app) is runners[0]._chain
    assert stage_runner(app.stages[0]) is runners[0].executors[0].run
    app2 = graph.MeiliApp("fw-tenant-b")
    app2.stages = list(app.stages)
    dp1 = ParallelDataPlane(app, num_pipelines=3, capacity_per_pipeline=64,
                            device="cpu")
    dp1.process(PKTS, tenant="tenant-a")
    dp2 = ParallelDataPlane(app2, num_pipelines=3, capacity_per_pipeline=64,
                            device="cpu")
    assert dp2._dispatch is dp1._dispatch
    dp2.process(PKTS, tenant="tenant-b")
    assert dp2.dispatch_stats["compiles"] == 0        # no double compile
    assert dp2.dispatch_stats["by_tenant"] == {
        "tenant-b": {"calls": 1, "packets": PKTS.batch}}
    dp3 = ParallelDataPlane(ALL_APPS()["FW"], num_pipelines=3, device="cpu")
    assert dp3._dispatch is not dp1._dispatch


def test_metrics_and_stage_profile():
    obs = Obs()
    app = ALL_APPS()["ISG"]
    dp = ParallelDataPlane(app, num_pipelines=2, capacity_per_pipeline=64,
                           metrics=obs.metrics, profile=True, device="cpu")
    for _ in range(3):
        dp.process(PKTS)
    calls = obs.metrics.get("dataplane_dispatch_calls_total", app=app.name)
    assert calls is not None and calls.value == 3
    lat = obs.metrics.get("dataplane_dispatch_us", app=app.name)
    assert lat is not None and lat.count == 3
    hits = obs.metrics.get("flow_cache_hits_total", app=app.name)
    assert hits is not None and hits.value == dp.to.flow_cache.stats["hits"]
    timings = dp.profile_stages(PKTS)
    assert set(timings) == set(app.stage_names())
    assert dp.flow_cache_stats()["fast_batches"] == 3


def test_plane_refuses_batch_on_another_device():
    dp = ParallelDataPlane(ALL_APPS()["FW"], num_pipelines=2, device="cpu")
    dp.device = torch.device("cuda", 0)      # as a plane on the card sees it
    with pytest.raises(ValueError, match="batch on cpu"):
        dp.process(PKTS)
