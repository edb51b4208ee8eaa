"""The port's profiler, simulator and app profiles (``repro_torch.core.
profiler``, ``repro_torch.core.sim``, ``repro_torch.apps.profiles``) held
against the JAX package's.

* ``sim.simulate`` on ``test_replication.py``'s ``pipelines()`` draws, and
  on seeded pipelines with hop penalties and arrival gaps, returns a
  ``SimResult`` equal field by field (floats with ``==``), including on the
  draws where the reference's own bubble property fails.
* The calibrated tables, ``unit_gbps``, ``stage_unit_gbps``,
  ``paper_profile`` and ``synthetic_profile`` are equal for the six apps.
* ``measure_app`` on the CPU: the reference's stage names and ``bits``, the
  ``l_p``/``t_p`` identities, and the chain's output after profiling equal
  to ``run_pipeline``.
* ``cost_model_latency``: one f32 matmul counts the FLOPs and bytes XLA's
  ``cost_analysis()`` reports; an elementwise chain counts at least XLA's
  bytes (eager ops are not fused); a callable that launches a hand-written
  kernel is refused.
"""
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

from repro.apps import ALL_APPS as JALL_APPS
from repro.apps import profiles as jprofiles
from repro.apps import synth_packets as jsynth
from repro.core import profiler as jprofiler
from repro.core import replication as jrepl
from repro.core import sim as jsim
from repro_torch.apps import ALL_APPS, profiles, synth_packets
from repro_torch.core import graph, profiler, replication, sim
from repro_torch.kernels import _build

APPS = ["ID", "ICG", "ISG", "FW", "FM", "LLB"]


def _result(r):
    return (r.makespan, r.latencies, r.busy_time, r.replicas, r.throughput,
            r.avg_latency, r.utilization({}))


@st.composite
def pipelines(draw):
    n = draw(st.integers(1, 8))
    lat = {f"s{i}": draw(st.floats(0.1, 50.0)) for i in range(n)}
    return [f"s{i}" for i in range(n)], lat


@given(pipelines())
@settings(max_examples=30, deadline=None)
def test_sim_equals_reference_on_replication_draws(p):
    """``test_property_sim_removes_bubbles``'s draws and sequence counts;
    the property itself is not asserted (it fails on some draws in the
    reference too), only equality with the reference."""
    stages, lat = p
    R = replication.num_replication(stages, lat)
    assert R == jrepl.num_replication(stages, lat)
    n = min(4000, max(150, 25 * max(R.values())))
    got = sim.simulate(stages, lat, R, num_seqs=n)
    want = jsim.simulate(stages, lat, R, num_seqs=n)
    assert _result(got) == _result(want)


def test_sim_equals_reference_where_the_bubble_property_fails():
    """The draw ROADMAP records as failing the reference's property."""
    stages = [f"s{i}" for i in range(8)]
    lat = dict(zip(stages, [1.0, 1.0, 1.0, 35.0, 50.0, 50.0, 50.0,
                            0.109375]))
    R = replication.num_replication(stages, lat)
    n = min(4000, max(150, 25 * max(R.values())))
    got = sim.simulate(stages, lat, R, num_seqs=n)
    want = jsim.simulate(stages, lat, R, num_seqs=n)
    assert _result(got) == _result(want)
    assert want.throughput < 0.7 * min(R[s] / lat[s] for s in stages)


@pytest.mark.parametrize("seed", range(6))
def test_sim_with_hops_and_arrivals_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    stages = [f"s{i}" for i in range(n)]
    lat = {s: float(rng.uniform(0.05, 20.0)) for s in stages}
    R = {s: int(rng.integers(1, 5)) for s in stages}
    hops = {(a, b): float(rng.uniform(0, 3)) for a, b in zip(stages,
                                                             stages[1:])
            if rng.random() < 0.7}
    gap = float(rng.choice([0.0, rng.uniform(0.0, 5.0)]))
    got = sim.simulate(stages, lat, R, 500, arrival_interval=gap,
                       hop_penalty=hops)
    want = jsim.simulate(stages, lat, R, 500, arrival_interval=gap,
                         hop_penalty=hops)
    assert _result(got) == _result(want)


def test_profile_tables_equal_reference():
    assert profiles.APP_STAGE_LATENCY_US == jprofiles.APP_STAGE_LATENCY_US
    assert profiles.APP_STAGE_RESOURCE == jprofiles.APP_STAGE_RESOURCE
    assert profiles.HOP_US == jprofiles.HOP_US
    assert profiles.PKT_BITS == jprofiles.PKT_BITS
    for lat in (0.2, 0.92, 1.0, 3.2, 17.0):
        assert profiles.unit_gbps(lat) == jprofiles.unit_gbps(lat)
    # the resource map agrees with the apps the port runs
    for key, app in ALL_APPS(impl="torch").items():
        assert profiles.APP_STAGE_RESOURCE[key] == app.resource_needs()


def _profile(p):
    return (p.stages, p.l_s, p.t_s, p.l_p, p.t_p, p.batch_bits())


@pytest.mark.parametrize("key", APPS)
def test_paper_and_synthetic_profiles_equal_reference(key):
    assert profiles.stage_unit_gbps(key) == jprofiles.stage_unit_gbps(key)
    for batch_pkts in (1, 256, 1000):
        assert _profile(profiles.paper_profile(key, batch_pkts)) == \
            _profile(jprofiles.paper_profile(key, batch_pkts))
    stages = list(profiles.APP_STAGE_LATENCY_US[key])
    l_s = {s: (i + 1) * 37e-6 for i, s in enumerate(stages)}
    assert _profile(profiler.synthetic_profile(stages, l_s, 3.2e6)) == \
        _profile(jprofiler.synthetic_profile(stages, l_s, 3.2e6))


@pytest.mark.parametrize("key", APPS)
def test_measure_app_on_cpu(key):
    """Stage names and bits as the reference counts them; l_p the sum of
    l_s, t_p the bits over the slowest stage; profiling leaves the chain's
    output equal to ``run_pipeline``."""
    kw = dict(batch=96, num_flows=40, seed=3)
    batch = synth_packets(**kw, device="cpu")
    app = ALL_APPS(impl="torch")[key]
    prof = profiler.measure_app(app, batch, iters=2)
    jbatch = jsynth(**kw)
    jprof = jprofiler.measure_app(JALL_APPS(impl="ref")[key], jbatch, iters=1)
    assert prof.stages == jprof.stages == list(prof.l_s)
    assert prof.batch_bits() == jprof.batch_bits()
    assert all(v > 0 for v in prof.l_s.values())
    assert prof.l_p == sum(prof.l_s.values())
    assert prof.t_p == prof.batch_bits() / max(prof.l_s.values()) / 1e9
    assert prof.t_s == {n: prof.batch_bits() / v / 1e9
                        for n, v in prof.l_s.items()}
    cur = batch
    for fn in app.stages:
        cur = graph.stage_runner(fn)(cur)
    want = graph.run_pipeline(app, batch)
    for a, b in zip(graph.tree_leaves(cur), graph.tree_leaves(want)):
        assert torch.equal(graph.bits(a), graph.bits(b))


def _xla_cost(fn, *args):
    import jax
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    return float(cost.get("flops", 0.0)), float(cost.get("bytes accessed",
                                                         0.0))


def test_cost_model_matmul_equals_xla():
    """(128, 256) @ (256, 512) in f32: 33,554,432 FLOPs and 917,504 bytes
    (the operands and the result), as XLA counts them."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(128, 256)).astype(np.float32)
    b = rng.normal(size=(256, 512)).astype(np.float32)
    flops, nbytes = profiler.op_cost(lambda x, y: x @ y,
                                     torch.from_numpy(a), torch.from_numpy(b))
    assert (flops, nbytes) == (33_554_432, 917_504)
    assert (float(flops), float(nbytes)) == _xla_cost(lambda x, y: x @ y,
                                                      a, b)
    est = profiler.cost_model_latency(lambda x, y: x @ y,
                                      torch.from_numpy(a), torch.from_numpy(b))
    want = jprofiler.cost_model_latency(lambda x, y: x @ y, a, b,
                                        flops_rate=profiler.hw
                                        .PEAK_BF16_TENSOR_FLOPS,
                                        mem_bw=profiler.hw.HBM_BW)
    assert est == want == max(33_554_432 / 989e12, 917_504 / 3.35e12)


def test_cost_model_elementwise_chain_counts_at_least_xla_bytes():
    x = np.random.default_rng(1).normal(size=(128, 256)).astype(np.float32)

    _, nbytes = profiler.op_cost(lambda t: torch.tanh(t) * 2 + 1,
                                 torch.from_numpy(x))
    import jax.numpy as jnp
    _, xla_bytes = _xla_cost(lambda t: jnp.tanh(t) * 2 + 1, x)
    assert xla_bytes == 262_144
    assert nbytes >= xla_bytes
    # three eager ops, each reading its input and writing its output
    assert nbytes >= 3 * 2 * x.nbytes


def test_cost_model_views_move_no_bytes():
    """A slice, a view and a transpose are aliases: only the op that reads
    them counts, and only the elements the view holds."""
    x = torch.zeros(64, 1500, dtype=torch.uint8)
    _, nbytes = profiler.op_cost(lambda t: t[:, 750:].sum(), x)
    # sum reads 64 x 750 bytes and writes one int64
    assert nbytes == 64 * 750 + 8
    _, nbytes = profiler.op_cost(lambda t: t.t()[3:5], x)
    assert nbytes == 0
    # a batched matmul folds into one mm between a view and an
    # _unsafe_view of its result: only the mm's operands and result count
    a, w = torch.zeros(2, 8, 16), torch.zeros(16, 4)
    assert profiler.op_cost(lambda s, t: s @ t, a, w) == (
        2 * 16 * 16 * 4, (16 * 16 + 16 * 4 + 16 * 4) * 4)


def test_cost_model_refuses_a_kernel_launch(monkeypatch):
    """A kernel launched through ctypes is invisible to a dispatch mode, so
    a callable that moves ``_build``'s launch count is refused by name."""
    monkeypatch.setitem(_build._launches, "dfa_regex",
                        _build._launches["dfa_regex"])

    def launches(t):
        _build._launches["dfa_regex"] += 1
        return t + 1

    with pytest.raises(RuntimeError, match=r"\['dfa_regex'\]"):
        profiler.cost_model_latency(launches, torch.zeros(4))
    assert profiler.op_cost(lambda t: t + 1, torch.zeros(4)) == (0, 32)


def test_time_call_finishes_each_call():
    calls = []

    def fn(x):
        calls.append(x)
        return torch.ones(3)

    t = profiler._time_call(fn, 7, iters=3, warmup=2)
    assert len(calls) == 5 and t >= 0
