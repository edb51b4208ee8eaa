"""Port LM serving (planner, engine, serve entry point) held against the JAX
package.

* ``plan_serving`` gives the same replication factors R and pipeline count
  as the reference for the same latency dict, and the stage names agree;
  with ``pool=`` (``paper_cluster()`` or ``tpu_pod_pool()``) it places the
  replicas as the reference does (Algorithm 2).
* ``ServingEngine.run`` on reduced gemma3-1b, mamba2-370m, moonshot-v1-16b-a3b
  (MoE) and jamba-1.5-large-398b (hybrid), with
  the reference's ``init`` parameters carried across, completes the same
  requests in the same order with the same tokens. Greedy tokens may differ only where the choice was a
  near tie: the rule is that a request's tokens agree up to its first
  difference, and there the port's top-1/top-2 logit margin is under
  MARGIN_TOL = 2e-4, twice the logit tolerance of ``test_torch_lm.py``
  (1e-4, from f32 sums in other orders through 4 layers): a larger margin
  cannot be reordered by that error. After a difference the two runs feed
  the request different tokens, so its later tokens are not compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.core import pool as jpool
from repro.models import build as jbuild
from repro.serving import engine as jengine
from repro.serving import planner as jplanner
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import pool as pool_mod
from repro_torch.launch import serve
from repro_torch.models import build
from repro_torch.serving import engine, planner

MARGIN_TOL = 2e-4


@pytest.mark.parametrize("name,latencies", [
    ("gemma3-1b", [2.4e-3, 2.1e-4]),
    ("gemma3-1b", [1e-3, 1e-3]),
    ("olmo-1b", [5e-3]),
    ("mamba2-370m", [3e-3]),
    ("moonshot-v1-16b-a3b", [1e-4, 4e-3]),
    ("phi3.5-moe-42b-a6.6b", [2e-3]),
    ("jamba-1.5-large-398b", [6e-3]),
])
def test_plan_serving_equals_reference(name, latencies):
    jcfg, tcfg = ARCHS[name], get_arch(name)
    names = planner.segment_stage_names(tcfg)
    assert names == jplanner.segment_stage_names(jcfg)
    assert len(names) == len(latencies)
    lat = dict(zip(names, latencies))
    got = planner.plan_serving(build(tcfg, "cpu"), lat)
    want = jplanner.plan_serving(jbuild(jcfg), lat)
    assert got.R == want.R
    assert got.num_pipelines == want.num_pipelines
    assert got.throughput_gain == pytest.approx(want.throughput_gain)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("pool_fn", ["paper_cluster", "tpu_pod_pool"])
@pytest.mark.parametrize("name,latencies,unit", [
    ("gemma3-1b", [2.4e-3, 2.1e-4], None),
    ("gemma3-1b", [2.4e-3, 2.1e-4], [30.0, 55.0]),
    ("moonshot-v1-16b-a3b", [1e-4, 4e-3], [120.0, 7.5]),
    ("jamba-1.5-large-398b", [6e-3], None),
])
def test_plan_serving_pool_equals_reference(pool_fn, name, latencies, unit):
    """Algorithm 2 places each segment's R replicas over the pool: the
    same allocation (``A``, ``unmet``, ``bw_after``, ``bw_charge``) and
    placement lines as the reference's plan."""
    names = planner.segment_stage_names(get_arch(name))
    lat = dict(zip(names, latencies))
    t_s = dict(zip(names, unit)) if unit else None
    got = planner.plan_serving(build(get_arch(name), "cpu"), lat,
                               pool=getattr(pool_mod, pool_fn)(),
                               unit_throughput_gbps=t_s)
    want = jplanner.plan_serving(jbuild(ARCHS[name]), lat,
                                 pool=getattr(jpool, pool_fn)(),
                                 unit_throughput_gbps=t_s)
    ga, wa = got.allocation, want.allocation
    assert (ga.A, ga.unmet, ga.bw_after, ga.bw_charge) == \
        (wa.A, wa.unmet, wa.bw_after, wa.bw_charge)
    assert ga.units(names[0]) == got.R[names[0]]
    assert got.summary() == want.summary()
    assert " -> [" in got.summary()


def test_meili_serving_plan():
    """``test_system.py::test_meili_serving_plan``'s asserts on the port."""
    cfg = get_arch("jamba-1.5-large-398b").reduced().replace(remat=False)
    model = build(cfg, "cpu")
    plan = planner.plan_serving(model, {"seg0": 3.0e-3})
    assert plan.num_pipelines == 1
    assert plan.allocation is None
    plan = planner.plan_serving(model, {"enc": 2.0e-3, "dec": 0.9e-3})
    assert plan.R["enc"] == 3 and plan.R["dec"] == 1
    assert plan.throughput_gain > 1.5


def assert_tokens_agree(got, want, margin_tol):
    """``got``/``want``: requests in completion order. Same ids in the same
    order; each request's tokens equal up to a first difference, where the
    port's margin must be under ``margin_tol``. Returns the number of
    tokens compared."""
    assert [r.rid for r in got] == [r.rid for r in want]
    compared = 0
    for g, w in zip(got, want):
        assert len(g.out) == len(w.out) == len(g.margins)
        for i, (a, b) in enumerate(zip(g.out, w.out)):
            if a != b:
                assert g.margins[i] < margin_tol, (g.rid, i, g.margins[i])
                break
            compared += 1
    return compared


def _engines_agree(arch, pipelines, slots, requests):
    jcfg = ARCHS[arch].reduced().replace(remat=False)
    tcfg = get_arch(arch).reduced().replace(remat=False)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jnp.float32)
    params = convert.lm_params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, tcfg.vocab, size=4).tolist()
               for _ in range(requests)]
    max_new = [8 + (i % 5) for i in range(requests)]

    jeng = jengine.ServingEngine(jmodel, jparams, num_pipelines=pipelines,
                                 slots_per_pipeline=slots, max_len=40)
    eng = engine.ServingEngine(build(tcfg, "cpu"), params,
                               num_pipelines=pipelines,
                               slots_per_pipeline=slots, max_len=40)
    for i, p in enumerate(prompts):
        jeng.submit(jengine.Request(rid=i, prompt=p,
                                    max_new_tokens=max_new[i]))
        eng.submit(engine.Request(rid=i, prompt=p,
                                  max_new_tokens=max_new[i]))
    want = jeng.run(max_steps=32)
    got = eng.run(max_steps=32)
    assert len(got) == requests
    assert assert_tokens_agree(got, want, MARGIN_TOL) >= sum(max_new) // 2
    assert [p.cache["pos"] for p in eng.pipelines] == \
        [int(p.cache["pos"]) for p in jeng.pipelines]


@pytest.mark.parametrize("pipelines,slots,requests", [(1, 8, 16), (3, 4, 10)])
def test_engine_run_equals_reference(pipelines, slots, requests):
    _engines_agree("gemma3-1b", pipelines, slots, requests)


@pytest.mark.parametrize("pipelines,slots,requests", [(1, 8, 16), (3, 4, 10)])
def test_mamba_engine_run_equals_reference(pipelines, slots, requests):
    """Reduced mamba2-370m. Freed slots are reused without resetting their
    SSM state and conv tails, in both packages; tokens still agree."""
    _engines_agree("mamba2-370m", pipelines, slots, requests)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"])
def test_moe_and_hybrid_engine_run_equals_reference(arch):
    """Reduced moonshot (a dense segment, then attention + MoE layers) and
    reduced jamba (mamba, attention and MoE layers in one body); decode
    routes each step's tokens (T = B: capacity 128 a expert, no drops)."""
    _engines_agree(arch, 2, 4, 8)


@pytest.mark.parametrize("arch,stages", [
    ("moonshot-v1-16b-a3b", ["seg0[attn/mlp]x1", "seg1[attn/moe]x3"]),
    ("jamba-1.5-large-398b",
     ["seg0[attn/mlp+mamba/mlp+mamba/moe]x2"]),
])
def test_serve_moe_and_hybrid_on_cpu(capsys, arch, stages):
    """``launch.serve --arch <arch> --reduced --device cpu`` at the
    reference's defaults: the planner profiles each segment and the engine
    serves all 16 requests, 16 tokens each."""
    rep = serve.run(["--arch", arch, "--reduced", "--device", "cpu"])
    assert rep.plan.stages == stages
    assert rep.plan.stages == jplanner.segment_stage_names(
        ARCHS[arch].reduced())
    assert len(rep.done) == 16 and rep.tokens == 256
    assert "16/16 requests" in capsys.readouterr().out


def test_serve_main_on_cpu(capsys):
    """The serve entry point end to end on the CPU at the reference's
    defaults (reduced gemma3-1b): every request completes with its
    tokens."""
    rep = serve.run(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                     "--requests", "6", "--tokens", "5"])
    assert len(rep.done) == 6 and rep.tokens == 30
    assert rep.plan.num_pipelines >= 1
    out = capsys.readouterr().out
    assert "[serve] Meili plan:" in out and "6/6 requests" in out
    assert serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
                       "--requests", "2", "--tokens", "2"]) == 0


def test_serve_mamba_on_cpu(capsys):
    """``launch.serve --arch mamba2-370m --reduced --device cpu`` at the
    reference's defaults: the planner profiles the single mamba segment
    (Algorithm 1 gives R = 1, one pipeline) and the engine serves all 16
    requests, 16 tokens each."""
    rep = serve.run(["--arch", "mamba2-370m", "--reduced", "--device", "cpu"])
    assert rep.plan.stages == ["seg0[mamba/none]x4"]
    assert rep.plan.R == {"seg0[mamba/none]x4": 1}
    assert rep.plan.num_pipelines == 1
    assert len(rep.done) == 16 and rep.tokens == 256
    assert "16/16 requests" in capsys.readouterr().out


def test_segment_latencies_profile_every_layer_cache():
    """The per-segment profiler hands each layer its own cache slice, so it
    times a mamba segment (conv tails and SSM state) as it times attention
    segments: one positive latency per segment."""
    for arch in ("mamba2-370m", "gemma3-1b", "jamba-1.5-large-398b"):
        cfg = get_arch(arch).reduced().replace(remat=False)
        model = build(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(0), torch.float32)
        lat = serve.measure_segment_latencies(model, params, 2, 8)
        assert list(lat) == planner.segment_stage_names(cfg)
        assert all(v > 0 for v in lat.values())


def test_segment_latencies_of_a_bf16_model():
    """A bf16 model (as moonshot serves at full width) is profiled with
    bf16 activations, the dtype its decode steps carry."""
    cfg = get_arch("moonshot-v1-16b-a3b").reduced().replace(remat=False)
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16)
    lat = serve.measure_segment_latencies(model, params, 2, 8)
    assert list(lat) == planner.segment_stage_names(cfg)
    assert all(v > 0 for v in lat.values())


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(["--reduced"])
