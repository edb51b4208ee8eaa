"""The port's expert-parallel MoE paths (``models/moe.py`` over
``parallel/collectives.py``) held against the JAX package's ``shard_map``
paths on a CPU mesh.

The reference runs in a subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``; another test file
may already have initialised JAX in this process) on meshes built with
Auto axis types, as ``jax.make_mesh`` made them before Explicit axes
became its default. Calls run under ``jax.jit``, as its launchers run
them (an eager ``shard_map`` call takes ~8 s here; a path is counted when
it is traced), with ``--xla_allow_excess_precision=false``: XLA then
rounds every bf16 op as eager JAX and the port do, where its fusions would
keep f32 in between. The port runs over gloo worlds of spawned ranks
(``_torch_ep_ranks.py``), one process a rank, each holding its block of
the tokens. The same numpy-seeded inputs go to both.

* ``_dispatch_local`` and ``_combine_local`` bit for bit, f32 and bf16,
  with a top-k tie and drops past capacity: the slots' tokens and the
  combine exactly, the slots' gates within two f32 ulps (each framework's
  softmax rounds its exp otherwise).
* ``moe_ffn`` under ``dp_heavy_rules()`` over (2, 2) and (1, 4) worlds
  (batch over data x model; on (1, 4) the sequence over model): both
  packages take ``_moe_ep``. A case where every token prefers one expert
  binds the per-rank capacity: it equals the reference's EP and differs
  from the one-device ``moe_ffn``.
* ``default_rules()`` over (2, 2), and a decode step under
  ``dp_heavy_rules()``: the global dispatch, whose expert products run as
  the rank's (E/m, C/d, D) block (the reference's ``shard_map`` branch of
  ``_expert_matmuls``).
* The decision on the global shape: global B = 4 over four ranks is a
  local B = 1, whose spec alone would not cover both axes.
* The reduced moonshot prefill over a (1, 2) world against the
  reference's under the same mesh and rules.
* The one-process emulation that is the card's oracle against the
  reference.

Tolerances are ``test_torch_moe.py``'s for the FFN (f32 atol = rtol =
1e-5, bf16 2**-6 on tokens whose routes agree; a route may differ only at
a near tie) and ``test_torch_lm.py``'s for the prefill's logits (1e-4).
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ep_ranks as ranks
from repro.configs import ARCHS
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro_torch.models import moe
from repro_torch.parallel import sharding as sh

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2.0 ** -6, rtol=2.0 ** -6)
ROUTE_MARGIN = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
LM_TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_TIMEOUT_S = 240
WORLD_TIMEOUT_S = 150


def _cfg(E, k):
    return ARCHS[ranks.ARCH].reduced().replace(n_experts=E, top_k=k)


def _params(rng, E, D, F):
    s = 1.0 / np.sqrt(D)
    return {"router": (rng.standard_normal((D, E)) * s).astype(np.float32),
            "gate": (rng.standard_normal((E, D, F)) * s).astype(np.float32),
            "up": (rng.standard_normal((E, D, F)) * s).astype(np.float32),
            "down": (rng.standard_normal((E, F, D)) / np.sqrt(F)
                     ).astype(np.float32)}


def _case(name, E, k, B, S, dtype="float32", rules="dp_heavy", seed=0,
          prefer_first=False):
    """One moe_ffn case: numpy parameters and tokens. ``prefer_first``:
    tokens of -1, 0 and 1 halves, a router in eighths whose first row
    sends every token to expert 0 first (exact logits, so no near ties),
    and capacity binds."""
    cfg = _cfg(E, k)
    rng = np.random.default_rng(seed)
    p = _params(rng, E, cfg.d_model, cfg.d_ff)
    if prefer_first:
        x = (rng.integers(-1, 2, size=(B, S, cfg.d_model)) * 0.5
             ).astype(np.float32)
        x[..., 0] = 1.0
        p["router"] = rng.integers(-2, 3, size=(cfg.d_model, E)).astype(
            np.float32) / 8
        p["router"][0] = 0.0
        p["router"][0, 0] = 8.0
    else:
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return {"name": name, "cfg": {"n_experts": E, "top_k": k},
            "rules": rules, "dtype": dtype, "params": p, "x": x}


WORLDS = {
    (2, 2): [_case("ep_f32", 8, 3, 4, 24),
             _case("ep_bf16", 8, 3, 4, 24, "bfloat16"),
             _case("bind", 4, 2, 4, 200, seed=1, prefer_first=True),
             _case("default", 8, 2, 4, 24, rules="default", seed=2),
             _case("decode", 8, 2, 2, 1, seed=3)],
    (1, 4): [_case("ep_f32", 8, 2, 2, 24, seed=4),
             _case("ep_bf16", 8, 2, 2, 24, "bfloat16", seed=4),
             _case("bind", 4, 2, 4, 200, seed=5, prefer_first=True)],
}
EP_CASES = [pytest.param(w, c["name"], id=f"{w[0]}x{w[1]}-{c['name']}")
            for w, cs in WORLDS.items() for c in cs
            if c["name"] not in ("default", "decode")]
PREFILL = {"B": 2, "S": 16, "rules": "dp_heavy", "world": (1, 2)}


def _prefill_inputs():
    jmodel = jbuild(ARCHS[ranks.ARCH].reduced())
    jparams = jax.jit(lambda key: jmodel.init(key, jnp.float32)[0])(
        jax.random.PRNGKey(0))
    tokens = np.random.default_rng(6).integers(
        0, jmodel.cfg.vocab, size=(PREFILL["B"], PREFILL["S"])).astype(
            np.int32)
    return {"params": jax.tree.map(np.asarray, jparams), "tokens": tokens,
            "rules": PREFILL["rules"]}


def _reference_main(in_path, out_path):
    """The reference's side, in a process of its own with four host
    devices: each case's ``moe_ffn`` under its mesh and rules and without
    a mesh, the prefill under its mesh, and which paths were taken."""
    import jax.experimental.shard_map as jsm
    from jax.sharding import AxisType
    from repro.parallel import sharding as jsh

    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    seen = {"ep": 0, "shard_map": 0}
    ep, shard_map = jmoe._moe_ep, jsm.shard_map

    def count_ep(*a, **k):
        seen["ep"] += 1
        return ep(*a, **k)

    def count_shard_map(*a, **k):
        seen["shard_map"] += 1
        return shard_map(*a, **k)
    jmoe._moe_ep, jsm.shard_map = count_ep, count_shard_map

    def mesh(d, m):
        return jax.make_mesh((d, m), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:d * m])

    def run(fn):
        seen.update(ep=0, shard_map=0)
        out = fn()
        return out, dict(seen)
    rules = {"dp_heavy": jsh.dp_heavy_rules, "default": jsh.default_rules}
    out = {}
    for world, cases in inp["moe"].items():
        for c in cases:
            cfg = _cfg(c["cfg"]["n_experts"], c["cfg"]["top_k"])
            dt = getattr(jnp, c["dtype"])
            p = {k: jnp.asarray(v).astype(dt) for k, v in c["params"].items()}
            x = jnp.asarray(c["x"]).astype(dt)
            # a function of its own for each call: jit caches the trace,
            # which read the installed mesh
            ffn = lambda: jax.jit(lambda p, x: jmoe.moe_ffn(p, x, cfg))
            jsh.set_activation_sharding(rules[c["rules"]](), mesh(*world))
            try:
                y, paths = run(lambda: ffn()(p, x))
            finally:
                jsh.set_activation_sharding(None, None)
            y1 = ffn()(p, x)
            out[world, c["name"]] = {
                "y": np.asarray(y.astype(jnp.float32)),
                "one_device": np.asarray(y1.astype(jnp.float32)), **paths}
    pre = inp["prefill"]
    jmodel = jbuild(ARCHS[ranks.ARCH].reduced())
    prefill = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, max_len=PREFILL["S"], impl="blocked")[0])
    jsh.set_activation_sharding(rules[pre["rules"]](), mesh(*PREFILL["world"]))
    try:
        lg, paths = run(lambda: prefill(jax.tree.map(jnp.asarray,
                                                     pre["params"]),
                                        jnp.asarray(pre["tokens"])))
    finally:
        jsh.set_activation_sharding(None, None)
    out["prefill"] = {"logits": np.asarray(lg, np.float32), **paths}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, started first, and the port's three
    gloo worlds while it runs."""
    work = str(tmp_path_factory.mktemp("ep"))
    prefill = _prefill_inputs()
    in_path = os.path.join(work, "reference.in.pkl")
    out_path = os.path.join(work, "reference.out.pkl")
    with open(in_path, "wb") as f:
        pickle.dump({"moe": WORLDS, "prefill": prefill}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    code = ("import sys, test_torch_ep as t; "
            "t._reference_main(sys.argv[1], sys.argv[2])")
    ref = subprocess.Popen([sys.executable, "-c", code, in_path, out_path],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        port = {world: ranks.run_world("moe", world[0] * world[1], world[1],
                                       cases, work, WORLD_TIMEOUT_S)
                for world, cases in WORLDS.items()}
        port["prefill"] = ranks.run_world(
            "prefill", 2, 2, prefill, work, WORLD_TIMEOUT_S)
        log, _ = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log[-4000:]
    with open(out_path, "rb") as f:
        return {"reference": pickle.load(f), "port": port}


def _assemble(world, name, results):
    """The global output from the ranks' blocks."""
    case = next(c for c in WORLDS[world] if c["name"] == name)
    out = np.full(case["x"].shape, np.nan, np.float32)
    for r in results:
        spec = r[name]["spec"]
        g = ranks.Grid(*world, (r["coords"]["data"], r["coords"]["model"]))
        sh.block(torch.from_numpy(out), spec, g).copy_(
            torch.from_numpy(r[name]["y"]))
    return out, case


def _agree(case):
    """Tokens whose routes the two packages choose alike, or whose k-th
    and (k+1)-th probabilities are within the dtype's margin: (B, S)."""
    cfg = _cfg(case["cfg"]["n_experts"], case["cfg"]["top_k"])
    T = case["x"].shape[0] * case["x"].shape[1]
    dt = case["dtype"]
    x = jnp.asarray(case["x"]).astype(getattr(jnp, dt)).reshape(T, -1)
    probs = jax.nn.softmax((x @ jnp.asarray(case["params"]["router"]).astype(
        getattr(jnp, dt))).astype(jnp.float32), axis=-1)
    _, ids = jax.lax.top_k(probs, cfg.top_k)
    xt = torch.from_numpy(case["x"]).to(getattr(torch, dt)).reshape(T, -1)
    r = torch.from_numpy(case["params"]["router"]).to(getattr(torch, dt))
    _, _, tids = moe.route({"router": r}, xt, cfg)
    same = (np.sort(tids.numpy(), -1) == np.sort(np.asarray(ids), -1)).all(-1)
    s = -np.sort(-np.asarray(probs), axis=-1)
    near = s[:, cfg.top_k - 1] - s[:, cfg.top_k] <= ROUTE_MARGIN[dt]
    assert (same | near).all()
    return same.reshape(case["x"].shape[:2])


# -- _dispatch_local and _combine_local ---------------------------------------

def _exact_case(dtype, tie):
    """200 tokens over E 4, top-2 (C 128): every token prefers expert 0,
    so 72 of its slots drop; with ``tie`` router columns 1 and 2 are equal
    and every second choice ties, taken by expert 1."""
    cfg = _cfg(4, 2)
    rng = np.random.default_rng(7 + tie)
    router = rng.integers(-2, 3, size=(cfg.d_model, 4)).astype(np.float32) / 8
    if tie:
        router[:, 2] = router[:, 1]
        router[0] = [8.0, 0.0, 0.0, -8.0]
    else:
        router[0] = [8.0, 0.0, 0.0, 0.0]
    x = (rng.integers(-1, 2, size=(200, cfg.d_model)) * 0.5).astype(
        np.float32)
    x[:, 0] = 1.0
    return cfg, x, router


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_local_equals_reference_bit_for_bit(dtype, tie):
    cfg, x, router = _exact_case(dtype, tie)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jr = jnp.asarray(router).astype(getattr(jnp, dtype))
    want = [np.asarray(a) for a in jmoe._dispatch_local(jx, jr, cfg)]
    got = [t for t in moe._dispatch_local(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(router).to(getattr(torch, dtype)), cfg)]
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  want[0].astype(np.float32))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    # the gates come from each framework's f32 softmax, whose exp rounds
    # otherwise: two ulps
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=2.0 ** -22,
                               atol=0)
    np.testing.assert_array_equal(got[2].numpy() == 0, want[2] == 0)
    src = want[1].reshape(4, -1)
    assert (src[0] > 0).all()                      # expert 0 full: drops
    if tie:                    # expert 1 takes every tie and is full too
        assert (src[1] > 0).all() and (src[2] == 0).all()
    assert 200 * 2 - int((want[1] > 0).sum()) == (144 if tie else 72)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_local_equals_reference_bit_for_bit(dtype):
    """The reference's scatter-add of gate-weighted slots and the port's
    fixed-order gather, on the same slots, outputs and gates."""
    cfg, x, router = _exact_case(dtype, True)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    _, src, gate_slot = jmoe._dispatch_local(
        jx, jnp.asarray(router).astype(getattr(jnp, dtype)), cfg)
    ye = np.random.default_rng(9).standard_normal(
        (src.shape[0], cfg.d_model)).astype(np.float32)
    want = jmoe._combine_local(jnp.asarray(ye).astype(getattr(jnp, dtype)),
                               src, gate_slot, 200, cfg.d_model)
    got = moe._combine_local(
        torch.from_numpy(ye).to(getattr(torch, dtype)),
        torch.from_numpy(np.asarray(src)),
        torch.from_numpy(np.asarray(gate_slot)), 200, cfg.d_model,
        cfg.top_k)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# -- moe_ffn over gloo worlds ------------------------------------------------

def test_worlds_build_the_reference_meshes(runs):
    for world in WORLDS:
        got = runs["port"][world]
        assert [r["axes"] for r in got] == [
            {"data": world[0], "model": world[1]}] * len(got)
        assert sorted((r["coords"]["data"], r["coords"]["model"])
                      for r in got) == [(i, j) for i in range(world[0])
                                        for j in range(world[1])]


@pytest.mark.parametrize("world,name", EP_CASES)
def test_moe_ep_equals_reference_shard_map(runs, world, name):
    want = runs["reference"][world, name]
    got, case = _assemble(world, name, runs["port"][world])
    assert want["ep"] == 1
    for r in runs["port"][world]:
        assert r[name]["ep"] == 1 and r[name]["dtype"] == \
            f"torch.{case['dtype']}"
        cfg = _cfg(case["cfg"]["n_experts"], case["cfg"]["top_k"])
        m = world[1]
        (shape,) = r[name]["products"]              # (E/m, m·C_l, D)
        assert shape[0] == cfg.n_experts // m and shape[1] % m == 0
        assert r[name]["collectives"]["all_to_all_calls"] == 2
    keep = _agree(case)
    tol = TOL if case["dtype"] == "float32" else BF16_TOL
    np.testing.assert_allclose(got[keep], want["y"][keep], **tol)
    if case["dtype"] == "float32":
        assert keep.all()


@pytest.mark.parametrize("world", sorted(WORLDS),
                         ids=lambda w: f"{w[0]}x{w[1]}")
def test_binding_capacity_follows_the_ranks_not_one_device(runs, world):
    """Per-rank capacity 128 over 200 tokens that all prefer expert 0:
    each rank drops its own 72, where one device of 800 tokens at
    capacity 512 drops 288 others. The port equals the reference's EP and
    differs from the one-device path as the reference does."""
    want = runs["reference"][world, "bind"]
    got, _ = _assemble(world, "bind", runs["port"][world])
    np.testing.assert_allclose(got, want["y"], **TOL)
    apart = np.abs(want["y"] - want["one_device"]).max(-1) > 1e-3
    assert apart.any()
    np.testing.assert_array_equal(
        np.abs(got - want["one_device"]).max(-1) > 1e-3, apart)


@pytest.mark.parametrize("name", ["default", "decode"])
def test_global_dispatch_takes_the_expert_block_branch(runs, name):
    """default_rules(), and a decode step under dp_heavy_rules(): tokens
    split over data only, so both packages take the global dispatch, whose
    products run as the rank's (E/m, C/d, D) block with gathered weights
    (the reference's ``shard_map`` branch of ``_expert_matmuls``)."""
    world = (2, 2)
    want = runs["reference"][world, name]
    got, case = _assemble(world, name, runs["port"][world])
    assert want["ep"] == 0 and want["shard_map"] == 1
    cfg = _cfg(case["cfg"]["n_experts"], case["cfg"]["top_k"])
    B, S = case["x"].shape[:2]
    C = moe._capacity(B * S, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    for r in runs["port"][world]:
        assert r[name]["ep"] == 0
        assert r[name]["products"] == [(cfg.n_experts // 2, C // 2,
                                        cfg.d_model)]
        assert r[name]["collectives"].get("all_to_all_calls", 0) == 0
    assert _agree(case).all()
    np.testing.assert_allclose(got, want["y"], **TOL)
    np.testing.assert_allclose(got, want["one_device"], **TOL)


def test_decision_is_made_on_the_global_shape(runs):
    """Global B = 4 over a (2, 2) mesh puts the batch on data x model: EP.
    A rank's block is B = 1, whose own spec would put the batch nowhere
    and the sequence on model, and the global path. Both packages take
    EP; a tensor that is not the installed tokens' block raises."""
    rules, grid = sh.dp_heavy_rules(), ranks.Grid(2, 2)
    flat = lambda spec: {a for e in spec[:2] for a in sh.entry_axes(e)}
    assert flat(sh.token_spec((4, 24, 64), rules, grid)) == {"data", "model"}
    assert flat(sh.token_spec((1, 24, 64), rules, grid)) == {"model"}
    assert runs["reference"][(2, 2), "ep_f32"]["ep"] == 1
    for r in runs["port"][(2, 2)]:
        assert r["ep_f32"]["spec"][0] == ("data", "model")
        assert r["ep_f32"]["ep"] == 1
        assert r["mismatch"] == "ValueError"


@pytest.mark.parametrize("world,name", [
    pytest.param(w, n, id=f"{w[0]}x{w[1]}-{n}")
    for w in ((2, 2), (1, 4)) for n in ("ep_f32", "bind")])
def test_emulation_equals_reference_shard_map(runs, world, name):
    """The one-process emulation of the ranks, the card's oracle."""
    case = next(c for c in WORLDS[world] if c["name"] == name)
    cfg = _cfg(case["cfg"]["n_experts"], case["cfg"]["top_k"])
    p = ranks.tensors(case["params"], "float32", "cpu")
    out, src, drops = ranks.emulate_ep(p, torch.from_numpy(case["x"]), cfg,
                                       sh.dp_heavy_rules(), *world)
    np.testing.assert_allclose(out.numpy(), runs["reference"][world, name][
        "y"], **TOL)
    assert sorted(src) == [(i, j) for i in range(world[0])
                           for j in range(world[1])]
    assert all(d == (72 if name == "bind" else 0) for d in drops.values())


def test_prefill_over_two_ranks_equals_reference(runs):
    """Reduced moonshot (a dense layer, 3 MoE layers) prefilled over a
    (1, 2) world under dp_heavy_rules(): each rank one prompt, every MoE
    layer through ``_moe_ep`` in both packages."""
    want = runs["reference"]["prefill"]
    got = sorted(runs["port"]["prefill"], key=lambda r: r["coords"]["model"])
    assert want["ep"] == 1         # traced once: a scan over the layers
    assert [r["ep"] for r in got] == [3, 3]
    assert [r["logits"].shape[0] for r in got] == [1, 1]
    np.testing.assert_allclose(np.concatenate([r["logits"] for r in got]),
                               want["logits"], **LM_TOL)
