"""The port's partitioned steps (``launch/steps.py`` over a DeviceMesh, the
parameters, AdamW state, batch and cache DTensors placed by the resolver,
the kernels under ``local_map``) held against the port's one-device steps
and the JAX package's jitted partitioned steps.

Reduced olmo-1b (under ``rules_for``: full tensor parallelism on a (2, 2)
mesh, data parallelism on (4, 1)), gemma3-1b under ``dp_heavy_rules``
(the batch over data x model, the weights gathered at use) and
mamba2-370m (``rules_for``: the inner dim over model, so B7 takes half
the heads a rank), each with microbatch 2 (two microbatches of 4 x 32):
one ``make_train_step`` step, then a 4 x 32 prefill into a 40-deep f32
cache and 2 decode steps. The port runs over gloo worlds of spawned ranks
(``_torch_ep_ranks.run_world`` with ``_torch_partition_ranks``' cases),
the (2, 2) world with the functional collectives staged through the host
as on the card (``collectives.stage_through_host``), the (4, 1) world on
gloo's own; the reference runs in a subprocess with four host devices on
an Auto-axes (2, 2) mesh under the same rules (``jax.jit`` with the
shardings of its ``build_shardings``, ``batch_shardings`` and
``opt_state_struct_and_sharding``), as ``tests/test_torch_ep.py`` does.
The same numpy-seeded parameters (the reference's init) and tokens go to
all three.

Tolerances, from the arithmetic (``test_torch_train.py``'s): the ranks
compute the one-device step's products over blocks, so f32 sums in other
orders. The loss and grad norm are held to atol = rtol = 1e-5, AdamW's
moments (linear in the gradients) to atol 1e-5, rtol 1e-4, the logits to
``test_torch_lm.py``'s 1e-4; the parameters move by lr · u, u a function
of the gradient's sign where |g| >> eps, so every entry is held to twice
the bound on one step (2 lr · 0.1 / sqrt(0.05)) and all but a share of
1e-3 to atol 1e-5, rtol 1e-4. The reference computes its SSD by the
step-by-step recurrence (``impl="ref"``; its blocked SSD is what
``test_torch_lm.py`` avoids) and its attention blocked.

A faulted partition (the first model-axis all-reduce dropped) fails the
gate; attention whose sequence the rules split runs; every family's
parameters are placed (the encdec and vlm families' steps are
``test_torch_partition_encdec.py``'s).
"""
import os
import pickle
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate

import _torch_ep_ranks as epr
import _torch_partition_ranks as pr
from repro.configs import ARCHS as JARCHS
from repro.models import build as jbuild
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.mesh import MeshShape, fake_mesh
from repro_torch.launch.steps import build_shardings
from repro_torch.models import build
from repro_torch.models.registry import PARTITIONED_FAMILIES
from repro_torch.parallel.sharding import rules_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_TIMEOUT_S = 300
WORLD_TIMEOUT_S = 240
B, S, PROMPTS, MAX_LEN, DECODE = 8, 32, 4, 40, 2
# (arch, rules, config overrides)
ARCH_CASES = (("olmo-1b", "auto", {"microbatch": 2}),
              ("gemma3-1b", "dp_heavy", {"microbatch": 2}),
              ("mamba2-370m", "auto", {"microbatch": 2, "remat": False}))
WORLDS = {(2, 2): True, (4, 1): False}     # world -> staged through host
LR1 = 1e-2
TOL = {"loss": (1e-5, 1e-5), "logits": (1e-4, 1e-4),
       "moments": (1e-5, 1e-4),
       "param_bound": 2 * LR1 * 0.1 / np.sqrt(0.05) * 1.001,
       "param_tol": (1e-5, 1e-4), "param_share": 1e-3}


def _inputs():
    """Each arch's numpy parameters (the reference's init, f32) and
    tokens."""
    rng = np.random.default_rng(29)
    out = []
    for arch, rules, over in ARCH_CASES:
        jmodel = jbuild(JARCHS[arch].reduced().replace(**over))
        params = jax.jit(lambda k: jmodel.init(k, jnp.float32)[0])(
            jax.random.PRNGKey(0))
        V = jmodel.cfg.vocab
        out.append({
            "arch": arch, "rules": rules, "cfg": over,
            "params": jax.tree.map(np.asarray, params),
            "train": rng.integers(0, V, (B, S)).astype(np.int32),
            "prefill": rng.integers(0, V, (PROMPTS, S)).astype(np.int32),
            "decode": rng.integers(0, V, (DECODE, PROMPTS)).astype(np.int32),
            "max_len": MAX_LEN})
    return out


def _reference_main(in_path, out_path):
    """The reference's side, in a process of its own with four host
    devices: each arch's jitted partitioned train step, prefill and decode
    steps on a (2, 2) mesh under its rules."""
    from jax.sharding import AxisType, NamedSharding, PartitionSpec
    from repro.kernels import ops as jops
    from repro.launch import steps as jsteps
    from repro.parallel import sharding as jsh
    from repro_torch import convert

    with open(in_path, "rb") as f:
        cases = pickle.load(f)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    out = {}
    default_impl = jops.default_impl
    for c in cases:
        cfg = JARCHS[c["arch"]].reduced().replace(**c["cfg"])
        model = jbuild(cfg)
        rules = jsh.rules_for(cfg, mesh) if c["rules"] == "auto" else \
            jsh.dp_heavy_rules()
        jops.default_impl = (lambda: "ref") if cfg.family == "ssm" else \
            default_impl
        jsh.set_activation_sharding(rules, mesh)
        try:
            from repro.configs.base import ShapeConfig as JShape
            shape = JShape("t", S, B, "train")
            p_struct, p_shard, _ = jsteps.build_shardings(model, mesh, rules,
                                                          jnp.float32)
            _, b_shard = jsteps.batch_shardings(model, shape, mesh, rules)
            step, opt_init = jsteps.make_train_step(
                model, shape, mesh, rules, base_lr=LR1, warmup=1,
                total_steps=10)
            _, o_shard = jsteps.opt_state_struct_and_sharding(
                model, mesh, p_shard, p_struct, jnp.float32)
            sc = NamedSharding(mesh, PartitionSpec())
            params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]),
                                    p_shard)
            opt = jax.device_put(opt_init(params), o_shard)
            jstep = jax.jit(step, in_shardings=(p_shard, o_shard, b_shard,
                                                sc),
                            out_shardings=(p_shard, o_shard, sc, sc))
            new_p, new_o, loss, gn = jstep(
                params, opt, {"tokens": jnp.asarray(c["train"])},
                jnp.int32(1))
            named = lambda t: {k: v.float().numpy() for k, v in
                               convert.lm_named_from_jax(
                                   cfg, jax.tree.map(np.asarray, t),
                                   "cpu").items()}
            res = {"loss": float(loss), "grad_norm": float(gn),
                   "params": named(new_p), "mu": named(new_o.mu),
                   "nu": named(new_o.nu)}
            pshape = JShape("p", S, PROMPTS, "prefill")
            _, pb_shard = jsteps.batch_shardings(model, pshape, mesh, rules)
            prefill = jax.jit(lambda p, b: model.prefill(
                p, b, max_len=MAX_LEN, cache_dtype=jnp.float32),
                in_shardings=(p_shard, pb_shard))
            lg, cache = prefill(params, {"tokens": jnp.asarray(
                c["prefill"])})
            logits = [np.asarray(lg, np.float32)]
            serve = jax.jit(jsteps.make_serve_step(model))
            for t in c["decode"]:
                lg, cache = serve(params, cache, jnp.asarray(t))
                logits.append(np.asarray(lg, np.float32))
            res["logits"] = np.stack(logits)
        finally:
            jsh.set_activation_sharding(None, None)
            jops.default_impl = default_impl
        out[c["arch"]] = res
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, started first, the port's two worlds
    side by side while it runs, and the port's one-device steps."""
    work = str(tmp_path_factory.mktemp("partition"))
    cases = _inputs()
    in_path = os.path.join(work, "reference.in.pkl")
    out_path = os.path.join(work, "reference.out.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    code = ("import sys, test_torch_partition as t; "
            "t._reference_main(sys.argv[1], sys.argv[2])")
    ref = subprocess.Popen([sys.executable, "-c", code, in_path, out_path],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    port, errors = {}, []

    def world(w, stage):
        try:
            port[w] = epr.run_world(
                "steps", w[0] * w[1], w[1], {"archs": cases, "stage": stage},
                work, WORLD_TIMEOUT_S, module="_torch_partition_ranks")
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)
    try:
        threads = [threading.Thread(target=world, args=(w, st))
                   for w, st in WORLDS.items()]
        for t in threads:
            t.start()
        one = {c["arch"]: pr.run_steps(
            get_arch(c["arch"]).reduced().replace(**c["cfg"]), c["params"],
            c, None, None) for c in cases}
        for t in threads:
            t.join()
        log, _ = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    if errors:
        raise errors[0]
    assert ref.returncode == 0, log[-4000:]
    with open(out_path, "rb") as f:
        return {"reference": pickle.load(f), "port": port, "one": one}


CELLS = [pytest.param(w, a, id=f"{w[0]}x{w[1]}-{a}")
         for w in WORLDS for a, _, _ in ARCH_CASES]


@pytest.mark.parametrize("world,arch", CELLS)
def test_partitioned_steps_equal_one_device_steps(runs, world, arch):
    """Every rank's whole results (its DTensors gathered) equal the
    one-device step's, and the ranks agree among themselves."""
    ranks = runs["port"][world]
    one = runs["one"][arch]
    for r in ranks:
        assert pr.compare(r[arch], one, TOL) == [], (r["coords"], arch)
        assert r[arch]["accum"] == one["accum"] == 2
    np.testing.assert_array_equal(ranks[0][arch]["logits"],
                                  ranks[-1][arch]["logits"])


@pytest.mark.parametrize("world,arch", CELLS)
def test_partitioned_steps_equal_reference_partitioned_steps(runs, world,
                                                             arch):
    """The port's world against the reference's jitted step over (2, 2)."""
    got = runs["port"][world][0][arch]
    assert pr.compare(got, runs["reference"][arch], TOL) == []


@pytest.mark.parametrize("world", list(WORLDS))
def test_collectives_follow_the_mesh(runs, world):
    """The steps' collectives run on the mesh's axes: over (2, 2) on both
    (reduce-scatters of the FSDP'd gradients, all-gathers of the weights
    at use), over (4, 1) on data alone (the model axis has one rank); the
    staged world moved its bytes through the host."""
    d, m = world
    for r in runs["port"][world]:
        assert r["axes"] == {"data": d, "model": m}
        for arch, _, _ in ARCH_CASES:
            c = r[arch]["collectives_train"]
            assert c["total"] == sum(c["by_axis"].values()) > 0
            assert c["all-gather"] > 0 and c["reduce-scatter"] > 0
            assert c["by_axis"].get("data", 0) > 0, (arch, c["by_axis"])
            assert (c["by_axis"].get("model", 0) > 0) == (m > 1), \
                (arch, c["by_axis"])
        staged = r["staged"]
        if WORLDS[world]:
            assert staged["host_copy_bytes"] > 0
            assert staged["all_gather_calls"] > 0
        else:
            assert not staged


def test_faulted_partition_is_rejected(runs):
    """Dropping the first model-axis all-reduce (the attention output's
    sum over the model axis's heads) parts the loss from the one-device
    step's past the gate, on every rank."""
    for r in runs["port"][(2, 2)]:
        f = r["fault"]
        assert f["dropped"] == 1
        bad = pr.compare({"loss": f["loss"]}, runs["one"][f["arch"]], TOL,
                         keys=("loss",))
        assert bad and bad[0].startswith("loss")


def test_split_sequences_and_moe_are_refused(runs):
    """Reduced gemma3-1b's one kv head does not divide a 2-way model axis,
    so ``rules_for`` puts the sequence there: the prefill runs
    sequence-parallel attention (``test_torch_partition_seq.py`` holds
    those steps to the reference's) and its logits equal the (4, 1)
    mesh's, whose ranks hold whole sequences. No layout and no family is
    refused any more: the encdec and vlm families' parameters are placed
    on a fake (2, 2) mesh as the resolver gives them (their steps:
    ``test_torch_partition_encdec.py``); the MoE family's are
    (``test_torch_partition_moe.py``)."""
    whole = runs["port"][(4, 1)][0]["refusal"]["logits"]
    for w in WORLDS:
        for r in runs["port"][w]:
            assert r["refusal"]["error"] is None
            np.testing.assert_allclose(r["refusal"]["logits"], whole,
                                       atol=TOL["logits"][0],
                                       rtol=TOL["logits"][1])
    assert set(PARTITIONED_FAMILIES) == {get_arch(a).family for a in ARCHS}
    desc = MeshShape(("data", "model"), (2, 2))
    for arch in ("seamless-m4t-medium", "llava-next-34b"):
        model = build(get_arch(arch).reduced(), "meta")
        rules = rules_for(model.cfg, desc)
        _, want, _ = build_shardings(model, desc, rules)
        with fake_mesh(desc) as mesh:
            params = model.distribute(model.param_struct(torch.float32),
                                      mesh, rules)
            placed = {k: tuple(p.placements)
                      for k, p in params.named_parameters()}
        assert placed == want
        assert any(pl != (Replicate(), Replicate())
                   for pl in placed.values())
