"""The encoder-decoder and vlm families' partitioned steps (``launch/steps.py``
over a DeviceMesh: the encoder's and decoder's layers placed by their
blocks, cross-attention's q over the decoder's tokens and k/v over the
encoder's frames under ``local_map``, the frames and patches placed as
``("batch", "seq", "embed_act")``) held against the port's one-device
steps and the JAX package's jitted partitioned steps.

Reduced seamless-m4t-medium (2 encoder and 2 decoder layers, 4 query
heads over 2 KV heads: ``rules_for`` puts both on the model axis) and
reduced llava-next-34b (4 layers, 8 patch embeddings ahead of the
tokens), each with microbatch 2: one ``make_train_step`` step over 8 x 32
tokens (and 8 x 32 frames, or 8 x 8 patches), then a 4 x 32 prefill and 2
decode steps: seamless's from a zero 40-deep f32 cache (its prefill makes
none, as the reference's), llava's in its 48-deep prefilled one. Both
configs keep the reference's ``remat``, so every training body runs
checkpointed on both sides. The port runs over a (2, 2) gloo world of
spawned ranks with the functional collectives staged through the host,
as on the card (``_torch_ep_ranks.run_world`` with
``_torch_partition_ranks.encdec_case``); the reference in a subprocess
with four host devices on an Auto-axes (2, 2) mesh under the same rules,
as ``test_torch_partition.py``'s. The same numpy-seeded parameters (the
reference's init), frames, patches and tokens go to all three, held to
``test_torch_partition.py``'s ``TOL``.

A faulted world, the model-axis all-reduce after the first
cross-attention's output projection dropped, fails the gate.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ep_ranks as epr
import _torch_partition_ranks as pr
from repro.configs import ARCHS as JARCHS
from repro.models import build as jbuild
from repro_torch.configs import get_arch
from test_torch_partition import LR1, ROOT, TOL

REFERENCE_TIMEOUT_S = 300
WORLD_TIMEOUT_S = 240
WORLD = (2, 2)
B, S, PROMPTS, DECODE = 8, 32, 4, 2
SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-34b"
# (name, arch, rules, cache depth)
CASES = ((SEAMLESS, SEAMLESS, "auto", 40), (LLAVA, LLAVA, "auto", 48))
FAULT_CASE = SEAMLESS


def _inputs():
    """Each case's numpy parameters (the reference's init, f32), tokens,
    and frames or patches."""
    rng = np.random.default_rng(31)
    out = []
    for name, arch, rules, max_len in CASES:
        over = {"microbatch": 2}
        jmodel = jbuild(JARCHS[arch].reduced().replace(**over))
        params = jax.jit(lambda k: jmodel.init(k, jnp.float32)[0])(
            jax.random.PRNGKey(0))
        cfg = jmodel.cfg
        c = {"name": name, "arch": arch, "rules": rules, "cfg": over,
             "params": jax.tree.map(np.asarray, params),
             "train": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "prefill": rng.integers(0, cfg.vocab,
                                     (PROMPTS, S)).astype(np.int32),
             "decode": rng.integers(0, cfg.vocab,
                                    (DECODE, PROMPTS)).astype(np.int32),
             "max_len": max_len}
        for kind, rows in (("train", B), ("prefill", PROMPTS)):
            if cfg.family == "encdec":
                c[f"{kind}_frames"] = rng.standard_normal(
                    (rows, S, cfg.d_model)).astype(np.float32)
            else:
                c[f"{kind}_patches"] = rng.standard_normal(
                    (rows, cfg.frontend_tokens, cfg.d_model)).astype(
                        np.float32)
        out.append(c)
    return out


def _batch(c, kind):
    out = {"tokens": jnp.asarray(c[kind])}
    for k in pr.EMBEDS:
        if f"{kind}_{k}" in c:
            out[k] = jnp.asarray(c[f"{kind}_{k}"])
    return out


def _reference_main(in_path, out_path):
    """The reference's side, in a process of its own with four host
    devices: each case's jitted partitioned train step, prefill and decode
    steps on a (2, 2) mesh under its rules; the encoder-decoder's decode
    from ``init_cache``'s zero cache."""
    from jax.sharding import AxisType, NamedSharding, PartitionSpec
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch import steps as jsteps
    from repro.parallel import sharding as jsh
    from repro_torch import convert

    with open(in_path, "rb") as f:
        cases = pickle.load(f)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    out = {}
    for c in cases:
        cfg = JARCHS[c["arch"]].reduced().replace(**c["cfg"])
        model = jbuild(cfg)
        rules = jsh.rules_for(cfg, mesh)
        jsh.set_activation_sharding(rules, mesh)
        try:
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
            new_p, new_o, loss, gn = jstep(params, opt, _batch(c, "train"),
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
                p, b, max_len=c["max_len"], cache_dtype=jnp.float32),
                in_shardings=(p_shard, pb_shard))
            lg, cache = prefill(params, _batch(c, "prefill"))
            if cache is None:
                cache = model.init_cache(PROMPTS, c["max_len"],
                                         jnp.float32)[0]
            logits = [np.asarray(lg, np.float32)]
            serve = jax.jit(jsteps.make_serve_step(model))
            for t in c["decode"]:
                lg, cache = serve(params, cache, jnp.asarray(t))
                logits.append(np.asarray(lg, np.float32))
            res["logits"] = np.stack(logits)
        finally:
            jsh.set_activation_sharding(None, None)
        out[c["name"]] = res
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, started first, the port's world while
    it runs, and the port's one-device steps."""
    work = str(tmp_path_factory.mktemp("partition_encdec"))
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
    code = ("import sys, test_torch_partition_encdec as t; "
            "t._reference_main(sys.argv[1], sys.argv[2])")
    ref = subprocess.Popen([sys.executable, "-c", code, in_path, out_path],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        world = epr.run_world(
            "encdec", WORLD[0] * WORLD[1], WORLD[1],
            {"cases": cases, "fault_case": FAULT_CASE}, work,
            WORLD_TIMEOUT_S, module="_torch_partition_ranks")
        one = {c["name"]: pr.run_steps(
            get_arch(c["arch"]).reduced().replace(**c["cfg"]), c["params"],
            c, None, None) for c in cases}
        log, _ = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log[-4000:]
    with open(out_path, "rb") as f:
        return {"reference": pickle.load(f), "world": world, "one": one}


NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("name", NAMES)
def test_partitioned_encdec_and_vlm_steps_equal_one_device_steps(runs,
                                                                 name):
    """Every rank's whole results (its DTensors gathered) equal the
    one-device step's, and the ranks agree among themselves."""
    one = runs["one"][name]
    for r in runs["world"]:
        assert pr.compare(r[name], one, TOL) == [], (r["coords"], name)
        assert r[name]["accum"] == one["accum"] == 2
    np.testing.assert_array_equal(runs["world"][0][name]["logits"],
                                  runs["world"][-1][name]["logits"])


@pytest.mark.parametrize("name", NAMES)
def test_partitioned_encdec_and_vlm_steps_equal_reference_steps(runs, name):
    """The port's world against the reference's jitted step over (2, 2)."""
    got = runs["world"][0][name]
    assert pr.compare(got, runs["reference"][name], TOL) == []


def test_encdec_and_vlm_collectives_follow_the_mesh(runs):
    """The steps' collectives run on both axes of the (2, 2) mesh
    (reduce-scatters of the FSDP'd gradients, all-gathers of the weights
    at use), staged through the host."""
    for r in runs["world"]:
        assert r["axes"] == {"data": WORLD[0], "model": WORLD[1]}
        for name in NAMES:
            c = r[name]["collectives_train"]
            assert c["total"] == sum(c["by_axis"].values()) > 0
            assert c["all-gather"] > 0 and c["reduce-scatter"] > 0
            assert c["by_axis"].get("data", 0) > 0, (name, c["by_axis"])
            assert c["by_axis"].get("model", 0) > 0, (name, c["by_axis"])
        assert r["staged"]["host_copy_bytes"] > 0
        assert r["staged"]["all_gather_calls"] > 0


def test_faulted_cross_attention_world_is_rejected(runs):
    """Dropping the model-axis all-reduce after cross-attention's output
    projection (its heads split over the model axis) parts the train
    step's loss from the one-device step's past the gate, on every
    rank."""
    for r in runs["world"]:
        f = r["fault"]
        assert f["name"] == FAULT_CASE and f["dropped"] == 1
        bad = pr.compare(f, runs["one"][FAULT_CASE], TOL,
                         keys=("loss", "grad_norm"))
        assert bad and bad[0].startswith("loss"), (r["coords"], bad)
