"""The partitioned steps over a sequence split across ranks (the rules put
``seq`` and ``kv_seq`` on the model axis): sequence-parallel attention,
decode over a sequence-sharded cache, and the SSD and conv over a split
sequence, held against the port's one-device steps and the JAX package's
jitted partitioned steps under the same rule tables.

The reduced configs have 4 heads and 1 or 2 kv heads, so on a (2, 2)
world ``rules_for`` splits no sequence; each case names its table:

* reduced gemma3-1b under ``dp_heavy_rules()``, 2 sequences a train step
  (the batch cannot cover data x model: the sequence goes over the model
  axis), a 2-prompt prefill into a cache as deep as the prompt, so its
  blocks are the prompt's and the decode steps run at pos >= S (the
  write clamped to S - 1, as the reference's ``dynamic_update_slice``);
* reduced phi3.5-moe and reduced jamba under the table ``rules_for``
  builds for their full configs on the (16, 16) production mesh, whose
  model axis their 8 kv heads do not divide (heads and kv heads whole,
  the sequence over the model axis; held ``==`` to the reference's): the
  MoE FFN's global dispatch routes the tokens in the reference's global
  order; jamba's B/C projections keep the split sequence into the conv,
  while its inner dim takes the model axis into the SSD; the caches are
  8 rows deeper than the prompt, so a rank's block of the cache is not
  its block of the prompt;
* reduced mamba2-370m under ``dp_heavy_rules()``, 2 sequences a train
  step: the conv and the SSD over the split sequence, the SSD's state
  carried across ranks;
* reduced llava-next-34b under ``dp_heavy_rules()``, 2 sequences a train
  step: its 8 patch embeddings concatenated ahead of each sequence's
  tokens before the split, so the ranks' blocks are the one-device
  sequence's (held to one device alone).

Each: one ``make_train_step`` step (microbatch 2), a prefill and 2 decode
steps, the reference's SSD at ``impl="ref"`` (``test_torch_partition.py``
's harness). The port runs over a (2, 2) gloo world of spawned ranks with
the functional collectives staged through the host, as on the card
(``_torch_partition_ranks.seq_case``); the reference in a subprocess with
four host devices. Tolerances are ``test_torch_partition.py``'s ``TOL``,
jamba's bf16 gradient sums and moments ``test_torch_partition_moe.py``'s.
Two faulted worlds fail the gate: the K/V gather's reduce-scatter keeping
the rank's own slice of dK and dV (gemma), and the SSD without its state
exchange (mamba).
"""
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ep_ranks as epr
import _torch_partition_ranks as pr
from repro.configs import ARCHS as JARCHS
from repro.models import build as jbuild
from repro.parallel import sharding as jsh
from repro_torch.configs import get_arch
from repro_torch.models import lm
from test_torch_partition import ROOT, TOL
from test_torch_partition_moe import BF16_TOL

REFERENCE_TIMEOUT_S = 300
WORLD_TIMEOUT_S = 240
WORLD = (2, 2)
S, PROMPTS, DECODE = 32, 2, 2
GEMMA, PHI, JAMBA, MAMBA, LLAVA = (
    "gemma3-1b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b",
    "mamba2-370m", "llava-next-34b")
# (name, arch, rules, train sequences, cache rows past the prompt)
CASES = ((f"{GEMMA}-dp_heavy", GEMMA, "dp_heavy", 2, 0),
         (f"{PHI}-kv_indivisible", PHI, "kv_indivisible", 4, 8),
         (f"{JAMBA}-kv_indivisible", JAMBA, "kv_indivisible", 4, 8),
         (f"{MAMBA}-dp_heavy", MAMBA, "dp_heavy", 2, 8),
         (f"{LLAVA}-dp_heavy", LLAVA, "dp_heavy", 2, 8))
NAMES = [c[0] for c in CASES]
# held to the reference's steps (test_torch_partition_encdec.py holds
# llava's patches through the reference's partitioned steps)
REFERENCE_NAMES = NAMES[:4]
FAULTS = {"dropped_kv_reduce_scatter": NAMES[0],
          "dropped_state_exchange": NAMES[3]}
PRODUCTION = types.SimpleNamespace(axis_names=("data", "model"),
                                   shape={"data": 16, "model": 16})


def _tol(name):
    return BF16_TOL if name.startswith(JAMBA) else TOL


def _inputs():
    rng = np.random.default_rng(32)
    out = []
    for name, arch, rules, rows, extra in CASES:
        over = {"microbatch": 2}
        jmodel = jbuild(JARCHS[arch].reduced().replace(**over))
        params = jax.jit(lambda k: jmodel.init(k, jnp.float32)[0])(
            jax.random.PRNGKey(0))
        cfg = jmodel.cfg
        V, P = cfg.vocab, cfg.frontend_tokens
        c = {"name": name, "arch": arch, "rules": rules, "cfg": over,
             "params": jax.tree.map(np.asarray, params),
             "train": rng.integers(0, V, (rows, S)).astype(np.int32),
             "prefill": rng.integers(0, V, (PROMPTS, S)).astype(np.int32),
             "decode": rng.integers(0, V, (DECODE, PROMPTS)).astype(
                 np.int32),
             "max_len": P + S + extra}
        for kind, n in (("train", rows), ("prefill", PROMPTS)) if P else ():
            c[f"{kind}_patches"] = rng.standard_normal(
                (n, P, cfg.d_model)).astype(np.float32)
        out.append(c)
    return out


def _reference_main(in_path, out_path):
    """The reference's side, in a process of its own with four host
    devices: each case's jitted partitioned steps on a (2, 2) mesh
    (``test_torch_partition.py``'s harness at the case's batch and cache
    depth) under its table, the kv-indivisible one from the reference's
    ``rules_for`` on the production mesh; the SSD at ``impl="ref"``."""
    import test_torch_partition as tp
    from repro.kernels import ops as jops
    real_impl, real_dp = jops.default_impl, jsh.dp_heavy_rules
    with open(in_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    try:
        for c in cases:
            if c["name"] not in REFERENCE_NAMES:
                continue
            cfg = JARCHS[c["arch"]]
            jops.default_impl = (lambda: "ref") if cfg.family in (
                "ssm", "hybrid") else real_impl
            if c["rules"] == "kv_indivisible":
                table = jsh.rules_for(cfg, PRODUCTION)
                jsh.dp_heavy_rules = lambda table=table: table
            else:
                jsh.dp_heavy_rules = real_dp
            tp.B, tp.PROMPTS = c["train"].shape[0], c["prefill"].shape[0]
            tp.S, tp.MAX_LEN = c["train"].shape[1], c["max_len"]
            part = in_path + f".{c['name']}"
            with open(part, "wb") as f:
                pickle.dump([dict(c, rules="dp_heavy")], f)
            tp._reference_main(part, part + ".out")
            with open(part + ".out", "rb") as f:
                out[c["name"]] = pickle.load(f)[c["arch"]]
            if c["max_len"] == S:
                out[c["name"]]["logits_one_device"] = _reference_one(c)
    finally:
        jops.default_impl, jsh.dp_heavy_rules = real_impl, real_dp
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _reference_one(c):
    """The reference's prefill and decode steps of case ``c`` on one
    device (no mesh, no rules): its logits."""
    from repro.launch import steps as jsteps
    model = jbuild(JARCHS[c["arch"]].reduced().replace(**c["cfg"]))
    params = jax.tree.map(jnp.asarray, c["params"])
    lg, cache = jax.jit(lambda p, b: model.prefill(
        p, b, max_len=c["max_len"], cache_dtype=jnp.float32))(
        params, {"tokens": jnp.asarray(c["prefill"])})
    logits = [np.asarray(lg, np.float32)]
    serve = jax.jit(jsteps.make_serve_step(model))
    for t in c["decode"]:
        lg, cache = serve(params, cache, jnp.asarray(t))
        logits.append(np.asarray(lg, np.float32))
    return np.stack(logits)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, started first, the port's world while
    it runs, and the port's one-device steps."""
    work = str(tmp_path_factory.mktemp("partition_seq"))
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
    code = ("import sys, test_torch_partition_seq as t; "
            "t._reference_main(sys.argv[1], sys.argv[2])")
    ref = subprocess.Popen([sys.executable, "-c", code, in_path, out_path],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        world = epr.run_world(
            "seq", WORLD[0] * WORLD[1], WORLD[1],
            {"cases": cases, "faults": FAULTS}, work, WORLD_TIMEOUT_S,
            module="_torch_partition_ranks")
        one = {}
        for c in cases:
            cfg = get_arch(c["arch"]).reduced().replace(**c["cfg"])
            one[c["name"]] = pr.run_steps(cfg, c["params"], c, None, None)
        log, _ = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log[-4000:]
    with open(out_path, "rb") as f:
        return {"reference": pickle.load(f), "world": world, "one": one}


@pytest.mark.parametrize("arch", [PHI, JAMBA])
def test_kv_indivisible_table_equals_reference(arch):
    """The table the cases run under is ``rules_for`` of the full config
    on the production mesh in both packages, ``==``."""
    assert pr.kv_indivisible_rules(arch) == jsh.rules_for(JARCHS[arch],
                                                          PRODUCTION)


@pytest.mark.parametrize("name", NAMES)
def test_seq_parallel_steps_equal_one_device_steps(runs, name):
    """Every rank's whole results (its DTensors gathered) equal the
    one-device step's, and the ranks agree among themselves."""
    one = runs["one"][name]
    for r in runs["world"]:
        assert pr.compare(r[name], one, _tol(name)) == [], \
            (r["coords"], name)
        # a 2-row batch is one microbatch over the mesh: choose_microbatch
        # keeps a step's rows a multiple of the data axis
        rows = next(c[3] for c in CASES if c[0] == name)
        assert r[name]["accum"] == (1 if rows == 2 else 2)
        assert not any(r[name]["drops"])
    np.testing.assert_array_equal(runs["world"][0][name]["logits"],
                                  runs["world"][-1][name]["logits"])


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_seq_parallel_steps_equal_reference_partitioned_steps(runs, name):
    """The port's world against the reference's jitted steps over (2,
    2) under the same table. Where the decode steps run past the cache's
    depth (gemma's, pos >= S), the reference's partitioned decode parts
    from its own one-device decode (XLA's partitioned
    ``dynamic_update_slice`` does not clamp its write into a cache split
    on kv_seq as one device does), so there the world's decode logits
    are held to the reference's one-device steps, and the partitioned
    reference's prefill logits to the world's."""
    got, ref = runs["world"][0][name], runs["reference"][name]
    if "logits_one_device" not in ref:
        assert pr.compare(got, ref, _tol(name)) == []
        return
    keys = ("loss", "grad_norm", "mu", "nu", "params")
    assert pr.compare(got, ref, _tol(name), keys=keys) == []
    assert pr.compare(got, {"logits": ref["logits_one_device"]},
                      _tol(name), keys=("logits",)) == []
    assert pr.compare({"logits": got["logits"][:1]},
                      {"logits": ref["logits"][:1]}, _tol(name),
                      keys=("logits",)) == []


def _layers(arch):
    cfg = get_arch(arch).reduced()
    body = [s for seg in lm.build_schedule(cfg) for _ in range(seg.count)
            for s in seg.body]
    n_attn = sum(s.mixer != "mamba" for s in body)
    return n_attn, len(body) - n_attn


@pytest.mark.parametrize("name", NAMES)
def test_split_sequences_take_the_sequence_parallel_paths(runs, name):
    """Each attention layer of every forward (the train step's microbatches,
    each twice under remat, and the prefill) runs ``attention_seq``, each
    decode step's attention ``decode_over_blocks``; jamba's B/C conv runs
    ``conv_seq`` (its inner dim takes the model axis, so x's conv and the
    SSD see a whole sequence), mamba's two convs and SSD run over the
    split sequence. The train step's K/V and state gathers run on the
    model axis."""
    arch = next(c[1] for c in CASES if c[0] == name)
    n_attn, n_ssm = _layers(arch)
    for r in runs["world"]:
        forwards = 2 * r[name]["accum"] + 1
        seq = r[name]["seq"]
        assert seq["attention_seq"] == n_attn * forwards, (name, seq)
        assert seq["decode_over_blocks"] == seq["merge_partials"] == \
            n_attn * DECODE, (name, seq)
        convs = {JAMBA: 1, MAMBA: 2}.get(arch, 0)
        assert seq["conv_seq"] == n_ssm * convs * forwards, (name, seq)
        assert seq["ssd_seq"] == (n_ssm * forwards if arch == MAMBA
                                  else 0), (name, seq)
        c = r[name]["collectives_train"]
        assert c["by_axis"]["model"] > 0 and c["all-gather"] > 0
        assert r["staged"]["host_copy_bytes"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faulted_seq_world_is_rejected(runs, fault):
    """The train step with the K/V gather's reduce-scatter dropped, or with
    the SSD's state exchange left out, parts from the one-device step
    past the gate on every rank."""
    name = FAULTS[fault]
    one = runs["one"][name]
    for r in runs["world"]:
        bad = pr.compare(r["faults"][fault], one, _tol(name),
                         keys=("loss", "grad_norm"))
        assert bad, (r["coords"], fault)
