"""The MoE and hybrid families' partitioned steps (``launch/steps.py`` over
a DeviceMesh, the expert weights placed per rank as DTensors, the MoE
FFN's paths across ranks trained through autograd over
``parallel/collectives.py``) held against the port's one-device steps and
the JAX package's jitted partitioned steps.

Reduced moonshot-v1-16b-a3b (its first layer dense) and phi3.5-moe, each
under ``rules_for`` (full tensor parallelism on a (2, 2) mesh: the tokens
over data only, so the global dispatch, whose expert products run on the
rank's (E/m, C/d, D) block: the reference's ``shard_map`` branch of
``_expert_matmuls``) and under ``dp_heavy_rules()`` (the batch over data x
model: ``_moe_ep``); reduced jamba under ``rules_for`` (the global
dispatch, its mamba and attention layers tensor parallel), the
reference's SSD by the step-by-step recurrence (``impl="ref"``, as
``test_torch_partition.py`` runs it). Each with microbatch 2: one
``make_train_step`` step over 8 x 32 tokens, then a 4 x 32 prefill into a
40-deep f32 cache and 2 decode steps. The port runs over a (2, 2) gloo
world of spawned ranks with the functional collectives staged through the
host, as on the card (``_torch_ep_ranks.run_world`` with
``_torch_partition_ranks.moe_case``); the reference in a subprocess with
four host devices on an Auto-axes (2, 2) mesh under the same rules, as
``test_torch_partition.py``'s. The same numpy-seeded parameters (the
reference's init) and tokens go to all three.

One more case binds the per-rank capacity: reduced moonshot under
``dp_heavy_rules()`` at 8 x 160 tokens with every router zeroed, so every
probability ties at 1/E and every token picks experts 0 and 1 (the lower
ids, in both packages' top-k); each rank's 160 tokens of a microbatch
ask those experts for more than its 128 slots, and the reference's EP
step drops the same tokens. It is held to the reference, not to one
device, whose global capacity drops other tokens.

Tolerances are ``test_torch_partition.py``'s (``TOL``) for the f32
states. Jamba keeps bf16 gradient sums and bf16 moments (its config's
``bf16_optimizer_state``), held as ``test_torch_moe_train.py`` holds them
against the reference, from the same arithmetic: the world's f32
gradients part from one device's by a few f32 ulps, so a bf16 rounding of
each is the same but for a share near 1e-5 / 2**-8 per rounding, three
roundings reaching each moment: moments bit-equal but for a share under
1e-2, every entry within 2**-6 of the moment's largest. A moment that
differs can flip the sign of AdamW's first update, lr(1) · g / (|g| +
eps) where |g| is within a rounding of zero, so a parameter entry may
part by up to 2 lr(1), the bound AdamW puts on two runs' first step
(``test_torch_moe_train._adamw_bound(1)``), and all but 1e-3 of them are
held to ``TOL``'s. The faulted worlds (the all-to-all's backward with
its dims unswapped; the weights' reduce-scatter dropped) fail the gate.
The collectives' own gradients equal their explicit adjoints bit for
bit, on integer-valued tensors.
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

REFERENCE_TIMEOUT_S = 420
WORLD_TIMEOUT_S = 360
WORLD = (2, 2)
B, S, PROMPTS, DECODE = 8, 32, 4, 2
BIND_S = 160
MOONSHOT, PHI, JAMBA = ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
                        "jamba-1.5-large-398b")
# (name, arch, rules, sequence length, routers zeroed)
CASES = ((f"{MOONSHOT}-auto", MOONSHOT, "auto", S, False),
         (f"{MOONSHOT}-dp_heavy", MOONSHOT, "dp_heavy", S, False),
         (f"{PHI}-auto", PHI, "auto", S, False),
         (f"{PHI}-dp_heavy", PHI, "dp_heavy", S, False),
         (f"{JAMBA}-auto", JAMBA, "auto", S, False),
         ("bind", MOONSHOT, "dp_heavy", BIND_S, True))
HELD_TO_ONE_DEVICE = [c[0] for c in CASES if c[0] != "bind"]
FAULT_CASE = f"{MOONSHOT}-dp_heavy"
BF16_TOL = dict(TOL, moments=(2.0 ** -6, 0.0), moments_of_max=True,
                moment_share=1e-2, param_bound=2 * LR1 * 1.001)


def _tol(name):
    return BF16_TOL if name.startswith(JAMBA) else TOL


def _zero_routers(tree):
    if isinstance(tree, dict):
        return {k: (np.zeros_like(v) if k == "router" else _zero_routers(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zero_routers(v) for v in tree)
    return tree


def _inputs():
    rng = np.random.default_rng(30)
    out = []
    for name, arch, rules, seq, zero in CASES:
        over = {"microbatch": 2}
        jmodel = jbuild(JARCHS[arch].reduced().replace(**over))
        params = jax.jit(lambda k: jmodel.init(k, jnp.float32)[0])(
            jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, params)
        V = jmodel.cfg.vocab
        out.append({
            "name": name, "arch": arch, "rules": rules, "cfg": over,
            "params": _zero_routers(params) if zero else params,
            "train": rng.integers(0, V, (B, seq)).astype(np.int32),
            "prefill": rng.integers(0, V, (PROMPTS, seq)).astype(np.int32),
            "decode": rng.integers(0, V, (DECODE, PROMPTS)).astype(np.int32),
            "max_len": seq + 8})
    return out


def _reference_main(in_path, out_path):
    """The reference's side, in a process of its own with four host
    devices: each case's jitted partitioned train step, prefill and decode
    steps on a (2, 2) mesh under its rules (``test_torch_partition.py``'s
    harness at the case's sequence length and cache depth), with the
    hybrid's SSD at ``impl="ref"``."""
    import test_torch_partition as tp
    from repro.kernels import ops as jops
    real = jops.default_impl
    with open(in_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for c in cases:
        jops.default_impl = (lambda: "ref") if c["arch"] == JAMBA else real
        tp.S, tp.MAX_LEN = c["train"].shape[1], c["max_len"]
        part = in_path + f".{c['name']}"
        with open(part, "wb") as f:
            pickle.dump([c], f)
        tp._reference_main(part, part + ".out")
        with open(part + ".out", "rb") as f:
            out[c["name"]] = pickle.load(f)[c["arch"]]
    jops.default_impl = real
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, started first, the port's world while
    it runs, and the port's one-device steps."""
    work = str(tmp_path_factory.mktemp("partition_moe"))
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
    code = ("import sys, test_torch_partition_moe as t; "
            "t._reference_main(sys.argv[1], sys.argv[2])")
    ref = subprocess.Popen([sys.executable, "-c", code, in_path, out_path],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        world = epr.run_world(
            "moe", WORLD[0] * WORLD[1], WORLD[1],
            {"cases": cases, "fault_case": FAULT_CASE}, work,
            WORLD_TIMEOUT_S, module="_torch_partition_ranks")
        one = {}
        for c in cases:
            if c["name"] in HELD_TO_ONE_DEVICE:
                cfg = get_arch(c["arch"]).reduced().replace(**c["cfg"])
                with pr.moe_paths() as paths:
                    one[c["name"]] = pr.run_steps(cfg, c["params"], c, None,
                                                  None)
                one[c["name"]]["drops"] = paths.drops
        log, _ = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log[-4000:]
    with open(out_path, "rb") as f:
        return {"reference": pickle.load(f), "world": world, "one": one}


@pytest.mark.parametrize("name", HELD_TO_ONE_DEVICE)
def test_partitioned_moe_steps_equal_one_device_steps(runs, name):
    """Every rank's whole results (its DTensors gathered) equal the
    one-device step's, and the ranks agree among themselves. Neither
    drops a token at these sizes."""
    one = runs["one"][name]
    assert not any(one["drops"])
    for r in runs["world"]:
        assert pr.compare(r[name], one, _tol(name)) == [], \
            (r["coords"], name)
        assert r[name]["accum"] == one["accum"] == 2
        assert not any(r[name]["drops"])
    np.testing.assert_array_equal(runs["world"][0][name]["logits"],
                                  runs["world"][-1][name]["logits"])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_partitioned_moe_steps_equal_reference_partitioned_steps(runs,
                                                                 name):
    """The port's world against the reference's jitted step over (2, 2);
    the capacity-binding case among them."""
    got = runs["world"][0][name]
    assert pr.compare(got, runs["reference"][name], _tol(name)) == []


def test_moe_layers_take_the_reference_paths(runs):
    """Under ``dp_heavy_rules()`` every MoE layer of the train step,
    prefill and decode takes expert parallelism; under ``rules_for`` the
    global dispatch with its products on the rank's block. The binding
    case drops tokens on every rank, and differs from one device."""
    n_moe = {MOONSHOT: 3, PHI: 4, JAMBA: 4}
    for r in runs["world"]:
        for name, arch, rules, _, _ in CASES:
            calls = r[name]["paths"]
            # 2 microbatches, a prefill, 2 decode steps
            n = n_moe[arch] * (2 + 1 + DECODE)
            if rules == "dp_heavy":
                assert calls == {"ep": n, "global": 0, "block": 0}, name
            else:
                assert calls == {"ep": 0, "global": n, "block": n}, name
        assert sum(r["bind"]["drops"]) > 0
    cfg = get_arch(MOONSHOT).reduced().replace(microbatch=2)
    bind = next(c for c in _inputs() if c["name"] == "bind")
    one = pr.run_steps(cfg, bind["params"], dict(bind, decode=[]), None,
                       None)
    assert pr.compare(runs["world"][0]["bind"], one, TOL,
                      keys=("loss",)) != []


def test_expert_weights_are_placed_per_rank(runs):
    """``Model.distribute`` leaves each rank its experts' block of every
    MoE layer's gate, up and down (E/m experts, the embed dim FSDP'd over
    data) under both rule tables, and the router whole."""
    cfg = get_arch(MOONSHOT).reduced()
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    d, m = WORLD
    for r in runs["world"]:
        for rules, placed in r["placed"].items():
            assert len(placed) == 4 * (cfg.n_layers - cfg.first_dense)
            for name, (pl, local) in placed.items():
                leaf = name.rsplit(".", 1)[1]
                want = {"router": (D, E), "gate": (E // m, D // d, F),
                        "up": (E // m, D // d, F),
                        "down": (E // m, F, D // d)}[leaf]
                assert local == want, (rules, name, pl)


def test_moe_collectives_follow_the_paths(runs):
    """Each rank's collectives in the train step: all-to-alls over the
    model axis where the tokens take expert parallelism, none on the
    global path; reduce-scatters of the gradients on both axes; every
    collective staged through the host."""
    for r in runs["world"]:
        for name, _, rules, _, _ in CASES:
            c = r[name]["collectives_train"]
            assert c["total"] == sum(c["by_axis"].values()) > 0
            assert c["reduce-scatter"] > 0 and c["all-gather"] > 0
            assert (c["all-to-all"] > 0) == (rules == "dp_heavy"), name
        assert r["staged"]["host_copy_bytes"] > 0
        assert r["staged"]["all_to_all_calls"] > 0
        assert r["staged"]["reduce_scatter_calls"] > 0


@pytest.mark.parametrize("fault", sorted(pr.FAULTS))
def test_faulted_moe_world_is_rejected(runs, fault):
    """The EP train step with the all-to-all's backward unswapped, or
    with the weights' reduce-scatter dropped, parts from the one-device
    step past the gate on every rank."""
    one = runs["one"][FAULT_CASE]
    for r in runs["world"]:
        bad = pr.compare(r["faults"][fault], one, TOL,
                         keys=("grad_norm", "mu", "nu", "params"))
        assert bad, (r["coords"], fault)


@pytest.mark.parametrize("op", ["all_to_all", "all_gather"])
def test_collective_gradients_are_the_adjoints(runs, op):
    """The all-to-all's gradient is the all-to-all with split and concat
    swapped, the all-gather's the reduce-scatter (sum) of the gradient,
    bit for bit; both directions issue functional collectives that
    ``collective_bytes`` sees and ``stats()`` counts."""
    for r in runs["world"]:
        g = r["grads"][op]
        assert g["equal"], (r["coords"], op)
        if op == "all_to_all":
            assert g["moved"]
            assert g["forward"]["all-to-all"] == \
                g["backward"]["all-to-all"] > 0
            assert set(g["backward"]["by_axis"]) == {"model"}
        else:
            assert g["forward"]["all-gather"] == \
                g["backward"]["reduce-scatter"] * WORLD[0] > 0
            assert g["backward"]["count"] == 1
            assert set(g["backward"]["by_axis"]) == {"data"}
        counted = r["grads"]["counted"]
        assert counted["all_to_all_calls"] >= 3       # the adjoint's check
        assert counted["reduce_scatter_calls"] == 1
