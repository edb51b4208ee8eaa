"""Rematerialized training bodies (``cfg.remat``, ``models/remat.py``) held
against the port without remat and against the JAX package's
``jax.checkpoint``.

* Reduced olmo-1b, mamba2-370m (the plain SSD), moonshot-v1-16b-a3b,
  jamba-1.5-large-398b and seamless-m4t-medium: the port's loss and every
  gradient with ``remat=True`` equal those with ``remat=False`` with
  ``==``: the recompute runs the same ops on the same inputs, and the
  backward takes its saved tensors from it.
* The same archs with ``remat=True`` on both sides against the
  reference's ``jax.value_and_grad`` of ``Model.loss``, to the tolerances
  the train tests state (``test_torch_train.py``, ``test_torch_moe_train.
  py``, ``test_torch_encdec.py``: atol = rtol = 1e-5; A_log and dt_bias at
  1e-4 of their largest entry); the reference's SSD by the step-by-step
  recurrence (``impl="ref"``), its attention blocked.
* Counting the plain B5's and B7's calls (``impl="torch"``): a train step
  runs each checkpointed body's forward twice, a prefill once; without
  remat the train step runs it once. A record of the forward's choices
  (``moe_paths``) reads the first forward only.
* The decomposition (``launch/decompose.py``) of one reduced train cell
  per family books, for each checkpointed body, exactly its forward's
  FLOPs (the same body's prefill piece at the microbatch's rows) on top
  of its FLOPs without remat, and nothing more elsewhere; the dry run's
  predicted peak of the step falls. The reference's remat'd
  decomposition (XLA's cost analysis, which also counts elementwise
  FLOPs, so its figures are not the port's) rises in the same pieces and
  in no other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_partition_ranks as pr
from repro.configs import ARCHS as JARCHS
from repro.models import build as jbuild
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.decompose import decompose_cell
from repro_torch.models import build, lm, remat

ARCHS = ("olmo-1b", "mamba2-370m", "moonshot-v1-16b-a3b",
         "jamba-1.5-large-398b", "seamless-m4t-medium")
FAMILIES = {"dense": "olmo-1b", "vlm": "llava-next-34b",
            "moe": "moonshot-v1-16b-a3b", "ssm": "mamba2-370m",
            "hybrid": "jamba-1.5-large-398b",
            "encdec": "seamless-m4t-medium"}
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 32
TRAIN = ShapeConfig("t", 128, 4, "train")           # 2 microbatches of 2
PREFILL = ShapeConfig("p", 128, 2, "prefill")       # a microbatch's rows


def _cfgs(arch, remat_on, **kw):
    jcfg = JARCHS[arch].reduced().replace(remat=remat_on, **kw)
    tcfg = get_arch(arch).reduced().replace(remat=remat_on, **kw)
    assert jcfg.__dict__ == tcfg.__dict__
    return jcfg, tcfg


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(2, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return out


def _params(cfg, jparams):
    load = convert.encdec_params_from_jax if cfg.family == "encdec" else \
        convert.lm_params_from_jax
    return load(cfg, jax.tree.map(np.asarray, jparams), "cpu")


def _loss_and_grads(cfg, jparams, batch, impl=None):
    params = _params(cfg, jparams).requires_grad_(True)
    named = dict(params.named_parameters())
    loss = build(cfg, "cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        impl=impl)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


def _jparams(jcfg, seed):
    return jbuild(jcfg).init(jax.random.PRNGKey(seed), jnp.float32)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    jcfg, on = _cfgs(arch, True)
    off = on.replace(remat=False)
    jparams = _jparams(jcfg, 11)
    batch = _inputs(on, 12)
    loss_on, g_on = _loss_and_grads(on, jparams, batch)
    loss_off, g_off = _loss_and_grads(off, jparams, batch)
    assert torch.equal(loss_on, loss_off)
    assert set(g_on) == set(g_off)
    for k, g in g_on.items():
        assert torch.equal(g, g_off[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_reference_remat(arch):
    jcfg, tcfg = _cfgs(arch, True)
    # the draws of test_torch_moe_train.py's loss and gradient test
    jparams = _jparams(jcfg, 6)
    batch = _inputs(tcfg, 7)
    impl = "ref" if jcfg.ssm_state else "blocked"
    jmodel = jbuild(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, impl=impl)))(
            jparams)
    loss, grads = _loss_and_grads(tcfg, jparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    want = convert.lm_named_from_jax(tcfg, jax.tree.map(np.asarray, jgrads),
                                     "cpu")
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].float().numpy()
        tol = dict(atol=1e-4 * np.abs(w).max(), rtol=1e-4) if \
            k.endswith(("A_log", "dt_bias")) else LOSS_TOL
        np.testing.assert_allclose(g.float().numpy(), w, **tol, err_msg=k)


class _Calls:
    """Counts the plain B5's and B7's forward calls, and how many of them
    ran in a checkpointed body's recompute."""

    def __enter__(self):
        self.n = {"attention": 0, "ssd": 0, "recomputed": 0}
        self.real = (fa.flash_attention_torch, ss.ssd_scan_torch)

        def counted(key, fn):
            def wrapped(*a, **k):
                self.n[key] += 1
                self.n["recomputed"] += remat.recomputing()
                return fn(*a, **k)
            return wrapped
        fa.flash_attention_torch = counted("attention", self.real[0])
        ss.ssd_scan_torch = counted("ssd", self.real[1])
        return self

    def __exit__(self, *exc):
        fa.flash_attention_torch, ss.ssd_scan_torch = self.real


@pytest.mark.parametrize("arch", ["olmo-1b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium",
                                  "moonshot-v1-16b-a3b"])
def test_checkpointed_bodies_run_their_forward_twice(arch):
    """A train step (its two microbatches) with remat calls the plain B5
    and B7 twice per layer and microbatch, half of the calls in the
    recompute; without remat and in a prefill, once. The MoE route
    records (``moe_paths``) hold the first forward's calls only."""
    jcfg, on = _cfgs(arch, True, microbatch=2)
    jparams = _jparams(jcfg, 15)
    rng = np.random.default_rng(16)
    tok = lambda *shape: torch.from_numpy(
        rng.integers(2, on.vocab, shape).astype(np.int32))
    if on.family == "encdec":
        n_attn, n_ssd = on.enc_layers + 2 * on.dec_layers, 0
    else:
        body = [s for seg in lm.build_schedule(on)
                for _ in range(seg.count) for s in seg.body]
        n_ssd = sum(s.mixer == "mamba" for s in body)
        n_attn = len(body) - n_ssd
    n_moe = 0 if not on.n_experts else \
        sum(s.ffn == "moe" for seg in lm.build_schedule(on)
            for _ in range(seg.count) for s in seg.body)
    inputs = {"train": tok(4, S).numpy(), "prefill": tok(2, S).numpy(),
              "decode": np.zeros((0, 2), np.int32), "max_len": S}
    if on.family == "encdec":
        for kind, rows in (("train", 4), ("prefill", 2)):
            inputs[f"{kind}_frames"] = rng.standard_normal(
                (rows, S, on.d_model)).astype(np.float32)
    counts = {}
    for cfg in (on, on.replace(remat=False)):
        with _Calls() as calls, pr.moe_paths() as paths:
            pr.run_steps(cfg, jax.tree.map(np.asarray, jparams), inputs,
                         None, None, impl="torch", state=False, serve=False)
        counts[cfg.remat] = dict(calls.n, routes=len(paths.routes))
    assert counts[False] == {"attention": 2 * n_attn, "ssd": 2 * n_ssd,
                             "recomputed": 0, "routes": 2 * n_moe}
    assert counts[True] == {"attention": 4 * n_attn, "ssd": 4 * n_ssd,
                            "recomputed": 2 * (n_attn + n_ssd),
                            "routes": 2 * n_moe}
    with _Calls() as calls, torch.no_grad():
        build(on, "cpu").prefill(_params(on, jparams), {
            k: torch.from_numpy(v) for k, v in
            {"tokens": inputs["prefill"],
             **({"frames": inputs["prefill_frames"]}
                if on.family == "encdec" else {})}.items()},
            impl="torch")
    assert calls.n == {"attention": n_attn, "ssd": n_ssd, "recomputed": 0}


def _peak(model, shape):
    fn, hold, _ = dryrun.step_call(model, shape, torch.float32,
                                   cache_dtype=torch.float32)
    return rl.trace(fn, hold=hold, memory=True)["peak_bytes"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decomposition_books_the_recompute(family):
    """Each checkpointed body's piece of the train step books its
    forward's FLOPs (the prefill's piece of the same body at the
    microbatch's rows) on top of its FLOPs without remat; no other piece
    moves; the whole step's predicted peak falls."""
    cfg = get_arch(FAMILIES[family]).reduced().replace(microbatch=2)
    dec, peak = {}, {}
    for on in (False, True):
        model = build(cfg.replace(remat=on), "meta")
        dec[on] = decompose_cell(model, TRAIN, dtype=torch.float32,
                                 cache_dtype=torch.float32)
        peak[on] = _peak(model, TRAIN)
    fwd = decompose_cell(model, PREFILL, dtype=torch.float32,
                         cache_dtype=torch.float32)["pieces"]
    bodies = [k for k in dec[True]["pieces"]
              if k.startswith(("segment", "enc_first", "enc_body",
                               "dec_body"))]
    assert bodies
    added = 0
    for k, piece in dec[True]["pieces"].items():
        rise = piece["flops"] - dec[False]["pieces"][k]["flops"]
        assert rise == (fwd[k]["flops"] if k in bodies else 0), k
        assert rise >= 0 and piece["mult"] == dec[False]["pieces"][k]["mult"]
        added += rise * piece["mult"]
    assert added > 0
    assert dec[True]["totals"]["flops"] - dec[False]["totals"]["flops"] == \
        added
    assert peak[True] < peak[False]


def test_reference_decomposition_rises_in_the_same_pieces():
    """The reference's decomposition of reduced olmo-1b's train cell with
    and without ``jax.checkpoint`` (an Auto-axes mesh of one device: the
    host mesh's Explicit axes refuse its activation pins): its segment
    rises, its head and optimizer do not, as the port's."""
    from jax.sharding import AxisType
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch.decompose import decompose_cell as jdecompose
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])
    ref, port = {}, {}
    for on in (False, True):
        jcfg, tcfg = _cfgs("olmo-1b", on, microbatch=2)
        ref[on] = jdecompose(jbuild(jcfg), JShape("t", TRAIN.seq_len,
                                                  TRAIN.global_batch,
                                                  "train"), mesh)["pieces"]
        port[on] = decompose_cell(build(tcfg, "meta"), TRAIN,
                                  dtype=torch.float32)["pieces"]
    for k in ("segment0", "embed_loss", "optimizer"):
        rises = {name: d[True][k]["flops"] > d[False][k]["flops"]
                 for name, d in (("reference", ref), ("port", port))}
        assert rises["reference"] == rises["port"] == (k == "segment0"), \
            (k, rises)
