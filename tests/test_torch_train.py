"""The port's training path held against the JAX package.

Same numpy-seeded inputs through both packages, on the CPU (the port's
plain versions; JAX's ``impl="blocked"`` attention with its custom VJP):

* B5's plain backward (``ops.attention`` under autograd) against
  ``jax.vjp`` of the reference's blocked attention;
* reduced olmo-1b ``Model.loss`` and its gradients against
  ``jax.value_and_grad`` of the reference ``model.loss``, and reduced
  mamba2-370m's (B7's plain backward on the path) against the reference's
  with its step-by-step SSD (``impl="ref"``);
* one and three ``make_train_step`` steps with accumulation 2 (loss, grad
  norm, parameters, AdamW state) of olmo and of mamba against the
  reference's step, both
  started from the reference's parameters and AdamW state;
* the data stream bit for bit, AdamW, clipping, the bf16-state option and
  the schedules against the reference's values;
* checkpoints (round trip, uncommitted steps ignored, GC, ``every``) and a
  crash/resume run that lands on the uninterrupted run's parameters bit for
  bit, as ``test_system.py::test_train_crash_resume_bitexact`` holds the
  reference.

Tolerances, from the arithmetic. Both packages do f32 math with sums in
other orders (blocked vs whole einsums, other matmul orders), so attention
outputs and gradients agree to a few f32 ulps of their O(1) scale: they
are held to atol = rtol = 1e-5. Through the 4 layers of the reduced model
the loss (~6) and the gradients (entries up to ~1) differ by a few 1e-7 of
their scale, held to atol = rtol = 1e-5. A training step adds AdamW.
The moments are linear in the gradients and are held to atol = 1e-5,
rtol = 1e-4 after one and three steps. A parameter moves by lr · u with
u = m̂ / (sqrt(v̂) + eps), which at count 1 is g / (|g| + eps): a
function of the gradient's sign alone where |g| >> eps, but of its low
bits where |g| is within a few orders of eps = 1e-8 and the two packages'
gradients differ in relative terms (a rarely seen token's embedding row
gets a gradient of ~1e-7 that is a sum of cancelling terms). So the
parameters are held to the same tolerance but for a share under 1e-3 of
their elements (13 of 32,768 in the embedding at one step), and every
element to the bound on the step itself:
by Cauchy-Schwarz |m_t| / sqrt(v_t) <= (1 - b1) / sqrt(1 - b2) ·
sqrt(sum_{k<t} (b1^2 / b2)^k), so |u_t| <= U_t, that times
sqrt(1 - b2^t) / (1 - b1^t), and two runs differ by at most
sum_t 2 lr_t U_t. Schedules and AdamW
on the same f32 inputs agree to one f32 ulp (rtol 1e-6). Token streams,
checkpoints and the crash/resume parameters are held bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import ARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.data import host_shard_iterator as jshard_iterator
from repro.kernels import ops as jops
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build as jbuild
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim import wsd_schedule as jwsd
from repro_torch import convert
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLMDataset, host_shard_iterator
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.launch.steps import choose_microbatch, make_train_step
from repro_torch.models import build
from repro_torch.models import lm
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, wsd_schedule)

ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-5, rtol=1e-4)
SCHED_TOL = dict(atol=0.0, rtol=1e-6)


def _np(t):
    return t.detach().cpu().numpy()


# -- B5's backward ----------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [16, 64])
def test_attention_backward_matches_reference(D, G, window):
    rng = np.random.default_rng(D + G + (window or 0))
    B, S, Hkv = 2, 40, 2
    Hq = Hkv * G
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    f = lambda q_, k_, v_: jops.attention(q_, k_, v_, causal=True,
                                          window=window, impl="blocked",
                                          block_k=8)
    jout, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = _build.launch_counts()
    out = ops.attention(tq, tk, tv, causal=True, window=window, block_k=16)
    out.backward(torch.from_numpy(do))
    assert _build.launch_counts() == before         # the plain pair on CPU
    np.testing.assert_allclose(_np(out), np.asarray(jout), **ATTN_TOL)
    for t, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(want), **ATTN_TOL)


def test_attention_lse_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    for window in (None, 4):
        _, (_, _, _, _, jlse) = jops._attention_blocked_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, window,
            16 ** -0.5, 8)
        want = np.asarray(jlse).reshape(2, 24, 4).transpose(0, 2, 1)
        _, lse = fa.flash_attention_torch(
            *(torch.from_numpy(x) for x in (q, k, v)), window=window,
            block_k=8, return_lse=True)
        assert lse.shape == (2, 4, 24) and lse.dtype == torch.float32
        np.testing.assert_allclose(_np(lse), want, **ATTN_TOL)


# -- model loss and gradients -------------------------------------------------------

def _olmo(**kw):
    jcfg = ARCHS["olmo-1b"].reduced().replace(remat=False, **kw)
    tcfg = get_arch("olmo-1b").reduced().replace(remat=False, **kw)
    assert jcfg.__dict__ == tcfg.__dict__
    return jcfg, tcfg


def _tokens(rng, B, S, vocab):
    return rng.integers(2, vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("seq,chunk", [(33, 512), (41, 16)])
def test_loss_and_grads_match_reference(seq, chunk):
    """chunk 16 at seq 41: 40 predictions, the last 8 dropped as the
    reference drops them."""
    jcfg, tcfg = _olmo()
    jparams, _ = jbuild(jcfg).init(jax.random.PRNGKey(1), jnp.float32)
    tokens = _tokens(np.random.default_rng(seq), 2, seq, jcfg.vocab)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(jcfg, p, jnp.asarray(tokens), impl="blocked",
                              chunk=chunk))(jparams)
    params = convert.lm_params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                           jparams),
                                        "cpu").requires_grad_(True)
    loss = lm.lm_loss(tcfg, params, torch.from_numpy(tokens), chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    want = convert.lm_named_from_jax(tcfg, jax.tree.map(np.asarray, jgrads),
                                     "cpu")
    named = dict(params.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        np.testing.assert_allclose(_np(p.grad), _np(want[k]), **LOSS_TOL,
                                   err_msg=k)


def test_model_loss_is_lm_loss_and_specs():
    _, tcfg = _olmo()
    model = build(tcfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), torch.float32)
    tokens = torch.from_numpy(_tokens(np.random.default_rng(0), 2, 17,
                                      tcfg.vocab))
    assert torch.equal(model.loss(params, {"tokens": tokens}),
                       lm.lm_loss(tcfg, params, tokens))
    struct = model.param_struct(torch.float32)
    assert all(p.device.type == "meta" and p.dtype == torch.float32
               for p in struct.parameters())
    assert [(k, p.shape) for k, p in struct.named_parameters()] == \
        [(k, p.shape) for k, p in params.named_parameters()]
    jmodel = jbuild(ARCHS["olmo-1b"].reduced())
    assert model.param_counts() == jmodel.param_counts()
    specs = model.input_specs(ShapeConfig("t", 64, 8, "train"))
    jspecs, _ = jmodel.input_specs(JShapeConfig("t", 64, 8, "train"))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in specs.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
    assert model.input_specs(ShapeConfig("d", 64, 8, "decode"))[
        "tokens"].shape == (8,)
    seamless = get_arch("seamless-m4t-medium").reduced()
    enc_model = build(seamless, "cpu")
    assert enc_model.encdec and enc_model.init(
        torch.Generator().manual_seed(0), torch.float32).dec[0]["cross"]


# -- train steps --------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_reference(steps):
    jcfg, tcfg = _olmo(microbatch=2)
    _train_steps_vs_reference(jcfg, tcfg, steps, key=2)


def _train_steps_vs_reference(jcfg, tcfg, steps, key, resync=False):
    """``steps`` steps of the port's ``make_train_step`` (batch 4 x 32,
    accumulation 2) against the reference's, from the reference's
    parameters and AdamW state: loss and grad norm each step, moments and
    parameters after the last (tolerances in the module docstring). With
    ``resync`` every step starts from the reference's parameters and
    AdamW state after the step before."""
    B, S = 4, 32
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(key), jnp.float32)
    jshape = JShapeConfig("t", S, B, "train")
    jstep, jopt_init = jmake_train_step(jmodel, jshape, make_host_mesh(),
                                        base_lr=1e-2, warmup=1,
                                        total_steps=10)
    assert jstep.accum == 2
    model = build(tcfg, "cpu")
    step_fn, _ = make_train_step(model, ShapeConfig("t", S, B, "train"),
                                 base_lr=1e-2, warmup=1, total_steps=10)
    assert step_fn.accum == 2 == choose_microbatch(tcfg, B)
    jopt = jopt_init(jparams)
    params = convert.lm_params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                           jparams),
                                        "cpu").requires_grad_(True)
    opt = convert.adamw_state_from_jax(tcfg, jax.tree.map(np.asarray, jopt),
                                       "cpu")
    rng = np.random.default_rng(steps)
    for s in range(steps):
        if resync and s:
            params = convert.lm_params_from_jax(
                tcfg, jax.tree.map(np.asarray, jparams),
                "cpu").requires_grad_(True)
            opt = convert.adamw_state_from_jax(
                tcfg, jax.tree.map(np.asarray, jopt), "cpu")
        tokens = _tokens(rng, B, S, jcfg.vocab)
        jparams, jopt, jloss, jgn = jstep(jparams, jopt,
                                          {"tokens": jnp.asarray(tokens)},
                                          jnp.int32(s + 1))
        params, opt, loss, gn = step_fn(params, opt,
                                        {"tokens": torch.from_numpy(tokens)},
                                        s + 1)
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
        np.testing.assert_allclose(float(gn), float(jgn), **LOSS_TOL)
    assert int(opt.count) == int(jopt.count) == steps
    for got, want in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        want = convert.lm_named_from_jax(tcfg, jax.tree.map(np.asarray,
                                                            want), "cpu")
        for k in want:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                       **STEP_TOL, err_msg=k)
    # parameters: tight but for a share under 1e-3, all within the bound
    b1, b2, lr = 0.9, 0.95, 1e-2          # lr(s + 1) = 1e-2 (cosine start)
    bound = sum(2 * lr * 0.1 / np.sqrt(0.05)
                * np.sqrt(sum((b1 * b1 / b2) ** k for k in range(t)))
                * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
                for t in range(1, steps + 1))
    want = convert.lm_named_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                     "cpu")
    named = dict(params.named_parameters())
    loose = total = 0
    for k in want:
        g, w = _np(named[k]), _np(want[k])
        assert np.abs(g - w).max() <= bound * 1.001, k
        loose += int((~np.isclose(g, w, **STEP_TOL)).sum())
        total += g.size
    assert loose < 1e-3 * total


# -- mamba2-370m (ssm family): B7's backward on the training path -------------

def _mamba(**kw):
    jcfg = ARCHS["mamba2-370m"].reduced().replace(remat=False, **kw)
    tcfg = get_arch("mamba2-370m").reduced().replace(remat=False, **kw)
    assert jcfg.__dict__ == tcfg.__dict__
    return jcfg, tcfg


@pytest.mark.parametrize("seq", [32, 256])
def test_mamba_loss_and_grads_match_reference(seq):
    """Reduced mamba2-370m's loss and gradients (every parameter: through
    ``ops.ssd``'s chunked backward to x, b = Bm·dt, c (broadcast over H)
    and a, so to the projections, the convs, A_log, dt_bias and D_skip)
    against ``jax.value_and_grad`` of the reference's ``lm_loss(...,
    impl="ref")``, whose SSD is the step-by-step recurrence. seq 32 gives
    one 32-step chunk, 256 two chunks of 128 at the init decays (a chunk
    sums -log a to ~90, past exp's f32 overflow). The port's SSD gradient
    differs from the recurrence's by exp of differences of f32 cumulative
    sums, ~1e-5 relative at those sums (``test_torch_ssd.py``); A_log and
    dt_bias sum it over every position, so their gradients are held to
    1e-4 of each tensor's largest entry, the rest as olmo's (LOSS_TOL)."""
    jcfg, tcfg = _mamba()
    jparams, _ = jbuild(jcfg).init(jax.random.PRNGKey(4), jnp.float32)
    tokens = _tokens(np.random.default_rng(seq), 2, seq, jcfg.vocab)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(jcfg, p, jnp.asarray(tokens), impl="ref"))(
            jparams)
    params = convert.lm_params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                           jparams),
                                        "cpu").requires_grad_(True)
    loss = lm.lm_loss(tcfg, params, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    want = convert.lm_named_from_jax(tcfg, jax.tree.map(np.asarray, jgrads),
                                     "cpu")
    named = dict(params.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        w = _np(want[k])
        if k.endswith(("A_log", "dt_bias")):
            tol = dict(atol=1e-4 * np.abs(w).max(), rtol=1e-4)
        else:
            tol = LOSS_TOL
        np.testing.assert_allclose(_np(p.grad), w, **tol, err_msg=k)


@pytest.mark.parametrize("steps", [1, 3])
def test_mamba_train_steps_match_reference(steps):
    """One and three ``make_train_step`` steps of reduced mamba2-370m
    against the reference's (its SSD ``impl="blocked"`` there, finite at
    S 32), at olmo's tolerances, each step from the reference's state
    after the step before. Left to run free, the two part as AdamW parts
    them (module docstring): a parameter whose gradient is near eps moves
    by a function of its low bits, and the reduced mamba's parameters
    carry those differences into the next steps' gradients faster than
    olmo's, past the share and the grad-norm tolerance olmo's test holds
    by the third step. Each step from the same state holds the step
    itself (its gradients through B7's plain backward, the moments' and
    the schedule's progress) at the one-step tolerances."""
    jcfg, tcfg = _mamba(microbatch=2)
    _train_steps_vs_reference(jcfg, tcfg, steps, key=5, resync=True)


def test_minicpm_wsd_train_step_matches_reference():
    """One ``make_train_step`` step of reduced minicpm-2b, whose config
    names ``schedule="wsd"``: at step 10 of 10 the WSD schedule is in its
    decay (lr 0.1 · base, where cosine gives 0), so the parameters move
    by what ``optim/schedules.wsd_schedule`` gives: at most lr (1 + 0.1
    |p|) with AdamW's first update (at most 1 an element) and weight decay
    0.1. Loss, grad norm
    and parameters against the reference's step."""
    jcfg = ARCHS["minicpm-2b"].reduced().replace(remat=False, microbatch=2)
    tcfg = get_arch("minicpm-2b").reduced().replace(remat=False,
                                                    microbatch=2)
    assert tcfg.schedule == jcfg.schedule == "wsd"
    B, S = 4, 24
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(3), jnp.float32)
    jstep, jopt_init = jmake_train_step(jmodel, JShapeConfig("t", S, B,
                                                             "train"),
                                        make_host_mesh(), base_lr=1e-2,
                                        warmup=1, total_steps=10)
    step_fn, _ = make_train_step(build(tcfg, "cpu"),
                                 ShapeConfig("t", S, B, "train"),
                                 base_lr=1e-2, warmup=1, total_steps=10)
    jopt = jopt_init(jparams)
    start = convert.lm_params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                          jparams), "cpu")
    params = convert.lm_params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                           jparams),
                                        "cpu").requires_grad_(True)
    opt = convert.adamw_state_from_jax(tcfg, jax.tree.map(np.asarray, jopt),
                                       "cpu")
    tokens = _tokens(np.random.default_rng(3), B, S, jcfg.vocab)
    jparams, jopt, jloss, jgn = jstep(jparams, jopt,
                                      {"tokens": jnp.asarray(tokens)},
                                      jnp.int32(10))
    params, opt, loss, gn = step_fn(params, opt,
                                    {"tokens": torch.from_numpy(tokens)}, 10)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(float(gn), float(jgn), **LOSS_TOL)
    lr = float(wsd_schedule(1e-2, 1, 10)(10))
    np.testing.assert_allclose(lr, 1e-3, rtol=1e-6)
    want = convert.lm_named_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                     "cpu")
    moved = big = loose = total = 0
    for (k, p), p0 in zip(params.named_parameters(), start.parameters()):
        g, w = _np(p), _np(want[k])
        assert np.abs(g - w).max() <= 2 * lr * 1.001, k
        loose += int((~np.isclose(g, w, **STEP_TOL)).sum())
        total += g.size
        moved = max(moved, float(np.abs(g - _np(p0)).max()))
        big = max(big, float(np.abs(_np(p0)).max()))
    assert loose < 1e-3 * total
    assert lr * 0.5 < moved <= lr * (1 + 0.1 * big) * 1.001


# -- data -----------------------------------------------------------------------------

def test_data_stream_equals_reference():
    ds = SyntheticLMDataset(vocab=1000, seq_len=65, seed=7)
    jds = JDataset(vocab=1000, seq_len=65, seed=7)
    for i in (0, 3, 11):
        np.testing.assert_array_equal(ds.batch(i, 4)["tokens"],
                                      jds.batch(i, 4)["tokens"])
    for host in (0, 1):
        it = host_shard_iterator(ds, 8, host, 2, start_step=5)
        jit_ = jshard_iterator(jds, 8, host, 2, start_step=5)
        for _ in range(2):
            a, b = next(it)["tokens"], next(jit_)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_resume_replays_stream():
    ds = SyntheticLMDataset(vocab=50, seq_len=16)
    it = host_shard_iterator(ds, 4, 0, 1)
    next(it)
    second = next(it)["tokens"]
    it_resumed = host_shard_iterator(ds, 4, 0, 1, start_step=1)
    np.testing.assert_array_equal(next(it_resumed)["tokens"], second)
    with pytest.raises(ValueError):
        next(host_shard_iterator(ds, 5, 0, 2))


# -- optimizer and schedules --------------------------------------------------------

def test_adamw_matches_reference_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    jparams = {"w": jnp.asarray([5.0, -3.0])}
    state, jstate = adamw_init(params), jadamw_init(jparams)
    for i in range(200):
        g = {"w": 2 * params["w"]}
        jg = jax.grad(lambda p: jnp.sum(p["w"] ** 2))(jparams)
        params, state, stats = adamw_update(params, g, state, lr=0.1,
                                            weight_decay=0.0)
        jparams, jstate, jstats = jadamw_update(jparams, jg, jstate, lr=0.1,
                                                weight_decay=0.0)
        if i < 3:
            np.testing.assert_allclose(_np(params["w"]),
                                       np.asarray(jparams["w"]), **SCHED_TOL)
            np.testing.assert_allclose(float(stats["grad_norm"]),
                                       float(jstats["grad_norm"]),
                                       **SCHED_TOL)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3
    assert int(state.count) == 200


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    jclipped, jnorm = jclip({"a": jnp.asarray([3.0, 4.0]),
                             "b": jnp.asarray([0.0])}, 1.0)
    assert float(norm) == pytest.approx(5.0) == float(jnorm)
    np.testing.assert_allclose(_np(clipped["a"]), np.asarray(jclipped["a"]),
                               **SCHED_TOL)
    small, _ = clip_by_global_norm(g, 10.0)
    assert torch.equal(small["a"], g["a"])


def test_bf16_state_option():
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    st = adamw_init(params, torch.bfloat16)
    assert st.mu["w"].dtype == torch.bfloat16 == st.nu["w"].dtype
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    jst = jadamw_init({"w": jnp.ones((4,), jnp.bfloat16)}, jnp.bfloat16)
    params, st, _ = adamw_update(params, g, st, lr=0.1)
    jp, jst, _ = jadamw_update({"w": jnp.ones((4,), jnp.bfloat16)},
                               {"w": jnp.full((4,), 0.5, jnp.bfloat16)},
                               jst, lr=0.1)
    assert params["w"].dtype == torch.bfloat16
    for got, want in ((params["w"], jp["w"]), (st.mu["w"], jst.mu["w"]),
                      (st.nu["w"], jst.nu["w"])):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedules_match_reference(kind):
    ours = (cosine_schedule(3e-3, 10, 100) if kind == "cosine"
            else wsd_schedule(1.0, warmup=10, total=100, decay_frac=0.2))
    theirs = (jcosine(3e-3, 10, 100) if kind == "cosine"
              else jwsd(1.0, warmup=10, total=100, decay_frac=0.2))
    steps = [0, 1, 5, 9, 10, 11, 50, 79, 80, 81, 99, 100, 150]
    got = [float(ours(s)) for s in steps]
    want = [float(theirs(s)) for s in steps]
    np.testing.assert_allclose(got, want, **SCHED_TOL)
    assert got[0] == 0.0
    if kind == "wsd":
        assert got[6] == pytest.approx(1.0) and got[10] < 0.2


# -- checkpoint -----------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32),
                  "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)},
            "opt": adamw_init({"w": torch.ones(3)})}
    save_checkpoint(str(tmp_path), 5, tree)
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(2,
                                                          dtype=torch.int32),
                                         "h": torch.zeros(
                                             2, dtype=torch.bfloat16)},
            "opt": adamw_init({"w": torch.zeros(3)})}
    restored, step = restore_checkpoint(str(tmp_path), like)
    assert step == 5
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert restored["b"]["h"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["h"], tree["b"]["h"])
    assert torch.equal(restored["opt"].mu["w"], tree["opt"].mu["w"])
    assert int(restored["opt"].count) == 0


def test_checkpoint_reads_like_the_reference(tmp_path):
    """The same leaves under the same names: each package restores the
    other's npz shard."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.array([1, 2], np.int32)}}
    jsave(str(tmp_path / "j"), 3, jax.tree.map(jnp.asarray, tree))
    restored, step = restore_checkpoint(
        str(tmp_path / "j"), {"a": torch.zeros(2, 3),
                              "b": {"c": torch.zeros(2, dtype=torch.int32)}})
    assert step == 3 and torch.equal(restored["a"],
                                     torch.from_numpy(tree["a"]))
    save_checkpoint(str(tmp_path / "t"), 4,
                    {"a": torch.from_numpy(tree["a"]),
                     "b": {"c": torch.from_numpy(tree["b"]["c"])}})
    jrestored, jstep = jrestore(str(tmp_path / "t"),
                                jax.tree.map(jnp.zeros_like, tree))
    assert jstep == 4
    np.testing.assert_array_equal(np.asarray(jrestored["b"]["c"]),
                                  tree["b"]["c"])


def test_checkpoint_ignores_uncommitted(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    os.makedirs(tmp_path / "step_00000002")          # a partial write
    assert latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "none")) is None


def test_checkpoint_manager_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), every=1, keep=2)
    for s in range(1, 6):
        m.maybe_save(s, {"a": torch.zeros(1)})
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 2 and kept[-1] == "step_00000005"


def test_checkpoint_respects_every(tmp_path):
    m = CheckpointManager(str(tmp_path), every=10)
    assert m.maybe_save(5, {"a": torch.zeros(1)}) is None
    assert m.maybe_save(10, {"a": torch.zeros(1)}) is not None


# -- crash and resume -----------------------------------------------------------------

def _final_params(ckpt_dir, step):
    data = np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "shard_0.npz"))
    return {k: data[k] for k in data.files}


def test_train_crash_resume_bitexact(tmp_path, capsys):
    """A run that crashes at step 5 and resumes lands on the uninterrupted
    run's parameters and AdamW state bit for bit (determinism, atomic
    checkpoints, the resumable data stream)."""
    common = ["--arch", "olmo-1b", "--reduced", "--device", "cpu",
              "--steps", "10", "--batch", "4", "--seq", "32",
              "--ckpt-every", "5", "--log-every", "100"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert train.main(common + ["--ckpt-dir", a]) == 0
    assert train.main(common + ["--ckpt-dir", b, "--fail-at", "5"]) == \
        train.CRASH_EXIT
    assert latest_step(b) == 5
    assert train.main(common + ["--ckpt-dir", b, "--resume"]) == 0
    assert "resumed from step 5" in capsys.readouterr().out
    want, got = _final_params(a, 10), _final_params(b, 10)
    assert set(got) == set(want) and len(got) > 10
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
