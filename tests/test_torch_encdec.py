"""The port's encoder-decoder (seamless-m4t-medium, reduced) held against
the JAX package.

The reference's ``init`` parameters (float32) cross over through
``convert.encdec_params_from_jax``; the same seeded numpy frames and tokens
go to both packages, JAX with ``impl="blocked"`` attention and the port on
the CPU (the plain versions). Reduced seamless: 2 encoder and 2 decoder
layers, d_model 64, 4 query heads over 2 KV heads of 16 (G 2), vocab 512.

Tolerances, from the arithmetic, as in ``test_torch_lm.py`` and
``test_torch_train.py``: both sides do f32 math with sums in other orders
(blocked vs whole attention, other einsum orders), which through 4 layers
of O(1) activations leaves a few 1e-6 in logits up to ~5 and in hidden
states of RMS ~1: held to atol = rtol = 1e-4. bf16 cache leaves are f32
values rounded once on each side, one ulp apart at most: two bf16 ulps
(atol 2**-8, rtol 2**-6); logits decoded over a bf16 cache move by up to
~1e-3 when one entry rounds the other way: 2e-3. The loss (~6) and its
gradients (entries up to ~1) differ by a few 1e-7 of their scale: held to
atol = rtol = 1e-5. A train step adds AdamW, whose first update is
lr · g / (|g| + eps): parameters are held to atol = 1e-5, rtol = 1e-4 but
for a share under 1e-3 of their elements (a near-zero gradient's update
follows its low bits), and every element within 2 lr of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build as jbuild
from repro.models import encdec as jencdec
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build, encdec

ARCH = "seamless-m4t-medium"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -6)
BF16_CACHE_LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-5, rtol=1e-4)


def _cfgs(**kw):
    jcfg = ARCHS[ARCH].reduced().replace(remat=False, **kw)
    tcfg = get_arch(ARCH).reduced().replace(remat=False, **kw)
    assert jcfg.__dict__ == tcfg.__dict__
    return jcfg, tcfg


def _setup(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed), jnp.float32)
    params = convert.encdec_params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jmodel, jparams, build(tcfg, "cpu"), params


def _inputs(rng, cfg, B, S_enc, S_dec):
    frames = rng.standard_normal((B, S_enc, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(2, cfg.vocab, size=(B, S_dec)).astype(np.int32)
    return frames, tokens


def _both(frames, tokens):
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)},
            {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens)})


def _np(t):
    return t.detach().cpu().float().numpy()


def _assert_cache_equal(got, want, tol):
    assert got["pos"] == int(want["pos"])
    got_np = convert.encdec_cache_to_numpy(got)
    for k in ("self_k", "self_v", "cross_k", "cross_v"):
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        np.testing.assert_allclose(got_np[k], np.asarray(want[k], np.float32),
                                   **tol, err_msg=k)


def test_params_and_init_follow_the_reference():
    """The converted tree and the port's own init have the same parameter
    names and shapes; the port draws 1/sqrt(fan-in) normals, norms at 1."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup()
    own = model.init(torch.Generator().manual_seed(0), torch.float32)
    assert isinstance(own, encdec.EncDec)
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == \
        {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert len(own.enc) == 2 and len(own.dec) == 2
    assert own.dec[0]["cross"]["q"]["w"].shape == (64, 4, 16)
    assert own.dec[0]["cross"]["k"]["w"].shape == (64, 2, 16)
    assert abs(float(own.embed["table"].std()) - 64 ** -0.5) < 0.01
    assert torch.equal(own.enc_norm["scale"], torch.ones(64))
    np.testing.assert_array_equal(
        _np(params.dec[1]["self"]["o"]["w"]),
        np.asarray(jparams["dec"]["self"]["o"]["w"][1]))
    assert model.init(torch.Generator().manual_seed(0)).embed[
        "table"].dtype == torch.bfloat16


def test_encode_and_decode_train_equal_reference():
    """The encoder (bidirectional) and the decoder over whole sequences,
    at S_enc != S_dec so the cross-attention is rectangular."""
    jcfg, tcfg, _, jparams, _, params = _setup(seed=1)
    frames, tokens = _inputs(np.random.default_rng(1), tcfg, 2, 24, 17)
    jenc = jencdec.encode(jcfg, jparams, jnp.asarray(frames), impl="blocked")
    enc = encdec.encode(tcfg, params, torch.from_numpy(frames))
    np.testing.assert_allclose(_np(enc), np.asarray(jenc), **TOL)
    jx = jencdec.decode_train(jcfg, jparams, jnp.asarray(tokens), jenc,
                              impl="blocked")
    x = encdec.decode_train(tcfg, params, torch.from_numpy(tokens), enc)
    assert x.shape == (2, 17, 64)
    np.testing.assert_allclose(_np(x), np.asarray(jx), **TOL)


def test_forward_and_prefill_equal_reference():
    """``Model.forward`` (encode then decode_train) and ``Model.prefill``,
    whose cache is None: the reference's prefill builds none."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup(seed=2)
    frames, tokens = _inputs(np.random.default_rng(2), tcfg, 3, 20, 20)
    jb, tb = _both(frames, tokens)
    np.testing.assert_allclose(_np(model.forward(params, tb)),
                               np.asarray(jmodel.forward(jparams, jb,
                                                         impl="blocked")),
                               **TOL)
    jlg, jcache = jmodel.prefill(jparams, jb, impl="blocked")
    lg, cache = model.prefill(params, tb, max_len=64)
    assert jcache is None and cache is None
    assert lg.shape == (3, 512) and lg.dtype == torch.float32
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_decode_8_steps_from_init_cache_equal_reference(cache_dtype):
    """Decode starts from ``init_cache`` (prefill leaves none), cross K/V
    zeros over ENC_LEN_DECODE frames: 8 steps, logits and every cache leaf
    with its dtype."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup(seed=3)
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    bf16 = cache_dtype == "bfloat16"
    jcache, axes = jmodel.init_cache(2, 16, jdt)
    cache = model.init_cache(2, 16, tdt)
    assert axes == encdec.cache_axes_encdec(tcfg)
    assert cache["cross_k"].shape == (2, 2, encdec.ENC_LEN_DECODE, 2, 16)
    assert encdec.ENC_LEN_DECODE == jencdec.ENC_LEN_DECODE == 4096
    _assert_cache_equal(cache, jcache, dict(atol=0, rtol=0))
    rng = np.random.default_rng(3)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t,
                                                      impl="blocked"))
    for i in range(8):
        t = rng.integers(2, tcfg.vocab, size=(2,)).astype(np.int32)
        jlg, jcache = step(jparams, jcache, jnp.asarray(t))
        lg, cache = model.decode_step(params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(
            lg.numpy(), np.asarray(jlg),
            **(BF16_CACHE_LOGIT_TOL if bf16 else TOL),
            err_msg=f"decode step {i}")
    _assert_cache_equal(cache, jcache, BF16_TOL if bf16 else TOL)


def test_cross_attention_over_init_cache_is_zero():
    """Mirrored from the reference: nothing fills the cross cache, so every
    decode step's cross-attention averages zero values and adds exactly
    0; a step equals the same step with the cross layers' output
    projections zeroed."""
    _, tcfg, _, _, model, params = _setup(seed=4)
    toks = torch.tensor([5, 9])
    lg, _ = model.decode_step(params, model.init_cache(2, 8, torch.float32),
                              toks)
    for lp in params.dec:
        lp["cross"]["o"]["w"].data.zero_()
    lg0, _ = model.decode_step(params, model.init_cache(2, 8, torch.float32),
                               toks)
    assert torch.equal(lg, lg0)


def test_cross_decode_over_a_filled_cache_equals_reference():
    """The reference's cache with its cross K/V filled from the same numpy
    values (a 24-frame encoder cache, kv_len = 24 on every row), carried
    across by ``convert.encdec_cache_from_jax``: 4 steps decode as in the
    reference, and the cross leaves are read, never written."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup(seed=5)
    rng = np.random.default_rng(5)
    jcache, _ = jencdec.init_cache_encdec(jcfg, 2, 12, jnp.float32,
                                          enc_len=24)
    for k in ("cross_k", "cross_v"):
        jcache[k] = jnp.asarray(rng.standard_normal(jcache[k].shape)
                                .astype(np.float32))
    cache = convert.encdec_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                          device="cpu")
    _assert_cache_equal(cache, jcache, dict(atol=0, rtol=0))
    cross = cache["cross_k"].clone()
    for i in range(4):
        t = rng.integers(2, tcfg.vocab, size=(2,)).astype(np.int32)
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(t),
                                         impl="blocked")
        lg, cache = model.decode_step(params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL,
                                   err_msg=f"decode step {i}")
    _assert_cache_equal(cache, jcache, TOL)
    assert torch.equal(cache["cross_k"], cross)


@pytest.mark.parametrize("seq,chunk", [(17, 512), (21, 8)])
def test_loss_and_grads_equal_reference(seq, chunk):
    """``encdec_loss`` (its logits carry vocab_bias) and its gradients
    against ``jax.value_and_grad`` of the reference's; chunk 8 at 20
    predictions drops the last 4, as the reference drops them. The
    encoder's and the cross layers' gradients go through the plain B5
    backward with ``causal=False``."""
    jcfg, tcfg, _, jparams, _, params = _setup(seed=6)
    frames, tokens = _inputs(np.random.default_rng(seq), tcfg, 2, 13, seq)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jencdec.encdec_loss(jcfg, p, jnp.asarray(frames),
                                      jnp.asarray(tokens), impl="blocked",
                                      chunk=chunk))(jparams)
    params.requires_grad_(True)
    loss = encdec.encdec_loss(tcfg, params, torch.from_numpy(frames),
                              torch.from_numpy(tokens), chunk=chunk)
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


def test_train_step_equals_reference():
    """One ``make_train_step`` step (accumulation 2) on an encdec batch
    (frames, tokens) against the reference's, both from the reference's
    parameters and AdamW state: loss, grad norm, moments, parameters."""
    jcfg, tcfg = _cfgs(microbatch=2)
    B, S = 4, 16
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(7), jnp.float32)
    jstep, jopt_init = jmake_train_step(jmodel, JShapeConfig("t", S, B,
                                                             "train"),
                                        make_host_mesh(), base_lr=1e-2,
                                        warmup=1, total_steps=10)
    step_fn, _ = make_train_step(build(tcfg, "cpu"),
                                 ShapeConfig("t", S, B, "train"),
                                 base_lr=1e-2, warmup=1, total_steps=10)
    assert step_fn.accum == jstep.accum == 2
    jopt = jopt_init(jparams)
    params = convert.encdec_params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), "cpu").requires_grad_(True)
    opt = convert.adamw_state_from_jax(tcfg, jax.tree.map(np.asarray, jopt),
                                       "cpu")
    frames, tokens = _inputs(np.random.default_rng(7), tcfg, B, S, S)
    jb, tb = _both(frames, tokens)
    jparams, jopt, jloss, jgn = jstep(jparams, jopt, jb, jnp.int32(1))
    params, opt, loss, gn = step_fn(params, opt, tb, 1)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(float(gn), float(jgn), **LOSS_TOL)
    for got, want in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        want = convert.lm_named_from_jax(tcfg, jax.tree.map(np.asarray,
                                                            want), "cpu")
        for k in want:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                       **STEP_TOL, err_msg=k)
    want = convert.lm_named_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                     "cpu")
    loose = total = 0
    for k, p in params.named_parameters():
        g, w = _np(p), _np(want[k])
        assert np.abs(g - w).max() <= 2 * 1e-2 * 1.001, k
        loose += int((~np.isclose(g, w, **STEP_TOL)).sum())
        total += g.size
    assert loose < 1e-3 * total


def test_specs_structs_and_counts_follow_the_reference():
    """``input_specs`` splits seq_len evenly into frames and tokens;
    ``cache_struct`` and ``param_struct`` are meta-device stand-ins of the
    reference's shapes; ``param_counts`` of the full config equals the
    reference's (~0.72 B with the padded vocab)."""
    jcfg, tcfg = _cfgs()
    model, jmodel = build(tcfg, "cpu"), jbuild(jcfg)
    for kind in ("train", "prefill", "decode"):
        specs = model.input_specs(ShapeConfig("s", 64, 8, kind))
        jspecs, _ = jmodel.input_specs(JShapeConfig("s", 64, 8, kind))
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in specs.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
    struct = model.cache_struct(ShapeConfig("d", 32, 2, "decode"))
    jstruct, _ = jmodel.cache_struct(JShapeConfig("d", 32, 2, "decode"))
    assert struct["pos"] == 0
    for k in ("self_k", "self_v", "cross_k", "cross_v"):
        assert struct[k].device.type == "meta"
        assert tuple(struct[k].shape) == jstruct[k].shape
    shapes = model.param_struct(torch.float32)
    assert all(p.device.type == "meta" for p in shapes.parameters())
    full = get_arch(ARCH)
    assert build(full, "cpu").param_counts() == \
        jbuild(ARCHS[ARCH]).param_counts()
    total, active = build(full, "cpu").param_counts()
    assert total == active and 0.7e9 < total < 0.75e9


def test_serve_raises_key_error_like_the_reference():
    """Mirrored from the reference: its ``launch.serve`` reads
    ``params["segments"]`` and dies with ``KeyError: 'segments'`` on an
    encoder-decoder; the port's raises the same KeyError."""
    with pytest.raises(KeyError, match="segments"):
        serve.run(["--arch", ARCH, "--reduced", "--device", "cpu"])
