"""Port LM (forward, prefill, decode_step) held against the JAX package.

Reduced gemma3-1b (local + global layers, MQA, RMSNorm), the same with a
5th layer (a tail segment), reduced olmo-1b (GQA, non-parametric
LayerNorm) and olmo with as many KV heads as query heads (MHA). The JAX
package's ``init`` parameters (float32) cross over through
``convert.lm_params_from_jax``; the same token arrays go to both packages,
JAX with ``impl="blocked"`` and the port on the CPU (the plain versions).

Tolerances, from the arithmetic: both sides do f32 math with sums in other
orders (blocked vs whole attention, other einsum/matmul orders). Through 4-5
layers of O(1) activations that leaves differences of a few 1e-6 in logits
of magnitude up to ~5, so logits and f32 cache leaves are held to
atol = rtol = 1e-4. bf16 cache leaves are f32 values rounded once on each
side; an f32 difference can flip that rounding by one ulp, so they are held
to two bf16 ulps (atol = 2**-8, rtol = 2**-6). Decode logits read a bf16
cache: one cache entry rounded the other way (2**-8 of an O(1) value)
moves an attention output by up to ~4e-3 times its probability, which the
output projection (weights ~1/8) and the later layers carry into the
logits at up to ~1e-3, so those logits are held to atol = rtol = 2e-3.
The port's own
decode-vs-forward check uses the reference test's tolerance (atol 5e-4,
rtol 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import build as jbuild
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import build
from repro_torch.models import lm

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -6)
BF16_CACHE_LOGIT_TOL = dict(atol=2e-3, rtol=2e-3)

VARIANTS = {
    "gemma3-1b": ("gemma3-1b", {}),
    "gemma3-1b-tail": ("gemma3-1b", {"n_layers": 5}),
    "olmo-1b": ("olmo-1b", {}),
    "olmo-1b-mha": ("olmo-1b", {"n_kv_heads": 4}),
}


def _cfgs(variant):
    name, kw = VARIANTS[variant]
    jcfg = ARCHS[name].reduced().replace(remat=False, **kw)
    tcfg = get_arch(name).reduced().replace(remat=False, **kw)
    assert jcfg.__dict__ == tcfg.__dict__
    return jcfg, tcfg


def _setup(variant, seed=0):
    jcfg, tcfg = _cfgs(variant)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed), jnp.float32)
    params = convert.lm_params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jmodel, jparams, build(tcfg, "cpu"), params


def _tokens(rng, cfg, shape):
    return rng.integers(0, cfg.vocab, size=shape).astype(np.int32)


def _assert_cache_equal(got, want, tol):
    assert got["pos"] == int(want["pos"])
    got_np = convert.lm_cache_to_numpy(got)
    a = jax.tree.leaves(got_np)
    b = jax.tree.leaves(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     want))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, **tol)


def test_schedule_and_layer_order_follow_the_scan():
    jcfg, tcfg = _cfgs("gemma3-1b-tail")

    def flat(sched):
        return [(tuple((x.mixer, x.ffn) for x in s.body), s.count)
                for s in sched]
    assert flat(lm.build_schedule(tcfg)) == flat(jlm.build_schedule(jcfg))
    sched = lm.build_schedule(tcfg)
    assert [s.count for s in sched] == [2, 1]
    params = lm.init_lm(tcfg, torch.Generator().manual_seed(0),
                        torch.float32, "cpu")
    mixers = [layer.spec.mixer for *_, layer in params.all_layers()]
    assert mixers == ["attn_local", "attn", "attn_local", "attn",
                      "attn_local"]
    assert [len(s) for s in params.segments] == [4, 1]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_equals_reference(variant):
    jcfg, tcfg, _, jparams, _, params = _setup(variant)
    toks = _tokens(np.random.default_rng(1), tcfg, (2, 24))
    jx = jlm.forward(jcfg, jparams, jnp.asarray(toks), impl="blocked")
    want = np.asarray(jlm.logits(jcfg, jparams, jx))
    x = lm.forward(tcfg, params, torch.from_numpy(toks))
    got = lm.logits(tcfg, params, x).numpy()
    assert got.shape == want.shape == (2, 24, 512)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_then_12_decode_steps_equal_reference(variant, cache_dtype):
    jcfg, tcfg, jmodel, jparams, model, params = _setup(variant)
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    tol = BF16_TOL if cache_dtype == "bfloat16" else TOL
    lg_tol = BF16_CACHE_LOGIT_TOL if cache_dtype == "bfloat16" else TOL
    rng = np.random.default_rng(2)
    B, S, max_len = 2, 20, 32
    toks = _tokens(rng, tcfg, (B, S))
    jlg, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                 max_len=max_len, impl="blocked",
                                 cache_dtype=jdt)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              max_len=max_len, cache_dtype=tdt)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_equal(cache, jcache, tol)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t,
                                                       impl="blocked"))
    for i in range(12):
        t = _tokens(rng, tcfg, (B,))
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(t))
        lg, cache = model.decode_step(params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **lg_tol,
                                   err_msg=f"decode step {i}")
    _assert_cache_equal(cache, jcache, tol)


@pytest.mark.parametrize("variant", ["gemma3-1b", "olmo-1b"])
def test_decode_past_max_len_clamps_like_reference(variant):
    """pos >= max_len: the reference's dynamic_update_slice clamps the write
    to max_len - 1 while kv_len = pos + 1 keeps growing; the port clamps
    the same way instead of raising or writing out of range."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup(variant, seed=3)
    rng = np.random.default_rng(4)
    B, S = 2, 16
    toks = _tokens(rng, tcfg, (B, S))
    jlg, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                 max_len=S, impl="blocked",
                                 cache_dtype=jnp.float32)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                             max_len=S, cache_dtype=torch.float32)
    for _ in range(3):                        # pos 16, 17, 18 on a 16-deep cache
        t = _tokens(rng, tcfg, (B,))
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(t),
                                         impl="blocked")
        lg, cache = model.decode_step(params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    assert cache["pos"] == S + 3
    _assert_cache_equal(cache, jcache, TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_matches_forward(variant):
    """The port alone, with its own init (a torch.Generator): decoding a
    sequence token by token gives forward's logits at every position."""
    _, tcfg = _cfgs(variant)
    model = build(tcfg, "cpu")
    params = model.init(torch.Generator().manual_seed(1), torch.float32)
    B, S = 2, 20
    toks = torch.from_numpy(_tokens(np.random.default_rng(5), tcfg, (B, S)))
    full = lm.logits(tcfg, params, model.forward(params, {"tokens": toks}))
    cache = model.init_cache(B, 24, torch.float32)
    for t in range(S):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   atol=5e-4, rtol=1e-3)


def test_init_draws_reference_distributions():
    """Same shapes as the reference's tree; normal with 1/sqrt(fan-in)
    scale; norm scales at 1."""
    jcfg, tcfg = _cfgs("gemma3-1b")
    jparams, _ = jbuild(jcfg).init(jax.random.PRNGKey(0), jnp.float32)
    params = build(tcfg, "cpu").init(torch.Generator().manual_seed(0),
                                     torch.float32)
    conv = convert.lm_params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                         jparams), "cpu")
    assert {n: tuple(p.shape) for n, p in params.named_parameters()} == \
        {n: tuple(p.shape) for n, p in conv.named_parameters()}
    table = params.embed["table"]
    assert table.dtype == torch.float32
    assert abs(float(table.std()) - 64 ** -0.5) < 0.01
    q = params.segments[0][0].attn["q"]["w"]
    assert q.shape == (64, 4, 16)
    assert abs(float(q.std()) - 64 ** -0.5) < 0.02
    assert torch.equal(params.final_norm["scale"], torch.ones(64))
    bf = build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert bf.embed["table"].dtype == torch.bfloat16


def test_unported_families_raise():
    with pytest.raises(KeyError, match="ROADMAP A18"):
        get_arch("mamba2-370m")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("nope")
    cfg = ARCHS["mamba2-370m"].reduced()
    from repro_torch.configs.base import ArchConfig
    tcfg = ArchConfig(**cfg.__dict__)
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        lm.init_lm(tcfg, torch.Generator(), torch.float32, "cpu")


@pytest.mark.parametrize("variant", ["gemma3-1b", "olmo-1b-mha"])
def test_decode_continues_from_reference_cache(variant):
    """The reference's prefill cache, carried across by
    ``convert.lm_cache_from_jax``, decodes in the port as in the
    reference; ``lm_cache_to_numpy`` gives back the reference's tree."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup(variant, seed=5)
    rng = np.random.default_rng(6)
    toks = _tokens(rng, tcfg, (2, 18))
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                               max_len=24, impl="blocked",
                               cache_dtype=jnp.float32)
    cache = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                      device="cpu")
    _assert_cache_equal(cache, jcache, dict(atol=0, rtol=0))
    for _ in range(4):
        t = _tokens(rng, tcfg, (2,))
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(t),
                                         impl="blocked")
        lg, cache = model.decode_step(params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_equal(cache, jcache, TOL)
