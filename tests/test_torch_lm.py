"""Port LM (forward, prefill, decode_step) held against the JAX package.

Reduced gemma3-1b (local + global layers, MQA, RMSNorm), the same with a
5th layer (a tail segment), reduced olmo-1b (GQA, non-parametric
LayerNorm), olmo with as many KV heads as query heads (MHA), reduced
mamba2-370m (4 mamba layers, no MLP; d_inner 128, H 16, N 16, P 8), and
the MoE and hybrid families: reduced moonshot-v1-16b-a3b (a dense layer,
then 3 attention + MoE layers, 4 experts top-2), phi3.5-moe-42b-a6.6b (4
attention + MoE layers, untied head) and jamba-1.5-large-398b (two 4-layer
bodies of mamba and attention mixers, MoE on every odd position). The
JAX package's ``init`` parameters (float32) cross over through
``convert.lm_params_from_jax``; the same token arrays go to both packages,
JAX with ``impl="blocked"`` for the attention models and
``impl="interpret"`` (the Pallas SSD kernel in interpret mode) for mamba
and jamba,
whose blocked path is not finite at Mamba-2's decays over a 128-step chunk
(``test_torch_ssd.py``), and the port on the CPU (the plain versions).

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
rtol 1e-3). Mamba's chunked scan takes its decays as exp of differences of
f32 cumulative sums (relative error ~1e-5 per decay, against the oracle's
products; ``test_torch_ssd.py``), inside the same 1e-4 through 4 layers.
A mamba layer's SSM state and, with f32 parameters, its conv tails stay
f32 in a bf16 cache, so mamba's prefill caches are held to TOL whatever
the cache dtype. torch's softplus returns x above its threshold of 20
where JAX's is logaddexp(x, 0); they differ by under 2e-9 there, below
f32's spacing at 20, and by at most two f32 ulps below it
(``test_softplus_agrees_with_reference``).
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
from repro_torch.configs import ARCHS as TARCHS
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
    "mamba2-370m": ("mamba2-370m", {}),
    "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {}),
    "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", {}),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}),
    "minicpm-2b": ("minicpm-2b", {}),
    "qwen2.5-32b": ("qwen2.5-32b", {}),
    "qwen2.5-32b-g5": ("qwen2.5-32b", {"n_heads": 10, "n_kv_heads": 2}),
    "llava-next-34b": ("llava-next-34b", {}),
}


def _impl(variant):
    """The JAX path each variant is held against: the Pallas SSD in
    interpret mode wherever the model has mamba layers."""
    return ("interpret" if variant.startswith(("mamba", "jamba"))
            else "blocked")


def _cfgs(variant):
    name, kw = VARIANTS[variant]
    jcfg = ARCHS[name].reduced().replace(remat=False, **kw)
    tcfg = get_arch(name).reduced().replace(remat=False, **kw)
    assert jcfg.__dict__ == tcfg.__dict__
    return jcfg, tcfg


def _with_random_biases(jparams, seed):
    """The reference inits qwen's q/k/v biases at 0; give every bias leaf
    seeded values so both packages' bias paths are compared."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape)
                                    .astype(np.float32)) if k == "b"
                        else fill(v)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v) for v in tree)
        return tree
    return fill(jparams)


def _setup(variant, seed=0):
    jcfg, tcfg = _cfgs(variant)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed), jnp.float32)
    if jcfg.qkv_bias:
        jparams = _with_random_biases(jparams, seed)
    params = convert.lm_params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jmodel, jparams, build(tcfg, "cpu"), params


def _tokens(rng, cfg, shape):
    return rng.integers(0, cfg.vocab, size=shape).astype(np.int32)


def _dtype_tree(tree):
    if isinstance(tree, dict):
        return {k: _dtype_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dtype_tree(v) for v in tree]
    return str(tree.dtype).split(".")[-1]


def _assert_cache_equal(got, want, tol):
    """Same pos, same leaves in the same order with the same dtypes, and
    values within ``tol``."""
    assert got["pos"] == int(want["pos"])
    assert jax.tree.leaves(_dtype_tree(got["segments"])) == \
        jax.tree.leaves(_dtype_tree(want["segments"]))
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
    jx = jlm.forward(jcfg, jparams, jnp.asarray(toks), impl=_impl(variant))
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
    bf16 = cache_dtype == "bfloat16" and tcfg.family != "ssm"
    tol = BF16_TOL if bf16 else TOL
    lg_tol = BF16_CACHE_LOGIT_TOL if bf16 else TOL
    rng = np.random.default_rng(2)
    B, S, max_len = 2, 20, 32
    toks = _tokens(rng, tcfg, (B, S))
    jlg, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                 max_len=max_len, impl=_impl(variant),
                                 cache_dtype=jdt)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              max_len=max_len, cache_dtype=tdt)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_equal(cache, jcache, tol)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t,
                                                       impl=_impl(variant)))
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
    """Every architecture of the JAX package resolves and builds now: the
    four that waited for a later slice (minicpm-2b, qwen2.5-32b,
    llava-next-34b, seamless-m4t-medium) with the others; each reduced
    config equals the reference's, builds on the CPU and inits. Only an
    unknown name raises."""
    assert sorted(ARCHS) == sorted(TARCHS) and len(ARCHS) == 10
    for arch in ARCHS:
        cfg = get_arch(arch)
        assert cfg.__dict__ == ARCHS[arch].__dict__
        model = build(cfg.reduced().replace(remat=False), "cpu")
        params = model.init(torch.Generator().manual_seed(0), torch.float32)
        assert sum(p.numel() for p in params.parameters()) == \
            model.param_counts()[0]
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("nope")


@pytest.mark.parametrize("variant", ["gemma3-1b", "olmo-1b-mha",
                                     "mamba2-370m"])
def test_decode_continues_from_reference_cache(variant):
    """The reference's prefill cache, carried across by
    ``convert.lm_cache_from_jax``, decodes in the port as in the
    reference; ``lm_cache_to_numpy`` gives back the reference's tree."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup(variant, seed=5)
    rng = np.random.default_rng(6)
    toks = _tokens(rng, tcfg, (2, 18))
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                               max_len=24, impl=_impl(variant),
                               cache_dtype=jnp.float32)
    cache = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                      device="cpu")
    _assert_cache_equal(cache, jcache, dict(atol=0, rtol=0))
    for _ in range(4):
        t = _tokens(rng, tcfg, (2,))
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(t),
                                         impl=_impl(variant))
        lg, cache = model.decode_step(params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_equal(cache, jcache, TOL)


# -- mamba2-370m (ssm family) ------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("S", [12, 256])
def test_mamba_prefill_and_decode_equal_reference(S, cache_dtype):
    """Prefill at S = 12 (one short chunk) and S = 256 (the state carried
    across a 128-step chunk, at decays whose chunk sums pass exp's f32
    overflow), every cache leaf with its dtype, then 12 decode steps."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup("mamba2-370m",
                                                        seed=7)
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    rng = np.random.default_rng(8)
    B = 2
    toks = _tokens(rng, tcfg, (B, S))
    jlg, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                 impl="interpret", cache_dtype=jdt)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              cache_dtype=tdt)
    assert np.isfinite(np.asarray(jlg)).all()
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    c = cache["segments"][0][0]
    assert {k: (tuple(t.shape), t.dtype) for k, t in c.items()} == {
        "conv_x": ((4, B, 3, 128), torch.float32),
        "conv_BC": ((4, B, 3, 32), torch.float32),
        "h": ((4, B, 16, 16, 8), torch.float32)}
    _assert_cache_equal(cache, jcache, TOL)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t))
    for i in range(12):
        t = _tokens(rng, tcfg, (B,))
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(t))
        lg, cache = model.decode_step(params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL,
                                   err_msg=f"decode step {i}")
    _assert_cache_equal(cache, jcache, TOL)


def test_mamba_bf16_cache_tails_promote_like_reference():
    """``init_cache(dtype=bf16)`` gives bf16 conv tails beside the f32
    state; the reference's decode concatenates them with f32 rows, so they
    come back f32 after one step. The port promotes the stacked leaves
    once and writes them in place after that: the same values and dtypes
    over 12 steps."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup("mamba2-370m",
                                                        seed=9)
    jcache, _ = jmodel.init_cache(2, 16, jnp.bfloat16)
    cache = model.init_cache(2, 16, torch.bfloat16)
    _assert_cache_equal(cache, jcache, dict(atol=0, rtol=0))
    assert cache["segments"][0][0]["conv_x"].dtype == torch.bfloat16
    assert cache["segments"][0][0]["h"].dtype == torch.float32
    rng = np.random.default_rng(10)
    for i in range(12):
        t = _tokens(rng, tcfg, (2,))
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(t))
        lg, cache = model.decode_step(params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL,
                                   err_msg=f"decode step {i}")
        _assert_cache_equal(cache, jcache, TOL)
    assert cache["segments"][0][0]["conv_x"].dtype == torch.float32


def test_mamba_short_prompt_tails_mirror_reference():
    """S < K - 1: the reference's tail slice starts at ``S - (K - 1)``, a
    negative index, so at S = 2 it keeps the last row only; the port
    mirrors it (not fixed) and, as the reference does, cannot decode from
    such a cache."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup("mamba2-370m",
                                                        seed=11)
    toks = _tokens(np.random.default_rng(12), tcfg, (2, 2))
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                               impl="interpret", cache_dtype=jnp.float32)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                             cache_dtype=torch.float32)
    assert cache["segments"][0][0]["conv_x"].shape == (4, 2, 1, 128)
    _assert_cache_equal(cache, jcache, TOL)
    with pytest.raises(RuntimeError):
        model.decode_step(params, cache, torch.zeros(2, dtype=torch.long))


def test_to_module_keeps_mixed_trees():
    """A mamba layer's tree mixes sub-dicts with bare tensors; to_module
    makes the tensors parameters under their own keys, and indexes and
    answers ``in`` as the dict did."""
    from repro_torch.models.layers import to_module
    tree = {"z": {"w": torch.ones(2, 3)}, "A_log": torch.zeros(4),
            "norm": {"scale": torch.ones(3)}, "empty": {}}
    m = to_module(tree)
    assert sorted(n for n, _ in m.named_parameters()) == [
        "A_log", "norm.scale", "z.w"]
    assert torch.equal(m["A_log"], tree["A_log"])
    assert torch.equal(m["z"]["w"], tree["z"]["w"])
    assert not m["A_log"].requires_grad
    assert "A_log" in m and "z" in m and "w" in m["z"]
    assert "b" not in m["z"] and "w" not in m


def test_softplus_agrees_with_reference():
    """The dt gate: torch's softplus (x itself above 20) against JAX's
    logaddexp(x, 0) in f32. Above 20 they differ by under 2e-9, below the
    f32 spacing there, so they are equal; below it the two libraries'
    exp/log1p differ by up to ~1.3 f32 ulps (held to two, rtol 2**-22)."""
    x = np.linspace(-40.0, 60.0, 20001, dtype=np.float32)
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=0, rtol=2.0 ** -22)
    np.testing.assert_array_equal(got[x > 20], want[x > 20])


# -- the remaining dense and vlm configs (qwen, minicpm, llava) ----------------------

def test_qkv_bias_is_added_in_both_paths():
    """qwen's q/k/v biases (seeded, non-zero) enter prefill and decode as
    in the reference: the logits move when they are zeroed, in both
    packages alike (the VARIANTS tests hold the values)."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup("qwen2.5-32b",
                                                        seed=13)
    assert all("b" in layer.attn[n] for *_, layer in params.all_layers()
               for n in ("q", "k", "v"))
    assert "b" not in params.segments[0][0].attn["o"]
    toks = _tokens(np.random.default_rng(13), tcfg, (2, 10))
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              max_len=16, cache_dtype=torch.float32)
    dec, _ = model.decode_step(params, cache, torch.tensor([3, 4]))
    for *_, layer in params.all_layers():
        for n in ("q", "k", "v"):
            layer.attn[n]["b"].data.zero_()
    lg0, cache0 = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                max_len=16, cache_dtype=torch.float32)
    dec0, _ = model.decode_step(params, cache0, torch.tensor([3, 4]))
    assert float((lg - lg0).abs().max()) > 1e-2
    assert float((dec - dec0).abs().max()) > 1e-2


def test_llava_patches_forward_prefill_decode_and_loss_equal_reference():
    """llava's stub vision frontend: ``frontend_tokens`` (8 reduced) patch
    embeddings prepended to the text, as ``_embed_inputs`` does in both
    packages. forward at every position, prefill logits and cache, 6
    decode steps from that cache, and the loss (over the text only), with
    the untied head carried across."""
    jcfg, tcfg, jmodel, jparams, model, params = _setup("llava-next-34b",
                                                        seed=14)
    assert params.head is not None and not tcfg.tie_embeddings
    rng = np.random.default_rng(14)
    B, S = 2, 16
    patches = rng.standard_normal((B, tcfg.frontend_tokens, tcfg.d_model)
                                  ).astype(np.float32)
    toks = _tokens(rng, tcfg, (B, S))
    jb = {"patches": jnp.asarray(patches), "tokens": jnp.asarray(toks)}
    tb = {"patches": torch.from_numpy(patches),
          "tokens": torch.from_numpy(toks)}
    jx = jmodel.forward(jparams, jb, impl="blocked")
    x = model.forward(params, tb)
    assert x.shape == (B, S + 8, 64)
    np.testing.assert_allclose(lm.logits(tcfg, params, x).numpy(),
                               np.asarray(jlm.logits(jcfg, jparams, jx)),
                               **TOL)
    jlg, jcache = jmodel.prefill(jparams, jb, max_len=32, impl="blocked",
                                 cache_dtype=jnp.float32)
    lg, cache = model.prefill(params, tb, max_len=32,
                              cache_dtype=torch.float32)
    assert cache["pos"] == S + 8
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_cache_equal(cache, jcache, TOL)
    for i in range(6):
        t = _tokens(rng, tcfg, (B,))
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(t),
                                         impl="blocked")
        lg, cache = model.decode_step(params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL,
                                   err_msg=f"decode step {i}")
    np.testing.assert_allclose(float(model.loss(params, tb)),
                               float(jmodel.loss(jparams, jb,
                                                 impl="blocked")), **TOL)


def test_full_config_param_counts_equal_reference():
    """The four configs of this family group at full width: total and
    active counts equal the reference's (meta device, no allocation);
    qwen2.5-32b's total lies in [31e9, 36e9]."""
    counts = {}
    for arch in ("minicpm-2b", "qwen2.5-32b", "llava-next-34b",
                 "seamless-m4t-medium"):
        counts[arch] = build(get_arch(arch), "cpu").param_counts()
        assert counts[arch] == jbuild(ARCHS[arch]).param_counts(), arch
    assert 31e9 <= counts["qwen2.5-32b"][0] <= 36e9
