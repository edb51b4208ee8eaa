"""The port's MoE FFN (``models/moe.py``) held against the JAX package's.

The same numpy-seeded inputs and the reference's ``moe_init`` parameters go
through ``repro.models.moe.moe_ffn`` (its global-dispatch path: no mesh is
installed) and the port's. Routes are compared as chosen expert ids, the
reference's taken with its own rule (f32 softmax of the router logits,
``jax.lax.top_k``).

Tolerances, from the arithmetic:
* f32: both sides sum the same products in other orders (BLAS vs
  ``torch.bmm``): outputs of O(1) through products of depth D = 64 and
  F = 128 agree to ~1e-6; held to atol = rtol = 1e-5. Routes are equal
  wherever the k-th and (k+1)-th probabilities are more than 1e-5 apart
  (they are, at these seeds, for every token).
* bf16: the parameters, the expert activations and each token's
  contributions are bf16 on both sides; either side may round a product of
  a depth-64 or depth-128 sum to the neighbouring bf16 value (2**-8
  relative), and a flip in the hidden activation moves the down projection
  by about that much again. Outputs are held to atol = rtol = 2**-6 (four
  bf16 ulps) on tokens whose routes agree. The router logits themselves are
  bf16 sums in another order, so a route may differ where the k-th and
  (k+1)-th probabilities are within 2**-6 of each other, nowhere else.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.models import build
from repro_torch.models import moe

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2.0 ** -6, rtol=2.0 ** -6)
ROUTE_MARGIN = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _cfgs(**kw):
    jcfg = ARCHS["moonshot-v1-16b-a3b"].reduced().replace(**kw)
    tcfg = get_arch("moonshot-v1-16b-a3b").reduced().replace(**kw)
    assert jcfg.__dict__ == tcfg.__dict__
    return jcfg, tcfg


def _params(jcfg, dtype, seed=0):
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg,
                          getattr(jnp, dtype))
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        getattr(torch, dtype)) for k, v in jp.items()}
    return jp, tp


def _ref_routes(jp, x, cfg):
    """The reference's probabilities and top-k ids of tokens x (T, D)."""
    logits = (x @ jp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, ids = jax.lax.top_k(probs, cfg.top_k)
    return np.asarray(probs), np.asarray(ids)


def _margin(probs, k):
    """Per token, the k-th minus the (k+1)-th largest probability."""
    s = -np.sort(-probs, axis=-1)
    return s[:, k - 1] - s[:, k]


def _compare(jcfg, tcfg, jp, tp, x_np, dtype):
    x = jnp.asarray(x_np).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x_np).to(getattr(torch, dtype))
    want = np.asarray(jmoe.moe_ffn(jp, x, jcfg), np.float32)
    got = moe.moe_ffn(tp, xt, tcfg)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    got = got.float().numpy()
    T = x_np.shape[0] * x_np.shape[1]
    probs, ids = _ref_routes(jp, x.reshape(T, -1), jcfg)
    _, _, tids = moe.route(tp, xt.reshape(T, -1), tcfg)
    same = (np.sort(tids.numpy(), -1) == np.sort(ids, -1)).all(-1)
    near = _margin(probs, jcfg.top_k) <= ROUTE_MARGIN[dtype]
    assert (same | near).all()
    tol = TOL if dtype == "float32" else BF16_TOL
    # a route that differs changes the token and no other
    keep = same.reshape(x_np.shape[:2])
    np.testing.assert_allclose(got[keep], want[keep], **tol)
    return same, tids.numpy(), ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k,B,S", [(4, 2, 2, 24), (8, 3, 3, 40),
                                     (16, 6, 4, 1)])
def test_moe_ffn_equals_reference(E, k, B, S, dtype):
    """Outputs and chosen experts, from moonshot's reduced config (E 4,
    top-2) to its full top-6 routing over 16 experts; S = 1 is decode."""
    jcfg, tcfg = _cfgs(n_experts=E, top_k=k)
    jp, tp = _params(jcfg, dtype, seed=E + k)
    x = np.random.default_rng(E * k + S).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    same, tids, ids = _compare(jcfg, tcfg, jp, tp, x, dtype)
    if dtype == "float32":
        assert same.all()
        np.testing.assert_array_equal(tids, ids)


def _exact_inputs(rng, T, D):
    """Tokens of -1, 0 and 1 halves: with router entries in eighths, every
    logit is an exact f32 (and bf16) sum, so equal columns tie exactly."""
    return (rng.integers(-1, 2, size=(T, D)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_top_k_ties_take_the_lower_expert(dtype):
    """Router columns 1 and 2 equal, column 0 far above and column 3 far
    below both: every token's second choice ties between experts 1 and 2,
    and both packages take expert 1 (``jax.lax.top_k``'s rule)."""
    jcfg, tcfg = _cfgs()                              # E 4, top-2
    D = jcfg.d_model
    rng = np.random.default_rng(3)
    router = rng.integers(-2, 3, size=(D, 4)).astype(np.float32) / 8
    router[:, 2] = router[:, 1]
    router[0] = [8.0, 0.0, 0.0, -8.0]
    x = _exact_inputs(rng, 2 * 12, D)
    x[:, 0] = 1.0
    jp, tp = _params(jcfg, dtype)
    jp["router"] = jnp.asarray(router).astype(getattr(jnp, dtype))
    tp["router"] = torch.from_numpy(router).to(getattr(torch, dtype))
    same, tids, ids = _compare(jcfg, tcfg, jp, tp, x.reshape(2, 12, D),
                               dtype)
    assert same.all()
    np.testing.assert_array_equal(ids, [[0, 1]] * 24)
    np.testing.assert_array_equal(tids, ids)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_drops_past_capacity_like_reference(dtype):
    """Every token prefers expert 0: 200 tokens x top-2 over 4 experts give
    C = 128, so expert 0 keeps the first 128 tokens in the stable order
    and drops the other 72 of its slots, as the reference does."""
    jcfg, tcfg = _cfgs()
    D = jcfg.d_model
    rng = np.random.default_rng(4)
    router = rng.integers(-2, 3, size=(D, 4)).astype(np.float32) / 8
    router[0] = [8.0, 0.0, 0.0, 0.0]
    x = _exact_inputs(rng, 200, D)
    x[:, 0] = 1.0
    jp, tp = _params(jcfg, dtype, seed=1)
    jp["router"] = jnp.asarray(router).astype(getattr(jnp, dtype))
    tp["router"] = torch.from_numpy(router).to(getattr(torch, dtype))
    assert moe._capacity(200, 2, 4, 1.25) == jmoe._capacity(200, 2, 4,
                                                            1.25) == 128
    same, tids, _ = _compare(jcfg, tcfg, jp, tp, x.reshape(2, 100, D),
                             dtype)
    assert same.all() and (tids[:, 0] == 0).all()
    dest = moe.dispatch(torch.from_numpy(tids), 200, 4, 128)
    dropped = (dest == 4 * 128).numpy()
    assert dropped.sum() == 72
    assert not dropped[:128].any() and dropped[128:, 0].all()


def test_aux_load_balance_loss_equals_reference():
    jcfg, tcfg = _cfgs(n_experts=8, top_k=2)
    jp, tp = _params(jcfg, "float32", seed=5)
    x = np.random.default_rng(6).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    want = float(jmoe.aux_load_balance_loss(jp, jnp.asarray(x), jcfg))
    got = float(moe.aux_load_balance_loss(tp, torch.from_numpy(x), tcfg))
    assert got == pytest.approx(want, rel=1e-6)


def test_moe_init_draws_reference_distributions():
    """Shapes as the reference's; normal with 1/sqrt(fan-in) scale."""
    cfg = get_arch("moonshot-v1-16b-a3b").reduced().replace(n_experts=8,
                                                            d_ff=256)
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for name, fan_in in (("router", 64), ("gate", 64), ("up", 64),
                         ("down", 256)):
        assert p[name].dtype == torch.float32
        assert abs(float(p[name].std()) * fan_in ** 0.5 - 1) < 0.05, name
        assert abs(float(p[name].mean())) < 0.01
    bf = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                      "cpu")
    assert all(v.dtype == torch.bfloat16 for v in bf.values())


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b"])
def test_param_counts_equal_reference(arch):
    """Total and active counts of the full-width configs, on the meta
    device, equal the reference's to the parameter, inside
    ``test_models.py``'s ranges."""
    got = build(get_arch(arch), "cpu").param_counts()
    assert got == jbuild(ARCHS[arch]).param_counts()
    tot, act = got
    lo, hi = {"moonshot-v1-16b-a3b": ((25e9, 30e9), (2e9, 4.5e9)),
              "phi3.5-moe-42b-a6.6b": ((38e9, 46e9), (5e9, 8e9)),
              "jamba-1.5-large-398b": ((330e9, 430e9), (60e9, 130e9))}[arch]
    assert lo[0] < tot < lo[1] and hi[0] < act < hi[1]
