"""The port's gradient compression (``repro_torch.parallel.compression``)
held against the JAX package's.

* ``test_substrates.py``'s two compression cases on the port.
* ``quantize_int8`` and ``compress_tree`` equal the reference bit for bit
  on seeded f32 and bf16 trees: int8 payloads, f32 scales and f32
  residuals, over several error-feedback rounds.
* ``psum_compressed`` over a one-rank ``gloo`` group, and with no group,
  equals the reference's psum over a one-device ``shard_map``.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as jc
from repro_torch.parallel import compression as tc


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256,)) * 3)
    q, s = tc.quantize_int8(x)
    err = (tc.dequantize_int8(q, s) - x).abs().numpy()
    assert err.max() <= float(s) / 2 + 1e-6


def test_error_feedback_is_unbiased_over_steps():
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.normal(size=(64,)))}
    res = tc.zero_residual(g)
    sent = np.zeros(64)
    for _ in range(50):
        q, s, res = tc.compress_tree(g, res)
        sent += tc.dequantize_int8(q["w"], s["w"]).numpy()
    np.testing.assert_allclose(sent / 50, g["w"].numpy(), atol=1e-2)


def _tree(seed, bf16):
    """Seeded leaves of assorted shapes and scales, one all zero and one
    with exact half-way values (round half to even)."""
    rng = np.random.default_rng(seed)
    leaves = {"w": rng.normal(size=(33, 17)) * 3.0,
              "b": rng.normal(size=(129,)) * 1e-3,
              "e": rng.standard_t(2, size=(4, 8, 16)),
              "z": np.zeros((7,)),
              "h": np.array([127.0, 0.5, 1.5, -2.5, 3.5, -0.5, 64.5])}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    if bf16:
        jt = {k: jnp.asarray(v, jnp.bfloat16) for k, v in leaves.items()}
        tt = {k: torch.from_numpy(np.array(jt[k].astype(jnp.float32)))
              .to(torch.bfloat16) for k in leaves}
    else:
        jt = {k: jnp.asarray(v) for k, v in leaves.items()}
        tt = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
    return jt, tt



@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_quantize_equals_reference_bit_for_bit(bf16):
    jt, tt = _tree(2, bf16)
    for k in jt:
        jq, js = jc.quantize_int8(jt[k])
        q, s = tc.quantize_int8(tt[k])
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
        np.testing.assert_array_equal(
            tc.dequantize_int8(q, s).numpy(),
            np.asarray(jc.dequantize_int8(jq, js)))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_compress_tree_equals_reference_over_rounds(bf16):
    jt, tt = _tree(3, bf16)
    jres, res = jc.zero_residual(jt), tc.zero_residual(tt)
    for _ in range(4):
        jq, js, jres = jc.compress_tree(jt, jres)
        q, s, res = tc.compress_tree(tt, res)
        for k in jt:
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            assert s[k].numpy().tobytes() == \
                np.asarray(js[k], np.float32).tobytes()
            assert res[k].dtype == torch.float32
            np.testing.assert_array_equal(res[k].numpy(),
                                          np.asarray(jres[k]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_psum(jt, jres):
    from jax.sharding import PartitionSpec as P
    mesh = jax.make_mesh((1,), ("pod",))
    f = jax.shard_map(lambda g, r: jc.psum_compressed(g, r, "pod"),
                      mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    return f(jt, jres)


def test_psum_compressed_over_one_rank_gloo_group():
    import torch.distributed as dist
    jt, tt = _tree(4, False)
    want, want_res = _reference_psum(jt, jc.zero_residual(jt))
    alone, alone_res = tc.psum_compressed(tt, tc.zero_residual(tt))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        group = dist.new_group([0])
        got, got_res = tc.psum_compressed(tt, tc.zero_residual(tt), group)
        dflt, _ = tc.psum_compressed(tt, tc.zero_residual(tt))
    finally:
        dist.destroy_process_group()
    for k in jt:
        for out in (got[k], alone[k], dflt[k]):
            np.testing.assert_array_equal(out.numpy(), np.asarray(want[k]))
        for r in (got_res[k], alone_res[k]):
            np.testing.assert_array_equal(r.numpy(), np.asarray(want_res[k]))
