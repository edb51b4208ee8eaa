"""Port attention (flash B5, decode B6) held against the JAX package.

The same seeded numpy inputs go through the JAX Pallas kernels in interpret
mode (``ops.attention(impl="interpret")``, ``ops.decode_attention(
impl="interpret")``), the JAX oracles (``ref.mha_ref``, ``ref.decode_ref``)
and the port's plain PyTorch versions — the CUDA kernels' oracles on the
card (``test_torch_cuda_kernels.py``). Tolerances, from the arithmetic:

* float32 outputs: atol = rtol = 1e-5. Both sides do f32 math with sums in
  another order (blocked vs whole-row softmax, other einsum orders); over
  at most 256-term dots of O(1) values that moves the last few f32 bits.
* bfloat16 outputs: atol = 2**-8, rtol = 2**-6, about two bf16 ulps (a
  bf16 ulp is 2**-8 to 2**-7 of the value): both sides compute in f32 and
  round once; f32 differences can flip that rounding by one ulp.

Inputs in bf16 are rounded from the same f32 numpy arrays on both sides
(round to nearest even in both), so both packages see identical values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import hw
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -6)

DTYPES = {"f32": (torch.float32, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16),
          "f32q_bf16kv": (torch.float32, torch.bfloat16)}


def _jdt(dt):
    return jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32


def _pair(x: np.ndarray, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    return jnp.asarray(x, _jdt(dt)), torch.from_numpy(x).to(dt)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def _tol(dt):
    return BF16_TOL if dt == torch.bfloat16 else F32_TOL


# -- B5: flash attention -------------------------------------------------------

FLASH_CASES = [
    # (Hq, Hkv, D, Sq, Sk, window)
    (4, 4, 16, 32, 32, None),      # MHA
    (4, 4, 64, 32, 64, 16),
    (4, 2, 64, 64, 64, None),      # GQA
    (4, 2, 16, 32, 128, 40),
    (4, 1, 256, 64, 64, 24),       # MQA, gemma's head dim
    (4, 1, 256, 32, 96, None),
    (4, 1, 64, 128, 128, 48),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Hq,Hkv,D,Sq,Sk,window", FLASH_CASES)
def test_flash_plain_equals_pallas_and_reference(Hq, Hkv, D, Sq, Sk, window,
                                                 dtype):
    q_dt, kv_dt = DTYPES[dtype]
    rng = np.random.default_rng(Hq * 1000 + Hkv * 100 + D + Sq + Sk)
    B = 2
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    jq, tq = _pair(q, q_dt)
    jk, tk = _pair(k, kv_dt)
    jv, tv = _pair(v, kv_dt)
    got = ops.attention(tq, tk, tv, causal=True, window=window, block_k=32)
    assert got.dtype == q_dt and got.shape == (B, Sq, Hq, D)
    pallas = jops.attention(jq, jk, jv, causal=True, window=window,
                            impl="interpret")
    oracle = jref.mha_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(q_dt))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(q_dt))
    # the port's own naive oracle agrees with the reference's
    np.testing.assert_allclose(
        _np(ref.mha_ref(tq, tk, tv, causal=True, window=window)),
        _np(oracle), **_tol(q_dt))


def test_flash_rows_without_keys_output_zero():
    """Sq > Sk: the first Sq - Sk query rows sit before every key, so no
    key is valid. Pallas and the plain version give 0 there (the naive
    oracle gives NaN); the other rows still match the oracle."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 64, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, 32, 1, 16)).astype(np.float32)
    v = rng.standard_normal((1, 32, 1, 16)).astype(np.float32)
    got = _np(ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=True))
    pallas = _np(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                impl="interpret"))
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    assert np.all(got[:, :32] == 0.0)
    np.testing.assert_allclose(
        got[:, 32:], _np(jref.mha_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                      causal=True))[:, 32:], **F32_TOL)


@pytest.mark.parametrize("block_k", [16, 48, 256])
def test_flash_plain_block_size_does_not_change_result(block_k):
    """Ragged last block (Sk = 80 is no multiple of 48) and tiles skipped
    outside the window band give the same result as one block."""
    rng = np.random.default_rng(block_k)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 80, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    want = fa.flash_attention_torch(q, k, v, window=20, block_k=80)
    got = fa.flash_attention_torch(q, k, v, window=20, block_k=block_k)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_key_split_balances_the_causal_grid():
    """The kernel's blocks take BLOCK_ROWS (position, head) rows; at
    gemma3-1b's causal prefill (B 4, S 1,024, G 4: 32 positions a block)
    the 128 query tiles see 2 to 64 key tiles, one wave on 132 SMs, so the
    longest sets the time: their key ranges are split (and combined) into
    parts of at most kmax tiles, which shortens the modelled makespan. The
    windowed layers' tiles see at most 34 and are not split."""
    PB, groups = fa.block_rows(4, 1)
    assert (PB, groups) == (32, 1)
    assert fa.block_rows(4, 4) == (128, 1) and fa.block_rows(8, 1) == (16, 1)
    assert fa.block_rows(6, 2) == (42, 1)
    kmax, parts = fa.key_split(4, 1024, 1024, 4, 1, True, None, 132)
    assert 1 < parts <= 4 and kmax * parts >= 64 and kmax < 64
    tiles = [2 * (i + 1) for i in range(32)]
    whole = fa._makespan(tiles * 4, 132)
    split = []
    for t in tiles:
        n = -(-t // kmax) if t > kmax else 1
        ln = -(-t // n)
        split += [min(ln, t - j * ln) for j in range(n)]
    assert sum(split) == sum(tiles) and max(split) <= kmax
    assert fa._makespan(split * 4, 132) + 1 < whole
    assert fa.key_split(4, 1024, 1024, 4, 1, True, 512, 132) == (34, 1)
    # many blocks per SM already: nothing to gain
    assert fa.key_split(64, 1024, 1024, 4, 1, True, None, 132)[1] == 1


def _tf32(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, dropping the
    13 low mantissa bits (on the int32 view: add half an ulp, truncate)."""
    u = np.asarray(x, np.float32).view(np.int32)
    return ((u + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)


def _trunc_tf32(x):
    """The tensor cores' read of an f32 register as TF32: its 13 low
    mantissa bits ignored."""
    u = np.asarray(x, np.float32).view(np.int32)
    return (u & np.int32(-0x2000)).view(np.float32)


def _mm_tf32(a, b, passes):
    """a @ b as the tensor cores compute it: one TF32 pass, or 3xTF32
    (hi = x rounded to TF32, lo = x - hi read as TF32; hi·lo + lo·hi, then
    hi·hi, summed in f32). Products of TF32 values are
    exact in f32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _trunc_tf32(a - ah), _trunc_tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _flash_tf32(q, k, v, passes, block_k=16):
    """B5's recurrence for one head: 16-key tiles, online softmax in f32,
    QKᵀ and PV through ``_mm_tf32``."""
    qs = q * np.float32(q.shape[-1] ** -0.5)
    m = np.full((q.shape[0], 1), -1e30, np.float32)
    l = np.zeros((q.shape[0], 1), np.float32)
    acc = np.zeros(q.shape, np.float32)
    for k0 in range(0, k.shape[0], block_k):
        s = _mm_tf32(qs, k[k0:k0 + block_k].T, passes)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        p = np.exp(s - m_new)
        alpha = np.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdims=True)
        acc = alpha * acc + _mm_tf32(p, v[k0:k0 + block_k], passes)
        m = m_new
    return acc / l


@pytest.mark.parametrize("seed", [0, 1])
def test_flash_3xtf32_products_keep_f32_accuracy(seed):
    """Why B5 takes three TF32 passes, at its width (D 256, 256 keys, unit-
    scale activations, the scale ATTN_TOL is set for: f32 itself strays
    from f64 by ~4 of ATTN_TOL at 3x that scale). With 3xTF32 products the
    output stays within ATTN_TOL of the plain f32 version, and no further
    from the f64 result than the plain version's own error; one TF32 pass
    (10-bit mantissa) misses ATTN_TOL by more than 10x."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((n, 256)).astype(np.float32)
               for n in (128, 256, 256))
    t = lambda a: torch.from_numpy(a)[None, :, None]
    plain = fa.flash_attention_torch(t(q), t(k), t(v), causal=False)[0, :, 0]
    plain = plain.numpy()
    s64 = (q.astype(np.float64) * 256 ** -0.5) @ k.T.astype(np.float64)
    p64 = np.exp(s64 - s64.max(-1, keepdims=True))
    exact = (p64 @ v.astype(np.float64)) / p64.sum(-1, keepdims=True)
    three = _flash_tf32(q, k, v, passes=3)
    np.testing.assert_allclose(three, plain, **F32_TOL)
    assert np.abs(three - exact).max() <= 2 * np.abs(plain - exact).max()
    one = _flash_tf32(q, k, v, passes=1)
    excess = np.abs(one - plain) / (1e-5 + 1e-5 * np.abs(plain))
    assert excess.max() > 10


def test_key_range_and_work_count_the_band():
    # causal + window 4 over 8 rows: row i sees min(i + 1, 4) keys
    assert fa.key_range(0, 8, 8, 8, True, 4) == (0, 8)
    assert fa.key_range(6, 8, 8, 8, True, 4) == (3, 8)
    assert fa.key_range(0, 2, 8, 8, True, None) == (0, 2)
    assert fa.work((1, 8, 1, 16), (1, 8, 1, 16), True, 4) == \
        1 + 2 + 3 + 4 * 5
    assert fa.work((2, 8, 3, 16), (2, 8, 1, 16), True, None) == 2 * 3 * 36
    assert fa.work((1, 4, 1, 16), (1, 8, 1, 16), False, None) == 32


# -- B6: decode attention ------------------------------------------------------

DECODE_CASES = [
    # (Hq, Hkv, D, S, block_k)
    (4, 4, 16, 64, 32),      # MHA
    (4, 2, 64, 64, 16),      # GQA
    (4, 1, 256, 128, 64),    # MQA, gemma's head dim
    (8, 1, 64, 96, 32),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Hq,Hkv,D,S,block_k", DECODE_CASES)
def test_decode_plain_equals_pallas_and_reference(Hq, Hkv, D, S, block_k,
                                                  dtype):
    q_dt, kv_dt = DTYPES[dtype]
    rng = np.random.default_rng(Hq * 100 + Hkv * 10 + D + S)
    kv_len = np.array([1, S // 2 + 1, S], np.int32)    # 1, mid, S
    B = kv_len.size
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    jq, tq = _pair(q, q_dt)
    jk, tk = _pair(k, kv_dt)
    jv, tv = _pair(v, kv_dt)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len),
                               block_k=block_k)
    assert got.dtype == q_dt and got.shape == (B, Hq, D)
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(kv_len),
                                   impl="interpret", block_k=block_k)
    oracle = jref.decode_ref(jq, jk, jv, jnp.asarray(kv_len))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(q_dt))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(q_dt))
    np.testing.assert_allclose(
        _np(ref.decode_ref(tq, tk, tv, torch.from_numpy(kv_len))),
        _np(oracle), **_tol(q_dt))


def test_decode_kv_len_past_cache_reads_whole_cache():
    """kv_len > S (the reference's clamped write at pos >= S) keeps every
    cache position, as the reference's ``arange(S) < kv_len`` does."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 1, 16)).astype(np.float32)
    kv_len = np.array([40, 32], np.int32)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v,
                                                               kv_len)))
    want = jref.decode_ref(*(jnp.asarray(a) for a in (q, k, v, kv_len)))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


@pytest.mark.parametrize("S,nsplit,chunk", [
    (64, 8, 8),              # the engine's cache: one cluster
    (1536, 48, 32),          # gemma3-1b's prefilled cache
    (1537, 56, 28),
    (4096, 128, 32),
    (32768, 1024, 32),
    (1, 8, 4),               # one key: a cluster of mostly empty splits
    (100, 8, 16),
    (1000, 32, 32)])
def test_decode_splits_cover_the_cache(S, nsplit, chunk):
    """The split plan covers every key with whole clusters of splits (no
    cluster wholly past S), in whole multiples of the block's warps, with
    at most KEYS_PER_WARP keys a warp and as few clusters as that
    allows."""
    assert da.splits(S) == (nsplit, chunk)
    assert nsplit % da.CLUSTER == 0 and chunk % da.WARPS == 0
    assert (nsplit - da.CLUSTER) * chunk < S <= nsplit * chunk
    assert chunk <= da.WARPS * da.KEYS_PER_WARP
    fewer = nsplit - da.CLUSTER
    assert fewer == 0 or S > fewer * da.WARPS * da.KEYS_PER_WARP


@pytest.mark.parametrize("chunk,D,itemsize,plan", [
    (32, 256, 2, (8, 1)), (8, 256, 4, (2, 1)), (32, 256, 4, (4, 2)),
    (4, 256, 4, (1, 1)), (28, 64, 4, (7, 1))])
def test_decode_stage_plan(chunk, D, itemsize, plan):
    """A warp stages all its keys at once where they fit in 8 keys and 8 KB
    of K and V, else two stages."""
    assert da.stage_plan(chunk, D, itemsize) == plan
    kt, stages = plan
    assert 2 * kt * D * itemsize <= da.STAGE_BYTES


SPLIT_CASES = [
    # (Hq, Hkv, D, S, kv_len)
    (4, 1, 256, 1536, [1056, 1, 1536, 25]),  # gemma3-1b's prefilled cache
    (4, 1, 256, 64, [17, 64, 0, 70, 40, 1, 63, 33]),   # the engine's cache
    (8, 2, 64, 700, [0, 699, 350]),           # GQA, an empty row
    (16, 1, 128, 96, [96, 5]),                # G 16: 2 keys a batch
    (32, 1, 64, 40, [40, 3]),                 # G 32: 1 key a batch
    (3, 1, 128, 300, [300, 299]),             # G 3
    (4, 1, 16, 64, [17, 64, 0, 40]),          # reduced gemma3-1b: D 16
    (16, 2, 16, 300, [300, 5, 129]),          # D 16, G 16: 4 keys a step
    (8, 1, 16, 40, [40, 3]),                  # D 16, G 8: 4 keys a batch
]


@pytest.mark.parametrize("D,lanes,max_group", [
    (16, 8, 16), (64, 32, 32), (128, 32, 16), (256, 32, 8)])
def test_decode_lane_layout_per_head_dim(D, lanes, max_group):
    """From D 64 on a cache row takes the warp's 32 lanes; at D 16 it takes
    8 (2 dims a lane) and a warp walks 4 rows a step. Every head dim has
    kernel instances up to 32 query heads per KV head (16 at D 16), within
    the block's 2,048 outputs; the attention kernels take every config's
    head dim and the reduced configs' 16."""
    assert da.row_lanes(D) == lanes and da.max_group(D) == max_group
    assert max_group * D <= da.MAX_OUT
    assert D in fa.HEAD_DIMS


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Hq,Hkv,D,S,kv_len", SPLIT_CASES)
def test_decode_split_merge_equals_pallas(Hq, Hkv, D, S, kv_len, dtype):
    """The CUDA kernel's split-and-merge order (per-warp partials in
    batches, 8-block clusters, the clusters merged last), written out in
    torch, against the Pallas decode kernel in interpret mode and the
    plain version."""
    q_dt, kv_dt = DTYPES[dtype]
    rng = np.random.default_rng(Hq * 7 + D + S)
    kv_len = np.array(kv_len, np.int32)
    B = kv_len.size
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    jq, tq = _pair(q, q_dt)
    jk, tk = _pair(k, kv_dt)
    jv, tv = _pair(v, kv_dt)
    tl = torch.from_numpy(kv_len)
    got = da.split_merge_torch(tq, tk, tv, tl)
    assert got.dtype == q_dt and got.shape == (B, Hq, D)
    block_k = 64 if S % 64 == 0 else S
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(kv_len),
                                   impl="interpret", block_k=block_k)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(q_dt))
    np.testing.assert_allclose(_np(got), _np(da.decode_attention_torch(
        tq, tk, tv, tl)), **_tol(q_dt))
    for i in np.flatnonzero(kv_len == 0):
        assert not bool(got[i].any())


def test_impl_must_be_known():
    x = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.attention(x, x, x, impl="blocked")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.decode_attention(x[:, 0], x, x, torch.ones(1, dtype=torch.int32),
                             impl="pallas")


# -- bounds ---------------------------------------------------------------------

def test_peak_flops_follows_operand_dtype():
    assert hw.peak_flops(torch.bfloat16, torch.bfloat16) == 989e12
    assert hw.peak_flops(torch.float32, torch.float32) == 165e12
    assert hw.peak_flops(torch.float32, torch.bfloat16) == 165e12
    assert hw.PEAK_TF32_TENSOR_FLOPS == 495e12


def test_bound_seconds_takes_the_larger_of_bytes_and_operations():
    # 3.35 MB at 3.35 TB/s = 1 us; 67 MFLOP at 67 TFLOP/s = 1 us
    t, by = hw.bound_seconds(3.35e6 * 2, 67e6)
    assert by == "bytes" and t == pytest.approx(2e-6)
    t, by = hw.bound_seconds(3.35e6, 67e6 * 3)
    assert by == "operations" and t == pytest.approx(3e-6)
    t, by = hw.bound_seconds(3.35e6, 989e6 * 3,
                             hw.peak_flops(torch.bfloat16))
    assert by == "operations" and t == pytest.approx(3e-6)
    # gemma3-1b's windowed prefill layer: B 4, S 1024, 4 heads, D 256,
    # window 512 -> 4 * 4 * (512 * 513 / 2 + 512 * 512) pairs at 4 * D flops
    pairs = fa.work((4, 1024, 4, 256), (4, 1024, 1, 256), True, 512)
    assert pairs == 16 * (512 * 513 // 2 + 512 * 512)
    t, by = hw.bound_seconds(0, pairs * 4 * 256)
    assert by == "operations" and t == pytest.approx(
        pairs * 1024 / 67e12)
    assert da.work(torch.tensor([5, 40, 0], dtype=torch.int32), 32, 4) == \
        (5 + 32 + 0) * 4


@pytest.mark.parametrize("causal,window,Hq,Hkv,Sk", [
    (True, None, 2, 1, 7), (True, 3, 4, 2, 7), (False, None, 2, 2, 9)])
def test_plain_attention_pair_passes_gradcheck(causal, window, Hq, Hkv, Sk):
    """The plain pair that the backward kernel is held to (the forward
    with its lse, ``flash_attention_bwd_torch``), as autograd runs it
    (``ops._Attention``), in f64: its dq, dk and dv equal central finite
    differences of the forward (``torch.autograd.gradcheck``: eps 1e-6,
    differences of f64 sums of O(1) terms, atol 1e-6, rtol 1e-5). Key
    blocks of 4 split the keys, so the blocked recurrence is crossed."""
    rng = np.random.default_rng(Hq + Sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
               for shape in ((1, 6, Hq, 4), (1, Sk, Hkv, 4), (1, Sk, Hkv, 4)))
    fn = lambda q, k, v: ops._Attention.apply(q, k, v, causal, window, 0.5,
                                             True, 4)
    assert fn(q, k, v).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


# -- the modes the remaining architectures add ------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Hq,Hkv,D,Sq,Sk", [
    (4, 4, 64, 24, 40),        # seamless's cross-attention: Sq < Sk, MHA
    (4, 2, 16, 40, 24),        # Sq > Sk: every row sees every key
    (16, 16, 64, 48, 48),      # the encoder: Sq == Sk, bidirectional
])
def test_flash_plain_noncausal_equals_pallas(Hq, Hkv, D, Sq, Sk, dtype):
    """B5's plain version with ``causal=False`` (the encoder and the
    cross-attention) against ``flash_attention(interpret=True)`` and the
    oracle, at Sq != Sk too."""
    q_dt, kv_dt = DTYPES[dtype]
    rng = np.random.default_rng(Hq + D + Sq * 3 + Sk)
    q = rng.standard_normal((2, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((2, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((2, Sk, Hkv, D)).astype(np.float32)
    jq, tq = _pair(q, q_dt)
    jk, tk = _pair(k, kv_dt)
    jv, tv = _pair(v, kv_dt)
    got = ops.attention(tq, tk, tv, causal=False, block_k=16)
    pallas = jops.attention(jq, jk, jv, causal=False, impl="interpret")
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(q_dt))
    np.testing.assert_allclose(
        _np(got), _np(jref.mha_ref(jq, jk, jv, causal=False)), **_tol(q_dt))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Hq,Hkv", [(40, 8), (56, 8)])
def test_flash_and_decode_plain_at_g5_and_g7(Hq, Hkv, dtype):
    """qwen2.5-32b's 40 query heads over 8 KV heads (G 5) and
    llava-next-34b's 56 over 8 (G 7), at head dim 128: B5's plain version
    (causal) and B6's plain version and split-and-merge order against the
    Pallas kernels in interpret mode."""
    q_dt, kv_dt = DTYPES[dtype]
    rng = np.random.default_rng(Hq)
    D, S = 128, 40
    q = rng.standard_normal((1, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((1, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((1, S, Hkv, D)).astype(np.float32)
    jq, tq = _pair(q, q_dt)
    jk, tk = _pair(k, kv_dt)
    jv, tv = _pair(v, kv_dt)
    got = ops.attention(tq, tk, tv, causal=True, block_k=16)
    pallas = jops.attention(jq, jk, jv, causal=True, impl="interpret")
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(q_dt))
    kv_len = np.array([S, 17], np.int32)
    dq = rng.standard_normal((2, Hq, D)).astype(np.float32)
    dk = rng.standard_normal((2, S, Hkv, D)).astype(np.float32)
    dv = rng.standard_normal((2, S, Hkv, D)).astype(np.float32)
    jq, tq = _pair(dq, q_dt)
    jk, tk = _pair(dk, kv_dt)
    jv, tv = _pair(dv, kv_dt)
    tl = torch.from_numpy(kv_len)
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(kv_len),
                                   impl="interpret", block_k=S)
    for got in (ops.decode_attention(tq, tk, tv, tl),
                da.split_merge_torch(tq, tk, tv, tl)):
        np.testing.assert_allclose(_np(got), _np(pallas), **_tol(q_dt))


def _attn_params(cfg, seed):
    """The reference's attention parameters (seeded non-zero biases where
    the config has them) as numpy, and the same as torch tensors."""
    from repro.models import attention as jattn
    jp, _ = jattn.attn_init(jax.random.PRNGKey(seed), cfg, jnp.float32,
                            cross=True)
    rng = np.random.default_rng(seed)
    jp = {n: {k: (rng.standard_normal(a.shape).astype(np.float32)
                  if k == "b" else np.array(a)) for k, a in p.items()}
          for n, p in jp.items()}
    tp = {n: {k: torch.from_numpy(a) for k, a in p.items()}
          for n, p in jp.items()}
    return jax.tree.map(jnp.asarray, jp), tp


@pytest.mark.parametrize("arch,kw", [
    ("seamless-m4t-medium", {}),
    ("qwen2.5-32b", {"n_heads": 10, "n_kv_heads": 2}),   # bias, G 5
])
def test_cross_attention_apply_and_decode_equal_reference(arch, kw):
    """``attn_apply(kv_x=...)``: k and v projected from the encoder output
    (Sk != Sq), no RoPE on either side, ``causal=False``; and
    ``attn_decode(cross=True)``: the cache read, not written, kv_len its
    whole depth on every row. q/k/v biases (qwen's config) added as the
    reference adds them."""
    from repro.configs import ARCHS
    from repro.models import attention as jattn
    from repro_torch.configs import get_arch
    from repro_torch.models import attention as attn
    jcfg = ARCHS[arch].reduced().replace(**kw)
    tcfg = get_arch(arch).reduced().replace(**kw)
    jp, tp = _attn_params(jcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 21, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    want = jattn.attn_apply(jp, jnp.asarray(x), jcfg,
                            positions=jnp.asarray(pos), causal=False,
                            kv_x=jnp.asarray(enc), impl="blocked")
    got = attn.attn_apply(tp, torch.from_numpy(x), tcfg,
                          positions=torch.from_numpy(pos.copy()),
                          causal=False, kv_x=torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # self-attention, for the bias path with RoPE
    want = jattn.attn_apply(jp, jnp.asarray(x), jcfg,
                            positions=jnp.asarray(pos), impl="blocked")
    got = attn.attn_apply(tp, torch.from_numpy(x), tcfg,
                          positions=torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    Hkv, dh = tcfg.n_kv_heads, tcfg.head_dim
    ck = rng.standard_normal((2, 21, Hkv, dh)).astype(np.float32)
    cv = rng.standard_normal((2, 21, Hkv, dh)).astype(np.float32)
    xd = rng.standard_normal((2, 64)).astype(np.float32)
    for cross in (True, False):
        want, wk, _ = jattn.attn_decode(jp, jnp.asarray(xd), jcfg,
                                        cache_k=jnp.asarray(ck),
                                        cache_v=jnp.asarray(cv),
                                        pos=jnp.int32(5), cross=cross,
                                        impl="blocked")
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        got = attn.attn_decode(tp, torch.from_numpy(xd), tcfg, cache_k=tk,
                               cache_v=tv, pos=5, cross=cross)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL,
                                   err_msg=f"cross={cross}")
        np.testing.assert_allclose(tk.numpy(), np.asarray(wk), **F32_TOL)
        assert torch.equal(tk, torch.from_numpy(ck)) == cross
