"""Port SSD scan (``ops.ssd``'s plain version) held against the JAX package.

The same numpy inputs go to the port on the CPU (``ssd_scan_torch``, the
chunked algorithm the CUDA kernel computes), to JAX's step-by-step oracle
``ref.ssd_ref`` and to the Pallas kernel in interpret mode
(``ops.ssd(impl="interpret")``).

Tolerance, from the arithmetic: the chunked algorithm takes each decay as
exp(cl_t - cl_s) of two f32 cumulative sums of log a; with Mamba-2's
decays a chunk's sums reach ~110 (f32 ulp 7.6e-6), so a decay carries a
relative error of ~1e-5 where the oracle multiplies the a's one by one,
and the interpret kernel and the port sum in other orders. y is a sum of
such terms: held to atol = rtol = 1e-4 (a chunked f32 scan at
mamba2-370m's widths, S 1,024, N 128, P 64, lies within 5.3e-5 of an f64
recurrence on |y| up to 15). At the JAX test's decays (a in [0.5, 0.999])
the sums stay under ~90 and the same tolerance holds with room.

Realistic decays are a = exp(-softplus(N(0, 1))), Mamba-2's at init: a
128-step chunk then sums -log a to ~105-111, past exp's f32 overflow at
~88.7. There the port must stay finite and equal the oracle and the
interpret kernel, while the reference's blocked path (which takes exp
above the diagonal and masks afterwards) is not finite: that test pins
the caveat.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, B, S, H, P, N, realistic, c_broadcast=False, slow=False):
    """``realistic``: a = exp(-softplus(N(0, 1))), the reference's init;
    with ``slow`` -log a is divided by 100 (a trained head's slow decay),
    so the state carried into a chunk is not forgotten within it."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    if realistic:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
        a = np.exp(-dt * (0.01 if slow else 1.0)).astype(np.float32)
    else:
        a = rng.uniform(0.5, 0.999, size=(B, S, H)).astype(np.float32)
    b = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    if c_broadcast:
        c = np.broadcast_to((rng.standard_normal((B, S, 1, N)) * 0.3)
                            .astype(np.float32), (B, S, H, N))
    else:
        c = (rng.standard_normal((B, S, H, N)) * 0.3).astype(np.float32)
    return x, a, b, c


def _jax(impl, x, a, b, c, chunk):
    args = [jnp.asarray(np.ascontiguousarray(v)) for v in (x, a, b, c)]
    if impl == "ref":
        y, h = jref.ssd_ref(*args)
    else:
        y, h = jops.ssd(*args, impl=impl, chunk=chunk)
    return np.asarray(y), np.asarray(h)


def _port(x, a, b, c, chunk, impl=None):
    t = [torch.from_numpy(np.ascontiguousarray(v)) for v in (x, a, b, c)]
    if c.strides[2] == 0:             # keep the broadcast as a view
        t[3] = torch.from_numpy(c[:, :, :1].copy()).expand(
            c.shape)
    y, h = ops.ssd(*t, chunk=chunk, impl=impl)
    return y.numpy(), h.numpy()


CASES = {
    # the JAX test's shapes and chunks (tests/test_kernels.py::test_ssd_vs_ref)
    "jax-1": (1, 128, 2, 16, 32, 32, False),
    "jax-2": (2, 256, 3, 8, 16, 64, False),
    "jax-3": (1, 64, 1, 32, 64, 64, False),
    # the state carried across a 128-step chunk
    "carry-256": (2, 256, 2, 8, 16, 128, False),
    # Mamba-2's decays: a chunk's summed -log a exceeds 88
    "realistic-256": (1, 256, 2, 8, 16, 128, True),
    "realistic-mamba-widths": (1, 256, 2, 64, 128, 128, True),
    # slow decays: the carried state reaches every row of the next chunk
    "slow-carry-256": (2, 256, 2, 8, 16, 64, "slow"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ssd_plain_equals_reference_and_interpret(case):
    B, S, H, P, N, chunk, realistic = CASES[case]
    x, a, b, c = _inputs(list(CASES).index(case), B, S, H, P, N,
                         bool(realistic), c_broadcast=bool(realistic),
                         slow=realistic == "slow")
    got_y, got_h = _port(x, a, b, c, chunk)
    assert got_y.shape == (B, S, H, P) and got_h.shape == (B, H, N, P)
    assert got_y.dtype == np.float32 and got_h.dtype == np.float32
    assert np.isfinite(got_y).all() and np.isfinite(got_h).all()
    for impl in ("ref", "interpret"):
        want_y, want_h = _jax(impl, x, a, b, c, chunk)
        np.testing.assert_allclose(got_y, want_y, **TOL, err_msg=impl)
        np.testing.assert_allclose(got_h, want_h, **TOL, err_msg=impl)
    # the port's own oracle agrees too
    ry, rh = ref.ssd_ref(*(torch.from_numpy(np.ascontiguousarray(v))
                           for v in (x, a, b, c)))
    np.testing.assert_allclose(got_y, ry.numpy(), **TOL)
    np.testing.assert_allclose(got_h, rh.numpy(), **TOL)


def test_realistic_decays_overflow_the_reference_blocked_path():
    """The reference caveat the port designs around: at Mamba-2's decays a
    128-step chunk's summed -log a passes 88.7, and the reference's blocked
    path (``ops._ssd_blocked``) returns NaN in y, while the port's plain
    version (mask before exp) is finite and equal to the oracle."""
    B, S, H, P, N, chunk = 1, 256, 2, 8, 16, 128
    x, a, b, c = _inputs(0, B, S, H, P, N, realistic=True)
    sums = -np.log(a.astype(np.float64)).reshape(B, S // chunk, chunk, H)
    assert sums.sum(axis=2).max() > 88.7
    blocked_y, _ = _jax("blocked", x, a, b, c, chunk)
    assert not np.isfinite(blocked_y).all()
    got_y, _ = _port(x, a, b, c, chunk)
    assert np.isfinite(got_y).all()
    np.testing.assert_allclose(got_y, _jax("ref", x, a, b, c, chunk)[0],
                               **TOL)


def test_ssd_bf16_inputs_widen_like_reference():
    """bf16 x, b, c: f32 math on the widened values, y back in bf16 (two
    bf16 ulps), h in f32."""
    x, a, b, c = _inputs(3, 1, 128, 2, 16, 32, realistic=True)
    to_bf16 = lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16))
    xb, bb, cb = (to_bf16(v) for v in (x, b, c))
    want_y, want_h = _jax("interpret", xb, a, bb, cb, 64)
    t = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16)
    y, h = ops.ssd(t(xb), torch.from_numpy(a), t(bb), t(cb), chunk=64)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32),
                               atol=2.0 ** -8, rtol=2.0 ** -6)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)


def test_ssd_rejects_what_the_reference_asserts():
    x, a, b, c = (torch.from_numpy(np.ascontiguousarray(v))
                  for v in _inputs(4, 1, 96, 1, 8, 16, realistic=False))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd(x, a, b, c, chunk=64)
    y, _ = ops.ssd(x, a, b, c, chunk=256)       # chunk = min(chunk, S)
    assert y.shape == x.shape
    with pytest.raises(ValueError, match="> 0"):
        ops.ssd(x, torch.zeros_like(a), b, c, chunk=32)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ssd(x, a, b, c, impl="blocked")
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_cuda(x, a, b, c)


def _three_phase(x, a, b, c, T, dtype):
    """The CUDA kernel's decomposition (arXiv:2405.21060 §6), transcribed
    in numpy at ``dtype``: (a) each chunk's state S_c = (B ⊙ exp(cl_{T-1}
    - cl))ᵀ X; (b) state passing h_0 = 0, h_{c+1} = exp(cl_{T-1}) h_c + S_c;
    (c) chunk scan Y = (C Bᵀ ⊙ L) X + diag(exp(cl)) C h_c, the exponent of
    L taken only on and below the diagonal."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // T
    xr, br, cr = (np.asarray(v, dtype).reshape(B, nc, T, H, -1)
                  for v in (x, b, c))
    cl = np.cumsum(np.log(np.asarray(a, dtype)).reshape(B, nc, T, H), axis=2)
    w = np.exp(cl[:, :, -1:] - cl)
    states = np.einsum("bcthn,bcth,bcthp->bchnp", br, w, xr)
    h = np.zeros((B, H, N, P), dtype)
    h_in = []
    for ic in range(nc):
        h_in.append(h)
        h = np.exp(cl[:, ic, -1])[..., None, None] * h + states[:, ic]
    low = np.tri(T, dtype=bool)[None, None, :, :, None]
    diff = cl[:, :, :, None, :] - cl[:, :, None, :, :]      # (B, nc, t, s, H)
    L = np.where(low, np.exp(np.where(low, diff, 0)), 0).astype(dtype)
    G = np.einsum("bcthn,bcshn->bctsh", cr, br)
    y = np.einsum("bctsh,bcshp->bcthp", G * L, xr) + np.exp(cl)[..., None] * \
        np.einsum("bcthn,bchnp->bcthp", cr, np.stack(h_in, axis=1))
    return y.reshape(B, S, H, P), h


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nc", [1, 2, 8])
@pytest.mark.parametrize("decay", ["init", "slow"])
def test_three_phase_ssd_equals_reference_and_interpret(decay, nc, dtype):
    """The chunk-state / state-passing / chunk-scan split that B7 runs on
    the card computes what the step-by-step oracle and the Pallas kernel
    compute, at Mamba-2's init decays and at slow decays (a^(1/100), where
    the state carried between chunks counts), over 1, 2 and 8 chunks."""
    T = 32
    x, a, b, c = _inputs(nc * 10 + len(decay), 1, nc * T, 2, 8, 16,
                         realistic=True, slow=decay == "slow")
    got_y, got_h = _three_phase(x, a, b, c, T, np.dtype(dtype))
    assert np.isfinite(got_y).all() and np.isfinite(got_h).all()
    for impl in ("ref", "interpret"):
        want_y, want_h = _jax(impl, x, a, b, c, T)
        np.testing.assert_allclose(got_y, want_y, **TOL, err_msg=impl)
        np.testing.assert_allclose(got_h, want_h, **TOL, err_msg=impl)


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
    hi·hi, summed in f32)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _trunc_tf32(a - ah), _trunc_tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("decay", ["init", "slow"])
def test_ssd_3xtf32_products_keep_f32_accuracy(decay):
    """Why B7 takes three TF32 passes, at its chunk shape (T = N = 128,
    P = 64, the mixer's input scales, an incoming state): with 3xTF32
    products each chunk's Y and state stay within SSD_TOL of the f32
    products; one TF32 pass misses SSD_TOL (by more than 2x at init decays,
    10x at slow ones)."""
    T, N, P = 128, 128, 64
    rng = np.random.default_rng(len(decay))
    x = (rng.standard_normal((T, P)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((T, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((T, N)) * 0.3).astype(np.float32)
    h = (rng.standard_normal((N, P)) * 2).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(T)))
    cl = np.cumsum(-dt * (0.01 if decay == "slow" else 1.0)).astype(
        np.float32)
    low = np.tri(T, dtype=bool)
    L = np.where(low, np.exp(np.where(low, cl[:, None] - cl[None, :], 0)),
                 0).astype(np.float32)
    w = np.exp(cl[-1] - cl).astype(np.float32)

    def chunk(mm):
        y = mm(mm(c, b.T) * L, x) + np.exp(cl)[:, None] * mm(c, h)
        return y, mm((b * w[:, None]).T, x)

    want = chunk(lambda p, q: p @ q)
    for got, ref_ in zip(chunk(lambda p, q: _mm_tf32(p, q, 3)), want):
        np.testing.assert_allclose(got, ref_, **TOL)
    worst = max((np.abs(got - ref_) / (1e-4 + 1e-4 * np.abs(ref_))).max()
                for got, ref_ in zip(chunk(lambda p, q: _mm_tf32(p, q, 1)),
                                     want))
    assert worst > (10 if decay == "slow" else 2)


def test_work_counts_the_triangle_and_the_state_products():
    """The bound counts the recurrence's 5·N·P flops per step and head, not
    the chunked form's triangle and state products, which cost more: at
    the path's shape 5.37 GFLOP against 7.54. Bytes read c once when it is
    broadcast over H, once per head when it is not."""
    B, S, H, P, N, T = 4, 1024, 32, 64, 128, 128
    x = torch.empty(B, S, H, P, device="meta")
    b = torch.empty(B, S, H, N, device="meta")
    c = torch.empty(B, S, 1, N, device="meta").expand(B, S, H, N)
    flops, nbytes = ss.work(x, b, c)
    assert flops == 5 * B * S * H * N * P == 5_368_709_120
    pairs = T * (T + 1) // 2
    chunked = B * H * (S // T) * (pairs * 2 * (N + P) + 4 * T * N * P)
    assert chunked == 7_541_358_592 and flops < chunked
    assert nbytes == (B * S * H * P * 8 + B * S * H * 4 + B * S * H * N * 4
                      + B * S * N * 4 + B * H * N * P * 4)
    _, nbytes_full = ss.work(x, b, c.contiguous())
    assert nbytes_full - nbytes == B * S * (H - 1) * N * 4
    _, nbytes_bf16 = ss.work(x.bfloat16(), b, c)
    assert nbytes - nbytes_bf16 == B * S * H * P * 4


# -- B7's backward ------------------------------------------------------------

def _jax_vjp(x, a, b, c, dy, dh):
    """jax.vjp of the reference's step-by-step ``ref.ssd_ref`` (its own
    autodiff: the JAX package has no SSD gradient of its own, and its
    blocked path is NaN at Mamba-2's decays)."""
    import jax
    args = [jnp.asarray(np.ascontiguousarray(v)) for v in (x, a, b, c)]
    (y, h), vjp = jax.vjp(jref.ssd_ref, *args)
    return [np.asarray(g, np.float32)
            for g in vjp((jnp.asarray(dy, y.dtype), jnp.asarray(dh)))]


def _port_bwd(x, a, b, c, dy, dh, chunk):
    """``ssd_scan_bwd_torch`` from ``ssd_scan_torch``'s scratch; c a view
    broadcast over H when it is one in numpy."""
    t = lambda v: torch.from_numpy(np.array(v, np.float32))
    xt, at, bt = t(x), t(a), t(b)
    ct = (t(c[:, :, :1]).expand(c.shape) if c.strides[2] == 0 else t(c))
    if x.dtype != np.float32:            # bf16 values carried as f32
        xt, bt, ct = (v.to(torch.bfloat16) for v in (xt, bt, ct))
    _, _, states, cl = ss.ssd_scan_torch(xt, at, bt, ct, chunk,
                                         return_scratch=True)
    dyt = t(dy).to(xt.dtype)
    got = ss.ssd_scan_bwd_torch(xt, at, bt, ct, dyt, t(dh), states, cl,
                                chunk)
    assert [g.dtype for g in got] == [xt.dtype, at.dtype, bt.dtype, ct.dtype]
    assert got[3].shape == c.shape
    return [g.float().numpy() for g in got]


def _assert_grads(got, want, f32, what):
    """Each gradient within TOL_BWD (f32) or BF16_BWD of its largest entry
    (see ``test_ssd_backward_equals_reference_vjp``)."""
    for name, g, w in zip(("dx", "da", "db", "dc"), got, want):
        scale = float(np.abs(w).max())
        if f32 or name == "da":
            np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=1e-4,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, atol=2.0 ** -8 * scale,
                                       rtol=2.0 ** -6,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["init", "mild"])
@pytest.mark.parametrize("nc", [1, 2, 4])
def test_ssd_backward_equals_reference_vjp(nc, decay, dtype):
    """B7's plain backward (``ssd_scan_bwd_torch``, the order the CUDA
    kernel computes) against ``jax.vjp`` of the reference's ``ssd_ref``,
    over 1, 2 and 4 chunks of 32, at Mamba-2's init decays (a chunk sums
    -log a to ~25; the state carried in is mostly forgotten) and at mild
    ones (a in [0.5, 0.999], where it is not), with c broadcast over H and
    per head, with dh_final and without (zero).

    Tolerance, from the arithmetic. The chunked backward weighs each term
    by exp of a difference of two f32 cumulative sums of log a, the
    reference by products of the a's one by one: ~1e-6 relative at these
    sums (ulp 1.9e-6 at 25), ~1e-5 at a 128-step chunk's ~110. Every
    gradient is a sum of such terms, and da's terms cancel (row sums minus
    column sums of the chunk's triangle, then a reverse cumulative sum),
    so an entry's error is bounded by the array's scale, not its own
    size: each gradient is held to 1e-4 of its largest entry (rtol 1e-4)
    (measured: within 7e-6 of an f64 reference at these shapes, the
    reference's within 2e-6). With bf16 x, b and c (and dy, y's dtype),
    both compute in f32 from the same bf16 values and round dx, db, dc to
    bf16 once each: two bf16 ulps apart at most (atol 2**-8 of the
    largest entry, rtol 2**-6); da stays f32 and keeps 1e-4."""
    T = 32
    B, S, H, P, N = 2, nc * T, 3, 8, 16
    f32 = dtype == "float32"
    rng = np.random.default_rng(nc * 7 + len(decay) + len(dtype))
    for c_broadcast in (True, False):
        x, a, b, c = _inputs(nc * 3 + c_broadcast, B, S, H, P, N,
                             decay == "init", c_broadcast)
        dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
        if not f32:
            to_bf16 = lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16))
            x, b, c, dy = (to_bf16(v) for v in (x, b, c, dy))
            if c_broadcast:
                c = np.broadcast_to(c[:, :, :1], (B, S, H, N))
        for dh in (rng.standard_normal((B, H, N, P)).astype(np.float32),
                   np.zeros((B, H, N, P), np.float32)):
            want = _jax_vjp(x, a, b, c, dy, dh)
            got = _port_bwd(x, a, b, c, dy, dh, T)
            if c_broadcast:          # autograd of the broadcast sums over H
                got[3] = np.broadcast_to(got[3].sum(2, keepdims=True),
                                         got[3].shape)
                want[3] = np.broadcast_to(want[3].sum(2, keepdims=True),
                                          want[3].shape)
            _assert_grads(got, want, f32,
                          f"c_broadcast={c_broadcast} dh={bool(dh.any())}")


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_backward_equals_autograd_of_plain_forward(chunk):
    """``ops.ssd`` under autograd (``_SSD`` with the plain backward) against
    ``torch.autograd`` through ``ssd_scan_torch``, c broadcast over H
    (its gradient summed by the expand's backward), y and h_final both
    used: the same f32 arithmetic up to order, held to atol = rtol = 1e-5
    of each gradient's largest entry."""
    x, a, b, c = _inputs(chunk, 2, 128, 3, 8, 16, True, c_broadcast=True)
    dy = np.random.default_rng(chunk).standard_normal(x.shape).astype(
        np.float32)

    def grads(fn):
        ts = [torch.from_numpy(np.array(v)).requires_grad_()
              for v in (x, a, b, c[:, :, :1])]
        y, h = fn(ts[0], ts[1], ts[2], ts[3].expand(c.shape))
        ((y * torch.from_numpy(dy)).sum() + h.square().sum()).backward()
        return [t.grad.numpy() for t in ts]

    got = grads(lambda *t: ops.ssd(*t, chunk=chunk))
    want = grads(lambda *t: ss.ssd_scan_torch(*t, chunk))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(),
                                   rtol=1e-5)


@pytest.mark.parametrize("use_h", [True, False])
def test_ssd_backward_gradcheck_f64(use_h):
    """In f64, ``_SSD`` with the plain pair (``ops.ssd(impl="torch")``)
    equals central finite differences of its forward
    (``torch.autograd.gradcheck``), over 2 chunks, c broadcast over H; with
    h_final dropped its gradient arrives as None."""
    rng = np.random.default_rng(5)
    B, S, H, P, N = 1, 16, 2, 3, 4
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)))
    a = torch.from_numpy(rng.uniform(0.3, 0.95, (B, S, H)))
    b = torch.from_numpy(rng.standard_normal((B, S, H, N)))
    c = torch.from_numpy(rng.standard_normal((B, S, 1, N)))
    ts = [t.requires_grad_() for t in (x, a, b, c)]

    def fn(x, a, b, c):
        y, h = ops.ssd(x, a, b, c.expand(B, S, H, N), chunk=8, impl="torch")
        return (y, h) if use_h else y

    assert torch.autograd.gradcheck(fn, ts, eps=1e-6, atol=1e-7, rtol=1e-6)


def test_work_bwd_counts_the_recurrence_backward():
    """The backward's bound: 14·N·P flops per step and head, and the bytes
    of its inputs, outputs and the forward's scratch once each; dc is
    written for every head even when c is broadcast over H."""
    B, S, H, P, N = 4, 1024, 32, 64, 128
    x = torch.empty(B, S, H, P, device="meta")
    b = torch.empty(B, S, H, N, device="meta")
    c = torch.empty(B, S, 1, N, device="meta").expand(B, S, H, N)
    flops, nbytes = ss.work_bwd(x, b, c, with_dh=False)
    assert flops == 14 * B * S * H * N * P
    want = (3 * B * S * H * P * 4 + 2 * B * S * H * N * 4
            + B * S * (1 + H) * N * 4 + 3 * B * S * H * 4
            + B * H * (S // 128) * N * P * 4)
    assert nbytes == want
    assert ss.work_bwd(x, b, c, with_dh=True)[1] - want == B * H * N * P * 4
