"""Mamba-2 SSD (state-space duality) chunked scan.

The recurrence h_t = a_t h_{t-1} + b_t ⊗ x_t, y_t = c_t · h_t over x
(B, S, H, P), decays a (B, S, H) in (0, 1], b and c (B, S, H, N), from a
zero state; it returns y (B, S, H, P) in x's dtype and the final state
h (B, H, N, P) in f32. Within a chunk of T steps, with cl = cumsum(log a),

    Y = (C Bᵀ ⊙ L) X + diag(exp(cl)) C h,   L[t, s] = exp(cl_t - cl_s), s <= t
    h' = exp(cl_{T-1}) h + (B ⊙ exp(cl_{T-1} - cl))ᵀ X

and the (N, P) state is carried from chunk to chunk in order.

L is zero above the diagonal, and the exponent is taken only on and below
it. Above it, cl_t - cl_s is a chunk's summed -log a: with Mamba-2's decays
that passes f32's exp overflow (~88.7) within a 128-step chunk, and
exp(inf) times a zero mask is NaN. The reference's blocked path and Pallas
body take the exponent everywhere and mask afterwards, so the blocked path
yields NaN there; ``ssd_ref`` and the Pallas kernel in interpret mode stay
finite, and this module computes what they compute.

``ssd_scan_cuda`` launches the hand-written kernel (``csrc/ssd_scan.cu``);
``ssd_scan_torch`` is the plain PyTorch version of the same chunked
algorithm, the CPU path and the kernel's oracle on the card.
``ops.ssd`` picks between them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128       # T: chunk rows a block stages in shared memory
MAX_STATE = 128       # N
MAX_HEAD_DIM = 64     # P
DTYPES = (torch.float32, torch.bfloat16)


def _chunk(S: int, chunk: int) -> int:
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of the chunk "
                         f"{chunk}")
    return chunk


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 math for f32 and bf16 inputs; f64 inputs (finite-difference
    checks of the plain pair) stay f64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_scan_torch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, chunk: int = 128,
                   return_scratch: bool = False):
    """Plain version: the chunked algorithm of the reference's blocked path
    (``ops._ssd_blocked``) with the decay masked before the exponent.
    Returns (y, h_final); with ``return_scratch`` also what the backward
    reads, as the kernel leaves it: each chunk's incoming state ``states``
    (B, H, S / T, N, P) and ``cl`` (B, H, S), cumsum(log a) within each
    chunk."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    T = _chunk(S, chunk)
    if not bool((a > 0).all()):
        raise ValueError("ssd_scan: the decays a must be > 0 (log a is taken)")
    f = _acc_dtype(x)
    la = torch.log(a.to(f))
    idx = torch.arange(T, device=x.device)
    above = (idx[None, :] > idx[:, None])[None, :, :, None]   # (1, t, s, 1)
    h = torch.zeros((B, H, N, P), dtype=f, device=x.device)
    ys, states, cls = [], [], []
    for s0 in range(0, S, T):
        xc = x[:, s0:s0 + T].to(f)                       # (B, T, H, P)
        bc = b[:, s0:s0 + T].to(f)                       # (B, T, H, N)
        cc = c[:, s0:s0 + T].to(f)
        cl = torch.cumsum(la[:, s0:s0 + T], dim=1)       # (B, T, H)
        states.append(h)
        cls.append(cl)
        diff = cl[:, :, None, :] - cl[:, None, :, :]     # (B, t, s, H)
        decay = torch.exp(diff.masked_fill(above, float("-inf")))
        cb = torch.einsum("bthn,bshn->btsh", cc, bc)
        y = torch.einsum("btsh,bshp->bthp", cb * decay, xc)
        y = y + torch.exp(cl)[..., None] * torch.einsum("bthn,bhnp->bthp",
                                                        cc, h)
        w = torch.exp(cl[:, -1:] - cl)                   # (B, T, H)
        h = torch.exp(cl[:, -1])[..., None, None] * h + torch.einsum(
            "bthn,bthp->bhnp", bc * w[..., None], xc)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype)
    if not return_scratch:
        return y, h
    return (y, h, torch.stack(states, dim=2),
            torch.cat(cls, dim=1).permute(0, 2, 1).contiguous())


def ssd_scan_bwd_torch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, dy: torch.Tensor,
                       dh_final: Optional[torch.Tensor],
                       states: torch.Tensor, cl: torch.Tensor,
                       chunk: int = 128):
    """Plain version of the gradient: the chunked forward's three steps in
    reverse, from the forward's scratch (``states``, each chunk's incoming
    state h_c, and ``cl``; see ``ssd_scan_torch``). dy is y's gradient,
    ``dh_final`` h_final's (None: zero). With g_c the gradient of the state
    a chunk leaves (g of the last chunk is dh_final):

    (b') g_{c-1} = exp(cl_{T-1}) g_c + sum_t exp(cl_t) c_t ⊗ dy_t, in
         reverse chunk order;
    (a'/c') per chunk, with M1 = L ⊙ C Bᵀ, M2 = L ⊙ dY Xᵀ and
         w = exp(cl_{T-1} - cl):
           dX = M1ᵀ dY + diag(w) B g_c
           dB = M2ᵀ C + diag(w) X g_cᵀ
           dC = M2 B + diag(exp(cl)) dY h_cᵀ
         and dcl from Q = M1 ⊙ dY Xᵀ (row sums minus column sums), the
         state term exp(cl_t) c_t·h_c dy_t, the weights w and the decay
         exp(cl_{T-1}) of h_c;
    then d log a is the reverse cumulative sum of dcl within each chunk and
    da = d log a / a. L's exponent is taken only on and below the diagonal,
    as in the forward. Returns (dx, da, db, dc) in the dtypes of x, a, b
    and c; dc is (B, S, H, N) whatever c's strides (a c broadcast over H
    gets its gradient summed by autograd)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    T = _chunk(S, chunk)
    nc = S // T
    f = _acc_dtype(x)
    r = lambda t: t.to(f).reshape(B, nc, T, H, -1)
    xr, br, cr, dyr = r(x), r(b), r(c), r(dy)
    clr = cl.to(f).reshape(B, H, nc, T).permute(0, 2, 3, 1)    # (B, nc, T, H)
    h_in = states.to(f).permute(0, 2, 1, 3, 4)            # (B, nc, H, N, P)
    ecl = torch.exp(clr)
    last = clr[:, :, -1]                                        # (B, nc, H)
    w = torch.exp(last[:, :, None] - clr)                       # (B, nc, T, H)
    # (b') reverse state passing
    cdy = torch.einsum("bcth,bcthn,bcthp->bchnp", ecl, cr, dyr)
    g = (torch.zeros((B, H, N, P), dtype=f, device=x.device)
         if dh_final is None else dh_final.to(f))
    gs = []
    for ic in reversed(range(nc)):
        gs.append(g)
        g = torch.exp(last[:, ic])[..., None, None] * g + cdy[:, ic]
    G = torch.stack(gs[::-1], dim=1)                      # (B, nc, H, N, P)
    # (a'/c') per chunk
    idx = torch.arange(T, device=x.device)
    above = (idx[None, :] > idx[:, None])[None, None, :, :, None]
    diff = clr[:, :, :, None, :] - clr[:, :, None, :, :]  # (B, nc, t, s, H)
    L = torch.exp(diff.masked_fill(above, float("-inf")))
    dM = torch.einsum("bcthp,bcshp->bctsh", dyr, xr)
    M1 = L * torch.einsum("bcthn,bcshn->bctsh", cr, br)
    M2 = L * dM
    Gx = torch.einsum("bchnp,bcshp->bcshn", G, xr)              # g_c x_s
    hdy = torch.einsum("bchnp,bcthp->bcthn", h_in, dyr)         # h_c dy_t
    dx = (torch.einsum("bctsh,bcthp->bcshp", M1, dyr)
          + w[..., None] * torch.einsum("bchnp,bcshn->bcshp", G, br))
    db = torch.einsum("bctsh,bcthn->bcshn", M2, cr) + w[..., None] * Gx
    dc = torch.einsum("bctsh,bcshn->bcthn", M2, br) + ecl[..., None] * hdy
    Q = M1 * dM
    rs = w * (br * Gx).sum(-1)                                  # (B, nc, T, H)
    dcl = Q.sum(3) - Q.sum(2) + ecl * (cr * hdy).sum(-1) - rs
    tail = rs.sum(2) + torch.exp(last) * (G * h_in).sum((-2, -1))
    dcl = torch.cat([dcl[:, :, :-1], dcl[:, :, -1:] + tail[:, :, None]],
                    dim=2)
    dla = dcl.flip(2).cumsum(2).flip(2).reshape(B, S, H)
    da = dla / a.to(f)
    return (dx.reshape(B, S, H, P).to(x.dtype), da.to(a.dtype),
            db.reshape(B, S, H, N).to(b.dtype),
            dc.reshape(B, S, H, N).to(c.dtype))


def _check(name: str, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, chunk: int) -> Tuple[torch.device, int]:
    """Raise on any input the kernels do not take; (device, chunk)."""
    dev = _build.require_cuda(name, x, a, b)
    if c.device != dev or c.stride(-1) != 1:
        raise ValueError(f"{name}: c must be on {dev} with a contiguous "
                         f"last dimension")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"{name}: want x (B, S, H, P), a (B, S, H), b and c "
                         f"(B, S, H, N), got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if a.shape != (B, S, H) or b.shape[:3] != (B, S, H):
        raise ValueError(f"{name}: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    for what, t in (("x", x), ("b", b), ("c", c)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    _build.require_dtype(name, "a", a, torch.float32)
    T = _chunk(S, chunk)
    if T > MAX_CHUNK or N > MAX_STATE or P > MAX_HEAD_DIM:
        raise ValueError(f"{name}: chunk {T}, state {N}, head dim {P}; the "
                         f"kernel takes at most {MAX_CHUNK}, {MAX_STATE}, "
                         f"{MAX_HEAD_DIM}")
    return dev, T


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int = 128,
                  return_scratch: bool = False):
    """Launch the CUDA kernel. x, a and b contiguous on one CUDA device; c
    may be any strided view whose last dimension is contiguous (the mixer
    passes one (B, S, N) tensor broadcast over H, stride 0, not a copy).
    The C launcher runs the chunked form's three steps (chunk states, state
    passing, chunk scan) on scratch allocated here; it counts as one
    launch of ``ssd_scan``. Returns (y, h_final), and with
    ``return_scratch`` the scratch the backward reads (as
    ``ssd_scan_torch``'s: ``states``, ``cl``).
    The decays are not checked for a > 0 here: that would synchronize the
    host on every layer."""
    name = "ssd_scan"
    dev, T = _check(name, x, a, b, c, chunk)
    B, S, H, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    # scratch of the chunked form: each chunk's state, then (in place) the
    # state entering it; and cl = cumsum(log a) within each chunk
    states = torch.empty((B, H, S // T, N, P), dtype=torch.float32,
                         device=dev)
    cl = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    if B * H and _build.traced(x):
        _build.trace_launch(name, *work(x, b, c))
    elif B * H:
        _build.launch(name, dev, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), y.data_ptr(), h.data_ptr(),
                      states.data_ptr(), cl.data_ptr(), B, S, H, P, N, T,
                      c.stride(0), c.stride(1), c.stride(2),
                      int(x.dtype == torch.bfloat16),
                      int(b.dtype == torch.bfloat16),
                      int(c.dtype == torch.bfloat16))
    return (y, h, states, cl) if return_scratch else (y, h)


def ssd_scan_bwd_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, dy: torch.Tensor,
                      dh_final: Optional[torch.Tensor],
                      states: torch.Tensor, cl: torch.Tensor,
                      chunk: int = 128):
    """Launch the backward kernels (``csrc/ssd_scan_bwd.cu``: the chunk
    states of dy, the reverse state passing, dx and db by step s, then dc
    and da by step t), on the forward's scratch (``states``, ``cl`` from
    ``ssd_scan_cuda(..., return_scratch=True)``) and scratch allocated
    here (g, each chunk's outgoing state gradient, and four (B, H, S)
    planes: the row sums of M1 ⊙ dY Xᵀ from each 64-step block s, its
    column sums, and r); counts as one launch of ``ssd_scan_bwd``. Inputs as
    ``ssd_scan_cuda``'s, dy (y's gradient) in x's dtype, ``dh_final``
    (B, H, N, P) f32 or None. Returns (dx, da, db, dc) as
    ``ssd_scan_bwd_torch`` does: dc is (B, S, H, N) in c's dtype for every
    head, whatever c's strides."""
    name = "ssd_scan_bwd"
    dev, T = _check(name, x, a, b, c, chunk)
    B, S, H, P = x.shape
    N = b.shape[-1]
    _build.require_cuda(name, x, dy, states, cl)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{name}: dy must be shaped and typed as x")
    nc = S // T
    if (states.shape != (B, H, nc, N, P) or cl.shape != (B, H, S)
            or states.dtype != torch.float32 or cl.dtype != torch.float32):
        raise ValueError(f"{name}: states (B, H, S / T, N, P) and cl "
                         f"(B, H, S) f32, the forward's scratch")
    if dh_final is not None:
        _build.require_cuda(name, x, dh_final)
        if (dh_final.shape != (B, H, N, P)
                or dh_final.dtype != torch.float32):
            raise ValueError(f"{name}: dh_final must be (B, H, N, P) f32")
    dx = torch.empty_like(x)
    da = torch.empty_like(a)
    db = torch.empty_like(b)
    dc = torch.empty((B, S, H, N), dtype=c.dtype, device=dev)
    if B * H == 0:
        return dx, da, db, dc
    g = torch.empty_like(states)
    vec = torch.empty((4, B, H, S), dtype=torch.float32, device=dev)
    if _build.traced(x):
        _build.trace_launch(name, *work_bwd(x, b, c, dh_final is not None))
        return dx, da, db, dc
    _build.launch(name, dev, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), dy.data_ptr(),
                  None if dh_final is None else dh_final.data_ptr(),
                  states.data_ptr(), cl.data_ptr(), dx.data_ptr(),
                  da.data_ptr(), db.data_ptr(), dc.data_ptr(), g.data_ptr(),
                  vec.data_ptr(), B, S, H, P, N, T, c.stride(0), c.stride(1),
                  c.stride(2), int(x.dtype == torch.bfloat16),
                  int(b.dtype == torch.bfloat16),
                  int(c.dtype == torch.bfloat16))
    return dx, da, db, dc


def work(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor
         ) -> Tuple[int, int]:
    """(flops, bytes) that the function needs, for the bound. Flops: the
    recurrence from a zero state, 5·N·P per step and head (a·h, the
    b ⊗ x update and c · h). The chunked form's products (C Bᵀ and its
    product with X over a chunk's triangle, C h and the state update per
    chunk) are the algorithm's cost, not the function's, and are not
    counted. Bytes: x, b and y once at their item sizes, a in f32, c once
    per distinct head (once in all when it is broadcast over H, stride
    0), h_final in f32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    flops = 5 * B * S * H * N * P
    c_heads = 1 if c.stride(2) == 0 else H
    nbytes = (B * S * H * P * 2 * x.element_size() + B * S * H * 4
              + B * S * H * N * b.element_size()
              + B * S * c_heads * N * c.element_size() + B * H * N * P * 4)
    return flops, nbytes


def work_bwd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             with_dh: bool) -> Tuple[int, int]:
    """(flops, bytes) that the gradient needs, for the bound. Flops: the
    recurrence's backward from each chunk's saved incoming state, 14·N·P
    per step and head: 3 to carry dh_t = a_{t+1} dh_{t+1} + c_t ⊗ dy_t, 2
    each for dx_t = dh_tᵀ b_t, db_t = dh_t x_t, dc_t = h_t dy_t and da_t =
    <dh_t, h_{t-1}>, and 3 to recompute h_t. The chunked form's triangle
    products are the algorithm's cost, not the function's. Bytes: x, dy,
    b, dx and db once at their item sizes; c once per distinct head (as
    ``work``); dc for every head at c's item size; a and da in f32; the
    forward's scratch read once (states (B, H, S / T, N, P) and cl, f32,
    at chunk 128); dh_final in f32 when given."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    flops = 14 * B * S * H * N * P
    c_heads = 1 if c.stride(2) == 0 else H
    nc = -(-S // MAX_CHUNK)
    nbytes = (B * S * H * P * 3 * x.element_size()
              + B * S * H * N * 2 * b.element_size()
              + B * S * (c_heads + H) * N * c.element_size()
              + B * S * H * 4 * 3 + B * H * nc * N * P * 4
              + (B * H * N * P * 4 if with_dh else 0))
    return flops, nbytes
