"""Public kernel API with backend dispatch: the NIC ops of the data plane
and the attention and SSD ops of the LM stack.

Two implementations per op:
  * the hand-written CUDA kernel — taken for tensors on a CUDA device;
  * the plain PyTorch version   — taken for tensors on the CPU.

``impl=None`` dispatches by the tensors' device. The attention and SSD ops
have a third branch, taken before the device is looked at, for tensors
that hold no data (on the meta device, or fake: ``_build.traced``): their
kernel wrapper allocates what the kernel's call allocates (outputs,
scratch, the tensors saved for backward) and reports the kernel's work
instead of launching it, so a dry run traces the card's path. ``impl="torch"`` forces the
plain version on any device: only the tests and ``chip_smoke.py`` use it, to
hold a kernel against its plain version on the card.

On DTensors (a partitioned step) the attention and SSD ops run under
``local_map``: each rank calls the same op on its local block, whose
placements come from the logical axes of the op's tensors under the
installed rules (batch over data, heads over model where the rules put
them there). A layout that splits a sequence, a head's features or a GQA
group over ranks raises: sequence-parallel attention is not ported, and
gathering the sequence silently would hide that.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import crypto as _crypto
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dfa_regex as _dfa
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.parallel import sharding as _sh

build_aho_corasick = _ref.build_aho_corasick

IMPLS = (None, "torch")


def _check_impl(impl: Optional[str]) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def _plain(impl: Optional[str], t: torch.Tensor) -> bool:
    """Whether the plain version runs: with ``impl="torch"``, or for data
    on the CPU. A traced tensor takes the kernel's wrapper (its
    kernel-shaped branch), as a CUDA tensor does."""
    if impl == "torch":
        return True
    if _build.traced(t):
        return False
    return not t.is_cuda


def regex_scan(payload, length, table, out_count, *, packed=None,
               depth: Optional[int] = None, counts=None,
               impl: Optional[str] = None):
    """Match counts of the DFA (``table``, ``out_count``); the kernel takes
    it as ``dfa_regex.prepare`` left it (``packed``, ``depth``, and
    ``counts`` for the wide form)."""
    _check_impl(impl)
    if impl == "torch":
        return _dfa.dfa_scan_torch(payload, length, table, out_count)
    return _dfa.dfa_regex(payload, length, table, out_count, packed, depth,
                          counts)


def cipher(words, key, *, impl: Optional[str] = None):
    _check_impl(impl)
    if impl == "torch":
        return _crypto.arx_cipher_torch(words, key)
    return _crypto.arx_cipher(words, key)


def digest(words, key, *, impl: Optional[str] = None):
    _check_impl(impl)
    if impl == "torch":
        return _crypto.keyed_hash_torch(words, key)
    return _crypto.keyed_hash(words, key)


# ---------------------------------------------------------------------------
# Partitioned calls: each rank's local block under local_map.
# ---------------------------------------------------------------------------

def _specs(op: str, tensors, axes):
    """(mesh, specs) of the op's DTensor arguments from their logical
    ``axes`` under the installed rules; raises where the specs split a
    sequence or a head's features over a mesh axis."""
    rules = _sh.installed()[0]
    mesh = tensors[0].device_mesh
    if rules is None:
        raise RuntimeError(f"{op} on DTensors needs the activation rules "
                           f"installed (sharding.set_activation_sharding)")
    specs = [_sh.spec_for(ax, tuple(t.shape), rules, mesh)
             for t, ax in zip(tensors, axes)]
    for t, ax, spec in zip(tensors, axes, specs):
        for d, a in enumerate(ax):
            if a in ("seq", "kv_seq", "head_dim") and \
                    _sh.entry_axes(spec[d]):
                raise NotImplementedError(
                    f"{op}: the rules split dim {d} ({ax[d]}) of a tensor "
                    f"of shape {tuple(t.shape)} over {spec[d]!r}; "
                    f"sequence-parallel attention is not ported")
    return mesh, specs


def _local(fn, mesh, specs, out_specs, *args):
    """``fn`` on each rank's local blocks of ``args`` (the DTensors
    redistributed to ``specs`` first, a no-op where they have them), its
    outputs DTensors placed by ``out_specs``."""
    from torch.distributed.tensor.experimental import local_map
    pl = [_sh.live_placements(s, mesh) for s in specs]
    outs = [_sh.live_placements(s, mesh) for s in out_specs]
    return local_map(fn, out_placements=tuple(outs) if len(outs) > 1
                     else list(outs[0]),
                     in_placements=tuple(pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _same_groups(op: str, q_heads, kv_heads) -> None:
    if _sh.entry_axes(q_heads) != _sh.entry_axes(kv_heads):
        raise NotImplementedError(
            f"{op}: query heads over {q_heads!r} and kv heads over "
            f"{kv_heads!r} would part a GQA group from its kv head")


_Q_AXES = ("batch", "seq", "heads", "head_dim")
_KV_AXES = ("batch", "seq", "kv_heads", "head_dim")


def _attention_partitioned(q, k, v, **kw):
    mesh, (qs, ks, vs) = _specs("attention", (q, k, v),
                                (_Q_AXES, _KV_AXES, _KV_AXES))
    _same_groups("attention", qs[2], ks[2])
    return _local(lambda q, k, v: attention(q, k, v, **kw), mesh,
                  (qs, ks, vs), (qs,), q, k, v)


def _decode_partitioned(q, k, v, kv_len, **kw):
    kv_axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    mesh, (qs, ks, vs) = _specs("decode_attention", (q, k, v),
                                (("batch", "heads", "head_dim"), kv_axes,
                                 kv_axes))
    _same_groups("decode_attention", qs[1], ks[2])
    lens = _sh.block(kv_len, _sh.PartitionSpec(qs[0]), mesh)
    return _local(lambda q, k, v: decode_attention(q, k, v, lens, **kw),
                  mesh, (qs, ks, vs), (qs,), q, k, v)


def _ssd_partitioned(x, a, b, c, **kw):
    """The scan's heads follow the inner dim's rule (``ff``), as the
    reference's reshape of the pinned (B, S, d_inner) activations gives
    them."""
    four = ("batch", "seq", "ff", None)
    mesh, (xs, as_, bs, cs) = _specs(
        "ssd", (x, a, b, c), (four, ("batch", "seq", "ff"), four, four))
    hs = _sh.PartitionSpec(xs[0], xs[2], None, None)
    return _local(lambda x, a, b, c: ssd(x, a, b, c, **kw), mesh,
                  (xs, as_, bs, cs), (xs, hs), x, a, b, c)


# ---------------------------------------------------------------------------
# Attention (prefill) and decode attention (one token vs a KV cache).
# ---------------------------------------------------------------------------

class _Attention(torch.autograd.Function):
    """Attention with its flash-style gradient, as the reference's custom
    VJP ``_attention_blocked``: the forward keeps (q, k, v, out, lse) and
    the backward recomputes the probabilities from lse. ``plain`` picks the
    plain forward and backward, else B5 and its backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, plain, block_k):
        if plain:
            out, lse = _fa.flash_attention_torch(
                q, k, v, causal=causal, window=window, scale=scale,
                block_k=block_k, return_lse=True)
        else:
            out, lse = _fa.flash_attention_cuda(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=causal, window=window, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, plain, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, plain, block_k = ctx.args
        if plain:
            grads = _fa.flash_attention_bwd_torch(
                q, k, v, out, lse, dout, causal=causal, window=window,
                scale=scale, block_k=block_k)
        else:
            grads = _fa.flash_attention_bwd_cuda(
                q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                dout.contiguous(), causal=causal, window=window, scale=scale)
        return grads + (None,) * 5


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, impl: Optional[str] = None,
              block_k: int = 256) -> torch.Tensor:
    """Flash attention. q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).
    ``block_k`` is the plain version's key block. Where autograd needs a
    gradient of q, k or v, the call goes through ``_Attention``: B5 and
    its backward kernel on the card, the plain pair on the CPU or with
    ``impl="torch"``. On DTensors, each rank's local block (module
    docstring)."""
    _check_impl(impl)
    if _sh.is_dtensor(q):
        return _attention_partitioned(q, k, v, causal=causal, window=window,
                                      scale=scale, impl=impl,
                                      block_k=block_k)
    scale_v = float(scale) if scale is not None else q.shape[-1] ** -0.5
    plain = _plain(impl, q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window, scale_v, plain,
                                block_k)
    if plain:
        return _fa.flash_attention_torch(q, k, v, causal=causal,
                                         window=window, scale=scale_v,
                                         block_k=block_k)
    return _fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window, scale=scale_v)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, scale: Optional[float] = None,
                     impl: Optional[str] = None,
                     block_k: int = 512) -> torch.Tensor:
    """q: (B, Hq, D); k, v: (B, S, Hkv, D); kv_len: (B,) int32.
    ``block_k`` is the plain version's key block. On DTensors, each
    rank's local block, with its rows of ``kv_len`` (a plain tensor)."""
    _check_impl(impl)
    if _sh.is_dtensor(q):
        return _decode_partitioned(q, k, v, kv_len, scale=scale, impl=impl,
                                   block_k=block_k)
    scale_v = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if _plain(impl, q):
        return _da.decode_attention_torch(q, k, v, kv_len, scale=scale_v,
                                          block_k=block_k)
    return _da.decode_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), kv_len.contiguous(),
                                     scale=scale_v)


# ---------------------------------------------------------------------------
# Mamba-2 SSD.
# ---------------------------------------------------------------------------

class _SSD(torch.autograd.Function):
    """The SSD scan with its chunked gradient: the forward keeps (x, a, b,
    c) and the scan's scratch (each chunk's incoming state and cl), the
    backward runs the forward's steps in reverse from them. ``plain``
    picks the plain forward and backward, else B7 and its backward
    kernel. A gradient of y or h_final that autograd does not need arrives
    as None (h_final's, when the caller drops it, is taken as zero)."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk, plain):
        ctx.set_materialize_grads(False)
        if plain:
            y, h, states, cl = _ssd.ssd_scan_torch(x, a, b, c, chunk,
                                                   return_scratch=True)
        else:
            y, h, states, cl = _ssd.ssd_scan_cuda(
                x.contiguous(), a.contiguous(), b.contiguous(), c, chunk,
                return_scratch=True)
        ctx.save_for_backward(x, a, b, c, states, cl)
        ctx.args = (chunk, plain)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, a, b, c, states, cl = ctx.saved_tensors
        chunk, plain = ctx.args
        if dy is None:
            dy = torch.zeros_like(x)
        if plain:
            grads = _ssd.ssd_scan_bwd_torch(x, a, b, c, dy, dh, states, cl,
                                            chunk)
        else:
            grads = _ssd.ssd_scan_bwd_cuda(
                x.contiguous(), a.contiguous(), b.contiguous(), c,
                dy.contiguous(), None if dh is None else dh.contiguous(),
                states, cl, chunk)
        return grads + (None, None)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        *, chunk: int = 128, impl: Optional[str] = None):
    """Mamba-2 SSD from a zero state. x: (B, S, H, P), a: (B, S, H) in
    (0, 1], b/c: (B, S, H, N) (c may be a view broadcast over H). Returns
    (y (B, S, H, P), h_final (B, H, N, P) f32). Where autograd needs a
    gradient of x, a, b or c, the call goes through ``_SSD``: B7 and its
    backward kernel on the card, the plain pair on the CPU or with
    ``impl="torch"``. On DTensors, each rank's local block."""
    _check_impl(impl)
    if _sh.is_dtensor(x):
        return _ssd_partitioned(x, a, b, c, chunk=chunk, impl=impl)
    plain = _plain(impl, x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, b, c)):
        return _SSD.apply(x, a, b, c, chunk, plain)
    if plain:
        return _ssd.ssd_scan_torch(x, a, b, c, chunk)
    return _ssd.ssd_scan_cuda(x.contiguous(), a.contiguous(), b.contiguous(),
                              c, chunk)
