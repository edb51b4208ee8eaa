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
them there). Where the rules split a sequence over ranks, each rank runs
the kernel on its block and the ranks exchange what the block needs:
the keys and values for attention (``attention_seq``), each block's
partial for decode over a sequence-sharded cache (``decode_over_blocks``,
B6 returning its log-sum-exp), the state carried between blocks for the
SSD (``ssd_seq``); no rank gathers the whole sequence of queries or
states. A layout that splits a head's features or a GQA group over ranks
raises.
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
from repro_torch.parallel import collectives as _coll
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
    head's features over a mesh axis (no rule table of the reference
    does)."""
    rules = _sh.installed()[0]
    mesh = tensors[0].device_mesh
    if rules is None:
        raise RuntimeError(f"{op} on DTensors needs the activation rules "
                           f"installed (sharding.set_activation_sharding)")
    specs = [_sh.spec_for(ax, tuple(t.shape), rules, mesh)
             for t, ax in zip(tensors, axes)]
    for t, ax, spec in zip(tensors, axes, specs):
        for d, a in enumerate(ax):
            if a == "head_dim" and _sh.entry_axes(spec[d]):
                raise NotImplementedError(
                    f"{op}: the rules split dim {d} ({ax[d]}) of a tensor "
                    f"of shape {tuple(t.shape)} over {spec[d]!r}; a head's "
                    f"features split over ranks is not ported")
    return mesh, specs


def _split(entry, mesh):
    """The entry if it splits a dim over more than one rank, else None."""
    if not _sh.entry_axes(entry):
        return None
    return entry if _sh.block_index(entry, mesh)[1] > 1 else None


def _local(fn, mesh, specs, out_specs, *args, partial_axes=()):
    """``fn`` on each rank's local blocks of ``args`` (the DTensors
    redistributed to ``specs`` first, a no-op where they have them), its
    outputs DTensors placed by ``out_specs``; an output numbered in
    ``partial_axes`` (output index -> mesh axes) is a partial sum over
    those axes."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    pl = [_sh.live_placements(s, mesh) for s in specs]
    outs = [list(_sh.live_placements(s, mesh)) for s in out_specs]
    for i, axes in dict(partial_axes).items():
        for a in axes:
            outs[i][mesh.mesh_dim_names.index(a)] = Partial()
    outs = [tuple(o) for o in outs]
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


def attention_seq(q, k, v, entry, mesh, *, causal: bool = True,
                  window: Optional[int] = None, **kw):
    """Sequence-parallel attention on one rank's blocks (plain tensors):
    q (B, L, Hq, D) is the rank's block r of n of the queries, k and v
    the rank's blocks of the keys, the sequence split over ``entry``'s
    mesh axes. K and V are gathered over those axes
    (``collectives.gather_dim``: its adjoint, a reduce-scatter, returns
    dK and dV to their owners); causal attention keeps the keys [0,
    (r+1)·L), under a window w from max(0, r·L - w + 1), and runs on the
    rank's L queries, which B5 aligns to the end of the keys; bidirectional
    attention keeps every key. dQ stays local."""
    r, _ = _sh.block_index(entry, mesh)
    L = q.shape[1]
    k = _coll.gather_dim(k, entry, mesh, 1)
    v = _coll.gather_dim(v, entry, mesh, 1)
    if causal:
        lo = 0 if window is None else max(0, r * L - window + 1)
        k, v = k[:, lo:(r + 1) * L], v[:, lo:(r + 1) * L]
    elif window is not None:
        raise NotImplementedError("a bidirectional window over a split "
                                  "sequence")
    return _attention_local(q, k, v, causal=causal, window=window, **kw)


def _attention_partitioned(q, k, v, **kw):
    mesh, (qs, ks, vs) = _specs("attention", (q, k, v),
                                (_Q_AXES, _KV_AXES, _KV_AXES))
    _same_groups("attention", qs[2], ks[2])
    seq, kv_seq = _split(qs[1], mesh), _split(ks[1], mesh)
    if _sh.entry_axes(seq) != _sh.entry_axes(kv_seq):
        raise NotImplementedError(
            f"attention: queries over {qs[1]!r}, keys over {ks[1]!r}")
    if seq is None:
        fn = lambda q, k, v: attention(q, k, v, **kw)
    else:
        fn = lambda q, k, v: attention_seq(q, k, v, seq, mesh, **kw)
    return _local(fn, mesh, (qs, ks, vs), (qs,), q, k, v)


def merge_partials(out: torch.Tensor, lse: torch.Tensor, entry, mesh
                   ) -> torch.Tensor:
    """Decode attention from each rank's partial over its block of the
    cache: out (B, Hq, D) and lse (B, Hq) (``LSE_EMPTY`` where the block
    has no valid key) gathered over ``entry``'s axes and merged by
    log-sum-exp, each rank's out weighed by exp(lse_r - max). Every rank
    of those axes gets the same (B, Hq, D) in out's dtype."""
    outs = _coll.gather_dim(out.float()[None], entry, mesh, 0)
    lses = _coll.gather_dim(lse.float()[None], entry, mesh, 0)
    lses = torch.where(lses >= _fa.LSE_EMPTY, _fa.NEG_INF, lses)
    w = torch.exp(lses - lses.amax(0))
    merged = (w[..., None] * outs).sum(0) / w.sum(0)[..., None]
    return merged.to(out.dtype)


def decode_over_blocks(partial, q, k, v, lo, kv_len, entry, mesh
                       ) -> torch.Tensor:
    """One rank's decode over its block of a cache whose keys ``entry``
    splits: ``partial(q, k, v, lo, kv_len, s0)`` gives (out, lse) over the
    block, s0 its first key's position; the ranks' partials merged
    (``merge_partials``)."""
    s0 = _sh.block_index(entry, mesh)[0] * k.shape[1]
    out, lse = partial(q, k, v, lo, kv_len, s0)
    return merge_partials(out, lse, entry, mesh)


def decode_partitioned(partial, q, k, v, lo, kv_len, whole):
    """Decode over DTensors q (B, Hq, D) and a cache k, v (B, S, Hkv, D),
    ``lo`` and ``kv_len`` plain (B,) tensors (``lo`` may be None): the
    rows of each rank's block of the batch; where the rules split the
    cache's keys, ``decode_over_blocks`` with ``partial``, else ``whole(q,
    k, v, lo, kv_len)`` on the block."""
    kv_axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    mesh, (qs, ks, vs) = _specs("decode_attention", (q, k, v),
                                (("batch", "heads", "head_dim"), kv_axes,
                                 kv_axes))
    _same_groups("decode_attention", qs[1], ks[2])
    rows = lambda t: None if t is None else \
        _sh.block(t, _sh.PartitionSpec(qs[0]), mesh)
    lo, lens = rows(lo), rows(kv_len)
    seq = _split(ks[1], mesh)
    if seq is None:
        fn = lambda q, k, v: whole(q, k, v, lo, lens)
    else:
        fn = lambda q, k, v: decode_over_blocks(partial, q, k, v, lo, lens,
                                                seq, mesh)
    return _local(fn, mesh, (qs, ks, vs), (qs,), q, k, v)


def b6_partial(**kw):
    """The partial of ``decode_over_blocks`` that B6 computes: (out, lse)
    over a block of the cache whose first key is at s0, with the block's
    valid length clamp(kv_len - s0, 0, S_b) (``lo`` is 0)."""
    def partial(q, k, v, lo, kv_len, s0):
        mine = (kv_len - s0).clamp(0, k.shape[1]).to(torch.int32)
        return decode_attention(q, k, v, mine, return_lse=True, **kw)
    return partial


def _decode_partitioned(q, k, v, kv_len, **kw):
    return decode_partitioned(
        b6_partial(**kw), q, k, v, None, kv_len,
        lambda q, k, v, lo, lens: decode_attention(q, k, v, lens, **kw))


def ssd_seq(x, a, b, c, entry, mesh, *, chunk: int = 128,
            impl: Optional[str] = None, partial_state: bool = False):
    """The SSD on one rank's block r of n of a sequence split over
    ``entry``'s axes (plain tensors). B7 runs from a zero state on the
    block, giving (y_r, h_r); the block's decay A_r = exp(sum log a)
    (B, H) f32 and h_r are gathered over the axes; the state entering
    the block, h_in(r) = A_{r-1} h_in(r-1) + h_{r-1} (h_in(0) = 0), adds
    exp(cl_t) (c_t · h_in(r)) to y_t, cl_t the cumulative log decay inside
    the block (<= 0: exp cannot overflow). The gradients reach the earlier
    blocks' h and A through the gather's adjoint. Returns (y, h_final):
    the whole sequence's final state, or with ``partial_state`` this
    rank's term of it, (A_{r+1} ··· A_{n-1}) h_r, whose sum over the
    ranks is the final state (a partial sum, as its gradient wants)."""
    r, n = _sh.block_index(entry, mesh)
    y, h = _ssd_local(x, a, b, c, chunk, impl)
    cl = torch.cumsum(torch.log(a.float()), dim=1)           # (B, L, H)
    A = torch.exp(cl[:, -1])                                 # (B, H)
    hs = _coll.gather_dim(h[None], entry, mesh, 0)           # (n, B, H, N, P)
    As = _coll.gather_dim(A[None], entry, mesh, 0)[..., None, None]
    # every rank runs the same ops on every block's (h, A), selecting by
    # its index: the gathers' gradients (reduce-scatters) then run on
    # every rank, in one order, whichever blocks a rank's output needs
    pick = lambda cond, new, old: new * float(cond) + old * float(not cond)
    h_in = hs[0] * 0.0
    for j in range(n - 1):
        h_in = pick(j < r, As[j] * h_in + hs[j], h_in)
    carried = torch.einsum("bshn,bhnp->bshp", c.float(), h_in)
    y = (y.float() + torch.exp(cl)[..., None] * carried).to(y.dtype)
    if partial_state:
        later = torch.ones_like(As[0])
        for j in range(1, n):
            later = pick(j > r, later * As[j], later)
        return y, later * h
    h_fin = h_in
    for j in range(n):
        h_fin = pick(j >= r, As[j] * h_fin + hs[j], h_fin)
    return y, h_fin


def _ssd_partitioned(x, a, b, c, **kw):
    """The scan's heads follow the inner dim's rule (``ff``), as the
    reference's reshape of the pinned (B, S, d_inner) activations gives
    them. Where the rules split the sequence, ``ssd_seq``: its final
    state is a partial sum over the sequence's axes."""
    four = ("batch", "seq", "ff", None)
    mesh, (xs, as_, bs, cs) = _specs(
        "ssd", (x, a, b, c), (four, ("batch", "seq", "ff"), four, four))
    hs = _sh.PartitionSpec(xs[0], xs[2], None, None)
    seq = _split(xs[1], mesh)
    if seq is None:
        return _local(lambda x, a, b, c: ssd(x, a, b, c, **kw), mesh,
                      (xs, as_, bs, cs), (xs, hs), x, a, b, c)
    return _local(lambda x, a, b, c: ssd_seq(x, a, b, c, seq, mesh,
                                             partial_state=True, **kw),
                  mesh, (xs, as_, bs, cs), (xs, hs), x, a, b, c,
                  partial_axes={1: _sh.entry_axes(seq)})


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
    docstring); on a rank's plain block of installed tokens whose
    sequence is split over ranks, ``attention_seq``."""
    _check_impl(impl)
    kw = dict(causal=causal, window=window, scale=scale, impl=impl,
              block_k=block_k)
    if _sh.is_dtensor(q):
        return _attention_partitioned(q, k, v, **kw)
    entry = _sh.token_seq_entry()
    if entry is not None:
        return attention_seq(q, k, v, entry, _sh.installed()[1], **kw)
    return _attention_local(q, k, v, **kw)


def _attention_local(q, k, v, *, causal=True, window=None, scale=None,
                     impl=None, block_k=256):
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
                     impl: Optional[str] = None, block_k: int = 512,
                     return_lse: bool = False):
    """q: (B, Hq, D); k, v: (B, S, Hkv, D); kv_len: (B,) int32.
    ``block_k`` is the plain version's key block. With ``return_lse``
    also each row's log-sum-exp of its scaled logits (B, Hq) f32,
    ``LSE_EMPTY`` where it has no valid key. On DTensors, each rank's
    local block, with its rows of ``kv_len`` (a plain tensor); where the
    rules split the cache's keys over ranks, each rank's partial over its
    block, merged (``merge_partials``)."""
    _check_impl(impl)
    if _sh.is_dtensor(q):
        if return_lse:
            raise NotImplementedError("decode_attention's lse on DTensors")
        return _decode_partitioned(q, k, v, kv_len, scale=scale, impl=impl,
                                   block_k=block_k)
    scale_v = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if _plain(impl, q):
        return _da.decode_attention_torch(q, k, v, kv_len, scale=scale_v,
                                          block_k=block_k,
                                          return_lse=return_lse)
    return _da.decode_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), kv_len.contiguous(),
                                     scale=scale_v, return_lse=return_lse)


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
    ``impl="torch"``. On DTensors, each rank's local block; on a rank's
    plain block of installed tokens whose sequence is split over ranks,
    ``ssd_seq`` (h_final the whole sequence's, on every rank)."""
    _check_impl(impl)
    if _sh.is_dtensor(x):
        return _ssd_partitioned(x, a, b, c, chunk=chunk, impl=impl)
    entry = _sh.token_seq_entry()
    if entry is not None:
        return ssd_seq(x, a, b, c, entry, _sh.installed()[1], chunk=chunk,
                       impl=impl)
    return _ssd_local(x, a, b, c, chunk, impl)


def _ssd_local(x, a, b, c, chunk, impl):
    plain = _plain(impl, x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, b, c)):
        return _SSD.apply(x, a, b, c, chunk, plain)
    if plain:
        return _ssd.ssd_scan_torch(x, a, b, c, chunk)
    return _ssd.ssd_scan_cuda(x.contiguous(), a.contiguous(), b.contiguous(),
                              c, chunk)
