"""Roofline decomposition: a step counted piece by piece, each piece times
its multiplicity, as the reference's ``launch/decompose.py``.

    total = Σ_piece cost(piece) × multiplicity(piece)

Pieces of a training step: one repetition of each segment's body (forward
and backward) × ``seg.count × accum``; the embedding, final norm and
chunked cross-entropy head × ``accum``; the gradient sums (made once,
added to ``accum`` times) and AdamW, once. Prefill: the embedding with the
cache's allocation, each segment's body × count, the final norm and
last-position logits. Decode: the embedding and head, and each segment's
body × count. The encoder-decoder has its encoder and decoder layers in
place of segments. Per-segment costs are the per-stage figures Meili's
Algorithm 1 plans with. With ``cfg.remat`` a training body runs under
``remat.checkpoint`` as the step runs it, so its backward books the
recomputed forward (the reference's ``jax.checkpoint`` in its pieces);
the encoder-decoder's cross-entropy chunks are checkpointed always.

Each piece runs eagerly on the meta device at the step's own shapes,
under the counter of ``roofline.trace`` (the kernels through their
kernel-shaped branches). The reference lowers each piece at two sequence
lengths and fits cost(S) = a·S + b·S² (``_fit_quadratic``, ``S_FIT``)
because XLA's cost analysis counts a ``while`` body once; an eager count
counts every op, so each piece is exact at the target S and there is
nothing to fit. The pieces' FLOPs sum to the whole step's exactly, and
so do their bytes: what joins two pieces is a piece of its own (the
first encoder layer, whose input needs no gradient; the sum autograd
makes of the decoder layers' gradients of the encoder's output).

Over a partitioned mesh (``mesh.fake_mesh``) each piece's inputs are
DTensors placed as the step places them (the parameters, gradients and
moments by the resolver, activations by their logical axes: ("batch",
"seq", None)), each piece runs under the step's context
(``steps.on_mesh``) and its collectives are counted
(``roofline.collective_bytes``, ``coll`` in each piece); its figures are
one device's. A piece starts from activations in their pinned layout,
so the redistributions that join two pieces land in the later one.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline as rl
from repro_torch.launch.steps import (accumulate, choose_microbatch,
                                      finish_grads, grad_buffers, on_mesh,
                                      partitioned, place_batch, place_cache)
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import remat
from repro_torch.models.layers import embed, make_norm
from repro_torch.models.registry import Model
from repro_torch.optim import adamw_init, adamw_update, make_schedule

META = torch.device("meta")
# ``make_train_step``'s defaults; the learning rate at step 1 is computed
# as the step computes it
_SCHEDULE = (3e-4, 100, 10000)


# the partitioned mesh and rules of the cell being decomposed, if any
_ON = {"mesh": None, "rules": None}


def _empty(shape, dtype, grad: bool = False, axes=None) -> torch.Tensor:
    """A meta tensor; over a partitioned mesh a DTensor placed by the spec
    of ``axes`` (replicated without)."""
    mesh = _ON["mesh"]
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device=META,
                           requires_grad=grad)
    from repro_torch.parallel import sharding as sh
    t = sh.dzeros(shape, axes or (None,) * len(shape), _ON["rules"], mesh,
                  dtype, META)
    return t.requires_grad_(grad)


_ACT = ("batch", "seq", None)


def _like(t: torch.Tensor) -> torch.Tensor:
    """A meta tensor shaped and placed as ``t``."""
    return torch.empty_like(t) if _ON["mesh"] is not None else \
        _empty(t.shape, t.dtype)


def _params(model: Model, dtype):
    params = model.param_struct(dtype)
    if _ON["mesh"] is not None:
        model.distribute(params, _ON["mesh"], _ON["rules"])
    return params


def _zero() -> Dict:
    return {"flops": 0, "bytes": 0, "kernel_flops": 0, "kernels": {}}


def _acc(totals: Dict, piece: Dict, mult: int) -> None:
    for k in ("flops", "bytes", "kernel_flops"):
        totals[k] += piece[k] * mult
    for name, k in piece["kernels"].items():
        t = totals["kernels"].setdefault(name, {"launches": 0, "flops": 0,
                                                "bytes": 0})
        for f in t:
            t[f] += k[f] * mult


class _Pieces:
    def __init__(self):
        self.totals, self.pieces = _zero(), {}

    def add(self, name: str, fn: Callable, mult: int) -> None:
        mesh = _ON["mesh"]
        if mesh is None:
            c = rl.trace(fn)
        else:
            with on_mesh(mesh, _ON["rules"]), \
                    rl.collective_bytes(mesh) as coll:
                c = rl.trace(fn)
            c["coll"] = coll.result
        c.pop("seconds")
        self.pieces[name] = {**c, "mult": mult}
        _acc(self.totals, c, mult)


def _grad(outputs, inputs, grad_outputs=None):
    torch.autograd.grad(outputs, inputs, grad_outputs, allow_unused=True)


def _train_tail(p: _Pieces, cfg, named: Dict[str, torch.Tensor],
                accum: int) -> None:
    """The gradient sums and AdamW, as ``make_train_step`` runs them."""
    grad_dtype = torch.bfloat16 if cfg.bf16_optimizer_state else torch.float32
    grads = {k: _like(t) for k, t in named.items()}
    g_acc = grad_buffers(named, grad_dtype)
    loss = _empty((), torch.float32)
    p.add("grad_init", lambda: finish_grads(grad_buffers(named, grad_dtype),
                                            [loss] * accum), 1)
    p.add("grad_accum", lambda: accumulate(g_acc, grads), accum)
    opt = adamw_init(named, grad_dtype)
    lr_fn = make_schedule(cfg.schedule, *_SCHEDULE)
    p.add("optimizer", lambda: adamw_update(named, g_acc, opt, lr_fn(1)), 1)


# ---------------------------------------------------------------------------
# decoder LM families (dense, vlm, MoE, ssm, hybrid)
# ---------------------------------------------------------------------------

def _lm_train(model: Model, shape: ShapeConfig, dtype, p: _Pieces) -> None:
    cfg = model.cfg
    accum = choose_microbatch(cfg, shape.global_batch, _ON["mesh"],
                              _ON["rules"])
    B, S, D = shape.global_batch // accum, shape.seq_len, cfg.d_model
    params = _params(model, dtype).requires_grad_(True)
    named = dict(params.named_parameters())
    mb_shape = ShapeConfig(shape.name, S, B, "train")
    mb = place_batch(model, model.input_specs(mb_shape, dtype), mb_shape,
                     _ON["mesh"], _ON["rules"])
    _, norm_apply = make_norm(cfg)

    for si, seg in enumerate(lm_mod.build_schedule(cfg)):
        layers = params.layers(si, 0)
        x = _empty((B, S, D), dtype, grad=True, axes=_ACT)
        pos, hbar = lm_mod.positions_of(x), _empty((B, S, D), dtype,
                                                   axes=_ACT)
        ps = [t for layer in layers for t in layer.parameters()]

        def body(layers=layers, x=x, pos=pos, hbar=hbar, ps=ps):
            h = remat.maybe(cfg, lm_mod._apply_body, cfg, layers, x, pos,
                            None)
            _grad(h, ps + [x], hbar)
        p.add(f"segment{si}", body, seg.count * accum)

    x_last = _empty((B, S, D), dtype, grad=True, axes=_ACT)
    dx0 = _empty((B, S, D), dtype, axes=_ACT)
    outer = [t for k, t in named.items() if not k.startswith("segments.")]

    def embed_loss():
        x0 = lm_mod._embed_inputs(params, mb["tokens"], mb.get("patches"))
        lm_mod.positions_of(x0)
        offset = 0 if "patches" not in mb else mb["patches"].shape[1]
        loss = lm_mod.chunked_ce(cfg, params, norm_apply(params.final_norm,
                                                         x_last),
                                 mb["tokens"], offset)
        _grad([loss, x0], outer + [x_last], [None, dx0])
    p.add("embed_loss", embed_loss, accum)
    _train_tail(p, cfg, named, accum)


@torch.no_grad()
def _lm_prefill(model: Model, shape: ShapeConfig, dtype, p: _Pieces,
                cache_dtype) -> None:
    cfg = model.cfg
    B, S, D = shape.global_batch, shape.seq_len, cfg.d_model
    params = _params(model, dtype)
    inp = place_batch(model, model.input_specs(shape, dtype), shape,
                      _ON["mesh"], _ON["rules"])
    _, norm_apply = make_norm(cfg)
    mesh = _ON["mesh"]

    def embed_cache():
        x = lm_mod._embed_inputs(params, inp["tokens"], inp.get("patches"))
        lm_mod.positions_of(x)
        lm_mod._new_cache(cfg, B, S, cache_dtype, META, with_mamba=False,
                          mesh=mesh)
    p.add("embed", embed_cache, 1)

    with on_mesh(mesh, _ON["rules"]):
        cache = lm_mod._new_cache(cfg, B, S, cache_dtype, META,
                                  with_mamba=False, mesh=mesh)
    for si, seg in enumerate(lm_mod.build_schedule(cfg)):
        layers = params.layers(si, 0)
        x = _empty((B, S, D), dtype, axes=_ACT)
        pos = lm_mod.positions_of(x)

        def body(si=si, seg=seg, layers=layers, x=x, pos=pos):
            h = x
            for bpos, layer in enumerate(layers):
                h = lm_mod.prefill_layer(cfg, layer, h, pos, None,
                                         cache["segments"][si][bpos], 0,
                                         seg.count, cache_dtype)
        p.add(f"segment{si}", body, seg.count)

    x = _empty((B, S, D), dtype, axes=_ACT)
    p.add("head", lambda: lm_mod.logits(
        cfg, params, norm_apply(params.final_norm, x)[:, -1]), 1)


@torch.no_grad()
def _lm_decode(model: Model, shape: ShapeConfig, dtype, p: _Pieces,
               cache_dtype) -> None:
    cfg = model.cfg
    B, S, D = shape.global_batch, shape.seq_len, cfg.d_model
    params = _params(model, dtype)
    cache = place_cache(model, model.cache_struct(shape, cache_dtype),
                        _ON["mesh"], _ON["rules"])
    tokens = _empty((B,), torch.int32, axes=("batch",))
    _, norm_apply = make_norm(cfg)
    pos = S - 1

    def embed_head():
        x = embed(params.embed, tokens)
        return lm_mod.logits(cfg, params, norm_apply(params.final_norm, x))
    p.add("embed_head", embed_head, 1)

    schedule = lm_mod.build_schedule(cfg)
    for si, seg in enumerate(schedule):
        layers = params.layers(si, 0)
        seg_c = cache["segments"][si]
        if any(not lm_mod._is_attn(s) for s in seg.body):
            p.add(f"segment{si}_tails", lambda seg_c=seg_c, seg=seg: [
                lm_mod._promote_tails(c, dtype)
                for c, s in zip(seg_c, seg.body) if not lm_mod._is_attn(s)],
                1)
        x = _empty((B, D), dtype, axes=("batch", None))

        def body(layers=layers, seg_c=seg_c, x=x):
            h = x
            for bpos, layer in enumerate(layers):
                h = lm_mod.decode_layer(cfg, layer, h,
                                        lm_mod.layer_cache(seg_c[bpos], 0),
                                        pos, None)
        p.add(f"segment{si}", body, seg.count)


# ---------------------------------------------------------------------------
# encoder-decoder
# ---------------------------------------------------------------------------

def _encdec(model: Model, shape: ShapeConfig, dtype, p: _Pieces,
            cache_dtype) -> None:
    cfg = model.cfg
    train = shape.kind == "train"
    accum = choose_microbatch(cfg, shape.global_batch, _ON["mesh"],
                              _ON["rules"]) if train else 1
    B, D = shape.global_batch // accum, cfg.d_model
    params = _params(model, dtype).requires_grad_(train)
    named = dict(params.named_parameters())
    _, norm_apply = make_norm(cfg)
    ctx = torch.enable_grad if train else torch.no_grad

    if shape.kind == "decode":
        S = shape.seq_len
        cache = place_cache(model, model.cache_struct(shape, cache_dtype),
                            _ON["mesh"], _ON["rules"])
        tokens = _empty((B,), torch.int32, axes=("batch",))

        @torch.no_grad()
        def embed_head():
            h = embed(params.embed, tokens)
            encdec_mod.logits(cfg, params, norm_apply(params.dec_norm, h))
        p.add("embed_head", embed_head, 1)
        x = _empty((B, D), dtype, axes=("batch", None))
        p.add("dec_body", torch.no_grad()(lambda: encdec_mod.
                                          decode_layer_encdec(
                                              cfg, params.dec[0], x, cache,
                                              0, S - 1)), cfg.dec_layers)
        return

    half = shape.seq_len // 2
    mb_shape = ShapeConfig(shape.name, shape.seq_len, B, shape.kind)
    inp = place_batch(model, model.input_specs(mb_shape, dtype), mb_shape,
                      _ON["mesh"], _ON["rules"])
    frames, tokens = inp["frames"], inp["tokens"]

    def body_of(layer_fn, lp, grads):
        xs = [_empty((B, half, D), dtype, grad=g, axes=_ACT) for g in grads]
        pos = encdec_mod._positions(xs[0])
        hbar = _empty((B, half, D), dtype, axes=_ACT)

        def body():
            with ctx():
                out = remat.maybe(cfg, layer_fn, cfg, lp, xs[0], pos,
                                  *xs[1:])
                if train:
                    _grad(out, list(lp.parameters())
                          + [x for x in xs if x.requires_grad], hbar)
        return body
    mult = accum if train else 1
    # the frames need no gradient: the first encoder layer's input has none
    p.add("enc_first", body_of(encdec_mod.encoder_layer, params.enc[0],
                               (False,)), mult)
    p.add("enc_body", body_of(encdec_mod.encoder_layer, params.enc[0],
                              (train,)), (cfg.enc_layers - 1) * mult)
    p.add("dec_body", body_of(encdec_mod.decoder_layer, params.dec[0],
                              (train, train)), cfg.dec_layers * mult)
    if train:
        # autograd sums the gradients the decoder layers give enc_out
        g = [_empty((B, half, D), dtype, axes=_ACT) for _ in range(2)]
        p.add("enc_out_grad_sum", lambda: g[0] + g[1],
              (cfg.dec_layers - 1) * mult)

    enc_h = _empty((B, half, D), dtype, grad=train, axes=_ACT)
    dec_h = _empty((B, half, D), dtype, grad=train, axes=_ACT)
    d_eo = _empty((B, half, D), dtype, axes=_ACT)
    d_x0 = _empty((B, half, D), dtype, axes=_ACT)
    outer = [t for k, t in named.items()
             if not k.startswith(("enc.", "dec."))]

    def embed_loss():
        with ctx():
            encdec_mod._positions(frames)
            eo = norm_apply(params.enc_norm, enc_h)
            x0 = encdec_mod._pin(embed(params.embed, tokens))
            encdec_mod._positions(x0)
            x = norm_apply(params.dec_norm, dec_h)
            if not train:
                encdec_mod.logits(cfg, params, x[:, -1])
                return
            loss = encdec_mod.chunked_ce(cfg, params, x, tokens)
            _grad([loss, eo, x0], outer + [enc_h, dec_h], [None, d_eo, d_x0])
    p.add("embed_loss" if train else "embed_head", embed_loss, mult)
    if train:
        _train_tail(p, cfg, named, accum)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def decompose_cell(model: Model, shape: ShapeConfig, mesh=None,
                   rules=None, dtype=torch.bfloat16,
                   cache_dtype=torch.bfloat16) -> Dict:
    """Per-piece and total FLOPs and bytes of one (arch × shape) step, a
    device's, and its roofline: ``{"totals", "pieces", "roofline"}``. On
    one card (``mesh`` None or of one device), or over a partitioned
    DeviceMesh under ``rules`` (default ``rules_for``), whose totals also
    carry the pieces' collectives (``coll``)."""
    cfg = model.cfg
    p = _Pieces()
    if partitioned(mesh):
        from repro_torch.parallel.sharding import rules_for
        _ON.update(mesh=mesh, rules=rules or rules_for(cfg, mesh))
    try:
        if cfg.family == "encdec":
            _encdec(model, shape, dtype, p, cache_dtype)
        elif shape.kind == "train":
            _lm_train(model, shape, dtype, p)
        elif shape.kind == "prefill":
            _lm_prefill(model, shape, dtype, p, cache_dtype)
        else:
            _lm_decode(model, shape, dtype, p, cache_dtype)
    finally:
        on = dict(_ON)
        _ON.update(mesh=None, rules=None)
    coll = None
    if on["mesh"] is not None:
        coll = {"total": 0, "by_axis": {}}
        for piece in p.pieces.values():
            coll["total"] += piece["coll"]["total"] * piece["mult"]
            for a, n in piece["coll"]["by_axis"].items():
                coll["by_axis"][a] = coll["by_axis"].get(a, 0) + \
                    n * piece["mult"]
        p.totals["coll"] = coll
    total, active = model.param_counts()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mflops = rl.model_flops(total, active, shape.kind, tokens)
    roof = rl.build(p.totals["flops"], p.totals["bytes"], mflops, dtype,
                    mesh=on["mesh"], coll=coll)
    return {"totals": p.totals, "pieces": p.pieces,
            "roofline": roof.to_dict()}
