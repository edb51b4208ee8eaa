"""Encoder-decoder transformer (seamless-m4t), as the reference's
``models/encdec.py``: a bidirectional encoder over stub audio-frame
embeddings and a causal decoder with cross-attention to the encoder
output.

Encoder and decoder are distinct Meili pipeline stages with different
latencies. A shape's seq_len is split evenly between encoder frames and
decoder tokens for train and prefill; decode keeps a seq_len-deep decoder
self-attention cache and a fixed ``ENC_LEN_DECODE``-frame encoder cache.
The reference scans each stack over stacked parameters; here each layer
is a module of its own (``EncDec.enc``, ``EncDec.dec``), in scan order.
The cache keeps the reference's layout, each leaf stacked over the
decoder's layers: ``self_k``/``self_v`` (L, B, max_len, Hkv, dh), written
in place by ``decode_step_encdec``, and ``cross_k``/``cross_v`` (L, B,
ENC_LEN_DECODE, Hkv, dh), only read; ``pos`` is a Python int.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from repro_torch.hw import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import remat
from repro_torch.models.layers import (embed, embed_init, make_norm, mlp,
                                       mlp_init, to_module)
from repro_torch.models.lm import _target_logits, vocab_bias
from repro_torch.parallel.sharding import constrain_act

Tree = Dict
ENC_LEN_DECODE = 4096


def _enc_layer_init(gen: torch.Generator, cfg, dtype, device) -> Tree:
    norm_init, _ = make_norm(cfg)
    return {"norm1": norm_init(dtype, device),
            "attn": attn_mod.attn_init(gen, cfg, dtype, device),
            "norm2": norm_init(dtype, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)}


def _dec_layer_init(gen: torch.Generator, cfg, dtype, device) -> Tree:
    norm_init, _ = make_norm(cfg)
    p = {nm: norm_init(dtype, device) for nm in ("norm1", "norm2", "norm3")}
    p["self"] = attn_mod.attn_init(gen, cfg, dtype, device)
    p["cross"] = attn_mod.attn_init(gen, cfg, dtype, device)
    p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


class EncDec(nn.Module):
    """Tied embedding, the encoder's and the decoder's layers (each a
    parameter tree keyed as the reference's layer tree: ``norm1``,
    ``attn``, ``norm2``, ``mlp`` in the encoder; ``norm1``-``norm3``,
    ``self``, ``cross``, ``mlp`` in the decoder) and the two final
    norms."""

    def __init__(self, cfg, embed: Mapping, enc: list, dec: list,
                 enc_norm: Mapping, dec_norm: Mapping):
        super().__init__()
        self.cfg = cfg
        self.embed = to_module(embed)
        self.enc = nn.ModuleList(to_module(p) for p in enc)
        self.dec = nn.ModuleList(to_module(p) for p in dec)
        self.enc_norm = to_module(enc_norm)
        self.dec_norm = to_module(dec_norm)


def init_encdec(cfg, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> EncDec:
    """Parameters drawn as the reference draws them (normal, 1/sqrt(fan-in)
    scale; norms at 1), in its order: the embedding, the encoder's layers,
    the decoder's, from ``generator`` (a fresh one seeded 0 on the device
    when None)."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    table = embed_init(gen, cfg.vocab, cfg.d_model, dtype, dev)
    enc = [_enc_layer_init(gen, cfg, dtype, dev)
           for _ in range(cfg.enc_layers)]
    dec = [_dec_layer_init(gen, cfg, dtype, dev)
           for _ in range(cfg.dec_layers)]
    norm_init, _ = make_norm(cfg)
    return EncDec(cfg, table, enc, dec, norm_init(dtype, dev),
                  norm_init(dtype, dev))


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(
        B, S)


def encoder_layer(cfg, lp, h: torch.Tensor, positions: torch.Tensor,
                  impl: Optional[str] = None) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention, then the MLP. The
    residual stream is pinned to ("batch", "seq", None) after each block,
    as ``lm._apply_layer`` pins it."""
    _, norm_apply = make_norm(cfg)
    h = _pin(h + attn_mod.attn_apply(lp["attn"], norm_apply(lp["norm1"], h),
                                     cfg, positions=positions, causal=False,
                                     impl=impl))
    return _pin(h + mlp(lp["mlp"], norm_apply(lp["norm2"], h)))


def _pin(h: torch.Tensor) -> torch.Tensor:
    return constrain_act(h, ("batch", "seq", None))


def decoder_layer(cfg, lp, h: torch.Tensor, positions: torch.Tensor,
                  enc_out: torch.Tensor, impl: Optional[str] = None
                  ) -> torch.Tensor:
    """One decoder layer over whole sequences: causal self-attention,
    cross-attention over ``enc_out`` (bidirectional), the MLP."""
    _, norm_apply = make_norm(cfg)
    h = _pin(h + attn_mod.attn_apply(lp["self"], norm_apply(lp["norm1"], h),
                                     cfg, positions=positions, causal=True,
                                     impl=impl))
    h = _pin(h + attn_mod.attn_apply(lp["cross"],
                                     norm_apply(lp["norm2"], h), cfg,
                                     positions=positions, causal=False,
                                     kv_x=enc_out, impl=impl))
    return _pin(h + mlp(lp["mlp"], norm_apply(lp["norm3"], h)))


def encode(cfg, params: EncDec, frames: torch.Tensor,
           impl: Optional[str] = None) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> the encoder output, every
    layer's attention bidirectional (``causal=False``). With ``cfg.remat``
    each layer runs under ``remat.checkpoint`` when autograd records, as
    the reference checkpoints its scanned body."""
    _, norm_apply = make_norm(cfg)
    h = _pin(frames)
    positions = _positions(frames)
    for lp in params.enc:
        h = remat.maybe(cfg, encoder_layer, cfg, lp, h, positions, impl)
    return norm_apply(params.enc_norm, h)


def decode_train(cfg, params: EncDec, tokens: torch.Tensor,
                 enc_out: torch.Tensor, impl: Optional[str] = None
                 ) -> torch.Tensor:
    """The decoder over whole token sequences (``decoder_layer`` each,
    checkpointed as ``encode``'s). Returns the final hidden states (B, S,
    D)."""
    _, norm_apply = make_norm(cfg)
    # pinned: a vocab-parallel lookup leaves a partial sum
    h = _pin(embed(params.embed, tokens))
    positions = _positions(h)
    for lp in params.dec:
        h = remat.maybe(cfg, decoder_layer, cfg, lp, h, positions, enc_out,
                        impl)
    return norm_apply(params.dec_norm, h)


def encdec_loss(cfg, params: EncDec, frames: torch.Tensor,
                tokens: torch.Tensor, impl: Optional[str] = None,
                chunk: int = 512) -> torch.Tensor:
    """Next-token cross-entropy of the decoder, chunk by chunk, as the
    reference's ``encdec_loss`` (``chunked_ce``)."""
    x = decode_train(cfg, params, tokens, encode(cfg, params, frames, impl),
                     impl)
    return chunked_ce(cfg, params, x, tokens, chunk)


def chunked_ce(cfg, params: EncDec, x: torch.Tensor, tokens: torch.Tensor,
               chunk: int = 512) -> torch.Tensor:
    """The loss of the decoder's final hidden states ``x``: unlike
    ``lm.lm_loss`` the logits carry ``vocab_bias``, so the padded vocab
    rows stay out of the log-sum-exp; the predictions past the last whole
    chunk are dropped. Each chunk runs under ``remat.checkpoint`` where
    autograd records, whatever ``cfg.remat`` says, as the reference
    checkpoints its scanned chunk; its logits are pinned to
    ("loss_batch", "seq", "vocab")."""
    xs, tgt = x[:, :-1], tokens[:, 1:].long()
    B, S, _ = xs.shape
    chunk = min(chunk, S)
    n = S // chunk
    w = params.embed["table"].T
    vbias = vocab_bias(cfg, device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        xc = xs[:, i * chunk:(i + 1) * chunk]
        tc = tgt[:, i * chunk:(i + 1) * chunk, None]
        part = remat.checkpoint(_ce_chunk, xc, w, vbias, tc) \
            if torch.is_grad_enabled() else _ce_chunk(xc, w, vbias, tc)
        total = total + part
    return total / (B * n * chunk)


def _ce_chunk(xc: torch.Tensor, w: torch.Tensor, vbias: torch.Tensor,
              tc: torch.Tensor) -> torch.Tensor:
    """One chunk's summed cross-entropy."""
    lg = constrain_act((xc @ w).float() + vbias,
                       ("loss_batch", "seq", "vocab"))
    lse = torch.logsumexp(lg, dim=-1)
    return (lse - _target_logits(lg, tc)).sum()


def logits(cfg, params: EncDec, x: torch.Tensor) -> torch.Tensor:
    """Logits of decoder hidden states over the tied embedding, padded
    vocab rows masked."""
    return ((x @ params.embed["table"].T).float()
            + vocab_bias(cfg, device=x.device))


@torch.no_grad()
def prefill(cfg, params: EncDec, frames: torch.Tensor, tokens: torch.Tensor,
            impl: Optional[str] = None):
    """The encoder and the decoder over the whole prompt; returns (last
    position's logits (B, V), None). As in the reference, prefill builds
    no decode cache: decode starts from ``init_cache_encdec``."""
    x = decode_train(cfg, params, tokens, encode(cfg, params, frames, impl),
                     impl)
    return logits(cfg, params, x[:, -1]), None


# -- decode ---------------------------------------------------------------------

def cache_axes_encdec(cfg) -> Tree:
    """The reference's logical axes of each cache leaf."""
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"pos": (), "self_k": ax, "self_v": ax, "cross_k": ax,
            "cross_v": ax}


def init_cache_encdec(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cuda") -> Tree:
    """Zeros, ``pos`` 0: the decoder's self-attention cache of ``max_len``
    positions and the cross-attention cache of ENC_LEN_DECODE encoder
    frames. Nothing fills the cross cache (the reference's neither), so a
    decode step's cross-attention averages zero values: its output is 0."""
    dev = resolve_device(device)
    L = cfg.dec_layers
    kself = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kcross = (L, batch, ENC_LEN_DECODE, cfg.n_kv_heads, cfg.head_dim)
    z = lambda shape: torch.zeros(shape, dtype=dtype, device=dev)
    return {"pos": 0, "self_k": z(kself), "self_v": z(kself),
            "cross_k": z(kcross), "cross_v": z(kcross)}


@torch.no_grad()
def decode_step_encdec(cfg, params: EncDec, cache: Tree,
                       tokens: torch.Tensor, impl: Optional[str] = None):
    """One decoder token against the cached self and cross keys and values.
    tokens: (B,) int. Writes the self-attention cache in place, advances
    ``cache["pos"]`` and returns (logits (B, V), cache)."""
    _, norm_apply = make_norm(cfg)
    h = constrain_act(embed(params.embed, tokens), ("batch", None))  # (B, D)
    pos = int(cache["pos"])
    for i, lp in enumerate(params.dec):
        h = decode_layer_encdec(cfg, lp, h, cache, i, pos, impl)
    cache["pos"] = pos + 1
    return logits(cfg, params, norm_apply(params.dec_norm, h)), cache


def decode_layer_encdec(cfg, lp, h: torch.Tensor, cache: Tree, i: int,
                        pos: int, impl: Optional[str] = None
                        ) -> torch.Tensor:
    """Decoder layer ``i`` of one decode step: self-attention over (and
    into) the self cache, cross-attention over the cross cache, the
    MLP."""
    _, norm_apply = make_norm(cfg)
    h = h + attn_mod.attn_decode(
        lp["self"], norm_apply(lp["norm1"], h), cfg,
        cache_k=cache["self_k"][i], cache_v=cache["self_v"][i], pos=pos,
        impl=impl)
    h = h + attn_mod.attn_decode(
        lp["cross"], norm_apply(lp["norm2"], h), cfg,
        cache_k=cache["cross_k"][i], cache_v=cache["cross_v"][i],
        pos=pos, cross=True, impl=impl)
    return h + mlp(lp["mlp"], norm_apply(lp["norm3"], h))
