"""Plain reference of a dense decoder's training loss (olmo-1b).

Pre-norm layers: non-parametric LayerNorm, attention (q, k, v projected
as (D, H, dh), rotary embeddings on q and k, causal softmax, output
projection (H, dh, D)) and a residual; LayerNorm, a SwiGLU MLP
(silu(x Wg) · x Wu) Wd and a residual; a final LayerNorm and the chunked
loss against the tied table. Parameters are named as the program names
them (``embed.table``, ``segments.0.<layer>.attn.q.w``, ...).

Departures from OLMo-1B as published, which the program makes too: the
table is padded to a multiple of 256 rows and the padding rows enter the
loss's log-sum-exp; the loss scores only whole 512-position chunks of
each row's predictions; LayerNorm's eps is 1e-6.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from pbench.reference import common

Tree = Dict[str, torch.Tensor]


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter."""
    D, F_, dh = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    H, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
    out = [("embed.table", (cfg["vocab_rows"], D))]
    for i in range(cfg["n_layers"]):
        p = f"segments.0.{i}."
        out += [(p + "attn.q.w", (D, H, dh)), (p + "attn.k.w", (D, Hkv, dh)),
                (p + "attn.v.w", (D, Hkv, dh)), (p + "attn.o.w", (H, dh, D)),
                (p + "mlp.gate.w", (D, F_)), (p + "mlp.up.w", (D, F_)),
                (p + "mlp.down.w", (F_, D))]
    return out


def loss(cfg: Dict, P: Tree, tokens: torch.Tensor,
         prod: common.Products) -> torch.Tensor:
    if cfg["n_kv_heads"] != cfg["n_heads"] or not cfg["nonparam_ln"] \
            or not cfg["tie_embeddings"]:
        raise NotImplementedError("the dense reference covers MHA with "
                                  "non-parametric LayerNorm, tied")
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    block = cfg.get("attention_block", 1024)

    def layer(i: int, x: torch.Tensor) -> torch.Tensor:
        w = lambda leaf: P[f"segments.0.{i}.{leaf}"]
        h = common.layernorm(x, eps)
        q = common.rope(prod.ein("bsd,dhe->bshe", h, w("attn.q.w")), theta)
        k = common.rope(prod.ein("bsd,dhe->bshe", h, w("attn.k.w")), theta)
        v = prod.ein("bsd,dhe->bshe", h, w("attn.v.w"))
        o = common.attention(q, k, v, prod, block)
        x = x + prod.ein("bshe,hed->bsd", o, w("attn.o.w"))
        h = common.layernorm(x, eps)
        u = F.silu(prod.mm(h, w("mlp.gate.w"))) * prod.mm(h, w("mlp.up.w"))
        return x + prod.mm(u, w("mlp.down.w"))

    x = common.embed(P["embed.table"], tokens)
    x = common.run_layers(layer, cfg["n_layers"], x)
    x = common.layernorm(x, eps)
    return common.chunked_ce(x, P["embed.table"], tokens, cfg["loss_chunk"],
                             prod)
