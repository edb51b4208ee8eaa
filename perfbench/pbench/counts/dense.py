"""Model FLOPs of a dense decoder's training step (olmo-1b), and the bound
of each of its kernel launches.

Model FLOPs: 6 × the parameters that multiply activations × the tokens
they see (forward 2, backward 4), the tied table counted once, as the
output projection, over the positions the chunked loss scores; and
causal attention's 12·D flops a pair (``kernels.attention_*``).
Rematerialization's second forward is not counted.
"""
from __future__ import annotations

from typing import Dict

from pbench import peaks
from pbench.counts import kernels


def scored(cfg: Dict, rows: int, seq: int) -> int:
    """Positions the chunked loss scores: whole chunks of the seq - 1
    predictions of each row."""
    chunk = min(cfg["loss_chunk"], seq - 1)
    return rows * ((seq - 1) // chunk) * chunk


def layer_matrix_params(cfg: Dict) -> int:
    D, F, dh = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    H, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
    return D * H * dh * 2 + D * Hkv * dh * 2 + 3 * D * F


def step_flops(cfg: Dict, rows: int, seq: int) -> Dict[str, float]:
    """{part: model FLOPs} of one step over rows × seq tokens."""
    L = cfg["n_layers"]
    tokens = rows * seq
    attn = sum(kernels.attention_fwd(rows, seq, cfg["n_heads"],
                                     cfg["n_kv_heads"], cfg["head_dim"])[0]
               + kernels.attention_bwd(rows, seq, cfg["n_heads"],
                                       cfg["n_kv_heads"], cfg["head_dim"])[0]
               for _ in range(L))
    return {"gemm": 6.0 * L * layer_matrix_params(cfg) * tokens,
            "head": 6.0 * cfg["vocab_rows"] * cfg["d_model"]
            * scored(cfg, rows, seq),
            "attention": float(attn)}


def launch_bounds(cfg: Dict, mb_rows: int, seq: int) -> Dict[str, float]:
    """{counted launch name: least seconds of one launch} at a microbatch
    of ``mb_rows`` rows."""
    shape = (mb_rows, seq, cfg["n_heads"], cfg["n_kv_heads"],
             cfg["head_dim"])
    return {"flash_attention": peaks.bound_s(*kernels.attention_fwd(*shape)),
            "flash_attention_bwd":
                peaks.bound_s(*kernels.attention_bwd(*shape))}
