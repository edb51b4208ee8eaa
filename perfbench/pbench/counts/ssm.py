"""Model FLOPs of a Mamba-2 training step (mamba2-370m), and the bound of
each of its kernel launches.

Model FLOPs: 6 × the parameters that multiply activations × the tokens
they see: the mixer's projections (z, x, B, C, dt, out) and its depthwise
conv kernels, and the tied table once, as the output projection, over the
positions the chunked loss scores; and the SSD's recurrence, 3 × its
forward's 5·N·P flops a step and head (``kernels.ssd_fwd``; forward once,
backward at twice the forward, as for the parameters).
Rematerialization's second forward is not counted.
"""
from __future__ import annotations

from typing import Dict

from pbench import peaks
from pbench.counts import kernels
from pbench.counts.dense import scored


def layer_matrix_params(cfg: Dict) -> int:
    D, Din, N = cfg["d_model"], cfg["d_inner"], cfg["ssm_state"]
    return 2 * D * Din + 2 * D * N + D * cfg["ssm_heads"] + Din * D


def layer_conv_params(cfg: Dict) -> int:
    return cfg["conv_kernel"] * (cfg["d_inner"] + 2 * cfg["ssm_state"])


def step_flops(cfg: Dict, rows: int, seq: int) -> Dict[str, float]:
    """{part: model FLOPs} of one step over rows × seq tokens."""
    L = cfg["n_layers"]
    tokens = rows * seq
    ssd = kernels.ssd_fwd(rows, seq, cfg["ssm_heads"], cfg["ssm_head_dim"],
                          cfg["ssm_state"])[0]
    return {"gemm": 6.0 * L * layer_matrix_params(cfg) * tokens,
            "conv": 6.0 * L * layer_conv_params(cfg) * tokens,
            "head": 6.0 * cfg["vocab_rows"] * cfg["d_model"]
            * scored(cfg, rows, seq),
            "ssd": 3.0 * L * ssd}


def launch_bounds(cfg: Dict, mb_rows: int, seq: int) -> Dict[str, float]:
    """{counted launch name: least seconds of one launch} at a microbatch
    of ``mb_rows`` rows."""
    shape = (mb_rows, seq, cfg["ssm_heads"], cfg["ssm_head_dim"],
             cfg["ssm_state"])
    return {"ssd_scan": peaks.bound_s(*kernels.ssd_fwd(*shape)),
            "ssd_scan_bwd": peaks.bound_s(*kernels.ssd_bwd(*shape))}
