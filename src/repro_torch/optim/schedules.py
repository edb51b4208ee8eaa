"""LR schedules: cosine and MiniCPM's WSD (warmup-stable-decay), as the
reference's ``optim/schedules.py``. Each returns ``lr(step)``, an f32
scalar tensor."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, floor: float = 0.1):
    """MiniCPM WSD: linear warmup -> constant plateau -> decay over the last
    ``decay_frac`` of training to ``floor``·base_lr."""
    decay_start = int(total * (1.0 - decay_frac))

    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - decay_start)
                           / max(total - decay_start, 1), 0.0, 1.0)
        decay = base_lr * torch.pow(_f32(floor), prog)
        return torch.where(step < warmup, warm,
                           torch.where(step < decay_start, _f32(base_lr),
                                       decay))
    return lr


def make_schedule(kind: str, base_lr: float, warmup: int, total: int):
    if kind == "wsd":
        return wsd_schedule(base_lr, warmup, total)
    return cosine_schedule(base_lr, warmup, total)
