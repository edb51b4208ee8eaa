"""Train / prefill / serve steps on one device, as the reference's
``launch/steps.py`` without its shardings.

``make_train_step`` builds the fwd+bwd+AdamW step with gradient
accumulation over microbatches (the count from ``choose_microbatch``);
``make_serve_step`` the one-token decode step; ``make_prefill_step`` the
full-sequence cache build.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.registry import Model
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.optim import make_schedule


def choose_microbatch(cfg: ArchConfig, global_batch: int, dp: int = 1) -> int:
    """Largest accumulation count <= cfg.microbatch that splits the global
    batch into steps whose batch spreads over the ``dp`` data-parallel
    devices (1 here: the port runs on one device)."""
    for m in range(min(cfg.microbatch, global_batch), 0, -1):
        if global_batch % m == 0 and (global_batch // m) % dp == 0:
            return m
    return 1


def grad_buffers(named: Mapping[str, torch.Tensor], grad_dtype
                 ) -> Dict[str, torch.Tensor]:
    """A zeroed gradient sum per parameter, in ``grad_dtype``."""
    return {k: torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
            for k, p in named.items()}


@torch.no_grad()
def accumulate(g_acc: Dict[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]]) -> None:
    """Add one microbatch's gradients (None where a parameter is unused)
    into the sums, in the sums' dtype."""
    for k, g in grads.items():
        if g is not None:
            g_acc[k] += g.to(g_acc[k].dtype)


@torch.no_grad()
def finish_grads(g_acc: Dict[str, torch.Tensor], losses) -> torch.Tensor:
    """Divide the sums by the microbatch count, in place; the mean loss."""
    for g in g_acc.values():
        g /= len(losses)
    return torch.stack(losses).mean()


def make_train_step(model: Model, shape: ShapeConfig, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    impl: Optional[str] = None):
    """Returns (train_step, opt_init).

    ``train_step(params, opt_state, batch, step)`` takes the ``LM`` (its
    parameters requiring gradients), splits ``batch`` into ``accum``
    microbatches, sums their gradients in ``grad_dtype`` (bf16 with bf16
    optimizer state, else f32), divides by ``accum`` and applies AdamW at
    ``lr(step)``, in place. Returns (params, opt_state, mean loss, grad
    norm). ``impl`` goes to the model's kernels (``"torch"``: the plain
    versions)."""
    cfg = model.cfg
    lr_fn = make_schedule(cfg.schedule, base_lr, warmup, total_steps)
    accum = choose_microbatch(cfg, shape.global_batch)
    grad_dtype = torch.bfloat16 if cfg.bf16_optimizer_state else torch.float32

    def train_step(params, opt_state: AdamWState,
                   batch: Mapping[str, torch.Tensor], step):
        named = dict(params.named_parameters())
        g_acc = grad_buffers(named, grad_dtype)
        losses = []
        for i in range(accum):
            mb = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss = model.loss(params, mb, impl=impl)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
            accumulate(g_acc, dict(zip(named, grads)))
            losses.append(loss.detach())
            del loss, grads
        mean_loss = finish_grads(g_acc, losses)
        _, opt_state, stats = adamw_update(named, g_acc, opt_state,
                                           lr_fn(step))
        return params, opt_state, mean_loss, stats["grad_norm"]

    def opt_init(params) -> AdamWState:
        return adamw_init(dict(params.named_parameters()),
                          torch.bfloat16 if cfg.bf16_optimizer_state
                          else torch.float32)

    train_step.accum = accum
    return train_step, opt_init


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens: torch.Tensor):
        return model.decode_step(params, cache, tokens)
    return serve_step


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        return model.prefill(params, batch, max_len=max_len)
    return prefill_step
