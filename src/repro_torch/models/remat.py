"""Rematerialization of a training body, the counterpart of the
reference's ``jax.checkpoint`` (``cfg.remat``).

``checkpoint(fn, *args)`` runs ``fn`` keeping none of its activations for
the backward but its inputs; autograd runs ``fn`` again on them when the
backward reaches it (``torch.utils.checkpoint``, the non-reentrant form,
which ``torch.autograd.grad`` takes). The recompute runs the whole body
again (no early stop), so every side effect of the body's forward happens
exactly twice in a training step: each hand-written kernel's launch (and
its count), each collective (and ``collectives.stats()``), each MoE
route. ``recomputing()`` tells a consumer which run it is in: a launch
counter counts both (the card does both), a record of the forward's
choices (routes, drops, the paths a MoE layer takes) reads the first
forward only. While a profiler records, each recompute is the span
``train.recompute`` (``obs/steps.py``).

Nothing random runs in a body (no dropout), so no RNG state is saved.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import checkpoint as _cp

from repro_torch.obs import steps as spans

_DEPTH = [0]


def recomputing() -> bool:
    """Whether the running ops are a checkpointed body's recompute (in the
    backward) rather than its first forward."""
    return _DEPTH[0] > 0


@contextlib.contextmanager
def _recompute():
    _DEPTH[0] += 1
    try:
        with spans.span(spans.RECOMPUTE):
            yield
    finally:
        _DEPTH[0] -= 1


def _contexts():
    return contextlib.nullcontext(), _recompute()


def checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward."""
    with _cp.set_checkpoint_early_stop(False):
        return _cp.checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=_contexts)


def maybe(cfg, fn, *args):
    """``checkpoint(fn, *args)`` where ``cfg.remat`` is set and autograd
    records (training), else ``fn(*args)``: prefill, decode and
    ``no_grad`` paths run as they are."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args)
    return fn(*args)
