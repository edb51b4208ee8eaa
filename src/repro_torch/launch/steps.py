"""Train / prefill / serve steps with resolved shardings, as the
reference's ``launch/steps.py``.

``make_train_step`` builds the fwd+bwd+AdamW step with gradient
accumulation over microbatches (the count from ``choose_microbatch``),
each of its phases a span of ``obs/steps.py`` while a profiler records;
``make_serve_step`` the one-token decode step; ``make_prefill_step`` the
full-sequence cache build. ``build_shardings``, ``batch_shardings``,
``cache_shardings`` and ``opt_state_struct_and_sharding`` resolve every
leaf through the logical-axis rules: meta structs and each leaf's DTensor
placements, the counterpart of the reference's ``NamedSharding`` trees.

Without a mesh, or on a mesh of one device, the steps run on one device as
they always did. With a live ``torch.distributed`` DeviceMesh of more than
one rank (``launch/mesh.make_host_mesh`` over a process group, or
``mesh.fake_mesh`` to trace a production mesh on meta), the steps take
DTensor parameters, optimizer state, batch and cache placed by those
placements (``Model.distribute``, ``opt_init``, ``place_batch``,
``place_cache``):
the counterpart of ``jit(in_shardings=...)``. They run with the rules
installed for the model code's ``constrain_act`` pins and with plain
tensors made inside the step (positions, masks, AdamW's scalars) taken as
replicated; DTensor's sharding propagation inserts the collectives, and
the hand-written kernels run on each rank's local block
(``kernels/ops.py``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.registry import Model, cache_leaves
from repro_torch.obs import steps as spans
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.optim import make_schedule
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import (LogicalRules, batch_dp_degree,
                                           default_rules)


def partitioned(mesh) -> bool:
    """Whether steps over ``mesh`` run on DTensors: a live mesh of more
    than one rank."""
    return mesh is not None and sh.mesh_size(mesh) > 1


@contextlib.contextmanager
def on_mesh(mesh, rules: Optional[LogicalRules]):
    """The context a partitioned step runs in: ``rules`` installed over
    ``mesh`` and plain tensors taken as replicated. Nothing on one
    device."""
    if not partitioned(mesh):
        yield
        return
    if not sh.is_live(mesh):
        raise NotImplementedError(
            f"a step over the description {sh.mesh_axes(mesh)} needs a "
            f"DeviceMesh (launch/mesh.make_host_mesh or fake_mesh)")
    from torch.distributed.tensor.experimental import implicit_replication
    with sh.activation_sharding(rules or default_rules(), mesh), \
            implicit_replication():
        yield


def choose_microbatch(cfg: ArchConfig, global_batch: int, mesh=None,
                      rules: Optional[LogicalRules] = None) -> int:
    """Largest accumulation count <= cfg.microbatch such that the per-step
    batch still spreads over the full data-parallel degree the rules can
    reach on ``mesh`` (dp_heavy archs shard the batch over data x model,
    so the count collapses to keep the step's batch a multiple of dp).
    Without a mesh, dp is 1."""
    dp = 1 if mesh is None else batch_dp_degree(rules or default_rules(),
                                                mesh, global_batch)
    for m in range(min(cfg.microbatch, global_batch), 0, -1):
        if global_batch % m == 0 and (global_batch // m) % dp == 0:
            return m
    return 1


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------

def build_shardings(model: Model, mesh, rules: Optional[LogicalRules] = None,
                    dtype=torch.bfloat16):
    """(parameter struct: the model on meta, ``{name: placements}``,
    ``{name: logical axes}``)."""
    rules = rules or default_rules()
    struct = model.param_struct(dtype)
    axes = model.param_axes()
    return struct, sh.shardings_for(axes, dict(struct.named_parameters()),
                                    rules, mesh), axes


def batch_shardings(model: Model, shape: ShapeConfig, mesh,
                    rules: Optional[LogicalRules] = None,
                    dtype=torch.bfloat16):
    """({input: meta tensor}, {input: placements})."""
    rules = rules or default_rules()
    specs, axes = model.input_specs(shape, dtype), model.input_axes(shape)
    return specs, {k: sh.placements(sh.spec_for(axes[k], tuple(t.shape),
                                                 rules, mesh), mesh)
                   for k, t in specs.items()}


def cache_shardings(model: Model, shape: ShapeConfig, mesh,
                    rules: Optional[LogicalRules] = None,
                    dtype=torch.bfloat16):
    """({cache leaf: meta tensor}, {cache leaf: placements}), keyed as
    ``registry.cache_leaves``."""
    rules = rules or default_rules()
    struct = cache_leaves(model.cache_struct(shape, dtype))
    return struct, sh.shardings_for(model.cache_axes(), struct, rules, mesh)


def opt_state_struct_and_sharding(model: Model, mesh, param_shardings,
                                  param_shapes, dtype=None):
    """The optimizer state mirrors the parameters (mu, nu) with a scalar
    count: (AdamWState of meta tensors, AdamWState of placements)."""
    from torch.distributed.tensor import Replicate
    sdtype = torch.bfloat16 if model.cfg.bf16_optimizer_state else \
        torch.float32
    named = dict(param_shapes.named_parameters())
    mu = {k: torch.empty(p.shape, dtype=sdtype, device="meta")
          for k, p in named.items()}
    struct = AdamWState(mu=mu, nu=dict(mu),
                        count=torch.zeros((), dtype=torch.int32,
                                          device="meta"))
    shard = AdamWState(mu=dict(param_shardings), nu=dict(param_shardings),
                       count=(Replicate(),) * len(sh.mesh_axes(mesh)))
    return struct, shard


def place_batch(model: Model, batch: Mapping[str, torch.Tensor],
                shape: ShapeConfig, mesh,
                rules: Optional[LogicalRules] = None
                ) -> Dict[str, torch.Tensor]:
    """A whole batch (the same on every rank) as DTensors placed by
    ``batch_shardings``' specs; unchanged off a partitioned mesh."""
    if not partitioned(mesh):
        return dict(batch)
    return sh.distribute(batch, model.input_axes(shape),
                         rules or default_rules(), mesh)


def place_cache(model: Model, cache, mesh,
                rules: Optional[LogicalRules] = None):
    """A whole decode cache (the same on every rank) with every leaf a
    DTensor placed by ``cache_shardings``' specs, in place; unchanged off
    a partitioned mesh."""
    if not partitioned(mesh):
        return cache
    placed = sh.distribute(cache_leaves(cache), model.cache_axes(),
                           rules or default_rules(), mesh)
    if "segments" not in cache:
        cache.update(placed)
        return cache
    for key, t in placed.items():
        _, i, j, leaf = key.split(".")
        cache["segments"][int(i)][int(j)][leaf] = t
    return cache


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def grad_buffers(named: Mapping[str, torch.Tensor], grad_dtype
                 ) -> Dict[str, torch.Tensor]:
    """A zeroed gradient sum per parameter, in ``grad_dtype`` (placed as
    the parameter where it is a DTensor)."""
    return {k: torch.zeros_like(p, dtype=grad_dtype) if sh.is_dtensor(p)
            else torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
            for k, p in named.items()}


@torch.no_grad()
def accumulate(g_acc: Dict[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]]) -> None:
    """Add one microbatch's gradients (None where a parameter is unused)
    into the sums, in the sums' dtype (and placements). A DTensor
    gradient that is a partial sum over ranks is reduced in its own dtype
    first, as the reference sums its f32 gradients before a bf16 sum
    takes them."""
    for k, g in grads.items():
        if g is None:
            continue
        if sh.is_dtensor(g) and g.placements != g_acc[k].placements:
            g = g.redistribute(g.device_mesh, g_acc[k].placements)
        g_acc[k] += g.to(g_acc[k].dtype)


@torch.no_grad()
def finish_grads(g_acc: Dict[str, torch.Tensor], losses) -> torch.Tensor:
    """Divide the sums by the microbatch count, in place; the mean loss."""
    for g in g_acc.values():
        g /= len(losses)
    return torch.stack(losses).mean()


def microbatch(v: torch.Tensor, accum: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``accum``: the i-th block of the batch's rows,
    as the reference's step splits it. A DTensor batch (the tokens: a few
    KB) is gathered, and each rank keeps its block of the microbatch's
    rows in the batch's placements, so every microbatch spreads over the
    same ranks as the batch and holds the rows the reference's holds (a
    MoE layer's capacity and drops depend on which tokens meet)."""
    if not sh.is_dtensor(v):
        return v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    whole = v.full_tensor()
    mb = whole.reshape((accum, whole.shape[0] // accum) + whole.shape[1:])[i]
    shape, offset = compute_local_shape_and_global_offset(
        mb.shape, v.device_mesh, v.placements)
    local = mb[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(local.contiguous(), v.device_mesh,
                              v.placements, run_check=False)


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if sh.is_dtensor(t) else t


def make_train_step(model: Model, shape: ShapeConfig, mesh=None,
                    rules: Optional[LogicalRules] = None,
                    base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, impl: Optional[str] = None):
    """Returns (train_step, opt_init).

    ``train_step(params, opt_state, batch, step)`` takes the ``LM`` (its
    parameters requiring gradients), splits ``batch`` into ``accum``
    microbatches, sums their gradients in ``grad_dtype`` (bf16 with bf16
    optimizer state, else f32), divides by ``accum`` and applies AdamW at
    ``lr(step)``, in place. Returns (params, opt_state, mean loss, grad
    norm); the loss and the norm are plain tensors, the norm the global
    one over every rank's blocks. ``impl`` goes to the model's kernels
    (``"torch"``: the plain versions). On a partitioned ``mesh`` the
    parameters, state and batch are DTensors (module docstring)."""
    cfg = model.cfg
    rules = rules or default_rules()
    lr_fn = make_schedule(cfg.schedule, base_lr, warmup, total_steps)
    accum = choose_microbatch(cfg, shape.global_batch,
                              mesh if partitioned(mesh) else None, rules)
    grad_dtype = torch.bfloat16 if cfg.bf16_optimizer_state else torch.float32

    def train_step(params, opt_state: AdamWState,
                   batch: Mapping[str, torch.Tensor], step):
        named = dict(params.named_parameters())
        with spans.step(next(iter(named.values())).device), \
                on_mesh(mesh, rules):
            g_acc = grad_buffers(named, grad_dtype)
            losses = []
            for i in range(accum):
                with spans.span(spans.MICROBATCH):
                    mb = {k: microbatch(v, accum, i)
                          for k, v in batch.items()}
                    with spans.span(spans.FORWARD):
                        loss = model.loss(params, mb, impl=impl)
                    with spans.span(spans.BACKWARD):
                        grads = torch.autograd.grad(
                            loss, list(named.values()), allow_unused=True)
                        accumulate(g_acc, dict(zip(named, grads)))
                    losses.append(loss.detach())
                    del loss, grads
            with spans.span(spans.ADAMW):
                mean_loss = finish_grads(g_acc, losses)
                _, opt_state, stats = adamw_update(named, g_acc, opt_state,
                                                   lr_fn(step))
            return (params, opt_state, _whole(mean_loss),
                    _whole(stats["grad_norm"]))

    def opt_init(params) -> AdamWState:
        return adamw_init(dict(params.named_parameters()),
                          torch.bfloat16 if cfg.bf16_optimizer_state
                          else torch.float32)

    train_step.accum = accum
    return train_step, opt_init


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _pin_logits(lg: torch.Tensor, mesh, rules) -> torch.Tensor:
    """The logits placed as the reference's ``out_shardings`` place them:
    ("batch", "vocab")."""
    return sh.constrain(lg, ("batch", "vocab"), rules, mesh) \
        if sh.is_dtensor(lg) else lg


def make_serve_step(model: Model, mesh=None,
                    rules: Optional[LogicalRules] = None,
                    impl: Optional[str] = None):
    """``serve_step(params, cache, tokens)`` -> (logits, cache): one
    decode step, the cache written in place."""
    rules = rules or default_rules()

    def serve_step(params, cache, tokens: torch.Tensor):
        with on_mesh(mesh, rules):
            lg, cache = model.decode_step(params, cache, tokens, impl=impl)
            return _pin_logits(lg, mesh, rules), cache
    return serve_step


def make_prefill_step(model: Model, max_len: int, mesh=None,
                      rules: Optional[LogicalRules] = None, **kw):
    """``prefill_step(params, batch)`` -> (last position's logits, cache of
    ``max_len``); ``kw`` go to ``Model.prefill`` (``impl``,
    ``cache_dtype``). On a partitioned mesh the cache's leaves are
    DTensors placed by ``cache_shardings``' specs."""
    rules = rules or default_rules()

    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        with on_mesh(mesh, rules):
            lg, cache = model.prefill(params, batch, max_len=max_len, **kw)
            return _pin_logits(lg, mesh, rules), cache
    return prefill_step
