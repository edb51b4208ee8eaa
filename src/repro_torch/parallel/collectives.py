"""The collectives of the expert-parallel paths, over the process groups of
a ``torch.distributed`` DeviceMesh's dims.

Each takes a tensor on the rank's device and gives one on the same device,
tiled as the reference's ``jax.lax`` collectives under ``shard_map``:

* ``all_to_all(x, mesh, axis, split_dim, concat_dim)``:
  ``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``, the
  ``split_dim`` cut into as many blocks as the axis has ranks, block j sent
  to the axis's rank j, the blocks received concatenated along
  ``concat_dim`` in rank order;
* ``all_gather(x, mesh, axis, dim)``: ``jax.lax.all_gather(x, axis,
  axis=dim, tiled=True)``;
* ``gather_block(x, spec, mesh)``: a rank's block of a tensor laid out by a
  spec, gathered back to the whole tensor on every rank (what GSPMD does
  where a sharded value meets code that needs it whole).

They are issued as the functional collectives
(``torch.ops._c10d_functional``), which DTensor issues too, so
``roofline.collective_bytes`` sees them and ``stage_through_host`` routes
them. Each carries a gradient, its adjoint, issued the same way: an
all-to-all's is the all-to-all with ``split_dim`` and ``concat_dim``
swapped (each received block goes back to the rank it came from); a tiled
all-gather's is a reduce-scatter (sum) along the same dim, since every
rank's copy of the gathered tensor feeds its own computation (the
transposes of ``shard_map``'s collectives). Calls and bytes of both
directions are counted (``stats()``).

NCCL moves CUDA tensors where they lie. Gloo, the backend that runs several
ranks on one card (NCCL refuses two ranks on one device) and the ranks of
the CPU tests, moves host tensors; gloo's own path for CUDA tensors is not
one to trust (a rank died in it on an H100, torch 2.11).
``stage_through_host(device_type)`` registers, for that device's tensors,
kernels of the functional ops that move the bytes through the host
explicitly, over the same group, with gloo's host collectives that only
move data: an all-gather is one, an all-to-all is one, and the two
reductions are an all-gather (all-reduce) or an all-to-all
(reduce-scatter) followed by the sum on the card, over the blocks in rank
order (so every rank's sum is the same, bit for bit). The bytes of both
copies are counted (``stats()["host_copy_bytes"]``). The collectives above
stage themselves where a CUDA tensor meets a gloo group. The collectives
only move bytes, so the result is bit for bit the same either way. No
computation moves to the host.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import PartitionSpec, entry_axes

_STATS: Dict[str, int] = {}


def reset_stats() -> None:
    _STATS.clear()


def stats() -> Dict[str, int]:
    """Calls and bytes since the last ``reset_stats``: ``<op>_calls``,
    ``<op>_bytes`` (each rank's input), and ``host_copy_bytes``. A
    checkpointed body's recompute (``models/remat.py``) issues its
    collectives again, and they are counted: the step moves those bytes
    twice."""
    return dict(_STATS)


def _count(key: str, n: int) -> None:
    _STATS[key] = _STATS.get(key, 0) + n


# > 0 while one of this module's collectives issues its functional op: it
# counts its own call, and the staged kernel counts only the host copies
_OWN = [0]


def _count_call(op: str, x: torch.Tensor) -> None:
    if not _OWN[0]:
        _count(f"{op}_calls", 1)
        _count(f"{op}_bytes", x.numel() * x.element_size())


# -- the functional collectives through the host --------------------------------

_STAGED = set()
_LIBS = []


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return name if isinstance(name, dist.ProcessGroup) else \
        _resolve_process_group(name)


def _host_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n * x.shape[0], ...) on x's device: every rank's x, rank order."""
    n = dist.get_world_size(group)
    host_x = x.contiguous().cpu()
    host_out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                           dtype=x.dtype)
    dist.all_gather_into_tensor(host_out, host_x, group=group)
    _count("host_copy_bytes", (host_x.numel() + host_out.numel())
           * x.element_size())
    return host_out.to(x.device)


def _host_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x's dim-0 blocks exchanged: block j to rank j, received blocks
    in rank order, on x's device."""
    host_x = x.contiguous().cpu()
    host_out = torch.empty_like(host_x)
    dist.all_to_all_single(host_out, host_x, group=group)
    _count("host_copy_bytes", 2 * host_x.numel() * x.element_size())
    return host_out.to(x.device)


def _sum_blocks(t: torch.Tensor, n: int, op: str) -> torch.Tensor:
    if op.lower() not in ("sum", "avg"):
        raise NotImplementedError(f"staged reduction {op!r}")
    out = t.unflatten(0, (n, -1)).sum(0)
    return out / n if op.lower() == "avg" else out


def _staged_all_gather(x, group_size, group_name):
    _count_call("all_gather", x)
    return _host_all_gather(x, _group(group_name))


def _staged_all_reduce(x, reduce_op, group_name):
    g = _group(group_name)
    n = dist.get_world_size(g)
    _count_call("all_reduce", x)
    flat = x.reshape((1,) + tuple(x.shape)) if x.dim() == 0 else x
    out = _sum_blocks(_host_all_gather(flat, g), n, reduce_op)
    return out.reshape(x.shape).to(x.dtype)


def _staged_reduce_scatter(x, reduce_op, group_size, group_name):
    g = _group(group_name)
    n = dist.get_world_size(g)
    _count_call("reduce_scatter", x)
    return _sum_blocks(_host_all_to_all(x, g), n, reduce_op).to(x.dtype)


def _staged_all_to_all(x, output_split_sizes, input_split_sizes,
                       group_name):
    g = _group(group_name)
    n = dist.get_world_size(g)
    if any(s != x.shape[0] // n for s in
           list(output_split_sizes) + list(input_split_sizes)):
        raise NotImplementedError("staged all_to_all: uneven splits")
    _count_call("all_to_all", x)
    return _host_all_to_all(x, g)


def stage_through_host(device_type: str = "cuda") -> None:
    """Run this process's functional collectives on ``device_type``
    tensors through the host, over gloo (module docstring). Once per
    process; the kernels stay registered for its life."""
    if device_type in _STAGED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    key = device_type.upper()
    lib.impl("all_gather_into_tensor", _staged_all_gather, key)
    lib.impl("all_reduce", _staged_all_reduce, key)
    lib.impl("reduce_scatter_tensor", _staged_reduce_scatter, key)
    lib.impl("all_to_all_single", _staged_all_to_all, key)
    _LIBS.append(lib)
    _STAGED.add(device_type)




def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def _issue(op: str, x: torch.Tensor, group, call) -> torch.Tensor:
    """``call(x)``, a functional collective over ``group``, waited on;
    counted as one ``op`` of x's bytes. A CUDA tensor over gloo goes
    through the host (``stage_through_host``)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        stage_through_host("cuda")
    _count(f"{op}_calls", 1)
    _count(f"{op}_bytes", x.numel() * x.element_size())
    _OWN[0] += 1
    try:
        return torch.ops._c10d_functional.wait_tensor(call(x))
    finally:
        _OWN[0] -= 1


def _all_to_all(x: torch.Tensor, group, n: int, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    blocks = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0)
    out = _issue("all_to_all", blocks.contiguous(), group,
                 lambda t: torch.ops._c10d_functional.all_to_all_single(
                     t, [1] * n, [1] * n, group.group_name))
    return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


def _all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    out = _issue("all_gather", x.movedim(dim, 0).contiguous(), group,
                 lambda t: torch.ops._c10d_functional.all_gather_into_tensor(
                     t, n, group.group_name))
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, n: int, dim: int
                    ) -> torch.Tensor:
    out = _issue("reduce_scatter", x.movedim(dim, 0).contiguous(), group,
                 lambda t: torch.ops._c10d_functional.reduce_scatter_tensor(
                     t, "sum", n, group.group_name))
    return out.movedim(0, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, split_dim, concat_dim)
        return _all_to_all(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, n, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, n, concat_dim, split_dim), None, None, \
            None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        return _reduce_scatter(g, group, n, dim), None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(axis), n, split_dim, concat_dim)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, mesh.get_group(axis), n, dim)


def gather_dim(x: torch.Tensor, entry, mesh, dim: int) -> torch.Tensor:
    """``dim`` of x whole from each rank's block of it, the dim laid out
    by one spec entry: gathered over its last axis first, whose blocks lie
    next to each other (``sharding.block_index``'s order)."""
    for axis in reversed(entry_axes(entry)):
        x = all_gather(x, mesh, axis, dim)
    return x


def gather_block(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The whole tensor from each rank's block of it (``sharding.block``):
    each dim split over a tuple of axes gathered as ``gather_dim``."""
    for dim, entry in enumerate(spec):
        x = gather_dim(x, entry, mesh, dim)
    return x


def _last_block_rows(x: torch.Tensor, rows: int, entry, mesh
                     ) -> torch.Tensor:
    """The last ``rows`` rows along dim 1 of a sequence split over
    ``entry``'s axes, from each rank's block x: every rank's last rows
    gathered, the last rank's kept, on every rank."""
    tails = gather_dim(x[None, :, x.shape[1] - rows:], entry, mesh, 0)
    return tails[-1]


def seq_tail(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x[:, S - rows:]`` of activations x (B, S, ...) (a negative
    ``S - rows`` counts from the end, as a slice does). Where x's
    sequence is split over ranks (a DTensor's, or the installed tokens'
    on a live mesh) the rows live on the last rank: each rank's last rows
    are gathered and the last rank's kept, placed whole over the
    sequence's axes; the sequence itself is not gathered."""
    if sh.is_dtensor(x):
        entry = sh.split_entry(x, 1)
        if entry is None:
            return x[:, x.shape[1] - rows:]
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        mesh = x.device_mesh
        out_pl = [Replicate() if q == Shard(1) else q for q in x.placements]
        return local_map(
            lambda t: _last_block_rows(t, rows, entry, mesh),
            out_placements=out_pl, in_placements=(tuple(x.placements),),
            device_mesh=mesh)(x)
    entry = sh.token_seq_entry()
    if entry is None:
        return x[:, x.shape[1] - rows:]
    return _last_block_rows(x, rows, entry, sh.installed()[1])
