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

NCCL moves CUDA tensors where they lie. Gloo, the backend that runs two
ranks on one card (NCCL refuses two ranks on one device) and the ranks of
the CPU tests, is given host tensors: a CUDA tensor is copied to the host
before the collective and the result back after it, explicitly, and the
bytes of both copies are counted (``stats()["host_copy_bytes"]``). The
collectives only move bytes, so the result is bit for bit the same either
way. No computation moves to the host.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import PartitionSpec, entry_axes

_STATS: Dict[str, int] = {}


def reset_stats() -> None:
    _STATS.clear()


def stats() -> Dict[str, int]:
    """Calls and bytes since the last ``reset_stats``: ``<op>_calls``,
    ``<op>_bytes`` (each rank's input), and ``host_copy_bytes``."""
    return dict(_STATS)


def _count(key: str, n: int) -> None:
    _STATS[key] = _STATS.get(key, 0) + n


def _run(op: str, collective, out: torch.Tensor, x: torch.Tensor,
         group) -> torch.Tensor:
    """``collective(out, x, group=group)`` on the rank's device, through
    host copies where the group's backend is gloo and x is on the card."""
    _count(f"{op}_calls", 1)
    _count(f"{op}_bytes", x.numel() * x.element_size())
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host_out = torch.empty(out.shape, dtype=out.dtype)
        host_x = x.cpu()
        collective(host_out, host_x, group=group)
        out.copy_(host_out)
        _count("host_copy_bytes", (host_x.numel() + host_out.numel())
               * x.element_size())
    else:
        collective(out, x, group=group)
    return out


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    blocks = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0)
    blocks = blocks.contiguous()
    out = _run("all_to_all", dist.all_to_all_single, torch.empty_like(blocks),
               blocks, mesh.get_group(axis))
    return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return _run("all_gather", dist.all_gather_into_tensor, out, xs,
                mesh.get_group(axis)).movedim(0, dim)


def gather_block(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The whole tensor from each rank's block of it (``sharding.block``):
    each dim split over a tuple of axes is gathered over its last axis
    first, whose blocks lie next to each other."""
    for dim, entry in enumerate(spec):
        for axis in reversed(entry_axes(entry)):
            x = all_gather(x, mesh, axis, dim)
    return x
