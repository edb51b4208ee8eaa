"""Mesh descriptions, as the reference's ``launch/mesh.py``.

Single pod: (16, 16) = 256 devices, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 devices, axes ("pod", "data", "model") — the
pod axis is pure data parallelism (parameters replicated across pods,
gradients all-reduced; optionally int8-compressed,
``parallel/compression.py``).

The production meshes are shapes only: no devices and no process group.
The sharding resolver reads ``axis_names`` and ``shape`` from them (and
takes a ``torch.distributed`` DeviceMesh as well). ``make_host_mesh`` is
the mesh over whatever ranks exist: a DeviceMesh over the process group
where one is initialised, else the (1, 1) description of the one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """Small mesh over whatever ranks exist, as the reference's over
    whatever devices exist: with a ``torch.distributed`` group initialised,
    a ("data", "model") DeviceMesh of ``device_type`` over its world, the
    model axis ``min(model, world)``; without one, the (1, 1) description.
    """
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return MeshShape(("data", "model"), (1, 1))
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def dp_degree(mesh) -> int:
    from repro_torch.parallel.sharding import mesh_axes
    sizes = mesh_axes(mesh)
    d = 1
    for ax in ("pod", "data"):
        if ax in sizes:
            d *= sizes[ax]
    return d
