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
``fake_mesh`` turns a description into a DeviceMesh over a fake process
group of as many ranks, this process its rank 0: DTensors on the meta
device trace a partitioned step through it without devices and move no
data (the counterpart of the reference's 256 and 512 fake CPU devices).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, Tuple


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


@contextlib.contextmanager
def fake_mesh(desc: MeshShape) -> Iterator:
    """``with fake_mesh(make_production_mesh()) as mesh:`` a DeviceMesh of
    ``desc``'s axes over a fake process group made for the block and
    destroyed after it, so no later code sees it. Refuses to replace a
    process group that is already initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(desc.sizes))
    try:
        yield init_device_mesh("cpu", desc.sizes,
                               mesh_dim_names=desc.axis_names)
    finally:
        dist.destroy_process_group()


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
