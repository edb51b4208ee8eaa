"""Mesh descriptions, as the reference's ``launch/mesh.py``.

Single pod: (16, 16) = 256 devices, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 devices, axes ("pod", "data", "model") — the
pod axis is pure data parallelism (parameters replicated across pods,
gradients all-reduced; optionally int8-compressed,
``parallel/compression.py``).

These are shapes only: no devices and no process group. The sharding
resolver reads ``axis_names`` and ``shape`` from them (and takes a
``torch.distributed`` DeviceMesh as well). ``make_host_mesh`` is the one
card the port runs on.
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


def make_host_mesh(model: int = 1) -> MeshShape:
    """The one card: a (1, 1) ("data", "model") mesh (``model`` above 1
    would need more devices than the port drives)."""
    if model != 1:
        raise ValueError(f"make_host_mesh: the port runs on one device, "
                         f"not a model axis of {model}")
    return MeshShape(("data", "model"), (1, 1))


def dp_degree(mesh) -> int:
    from repro_torch.parallel.sharding import mesh_axes
    sizes = mesh_axes(mesh)
    d = 1
    for ax in ("pod", "data"):
        if ax in sizes:
            d *= sizes[ax]
    return d
