"""Roofline terms of a step on the card, as the reference's
``launch/roofline.py``.

compute term    = FLOPs / peak(dtype)   [``hw.peak_flops``: 989 TFLOP/s for
                                         bf16 products, 165 TFLOP/s for the
                                         3xTF32 f32 path the kernels use]
memory term     = bytes / HBM bandwidth [``hw.HBM_BW``]
collective term = Σ_axis collective bytes(axis) / link rate(axis)
                                        [``hw.axis_link_bw``: NVLink 4 for
                                         an axis inside an 8-GPU node, the
                                         nodes' network otherwise; 0 on one
                                         card]

``count(fn, *args)`` gives (FLOPs, bytes) of one eager call through the
port's one counter, ``core/profiler.py``'s ``_CostMode``: aten ops by
``torch.utils.flop_counter``'s formulas and their tensors' bytes, and on
traced (meta or fake) tensors each hand-written kernel by its formula
(``_build.trace_launch``). Over a DeviceMesh (a partitioned step) the
counter sees each rank's local ops, so its figures are per device. The
reference reads XLA's ``cost_analysis`` of a compiled step and parses
collective bytes out of its optimized HLO; ``collective_bytes`` here is
a dispatch mode over the functional collectives the step issues, with the
reference's keys and conventions.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import hw
from repro_torch.core import profiler
from repro_torch.kernels import _build
from repro_torch.parallel.sharding import mesh_axes


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    chips: int
    model_flops: float                 # 6·N·D (train) or 2·N_active·tokens
    peak_flops: float = hw.PEAK_BF16_TENSOR_FLOPS
    # per mesh axis: collective bytes a device, and the axis's link rate
    coll_bytes_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    link_bw: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        """Each axis's collective bytes over its link rate, summed (the
        axes' collectives are issued one after another)."""
        return sum(b / self.link_bw[a]
                   for a, b in self.coll_bytes_by_axis.items() if b)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches recompute and waste."""
        tot = self.flops_per_device * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card's peak sustained if the step runs at the
        dominant term's duration: model FLOPs / (chips·peak·t_bound)."""
        denom = self.chips * self.peak_flops * self.t_bound
        return self.model_flops / denom if denom else 0.0

    def mfu(self, seconds: float) -> float:
        """Model FLOPs over peak × a measured step time."""
        return self.model_flops / (self.chips * self.peak_flops * seconds)

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "peak_flops": self.peak_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "coll_bytes_by_axis": dict(self.coll_bytes_by_axis),
            "link_bw": dict(self.link_bw),
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(total_params: int, active_params: int, kind: str,
                tokens: int) -> float:
    """6·N·D for training; 2·N_active·D forward-only (prefill/decode)."""
    if kind == "train":
        return 6.0 * active_params * tokens
    return 2.0 * active_params * tokens


def count(fn: Callable, *args) -> Tuple[int, int]:
    """(FLOPs, bytes) of one eager call of ``fn``: its aten ops' and, on
    traced tensors, its hand-written kernels' (``profiler.op_cost``)."""
    return profiler.op_cost(fn, *args)


def trace(fn: Callable, *args, hold=(), memory: bool = False) -> Dict:
    """One eager call of ``fn`` under the counter, itemized: ``flops`` and
    ``bytes`` in all; ``aten_flops``/``aten_bytes`` of the aten ops and
    ``kernel_flops``/``kernel_bytes`` of the hand-written kernels (traced
    launches, by name in ``kernels``); ``bytes_by_op``. With ``memory``
    also ``held_bytes``, the storages of ``hold`` (made before the call:
    parameters, optimizer state, batch, cache), and ``peak_bytes``, the
    most booked at once (``_CostMode``) during the call, ``held_bytes``
    included. Raises if a kernel really launched (``profiler.op_cost``)."""
    before = _build.launch_counts()
    t0 = time.perf_counter()
    with profiler._CostMode(memory=memory) as mode:
        mode.hold(hold)
        held = mode.live_bytes
        fn(*args)
    seconds = time.perf_counter() - t0
    moved = sorted(k for k, n in _build.launch_counts().items()
                   if n != before.get(k, 0))
    if moved:
        raise RuntimeError(f"trace: the call launched {moved}; a trace "
                           f"takes traced (meta or fake) tensors")
    out = {"flops": mode.flops + mode.kernel_flops,
           "bytes": mode.nbytes + mode.kernel_bytes,
           "aten_flops": mode.flops, "aten_bytes": mode.nbytes,
           "kernel_flops": mode.kernel_flops,
           "kernel_bytes": mode.kernel_bytes,
           "kernels": {k: {"launches": v[0], "flops": v[1], "bytes": v[2]}
                       for k, v in sorted(mode.kernels.items())},
           "bytes_by_op": dict(mode.bytes_by_op), "seconds": seconds}
    if memory:
        out["held_bytes"] = held
        out["peak_bytes"] = mode.peak_bytes
    return out


def build(flops: float, nbytes: float, mflops: float,
          dtype: torch.dtype = torch.bfloat16, mesh=None,
          coll: Optional[Dict] = None) -> Roofline:
    """The roofline of a step of ``flops`` and ``nbytes`` a device whose
    products take operands of ``dtype``: on one card, or over ``mesh``
    with the collectives ``coll`` (``collective_bytes``' result)."""
    axes = {} if mesh is None else mesh_axes(mesh)
    coll = coll or {}
    return Roofline(flops_per_device=float(flops),
                    bytes_per_device=float(nbytes),
                    coll_bytes_per_device=float(coll.get("total", 0)),
                    chips=max(1, math.prod(axes.values())),
                    model_flops=float(mflops),
                    peak_flops=hw.peak_flops(dtype),
                    coll_bytes_by_axis={a: float(b) for a, b in
                                        coll.get("by_axis", {}).items()},
                    link_bw=hw.axis_link_bw(axes))


# ---------------------------------------------------------------------------
# Collective bytes
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional collective -> (kind, which tensor's bytes count): an
# all-reduce or all-to-all counts its input, an all-gather its gathered
# output, a reduce-scatter its scattered output (the reference's HLO
# result shapes). DTensor issues no permute: that key stays 0.
_FUNCOLS = {
    "all_reduce": ("all-reduce", "in"), "all_reduce_": ("all-reduce", "in"),
    "all_reduce_coalesced": ("all-reduce", "in"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "all_to_all_single": ("all-to-all", "in"),
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class collective_bytes(TorchDispatchMode):
    """``with collective_bytes(mesh) as c: step()``, then ``c.result``: the
    bytes a device moves in each kind of collective (the reference's
    ``collective_bytes`` keys, with ``count`` and ``total``) and
    ``by_axis``, the bytes on each mesh axis (a group over several axes
    is named by them joined with "+"). Sees the functional collectives a
    DTensor program issues on its local tensors, on a live group or a
    fake one (meta tensors: nothing moves, the sizes are the same)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.groups = {}
        if mesh is not None:
            names = mesh.mesh_dim_names
            for i, n in enumerate(names):
                self.groups[mesh.get_group(i).group_name] = n
        self.result = {c: 0 for c in COLLECTIVES}
        self.result.update(count=0, total=0, by_axis={})

    def _axis(self, group) -> str:
        name = getattr(group, "group_name", group)
        return self.groups.get(name, str(name))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if profiler._has_dtensor(types):
            return NotImplemented      # let DTensor issue its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = func.overloadpacket
        if op.__module__.endswith(_NAMESPACES) or \
                getattr(func, "namespace", "") in _NAMESPACES:
            hit = _FUNCOLS.get(op.__name__)
            if hit is not None:
                kind, which = hit
                group = kwargs.get("group_name", args[-1])
                n = _nbytes(args[0] if which == "in" else out)
                r = self.result
                r[kind] += n
                r["count"] += 1
                r["total"] += n
                axis = self._axis(group)
                r["by_axis"][axis] = r["by_axis"].get(axis, 0) + n
        return out
