"""Roofline terms of a step on the card, as the reference's
``launch/roofline.py``.

compute term    = FLOPs / peak(dtype)   [``hw.peak_flops``: 989 TFLOP/s for
                                         bf16 products, 165 TFLOP/s for the
                                         3xTF32 f32 path the kernels use]
memory term     = bytes / HBM bandwidth [``hw.HBM_BW``]
collective term = 0 on one card

``count(fn, *args)`` gives (FLOPs, bytes) of one eager call through the
port's one counter, ``core/profiler.py``'s ``_CostMode``: aten ops by
``torch.utils.flop_counter``'s formulas and their tensors' bytes, and on
traced (meta or fake) tensors each hand-written kernel by its formula
(``_build.trace_launch``). The reference reads XLA's ``cost_analysis`` of
a compiled step and parses collective bytes out of its optimized HLO
(``collective_bytes``); the port compiles nothing and runs no collective
on one card, so that parser has no counterpart.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch import hw
from repro_torch.core import profiler
from repro_torch.kernels import _build


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    chips: int
    model_flops: float                 # 6·N·D (train) or 2·N_active·tokens
    peak_flops: float = hw.PEAK_BF16_TENSOR_FLOPS

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        """No collective runs on one card."""
        return 0.0

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
          dtype: torch.dtype = torch.bfloat16) -> Roofline:
    """The one-card roofline of a step of ``flops`` and ``nbytes`` whose
    products take operands of ``dtype``."""
    return Roofline(flops_per_device=float(flops),
                    bytes_per_device=float(nbytes), coll_bytes_per_device=0.0,
                    chips=1, model_flops=float(mflops),
                    peak_flops=hw.peak_flops(dtype))
