"""Application profiler (paper §6.1).

Meili decides single-pipeline performance by *offline profiling*: run each
CPU stage with one resource unit (1 core + 4 GB) and accelerator stages on
their engines, and record per-stage latency `l_s` / throughput `t_s` and
whole-pipeline `l_p` / `t_p`.

Two profiling backends:
  * ``measure_app``        — wall-clock each stage on the device that holds
                             the batch (on the card, the stage runners launch
                             the NIC kernels; on the CPU, their plain
                             versions run);
  * ``cost_model_latency`` — roofline estimate from the FLOPs and bytes the
                             callable's aten ops count, against the H100's
                             peak rates (``hw``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import hw
from repro_torch.core.graph import (MeiliApp, PacketBatch, stage_runner,
                                    tree_leaves)
from repro_torch.kernels import _build


@dataclasses.dataclass
class AppProfile:
    stages: list
    l_s: Dict[str, float]        # per-sequence(-batch) stage latency, seconds
    t_s: Dict[str, float]        # per-unit stage throughput, Gbps
    l_p: float                   # single-pipeline latency, seconds
    t_p: float                   # single-pipeline throughput, Gbps

    def batch_bits(self) -> float:
        return self._bits

    def __post_init__(self):
        self._bits = 0.0


def _finish(out) -> None:
    """Wait until ``out`` is computed: a CUDA stream runs behind the host,
    so synchronise the device that holds it; on the CPU the work is done
    when the call returns."""
    for leaf in tree_leaves(out):
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def _time_call(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        _finish(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _finish(fn(*args))
    return (time.perf_counter() - t0) / iters


def measure_app(app: MeiliApp, batch: PacketBatch, iters: int = 5) -> AppProfile:
    """Wall-clock profile of every stage with one resource unit, on the
    device that holds ``batch`` (the batch is never moved).

    l_p is the end-to-end pipeline latency (sum of stage latencies — the
    minimum app latency reported to users, §6.1); t_p is the *streaming*
    single-pipeline throughput, set by the slowest stage.
    """
    bits = float(batch.length.sum()) * 8.0
    l_s: Dict[str, float] = {}
    cur = batch
    for fn in app.stages:
        runner = stage_runner(fn)
        l_s[fn.name] = _time_call(runner, cur, iters=iters)
        cur = runner(cur)
    l_p = sum(l_s.values())
    t_s = {n: bits / l / 1e9 for n, l in l_s.items()}
    t_p = bits / max(l_s.values()) / 1e9
    prof = AppProfile(stages=app.stage_names(), l_s=l_s, t_s=t_s, l_p=l_p, t_p=t_p)
    prof._bits = bits
    return prof


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _moves_no_data(func, args, out) -> bool:
    """A view (the schema marks the output as an alias of an input) or an
    op whose every output shares an input's storage without writing it
    (``_unsafe_view``, ``alias``): no byte moves."""
    if func.is_view:
        return True
    if any(r.alias_info is not None and r.alias_info.is_write
           for r in func._schema.arguments):
        return False
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    if not outs:
        return False
    ins = {t.untyped_storage().data_ptr() for t in tree_flatten(args)[0]
           if isinstance(t, torch.Tensor)}
    return all(t.untyped_storage().data_ptr() in ins for t in outs)


class _CostMode(TorchDispatchMode):
    """Counts FLOPs through ``torch.utils.flop_counter``'s registered
    formulas and bytes as each aten op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not _moves_no_data(func, (args, kwargs), out):
            self.nbytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def op_cost(fn: Callable, *args) -> Tuple[int, int]:
    """(FLOPs, bytes) of one eager call of ``fn``, counted op by op.

    FLOPs come from ``torch.utils.flop_counter``'s formulas, which cover
    products (matmuls, convolutions, attention); elementwise ops count none.
    Eager mode runs every aten op on its own, so an elementwise chain that
    XLA would fuse into one pass counts each op's reads and writes: the
    byte count is at least what a fused compiler reports. A single product
    counts its operands and result, as XLA's ``cost_analysis`` does.

    A hand-written kernel launches through ctypes (``_build.launch``),
    which no dispatch mode sees, so its work would be left out: if any
    kernel launched during the call, this raises and names it.
    """
    before = _build.launch_counts()
    with _CostMode() as mode:
        fn(*args)
    moved = sorted(k for k, n in _build.launch_counts().items()
                   if n != before.get(k, 0))
    if moved:
        raise RuntimeError(
            f"op_cost: the call launched hand-written kernels {moved}, "
            f"whose work no aten op counts; time them instead")
    return mode.flops, mode.nbytes


def cost_model_latency(fn: Callable, *args,
                       flops_rate: float = hw.PEAK_BF16_TENSOR_FLOPS,
                       mem_bw: float = hw.HBM_BW) -> float:
    """Roofline latency estimate of one eager callable on the H100: the
    larger of its FLOPs over ``flops_rate`` and its bytes over ``mem_bw``
    (``op_cost``; raises if ``fn`` launches a hand-written kernel)."""
    flops, nbytes = op_cost(fn, *args)
    return max(flops / flops_rate, nbytes / mem_bw)


def synthetic_profile(stages, l_s: Dict[str, float], batch_bits: float) -> AppProfile:
    """Build a profile from known stage latencies (cost-model / paper tables)."""
    l_p = sum(l_s[s] for s in stages)
    t_s = {s: batch_bits / l_s[s] / 1e9 for s in stages}
    t_p = batch_bits / max(l_s[s] for s in stages) / 1e9
    prof = AppProfile(stages=list(stages), l_s=dict(l_s), t_s=t_s, l_p=l_p, t_p=t_p)
    prof._bits = batch_bits
    return prof
