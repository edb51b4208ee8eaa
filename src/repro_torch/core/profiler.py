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

import collections
import dataclasses
import functools
import time
import weakref
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
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
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _storage_key(t: torch.Tensor) -> int:
    """Identity of ``t``'s storage. Not its data pointer: every storage on
    the meta device starts at 0."""
    return t.untyped_storage()._cdata


# Ops that only allocate: no byte moves (their outputs' storages are new).
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                torch.ops.aten.new_empty_strided}


def _moves_no_data(func, args, out) -> bool:
    """A view (the schema marks the output as an alias of an input), an
    allocation (``_ALLOCATIONS``), or an op whose every output shares an
    input's storage without writing it (``_unsafe_view``, ``alias``): no
    byte moves."""
    if func.is_view or func.overloadpacket in _ALLOCATIONS:
        return True
    if any(r.alias_info is not None and r.alias_info.is_write
           for r in func._schema.arguments):
        return False
    outs = list(_tensors(out))
    if not outs:
        return False
    ins = {_storage_key(t) for t in _tensors(args)}
    return all(_storage_key(t) in ins for t in outs)


_MISS = object()


def _has_dtensor(types) -> bool:
    return any(t is not torch.Tensor and _is_dtensor_type(t) for t in types)


@functools.lru_cache(maxsize=None)
def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


# DTensor works out an op's global output shape by running the op on
# global-shaped stand-ins (``ShardingPropagator._propagate_tensor_meta_
# non_cached``); a counter sees those ops too, and they are not a rank's
# work. While one runs, the count is > 0 and the counters skip.
_PROPAGATING = [0]


def _skip_dtensor_propagation() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    f = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(f, "skipped_by_counters", False):
        return

    def propagate(self, op_schema):
        _PROPAGATING[0] += 1
        try:
            return f(self, op_schema)
        finally:
            _PROPAGATING[0] -= 1
    propagate.skipped_by_counters = True
    ShardingPropagator._propagate_tensor_meta_non_cached = propagate


def propagating() -> bool:
    """Whether DTensor is working out an op's output shape (no rank's
    work: counters skip it)."""
    return _PROPAGATING[0] > 0


def _tensors(tree):
    """The tensors of an op's (possibly nested) list, tuple or dict
    arguments."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for e in tree:
            yield from _tensors(e)
    elif isinstance(tree, dict):
        for e in tree.values():
            yield from _tensors(e)


def _key_of(x):
    if isinstance(x, torch.Tensor):
        if not x.is_meta or type(x) is not torch.Tensor:
            raise TypeError
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_key_of(e) for e in x)
    if isinstance(x, dict):
        return tuple((k, _key_of(v)) for k, v in x.items())
    hash(x)
    return (type(x), x)


def _meta_key(func, args, kwargs):
    """A memo key of an op on plain meta tensors (their shapes, strides,
    dtypes and offsets, and the other arguments), or None when an
    argument is not such a tensor or not hashable."""
    try:
        return (func, _key_of(args), _key_of(kwargs))
    except TypeError:
        return None


_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d")


def _memo_entry(out, args, flops: int, nbytes: int):
    """What a memoized meta op replays (whether it returned a tuple, each
    output's shape, stride and dtype, its FLOPs and bytes), or None when
    an output is not a plain meta tensor (a factory op on another
    device: its arguments hold no tensor) or shares an input's storage
    (``_unsafe_view``): such an op is run every time."""
    outs = out if isinstance(out, tuple) else (out,)
    ins = {_storage_key(t) for t in _tensors(args)}
    if not all(type(o) is torch.Tensor and o.is_meta
               and _storage_key(o) not in ins for o in outs):
        return None
    return (isinstance(out, tuple),
            tuple((o.shape, o.stride(), o.dtype) for o in outs), flops,
            nbytes)


def _allocated(nbytes: int) -> int:
    """Bytes the CUDA caching allocator books for a request: 512-byte
    units, none for an empty tensor."""
    return -(-nbytes // 512) * 512


class _CostMode(TorchDispatchMode):
    """Counts FLOPs through ``torch.utils.flop_counter``'s registered
    formulas and bytes as each aten op's tensor inputs and outputs
    (``bytes_by_op`` per op). A hand-written kernel's launch on traced
    tensors (``_build.trace_launch``) adds its work to ``kernels``
    (name -> [launches, flops, bytes]), not to ``flops`` and ``nbytes``.

    With ``memory`` it also follows the storages alive: each op output's
    new storage is booked at its allocated size (``_allocated``) until the
    storage dies, and ``peak_bytes`` is the most booked at once. ``hold``
    books storages made before the mode was entered (parameters,
    optimizer state, the batch)."""

    def __init__(self, memory: bool = False):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.bytes_by_op: Dict[str, int] = collections.Counter()
        self.kernels: Dict[str, list] = {}
        self._memory = memory
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._memo: Dict = {}
        self._memo_funcs: Dict = {}

    def __enter__(self):
        _skip_dtensor_propagation()
        _build._SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build._SINKS.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, [0, 0, 0])
        k[0] += 1
        k[1] += flops
        k[2] += nbytes

    def hold(self, tensors) -> None:
        for t in _tensors(tensors):
            self._book(getattr(t, "_local_tensor", t))   # a DTensor's block

    def _book(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = _allocated(st.nbytes())
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            # a DTensor op: DTensor issues the rank's local ops (and its
            # collectives), which come back here and are what one device
            # does
            return NotImplemented
        kwargs = kwargs or {}
        if propagating():
            return func(*args, **kwargs)
        key = _meta_key(func, args, kwargs) if self._memo_ok(func) else None
        got = self._memo.get(key, _MISS) if key is not None else _MISS
        if got is not _MISS and got is not None:
            many, metas, flops, n = got
            outs = tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                         for sh, st, dt in metas)
            out = outs if many else outs[0]
        else:
            out = func(*args, **kwargs)
            formula = flop_registry.get(func.overloadpacket)
            flops = 0 if formula is None else \
                formula(*args, **kwargs, out_val=out)
            n = 0 if _moves_no_data(func, (args, kwargs), out) else \
                _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
            if got is _MISS and key is not None:
                self._memo[key] = _memo_entry(out, args, flops, n)
        self.flops += flops
        if n:
            self.nbytes += n
            self.bytes_by_op[str(func.overloadpacket)] += n
        if self._memory:
            for t in _tensors(out):
                self._book(t)
        return out

    def _memo_ok(self, func) -> bool:
        """``func`` is functional: no view, no aliased argument or result,
        and it returns tensors only. A meta kernel computes only its
        outputs' shapes, strides and dtypes, at up to ~0.2 ms an op, and a
        dry run repeats each layer's ops thousands of times: on plain meta
        tensors such an op is memoized by its inputs' metadata, but for a
        collective."""
        ok = self._memo_funcs.get(func)
        if ok is None:
            sch = func._schema
            # a collective runs every time: a mode outside this one (the
            # dry run's ``roofline.collective_bytes``) counts each call
            ok = (func.namespace not in _COLLECTIVE_NAMESPACES
                  and not func.is_view and len(sch.returns) > 0
                  and all(a.alias_info is None
                          for a in (*sch.arguments, *sch.returns))
                  and all(str(r.type) == "Tensor" for r in sch.returns))
            self._memo_funcs[func] = ok
        return ok

    @property
    def kernel_flops(self) -> int:
        return sum(k[1] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> int:
        return sum(k[2] for k in self.kernels.values())


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
    kernel launched during the call, this raises and names it. On traced
    tensors (meta or fake) the kernels' wrappers report their work
    instead of launching, and it is counted in.
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
    return mode.flops + mode.kernel_flops, mode.nbytes + mode.kernel_bytes


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
