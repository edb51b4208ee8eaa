"""Meili programming model (paper §4): functions, packet/socket paradigms.

Applications are chains of fine-grained *functions*; each function is a
user-customized callback (UCF) over one of two base abstractions:

  * ``PacketBatch``  — the ``Meili_packet`` analog, batched for the GPU:
    headers (5-tuple), payload bytes, lengths, a liveness mask (pkt_flt
    drops), and a per-packet metadata dict that UCFs may read/compute/extend.
  * ``FlowBatch``    — the ``Meili_flow`` analog: connection descriptor plus
    per-connection metadata.

Both are dataclasses of tensors. ``tree_leaves``/``tree_map`` walk them in
a fixed order — fields in declaration order, ``meta`` keys sorted — so a
leaf list lines up one for one with the JAX package's ``jax.tree.leaves``.

UCFs are plain functions on tensors that run eagerly; a stage "program" is
the stage applied as a callable. The program caches keep the reference's
process-wide identity keying and hit/miss accounting
(``COMPILE_CACHE_STATS``) so replicas of one stage share one program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.pool import CPU
from repro_torch.hw import resolve_device

PKT_BYTES = 1500  # paper: 1500B packet buffers (§5.1.2, §8 methodology)


@dataclasses.dataclass
class PacketBatch:
    """Batched Meili_packet: (B,) packets processed as one sequence batch."""

    payload: torch.Tensor                # (B, PKT_BYTES) uint8
    length: torch.Tensor                 # (B,) int32 valid payload bytes
    five_tuple: torch.Tensor             # (B, 5) int32: sip dip sport dport proto
    mask: torch.Tensor                   # (B,) bool — False once dropped
    meta: Dict[str, torch.Tensor]        # per-packet metadata (UCF-computed)

    @property
    def batch(self) -> int:
        return self.payload.shape[0]

    @property
    def device(self) -> torch.device:
        return self.payload.device

    def with_meta(self, **kv: torch.Tensor) -> "PacketBatch":
        return dataclasses.replace(self, meta={**self.meta, **kv})


def make_packets(payload: torch.Tensor, length: torch.Tensor,
                 five_tuple: torch.Tensor, device="cuda") -> PacketBatch:
    dev = resolve_device(device)
    payload = torch.as_tensor(payload).to(dev, torch.uint8)
    b = payload.shape[0]
    return PacketBatch(payload=payload,
                       length=torch.as_tensor(length).to(dev, torch.int32),
                       five_tuple=torch.as_tensor(five_tuple).to(dev,
                                                                 torch.int32),
                       mask=torch.ones((b,), dtype=torch.bool, device=dev),
                       meta={})


@dataclasses.dataclass
class FlowBatch:
    """Batched Meili_flow: per-connection descriptor + metadata."""

    five_tuple: torch.Tensor             # (F, 5) int32
    meta: Dict[str, torch.Tensor]

    @property
    def flows(self) -> int:
        return self.five_tuple.shape[0]


# -- pytree helpers (leaf order == jax.tree.leaves on the reference) -----------

def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def bits(t: torch.Tensor) -> torch.Tensor:
    """A uint32 tensor as an int32 view of the same storage (other dtypes
    as they are). PyTorch lacks ``index_put`` and arithmetic for uint32, so
    data movement goes through the int32 bits and views back."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def take(a: torch.Tensor, idx) -> torch.Tensor:
    """Row gather ``a[idx]`` that also works for uint32 leaves."""
    return bits(a)[idx].view(a.dtype)


# -- stages and apps ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Function:
    """One pipeline stage: a named UCF plus its resource kind."""

    name: str
    kind: str                            # pkt_trans|pkt_flt|flow_ext|flow_trans|accel|socket
    ucf: Callable[..., Any]
    resource: str = CPU                  # CPU or accelerator kind (pool.REGEX, ...)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


class MeiliApp:
    """Application = ordered chain of Functions (Listing 1 style).

    The paper describes a DAG; its algorithms (1, 2) and all six evaluation
    apps use linear chains, so the chain is the first-class form here.
    """

    def __init__(self, name: str):
        self.name = name
        self.stages: List[Function] = []
        self.state_decls: Dict[str, dict] = {}

    # -- packet paradigm ------------------------------------------------------
    def pkt_trans(self, ucf: Callable[[PacketBatch], PacketBatch],
                  name: Optional[str] = None) -> "MeiliApp":
        self.stages.append(Function(name or ucf.__name__, "pkt_trans", ucf))
        return self

    def pkt_flt(self, ucf: Callable[[PacketBatch], torch.Tensor],
                name: Optional[str] = None) -> "MeiliApp":
        """UCF returns a keep-mask (B,) bool; dropped packets stay masked out."""
        self.stages.append(Function(name or ucf.__name__, "pkt_flt", ucf))
        return self

    def flow_ext(self, ucf: Callable[[PacketBatch], torch.Tensor], window: int,
                 slide: int, name: Optional[str] = None) -> "MeiliApp":
        """UCF maps packets -> flow keys; packets pass through unmodified."""
        self.stages.append(Function(name or ucf.__name__, "flow_ext", ucf,
                                    params={"window": window, "slide": slide}))
        return self

    def flow_trans(self, ucf: Callable[[PacketBatch, FlowBatch], FlowBatch],
                   name: Optional[str] = None) -> "MeiliApp":
        self.stages.append(Function(name or ucf.__name__, "flow_trans", ucf))
        return self

    # -- accelerator stages (core.accel supplies the UCF) ----------------------
    def accel(self, fn: Function) -> "MeiliApp":
        self.stages.append(fn)
        return self

    # -- socket paradigm (event-batch model) -------------------------------------
    def reg_sock(self, name: str = "reg_sock") -> "MeiliApp":
        self.stages.append(Function(name, "socket", lambda b: b))
        return self

    def epoll(self, ucf: Callable[[PacketBatch], PacketBatch], event: str = "EPOLLIN",
              name: Optional[str] = None) -> "MeiliApp":
        self.stages.append(Function(name or ucf.__name__, "socket", ucf,
                                    params={"event": event}))
        return self

    # -- state declarations (wired to the state engine at deploy) ---------------
    def declare_state(self, name: str, pattern: str, shape=(),
                      dtype=torch.int32):
        if pattern not in ("non-external-write", "full-access"):
            raise ValueError(f"unknown state pattern {pattern!r}")
        self.state_decls[name] = dict(pattern=pattern, shape=shape, dtype=dtype)
        return self

    # -- introspection ----------------------------------------------------------
    def stage_names(self) -> List[str]:
        return [f.name for f in self.stages]

    def resource_needs(self) -> Dict[str, str]:
        return {f.name: f.resource for f in self.stages}


def apply_stage(fn: Function, batch: PacketBatch) -> PacketBatch:
    """Execute one stage on a batch (the Executor's inner body)."""
    if fn.kind == "pkt_trans" or fn.kind == "socket" or fn.kind == "accel":
        out = fn.ucf(batch)
        return out if isinstance(out, PacketBatch) else batch
    if fn.kind == "pkt_flt":
        keep = fn.ucf(batch)
        return dataclasses.replace(batch, mask=batch.mask & keep)
    if fn.kind == "flow_ext":
        keys = fn.ucf(batch)
        return batch.with_meta(flow_key=keys)
    if fn.kind == "flow_trans":
        # Flow view derived on the fly; UCF updates flow metadata which is
        # scattered back to per-packet meta by key.
        flows = FlowBatch(five_tuple=batch.five_tuple, meta=dict(batch.meta))
        out = fn.ucf(batch, flows)
        return batch.with_meta(**out.meta)
    raise ValueError(f"unknown stage kind {fn.kind}")


def run_pipeline(app: MeiliApp, batch: PacketBatch) -> PacketBatch:
    """Reference single-pipeline execution (no replication) — the semantic
    oracle against which the parallel data plane is tested."""
    for fn in app.stages:
        batch = apply_stage(fn, batch)
    return batch


# -- process-wide program caches ------------------------------------------------
#
# Replicas differ in placement/timing, never in program: N pipeline replicas
# of one app share ONE program per stage (and one per chain), keyed on stage
# *identity* — the (kind, ucf, params) triple that fully determines the
# computation. PyTorch runs eagerly, so a program is the stage chain as a
# callable; the caches keep the reference's identity keying, FIFO bound and
# hit/miss/evict accounting, and the executor's fused dispatch registers its
# own per-shape specialization counts under "dispatch".

_CACHE_CAP = 256

COMPILE_CACHE_STATS: Dict[str, Dict[str, int]] = {}


def _cache_stats(cache_name: str) -> Dict[str, int]:
    return COMPILE_CACHE_STATS.setdefault(
        cache_name, {"hit": 0, "miss": 0, "evict": 0})


def compile_cache_stats() -> Dict[str, Dict[str, int]]:
    """A snapshot copy of the per-cache hit/miss/evict counters."""
    return {k: dict(v) for k, v in COMPILE_CACHE_STATS.items()}


def reset_compile_cache_stats() -> None:
    for stats in COMPILE_CACHE_STATS.values():
        for k in stats:
            stats[k] = 0


def cache_put(cache: Dict, key, value, cap: int = _CACHE_CAP,
              stats: Optional[Dict[str, int]] = None):
    """Insert into a bounded process-wide program cache (FIFO eviction)."""
    if len(cache) >= cap:
        cache.pop(next(iter(cache)))
        if stats is not None:
            stats["evict"] += 1
    cache[key] = value
    return value


_STAGE_RUNNERS: Dict[Any, Callable] = {}
_CHAIN_RUNNERS: Dict[Any, Callable] = {}


def _stage_key(fn: Function):
    try:
        params = tuple(sorted(fn.params.items()))
        hash(params)
    except TypeError:
        params = id(fn.params)            # unhashable params: identity key
    return (fn.kind, fn.ucf, params)


def chain_key(app: "MeiliApp"):
    """Identity of an app's full stage chain (the fused-program cache key)."""
    return tuple(_stage_key(f) for f in app.stages)


def stage_runner(fn: Function) -> Callable[[PacketBatch], PacketBatch]:
    """The single-stage program (one Executor), cached process-wide by
    stage identity."""
    key = _stage_key(fn)
    stats = _cache_stats("stage")
    runner = _STAGE_RUNNERS.get(key)
    if runner is None:
        stats["miss"] += 1
        runner = cache_put(_STAGE_RUNNERS, key,
                           lambda b: apply_stage(fn, b), stats=stats)
    else:
        stats["hit"] += 1
    return runner


def chain_runner(app: "MeiliApp") -> Callable[[PacketBatch], PacketBatch]:
    """The app's full stage chain as ONE program, cached process-wide."""
    key = chain_key(app)
    stats = _cache_stats("chain")
    runner = _CHAIN_RUNNERS.get(key)
    if runner is None:
        stats["miss"] += 1
        stages = tuple(app.stages)

        def run(batch: PacketBatch) -> PacketBatch:
            for fn in stages:
                batch = apply_stage(fn, batch)
            return batch

        runner = cache_put(_CHAIN_RUNNERS, key, run, stats=stats)
    else:
        stats["hit"] += 1
    return runner
