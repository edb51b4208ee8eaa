"""State engine + state APIs (paper §4.3, §5.1.2, Appendix C).

Each pool member runs a lightweight state engine (SE) holding application
states in a **linked hash table** (4096 buckets, as in the paper's prototype).
State entries mirror the paper's 64-byte layout (s_name, h_key, s_addr,
s_len, lu_time) and expire past a lifespan threshold.

Access patterns (§4.3):
  * "non-external-write"  — writable locally, readable everywhere;
  * "full-access"         — writable/readable by all instances.

Operators: ADD / REMOVE / GET / SET / TRAVERSE / COMPUTE. GET checks local
state first and falls back to a remote read. TRAVERSE pulls whole remote
tables once and traverses locally (the paper's RDMA-batching optimization —
here one gather instead of per-key reads). COMPUTE ships the instruction and
returns aggregated results.

Transport: the paper uses RDMA; on one card the data-plane counterpart is
a sum over the replica dimension of a tensor already on the device
(`bounded_sync_deltas`), and control-plane reads go through a host
`Transport` that counts ops + bytes so benchmarks can report Fig 20-style
costs. Values may be torch tensors; a tensor's byte count is
``numel() * element_size()``, anything else is counted as ``np.asarray``
gives it.

Bounded-inconsistency flow-state sync (§5.1.2, after ExoPlane): every period
T each pipeline merges the *deltas* of all peers since the last sync into its
own value — `v_i' = v_i + Σ_{j≠i}(v_j − s_j)` — so sum-like flow statistics
converge to the global value while staying temporarily inconsistent within T.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

NUM_BUCKETS = 4096          # paper §7
LIFESPAN_S = 500.0          # paper Appendix C

NON_EXTERNAL_WRITE = "non-external-write"
FULL_ACCESS = "full-access"


def _h_key(name: str) -> int:
    h = 1469598103934665603
    for ch in name.encode():
        h = ((h ^ ch) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclasses.dataclass
class StateEntry:
    """The paper's 64-byte entry: 8B s_name | 32B h_key | 8B s_addr | 8B s_len | 8B lu_time."""

    s_name: str
    h_key: int
    value: Any                       # payload (s_addr/s_len point at it)
    lu_time: float

    @property
    def s_len(self) -> int:
        return _nbytes(self.value)


class LinkedHashTable:
    """Bucketed chained hash table — collision scans make reads slow down as
    occupancy grows, reproducing the paper's Fig 20 read/write asymmetry."""

    def __init__(self, buckets: int = NUM_BUCKETS):
        self.buckets: List[List[StateEntry]] = [[] for _ in range(buckets)]
        self.size = 0

    def _bucket(self, h: int) -> List[StateEntry]:
        return self.buckets[h % len(self.buckets)]

    def put(self, name: str, value: Any, now: Optional[float] = None) -> None:
        h = _h_key(name)
        now = time.monotonic() if now is None else now
        for e in self._bucket(h):
            if e.h_key == h and e.s_name == name:
                e.value, e.lu_time = value, now
                return
        self._bucket(h).append(StateEntry(name, h, value, now))
        self.size += 1

    def get(self, name: str, now: Optional[float] = None) -> Optional[StateEntry]:
        h = _h_key(name)
        for e in self._bucket(h):
            if e.h_key == h and e.s_name == name:
                e.lu_time = time.monotonic() if now is None else now
                return e
        return None

    def remove(self, name: str) -> bool:
        h = _h_key(name)
        b = self._bucket(h)
        for i, e in enumerate(b):
            if e.h_key == h and e.s_name == name:
                del b[i]
                self.size -= 1
                return True
        return False

    def entries(self) -> List[StateEntry]:
        return [e for b in self.buckets for e in b]

    def expire(self, now: float, lifespan: float = LIFESPAN_S) -> int:
        n = 0
        for b in self.buckets:
            keep = [e for e in b if now - e.lu_time <= lifespan]
            n += len(b) - len(keep)
            b[:] = keep
        self.size -= n
        return n


@dataclasses.dataclass
class Transport:
    """RDMA-analog op counter (per-op latency model used by benchmarks)."""

    reads: int = 0
    writes: int = 0
    bytes_read: int = 0
    bytes_written: int = 0

    def read(self, nbytes: int) -> None:
        self.reads += 1
        self.bytes_read += nbytes

    def write(self, nbytes: int) -> None:
        self.writes += 1
        self.bytes_written += nbytes


class StateEngine:
    """One per pool member."""

    def __init__(self, nic: str, buckets: int = NUM_BUCKETS):
        self.nic = nic
        self.table = LinkedHashTable(buckets)


class StateService:
    """The distributed ensemble of per-NIC engines + the state API."""

    def __init__(self, nics: Sequence[str], buckets: int = NUM_BUCKETS):
        self.engines: Dict[str, StateEngine] = {
            n: StateEngine(n, buckets) for n in nics}
        self.patterns: Dict[str, str] = {}
        self.transport = Transport()
        # Monotonic write version: bumped by every mutating state API call.
        # Failover replication compares it against the version it last
        # snapshotted, so unchanged state is never re-traversed (the dirty
        # flag — TRAVERSE over every engine is the expensive op here).
        self.version = 0

    def declare(self, name: str, pattern: str) -> None:
        assert pattern in (NON_EXTERNAL_WRITE, FULL_ACCESS)
        self.patterns[name] = pattern

    # -- full-access ops: apply to all replicas ---------------------------------
    def fstate_add(self, name: str, value: Any) -> None:
        self.version += 1
        for e in self.engines.values():
            e.table.put(name, value)
            self.transport.write(_nbytes(value))

    def fstate_set(self, name: str, value: Any) -> None:
        self.fstate_add(name, value)

    def fstate_remove(self, name: str) -> None:
        self.version += 1
        for e in self.engines.values():
            e.table.remove(name)
            self.transport.write(8)

    # -- non-external-write ops: local write, global read -----------------------
    def ne_set(self, name: str, value: Any, local: str) -> None:
        self.version += 1
        self.engines[local].table.put(name, value)

    def ne_add(self, name: str, value: Any, local: str) -> None:
        self.version += 1
        self.engines[local].table.put(name, value)

    def ne_remove(self, name: str, local: str) -> bool:
        self.version += 1
        return self.engines[local].table.remove(name)

    # -- GET: same in both patterns — local first, then remote READ -------------
    def get(self, name: str, local: str) -> Optional[Any]:
        e = self.engines[local].table.get(name)
        if e is not None:
            return e.value
        for nic, eng in self.engines.items():
            if nic == local:
                continue
            e = eng.table.get(name)
            if e is not None:
                self.transport.read(e.s_len)
                return e.value
        return None

    # -- TRAVERSE: pull whole remote tables once, walk locally ------------------
    def traverse(self, local: str) -> List[StateEntry]:
        out = list(self.engines[local].table.entries())
        for nic, eng in self.engines.items():
            if nic == local:
                continue
            remote = eng.table.entries()
            self.transport.read(sum(e.s_len + 64 for e in remote))
            out.extend(remote)
        return out

    # -- COMPUTE: ship the UCF, aggregate results -------------------------------
    def compute(self, name: str, ucf: Callable[[List[Any]], Any],
                combine: Callable[[List[Any]], Any]) -> Any:
        partials = []
        for nic, eng in self.engines.items():
            e = eng.table.get(name)
            vals = [e.value] if e is not None else []
            partials.append(ucf(vals))
            self.transport.write(64)          # the instruction
            self.transport.read(8)            # the aggregated result
        return combine(partials)

    def expire_all(self, now: float) -> int:
        return sum(e.table.expire(now) for e in self.engines.values())


def _nbytes(value: Any) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    v = np.asarray(value)
    return int(v.size * v.dtype.itemsize)


# ---------------------------------------------------------------------------
# Bounded-inconsistency sync (§5.1.2) — host and device forms.
# ---------------------------------------------------------------------------

def bounded_sync(values: torch.Tensor, snapshots: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host form. values/snapshots: (P, ...) per-pipeline replicas.

    Returns (merged values, new snapshots): v_i' = v_i + Σ_{j≠i}(v_j − s_j).
    For counter-like states all replicas converge to the global sum.
    """
    return bounded_sync_deltas(values, snapshots, dim=0)


def bounded_sync_deltas(value: torch.Tensor, snapshot: torch.Tensor,
                        dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device form: the pipelines' replicas lie along ``dim`` of a tensor
    on one device, so the delta exchange (the paper's RDMA negotiation, an
    all-reduce across device groups) is one sum over that dimension.

    The snapshot is a copy of the merged value: a tensor is mutable, and
    returning the merged tensor twice would let an in-place update of the
    value move its snapshot too.
    """
    delta = value - snapshot
    total = delta.sum(dim, keepdim=True)
    merged = value + (total - delta)
    return merged, merged.clone()
