"""Discrete-event pipeline timing simulator (validates §5.1.1 / Fig 7-8).

Models each stage replica as a deterministic server with the stage's profiled
per-sequence latency; sequences flow through stages in order, each picking the
earliest-free replica. Used to (a) unit-test that Algorithm 1 eliminates
bubbles at the short stages, (b) reproduce the paper's Fig 7 end-to-end
latency ordering (t1 < t2 < t3 with full replication faster but far less
efficient), and (c) drive the resource-efficiency benchmarks without
SmartNIC hardware (DESIGN.md §7).

Inter-stage hand-offs may add a network hop penalty when the placement puts
consecutive stages on different NICs (paper Table 1: ~3-4 µs observed for the
distributed IPComp gateway; §8.5 measures ~4.5 µs round trips).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class SimResult:
    makespan: float                 # time last sequence leaves the pipeline
    latencies: List[float]          # per-sequence end-to-end latency
    busy_time: Dict[str, float]     # stage -> total busy server-seconds
    replicas: Dict[str, int]

    @property
    def throughput(self) -> float:
        return len(self.latencies) / self.makespan if self.makespan else 0.0

    def utilization(self, latency: Dict[str, float]) -> float:
        """Resource-weighted mean replica utilization over the makespan."""
        total = sum(self.replicas.values()) * self.makespan
        used = sum(self.busy_time.values())
        return used / total if total else 0.0

    @property
    def avg_latency(self) -> float:
        return sum(self.latencies) / len(self.latencies)


def simulate(stages: Sequence[str], latency: Dict[str, float],
             R: Dict[str, int], num_seqs: int,
             arrival_interval: float = 0.0,
             hop_penalty: Dict[Tuple[str, str], float] | None = None) -> SimResult:
    """Run `num_seqs` sequences through the replicated pipeline.

    arrival_interval=0 models a saturating ingress (back-to-back arrivals);
    hop_penalty maps (stage_i, stage_{i+1}) -> added latency when the
    placement crosses NICs.
    """
    hop_penalty = hop_penalty or {}
    # Earliest-free time per replica, per stage.
    free: Dict[str, List[float]] = {s: [0.0] * R[s] for s in stages}
    busy: Dict[str, float] = {s: 0.0 for s in stages}
    starts: List[float] = [i * arrival_interval for i in range(num_seqs)]
    done: List[float] = []

    for i in range(num_seqs):
        t = starts[i]
        t0 = t
        prev: Optional[str] = None
        for s in stages:
            if prev is not None:
                t += hop_penalty.get((prev, s), 0.0)
            # earliest-free replica (replica list kept as a heap)
            heapq.heapify(free[s])
            ready = heapq.heappop(free[s])
            begin = max(t, ready)
            end = begin + latency[s]
            heapq.heappush(free[s], end)
            busy[s] += latency[s]
            t = end
            prev = s
        done.append(t - t0)
    makespan = max(starts[i] + done[i] for i in range(num_seqs))
    return SimResult(makespan=makespan, latencies=done, busy_time=busy,
                     replicas=dict(R))
