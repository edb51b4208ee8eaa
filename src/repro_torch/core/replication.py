"""Algorithm 1 — Partial pipeline replication (paper §5.1.1).

The paper's key data-plane idea: instead of replicating whole pipelines,
recursively split the pipeline at its minimum-latency stage `d`; every stage
`i` in the sub-pipeline *preceding* `d` is replicated ceil(L_i / L_d) times so
that the preceding stages match `d`'s processing capacity and `d` runs with no
bubbles; `d` itself gets one replica; recurse on the suffix.

Faithful to the pseudocode (variable names included). `find_min_stage`
breaks ties toward the earliest stage, which yields the most conservative
(smallest) replication factors for the prefix.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple


def find_min_stage(stages: Sequence[str], latency: Dict[str, float]) -> int:
    """Index of the minimum-latency stage (first on ties)."""
    best, best_lat = 0, float("inf")
    for i, s in enumerate(stages):
        if latency[s] < best_lat:
            best, best_lat = i, latency[s]
    return best


def partition(stages: Sequence[str], d: int) -> Tuple[List[str], List[str]]:
    """Split around stage index d: (S_pre strictly before d, S_post strictly after)."""
    return list(stages[:d]), list(stages[d + 1:])


def num_replication(stages: Sequence[str], latency: Dict[str, float]) -> Dict[str, int]:
    """Algorithm 1: per-stage replication counts R.

    Args:
      stages: pipeline stage names, in order.
      latency: average per-sequence processing latency of each stage
        (offline profiling, paper §6.1).

    Returns:
      R: stage name -> number of replications.
    """
    for s in stages:
        if latency[s] <= 0:
            raise ValueError(f"stage {s} has non-positive latency {latency[s]}")
    R: Dict[str, int] = {}
    S = list(stages)
    while S:
        d = find_min_stage(S, latency)
        d_name = S[d]
        S_pre, S_post = partition(S, d)
        for s in S_pre:
            R[s] = math.ceil(latency[s] / latency[d_name])
        R[d_name] = 1
        S = S_post
    return R


def num_pipelines(R: Dict[str, int]) -> int:
    """Paper §5.1.2: 'The number of pipelines equals the maximum value in R.'"""
    return max(R.values()) if R else 0


def pipeline_throughput(stages: Sequence[str], latency: Dict[str, float],
                        R: Dict[str, int] | None = None) -> float:
    """Steady-state sequences/sec of one (partially replicated) pipeline.

    A stage with replication r and latency L sustains r / L sequences/sec;
    the pipeline rate is the min over stages (the residual bottleneck).
    With R from Algorithm 1 every stage sustains at least 1/min(L), so the
    pipeline runs at the short-stage rate within each sub-pipeline.
    """
    if R is None:
        R = {s: 1 for s in stages}
    return min(R[s] / latency[s] for s in stages)


def efficiency(stages: Sequence[str], latency: Dict[str, float],
               R: Dict[str, int]) -> float:
    """Fraction of allocated stage-resource-time doing useful work.

    With throughput T (seq/s), stage s does useful work T * L_s seconds per
    second across its R_s replicas => utilization T * L_s / R_s. Resource
    efficiency is the resource-weighted mean utilization (each replica is one
    resource unit, paper Fig 2/3 notion of utilization).
    """
    T = pipeline_throughput(stages, latency, R)
    used = sum(T * latency[s] for s in stages)
    alloc = sum(R[s] for s in stages)
    return used / alloc


def full_replication(stages: Sequence[str], copies: int) -> Dict[str, int]:
    """The baseline the paper argues against (Fig 7b): replicate everything."""
    return {s: copies for s in stages}
