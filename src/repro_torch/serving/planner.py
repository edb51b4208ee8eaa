"""Meili-planned LM serving: the paper's algorithms applied to model stages.

An LM's layer schedule (``lm.build_schedule``) is a heterogeneous pipeline —
segments of different depth and mixer kind have different per-token
latencies, exactly the situation Algorithm 1 was designed for. The planner
takes per-segment decode latencies (``launch/serve.py`` measures them on the
card), runs Algorithm 1 for per-segment replication factors R, optionally
places the replicas over a pool of device groups with Algorithm 2
(``pool=``, ``core/allocation.py``), and returns a ServingPlan whose
pipeline count sizes the ServingEngine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import allocation as alloc_mod
from repro_torch.core import replication as repl
from repro_torch.core.pool import CPU, Pool
from repro_torch.models import lm as lm_mod
from repro_torch.models.registry import Model


@dataclasses.dataclass
class ServingPlan:
    stages: List[str]
    latencies: Dict[str, float]           # per-segment per-batch latency (s)
    R: Dict[str, int]
    num_pipelines: int
    allocation: Optional[alloc_mod.Allocation]
    throughput_gain: float                # vs single pipeline

    def summary(self) -> str:
        lines = [f"stages: {self.stages}", f"R: {self.R}",
                 f"pipelines: {self.num_pipelines}",
                 f"throughput gain: {self.throughput_gain:.2f}x"]
        if self.allocation is not None:
            for s in self.stages:
                lines.append(f"  {s} -> {self.allocation.nics_for(s)}")
        return "\n".join(lines)


def segment_stage_names(cfg) -> List[str]:
    sched = lm_mod.build_schedule(cfg)
    names = []
    for i, seg in enumerate(sched):
        kinds = "+".join(sorted({f"{s.mixer}/{s.ffn}" for s in seg.body}))
        names.append(f"seg{i}[{kinds}]x{seg.count}")
    return names


def plan_serving(model: Model, latencies: Dict[str, float],
                 pool: Optional[Pool] = None,
                 unit_throughput_gbps: Optional[Dict[str, float]] = None
                 ) -> ServingPlan:
    """latencies: per-stage (segment) per-batch latency from profiling."""
    stages = list(latencies.keys())
    R = repl.num_replication(stages, latencies)
    n_pipes = repl.num_pipelines(R)
    base = repl.pipeline_throughput(stages, latencies,
                                    {s: 1 for s in stages})
    scaled = repl.pipeline_throughput(stages, latencies, R)
    alloc = None
    if pool is not None:
        t_s = unit_throughput_gbps or {s: 1.0 for s in stages}
        need = {s: CPU for s in stages}
        alloc = alloc_mod.resource_alloc(stages, R, t_s, pool, need)
    return ServingPlan(stages=stages, latencies=latencies, R=R,
                       num_pipelines=n_pipes, allocation=alloc,
                       throughput_gain=scaled / base if base else 0.0)
