"""Meili core on PyTorch: programming model (graph, accel) and the scalable
data plane (replication, ringbuffer, orchestrator, flow cache, executor)."""

from repro_torch.core.replication import (num_replication, num_pipelines,
                                          pipeline_throughput, efficiency,
                                          full_replication)
from repro_torch.core.graph import (MeiliApp, PacketBatch, FlowBatch,
                                    Function, make_packets, run_pipeline,
                                    PKT_BYTES)
from repro_torch.core.pool import CPU
from repro_torch.core.orchestrator import TrafficOrchestrator
from repro_torch.core.executor import ParallelDataPlane, PipelineRunner
