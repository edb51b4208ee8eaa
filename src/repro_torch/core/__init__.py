"""Meili core on PyTorch.

Programming model (graph, accel), the scalable data plane (replication,
ringbuffer, orchestrator, flow cache, executor, state_engine), the unified
control plane (pool, allocation, profiler, the controller with its QoS
governor and defragmentation, and the governor's DWRR tick as a tensor
program on the card in sched_kernel), and a discrete-event timing
simulator (sim) used to validate the pipeline math without NIC hardware.
"""

from repro_torch.core.replication import (num_replication, num_pipelines,
                                          pipeline_throughput, efficiency,
                                          full_replication)
from repro_torch.core.allocation import (resource_alloc, Allocation, commit,
                                         release)
from repro_torch.core.graph import (MeiliApp, PacketBatch, FlowBatch,
                                    Function, make_packets, run_pipeline,
                                    PKT_BYTES)
from repro_torch.core.pool import (Pool, NicSpec, paper_cluster, tpu_pod_pool,
                                   CPU)
from repro_torch.core.controller import MeiliController, Deployment
from repro_torch.core.orchestrator import TrafficOrchestrator
from repro_torch.core.executor import ParallelDataPlane, PipelineRunner
from repro_torch.core.state_engine import (StateService, bounded_sync,
                                           bounded_sync_deltas)
from repro_torch.core.profiler import (measure_app, synthetic_profile,
                                       AppProfile)
from repro_torch.core.qos import (ResourceGovernor, TenantQuota, ScaleVerdict,
                                  quota_from_sla)
