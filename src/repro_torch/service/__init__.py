"""Meili-Serve: the multi-tenant SmartNIC-as-a-Service runtime.

Layers a service plane on top of the controller/pool/data-plane stack:

  tenants.py     tenant registry + SLA model + admission control
  workload.py    scenario-driven deterministic traffic generation
  telemetry.py   per-tenant / per-NIC tick telemetry + SLO accounting
  runtime.py     discrete-time service loop + closed-loop autoscaler
  efficiency.py  pooled vs standalone vs microservice comparator (§8, Fig 13)

The port's copy of the JAX package's ``service``: host Python and numpy
over the control plane, with the tenants' data planes, their packet
batches and (with ``RuntimeConfig.vectorized_sched``) the governor's DWRR
tick on the device the runtime is given, the card by default.
"""

from repro_torch.service.tenants import (AdmissionError, TenantRegistry,
                                         TenantSLA, TenantSpec,
                                         default_tenant_mix)
from repro_torch.service.workload import (SCENARIOS, ScenarioWorkload,
                                          TrafficSpec)
from repro_torch.service.telemetry import TelemetryLog, TenantTick
from repro_torch.service.runtime import RuntimeConfig, ServiceRuntime
from repro_torch.service.efficiency import MODES, run_comparison
