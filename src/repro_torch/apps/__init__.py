"""The paper's six SmartNIC applications (Appendix F) on the Meili model."""

from repro_torch.apps.nf import (intrusion_detection, ipcomp_gateway,
                                 ipsec_gateway, firewall, flow_monitor,
                                 l7_load_balancer, ALL_APPS, app_resources)
from repro_torch.apps.packets import synth_packets
from repro_torch.apps.profiles import (APP_STAGE_LATENCY_US,
                                       APP_STAGE_RESOURCE, HOP_US,
                                       paper_profile, stage_unit_gbps,
                                       unit_gbps)
