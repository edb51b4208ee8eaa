"""Calibrated paper-cluster cost model for the six evaluation apps.

Single home for the per-stage, per-1500B-packet latencies (µs) on one
resource unit (ARM A72 core or accelerator engine) and the stage->resource
map. Derived from the paper's observable aggregates: Fig 9 single-pipeline
rates, Fig 2 bottleneck structure (L7 Filter regex-bound, Malware Detection
CPU-bound), §8.5 TO overhead. They model the paper's NIC cluster, not the
card: the benchmarks and the service runtime build tenant profiles from
them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.graph import PKT_BYTES
from repro_torch.core.profiler import AppProfile, synthetic_profile

PKT_BITS = PKT_BYTES * 8.0

# Calibrated per-stage latencies (µs per 1500 B packet, one resource unit).
APP_STAGE_LATENCY_US: Dict[str, Dict[str, float]] = {
    # Intrusion Detection [3 fn: CPU, regex]  (CPU-bound like Malware Det.;
    # regex engine ~13 Gbps, matching Fig 2's L7-Filter regex bound)
    "ID": {"flow_ext": 2.20, "dpi_regex": 0.92, "verdict": 1.80},
    # IPComp Gateway [2 fn: CPU, compression]
    "ICG": {"ipcomp_encap": 1.80, "compress": 2.10},
    # IPsec Gateway [4 fn: CPU, regex, AES] — Listing 1
    "ISG": {"ddos_check": 2.00, "url_check": 0.92, "ipsec_encap": 1.00,
            "sha": 1.30, "aes": 1.90},
    # Firewall [2 fn: CPU]  (Fig 9: ~25 Gbps @ 7 pipelines => ~3.7 Gbps each)
    "FW": {"rule_match": 2.90, "conn_track": 3.20},
    # Flow Monitor [2 fn: CPU]
    "FM": {"flow_ext": 2.90, "flow_metrics": 3.20},
    # L7 Load Balancer [socket]  (Fig 9: ~60 Gbps @ 7 => ~8.8 Gbps each)
    "LLB": {"reg_sock": 0.20, "epoll_in": 1.36},
}

# Resource kind per stage (matches apps/nf.py definitions).
APP_STAGE_RESOURCE: Dict[str, Dict[str, str]] = {
    "ID": {"flow_ext": "cpu", "dpi_regex": "regex", "verdict": "cpu"},
    "ICG": {"ipcomp_encap": "cpu", "compress": "compression"},
    "ISG": {"ddos_check": "cpu", "url_check": "regex", "ipsec_encap": "cpu",
            "sha": "crypto", "aes": "crypto"},
    "FW": {"rule_match": "cpu", "conn_track": "cpu"},
    "FM": {"flow_ext": "cpu", "flow_metrics": "cpu"},
    "LLB": {"reg_sock": "cpu", "epoll_in": "cpu"},
}

# Remote hop penalty between stages on different NICs (paper §8.5: ~4.5 µs
# round trip; Table 1 shows +3.75 µs avg for the distributed IPComp GW).
HOP_US = 4.5


def unit_gbps(lat_us: float) -> float:
    """Throughput of one resource unit running a stage (1500 B packets)."""
    return PKT_BITS / (lat_us * 1e-6) / 1e9


def stage_unit_gbps(app_key: str) -> Dict[str, float]:
    return {s: unit_gbps(l) for s, l in APP_STAGE_LATENCY_US[app_key].items()}


def paper_profile(app_key: str, batch_pkts: int = 256) -> AppProfile:
    """An AppProfile for one evaluation app from the calibrated tables.

    Latencies are per *sequence batch* of ``batch_pkts`` packets (the
    profiler's sequence unit), so ``t_s``/``t_p`` come out in the paper's
    per-unit Gbps ranges regardless of batch size.
    """
    lat_us = APP_STAGE_LATENCY_US[app_key]
    l_s = {s: l * 1e-6 * batch_pkts for s, l in lat_us.items()}
    return synthetic_profile(list(lat_us), l_s, PKT_BITS * batch_pkts)
