"""Scenario-driven multi-tenant traffic generation (Meili-Serve).

Every generator is seeded and deterministic: the offered-rate series is a
pure function of (spec, tick) plus a seeded jitter draw, and per-tick packet
batches come from ``np.random.default_rng((seed, tenant_idx, tick))`` so two
runs of the same scenario are bit-identical (the efficiency comparator runs
the SAME traffic against all three deployment modes).

Patterns:
  constant  — flat at peak_gbps;
  bursty    — on/off square wave (duty cycle, phase-staggered per tenant);
  diurnal   — raised-cosine day/night cycle between trough_frac and 1.0;
  flash     — square wave like bursty, but the "on" window multiplies peak
              by surge_frac (>1 = a flash crowd exceeding the contract);
              run un-staggered it models correlated cross-tenant bursts
              with no multiplexing headroom;
Flow sizes are heavy-tailed (Pareto weights over the tenant's flow space),
so a few elephant flows carry most packets and the TO's spill path stays
exercised. Tenant churn (arrive/depart) lives on TenantSpec and is driven by
the runtime, not the traffic process.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from repro_torch.apps.packets import (pareto_flow_weights,
                                     synth_packets_weighted)
from repro_torch.core.graph import PacketBatch

# Flow-id address-space stride between tenants (flow tables never collide).
FLOW_BASE_STRIDE = 1 << 20


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    pattern: str = "constant"     # constant | bursty | diurnal
    peak_gbps: float = 10.0
    trough_frac: float = 0.25     # off/night rate as a fraction of peak
    period_ticks: int = 32
    duty: float = 0.5             # bursty: fraction of the period spent "on"
    phase_ticks: int = 0
    jitter_frac: float = 0.03     # deterministic multiplicative jitter
    num_flows: int = 24
    tail_alpha: float = 1.3       # Pareto shape (smaller = heavier tail)
    surge_frac: float = 1.0       # flash: on-window multiplier over peak
    flow_churn_per_tick: int = 0  # megaflow: flow-id window slide per tick


class ScenarioWorkload:
    def __init__(self, specs: Dict[str, TrafficSpec], seed: int = 0,
                 flow_base_stride: int = FLOW_BASE_STRIDE):
        self.specs = dict(specs)
        self.seed = seed
        self.flow_base_stride = flow_base_stride
        self._idx = {t: i for i, t in enumerate(self.specs)}
        self._weights = {
            t: pareto_flow_weights(sp.num_flows, sp.tail_alpha,
                                   seed=(seed * 1000003 + self._idx[t]))
            for t, sp in self.specs.items()}

    def tenants(self):
        return list(self.specs)

    # -- offered rate ---------------------------------------------------------
    def offered_gbps(self, tenant: str, tick: int) -> float:
        sp = self.specs[tenant]
        t = (tick + sp.phase_ticks) % max(1, sp.period_ticks)
        if sp.pattern == "constant":
            rate = sp.peak_gbps
        elif sp.pattern == "bursty":
            on = t < sp.duty * sp.period_ticks
            rate = sp.peak_gbps if on else sp.peak_gbps * sp.trough_frac
        elif sp.pattern == "diurnal":
            x = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / sp.period_ticks))
            rate = sp.peak_gbps * (sp.trough_frac + (1.0 - sp.trough_frac) * x)
        elif sp.pattern == "flash":
            on = t < sp.duty * sp.period_ticks
            rate = (sp.peak_gbps * sp.surge_frac if on
                    else sp.peak_gbps * sp.trough_frac)
        else:
            raise ValueError(f"unknown traffic pattern {sp.pattern!r}")
        if sp.jitter_frac > 0:
            rng = np.random.default_rng((self.seed, self._idx[tenant], tick))
            rate *= 1.0 + sp.jitter_frac * (2.0 * rng.random() - 1.0)
        return max(0.0, rate)

    # -- representative packet batch -----------------------------------------
    def batch_for(self, tenant: str, tick: int, max_pkts: int = 192,
                  pkt_bytes: int = 192,
                  device="cuda") -> Optional[PacketBatch]:
        """A scaled-down representative batch for the fused data plane: size
        proportional to the tick's offered rate, flows heavy-tailed, flow-id
        space disjoint per tenant. The packets are drawn with numpy, as the
        JAX package draws them, and land on ``device``."""
        sp = self.specs[tenant]
        offered = self.offered_gbps(tenant, tick)
        if offered <= 0.0 or sp.peak_gbps <= 0.0:
            return None
        n = max(8, int(round(max_pkts * offered / sp.peak_gbps)))
        # Megaflow churn: slide the flow-id window by flow_churn_per_tick
        # ids per tick — each tick retires that many old flows and births
        # that many new ones (short-lived-flow turnover; the Pareto weight
        # profile is stationary relative to the window).
        drift = sp.flow_churn_per_tick * tick
        return synth_packets_weighted(
            batch=n, num_flows=sp.num_flows, weights=self._weights[tenant],
            seed=(self.seed, self._idx[tenant], tick), pkt_bytes=pkt_bytes,
            flow_base=self._idx[tenant] * self.flow_base_stride + drift,
            device=device)


# -- scenario catalog ---------------------------------------------------------

def _staggered(contracts: Dict[str, float], seed: int, **kw) -> ScenarioWorkload:
    specs = {}
    for i, (t, peak) in enumerate(contracts.items()):
        specs[t] = TrafficSpec(peak_gbps=peak,
                               phase_ticks=i * kw.get("stagger", 0), **{
                                   k: v for k, v in kw.items()
                                   if k != "stagger"})
    return ScenarioWorkload(specs, seed=seed)


def steady(contracts: Dict[str, float], seed: int = 0) -> ScenarioWorkload:
    """Flat load at ~70% of contract — the sanity scenario."""
    return _staggered({t: 0.7 * c for t, c in contracts.items()}, seed,
                      pattern="constant")


def bursty(contracts: Dict[str, float], seed: int = 0) -> ScenarioWorkload:
    """On/off square waves at contract peak, phases staggered across tenants
    so the pool multiplexes offsetting bursts (the consolidation win)."""
    return _staggered(contracts, seed, pattern="bursty", duty=0.45,
                      period_ticks=16, trough_frac=0.15, stagger=3)


def diurnal(contracts: Dict[str, float], seed: int = 0) -> ScenarioWorkload:
    """Day/night raised-cosine cycles, staggered like tenants in different
    timezones; troughs at 20% of contract."""
    return _staggered(contracts, seed, pattern="diurnal", period_ticks=48,
                      trough_frac=0.2, stagger=8)


def churn(contracts: Dict[str, float], seed: int = 0) -> ScenarioWorkload:
    """Deep on/off waves with short periods — maximum scale-cycle pressure.

    Paired with a churning tenant mix (arrivals/departures on TenantSpec,
    see ``tenants.churn_tenant_mix``) this is the scenario that decays
    Algorithm-2 locality: every trough shrinks allocations, every burst
    re-grows them into whatever holes departures left behind."""
    return _staggered(contracts, seed, pattern="bursty", duty=0.4,
                      period_ticks=20, trough_frac=0.15, stagger=4)


def flash_crowd(contracts: Dict[str, float], seed: int = 0,
                crowd: Optional[str] = None,
                surge: float = 2.5) -> ScenarioWorkload:
    """Correlated cross-tenant bursts with NO multiplexing headroom: every
    tenant peaks in the same window (no stagger), and one *crowd* tenant
    (default: the largest contract) surges to ``surge``x its contract —
    demand its quota does not cover. The QoS isolation scenario: without a
    governor the crowd's over-scaling strips the headroom the in-quota
    tenants need to re-climb out of their troughs; with the governor the
    crowd queues behind its own quota and degrades only itself."""
    if crowd is None:
        crowd = max(contracts, key=lambda t: (contracts[t], t))
    specs = {}
    for t, peak in contracts.items():
        specs[t] = TrafficSpec(pattern="flash", peak_gbps=peak,
                               period_ticks=24, duty=0.5, trough_frac=0.25,
                               phase_ticks=0,     # correlated: all together
                               surge_frac=surge if t == crowd else 1.0)
    return ScenarioWorkload(specs, seed=seed)


def adversarial_churn(contracts: Dict[str, float],
                      seed: int = 0) -> ScenarioWorkload:
    """Admission pressure at peak: correlated near-contract load (high duty,
    no stagger, shallow troughs) so churn arrivals — wave-2 tenants of
    ``churn_tenant_mix`` land mid-run — must be admitted while the pool is
    as full as it ever gets. Strict admission + the governor's headroom
    ledger decide who gets in; nobody already admitted may be harmed."""
    specs = {}
    for t, peak in contracts.items():
        specs[t] = TrafficSpec(pattern="bursty", peak_gbps=peak,
                               period_ticks=16, duty=0.75, trough_frac=0.5,
                               phase_ticks=0)     # correlated peaks
    return ScenarioWorkload(specs, seed=seed)


def chaos(contracts: Dict[str, float], seed: int = 0) -> ScenarioWorkload:
    """Moderate staggered load for the fault-injection A/B: square waves at
    ~3/4 of contract with real troughs. The stressor here is the fault plan,
    not the traffic — the load leaves enough headroom that recovery (backoff
    re-admission, brownout partial grants) has capacity to re-place into
    when NICs revive, while peaks are high enough that a gray NIC's silent
    degradation shows up as sustained achieved-vs-expected deviation."""
    return _staggered({t: 0.75 * c for t, c in contracts.items()}, seed,
                      pattern="bursty", duty=0.5, period_ticks=16,
                      trough_frac=0.3, stagger=3)


def megaflow(contracts: Dict[str, float], seed: int = 0,
             concurrent_flows: int = 100_000,
             churn_frac: float = 0.005) -> ScenarioWorkload:
    """CDN / mobile-gateway regime: 10⁵–10⁶ concurrent short-lived flows
    with heavy per-tick churn. Steady near-peak rate so batches
    are dense; each tick ``churn_frac`` of the flow window turns over —
    the traffic the megaflow cache exists for. Mice-dominated: tail_alpha
    is high (near-uniform mice, 1-2 packets per flow per batch) so the
    whole flow window is genuinely live — with a CDN-atypical heavy tail
    (alpha ~1.1) most of the window would never be sampled at all and the
    "concurrent flow count" would be fiction. Tenant flow-id spaces use a
    wide stride so 10⁶-flow windows plus drift never collide (and stay
    inside the int32 five-tuple address space for a handful of tenants)."""
    specs = {}
    for t, peak in contracts.items():
        # jitter 0: batch size stays constant tick to tick — the stressor
        # here is flow-space churn, and a drifting batch size would measure
        # eager pad/slice recompiles instead of classification cost.
        specs[t] = TrafficSpec(pattern="constant", peak_gbps=0.9 * peak,
                               num_flows=concurrent_flows, tail_alpha=6.0,
                               jitter_frac=0.0,
                               flow_churn_per_tick=max(
                                   1, int(concurrent_flows * churn_frac)))
    return ScenarioWorkload(specs, seed=seed, flow_base_stride=1 << 28)


SCENARIOS = {"steady": steady, "bursty": bursty, "diurnal": diurnal,
             "churn": churn, "flash_crowd": flash_crowd,
             "adversarial_churn": adversarial_churn, "chaos": chaos,
             "megaflow": megaflow}


def make_scenario(name: str, contracts: Dict[str, float],
                  seed: int = 0, **kw) -> ScenarioWorkload:
    return SCENARIOS[name](contracts, seed=seed, **kw)
