"""Synthetic traffic generation — the DPDK-Pktgen / MACCDC-replay stand-in.

Deterministic (seeded) flows of 1500 B packets; a configurable fraction of
payloads embed rule-matching byte patterns so regex stages do real work.
``synth_packets`` draws flows uniformly; ``synth_packets_weighted`` assigns
packets to flows by an explicit probability vector (heavy-tailed Pareto
flow-size mixes).

The bytes come from numpy ``default_rng`` streams, never ``torch.Generator``,
so a seed gives byte-identical batches in the JAX package and here; the
finished arrays are copied to ``device`` once.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph import PKT_BYTES, PacketBatch, make_packets

DEFAULT_PATTERNS = ("attack", "GET /admin")


def _payloads(rng: np.random.Generator, batch: int, pkt_bytes: int,
              embed_patterns: Sequence[str], embed_frac: float) -> np.ndarray:
    payload = rng.integers(0, 256, size=(batch, pkt_bytes), dtype=np.uint8)
    # Embed known patterns into a fraction of packets (MACCDC has hits too).
    n_embed = int(batch * embed_frac)
    for i in range(n_embed):
        pat = embed_patterns[i % len(embed_patterns)].encode()
        pos = rng.integers(0, pkt_bytes - len(pat))
        payload[i, pos:pos + len(pat)] = np.frombuffer(pat, dtype=np.uint8)
    return payload


def _five_tuple(flows: np.ndarray, flow_base: int = 0) -> np.ndarray:
    """5-tuples for a per-packet flow-index vector; `flow_base` offsets the
    address space so different tenants never share flow ids."""
    batch = flows.shape[0]
    f = flows + flow_base
    five = np.zeros((batch, 5), dtype=np.int32)
    five[:, 0] = 0x0A000000 + f              # src ip per flow
    five[:, 1] = 0x0A800000 + (f // 4)       # dst ip
    five[:, 2] = 1024 + (f % 60000)          # sport
    five[:, 3] = 443                         # dport
    five[:, 4] = 6                           # TCP
    return five


def _build(payload: np.ndarray, pkt_bytes: int, flows: np.ndarray,
           flow_base: int, device) -> PacketBatch:
    length = np.full((payload.shape[0],), pkt_bytes, dtype=np.int32)
    return make_packets(torch.from_numpy(payload), torch.from_numpy(length),
                        torch.from_numpy(_five_tuple(flows, flow_base)),
                        device=device)


def synth_packets(batch: int = 256, num_flows: int = 32, seed: int = 0,
                  pkt_bytes: int = PKT_BYTES,
                  embed_patterns: Sequence[str] = DEFAULT_PATTERNS,
                  embed_frac: float = 0.1, device="cuda") -> PacketBatch:
    rng = np.random.default_rng(seed)
    payload = _payloads(rng, batch, pkt_bytes, embed_patterns, embed_frac)
    flows = rng.integers(0, num_flows, size=(batch,))
    return _build(payload, pkt_bytes, flows, 0, device)


def pareto_flow_weights(num_flows: int, alpha: float, seed: int) -> np.ndarray:
    """Normalized heavy-tailed flow popularity (Pareto shape `alpha`; smaller
    alpha => heavier tail / more elephant flows). Deterministic per seed."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(alpha, size=num_flows) + 1.0
    return w / w.sum()


def synth_packets_weighted(batch: int, num_flows: int,
                           weights: Optional[np.ndarray] = None,
                           seed: int = 0, pkt_bytes: int = PKT_BYTES,
                           flow_base: int = 0,
                           embed_patterns: Sequence[str] = DEFAULT_PATTERNS,
                           embed_frac: float = 0.1,
                           device="cuda") -> PacketBatch:
    """Like synth_packets but packets pick flows per `weights` (heavy-tailed
    traffic: a few elephant flows carry most packets, exercising the TO's
    spill path), with a per-tenant `flow_base` address-space offset."""
    rng = np.random.default_rng(seed)
    payload = _payloads(rng, batch, pkt_bytes, embed_patterns, embed_frac)
    if weights is None:
        flows = rng.integers(0, num_flows, size=(batch,))
    else:
        flows = rng.choice(num_flows, size=batch, p=weights)
    return _build(payload, pkt_bytes, flows, flow_base, device)
