"""The six evaluation applications (paper Appendix F, Table 3) as Meili apps.

| App                 | Abs.   | Stateful | #fn | Resources          |
| Intrusion Detection | packet |   yes    |  3  | CPU, regex         |
| IPComp Gateway      | packet |   no     |  2  | CPU, compression   |
| IPsec Gateway       | packet |   no     |  4  | CPU, regex, AES    |
| Firewall            | packet |   yes    |  2  | CPU                |
| Flow Monitor        | packet |   yes    |  2  | CPU                |
| L7 Load Balancer    | socket |   yes    |  1  | CPU                |

UCFs are PyTorch functions over PacketBatch. IPsec Gateway follows
Listing 1: ddos_check -> url_check (regex) -> ipsec (encap+sha) -> AES.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.core import accel
from repro_torch.core.graph import FlowBatch, MeiliApp, PacketBatch
from repro_torch.kernels import _u32

SNORT_RULES = ["attack", "GET /admin", "cmd.exe", "/etc/passwd", "SELECT *"]
DDOS_THRESHOLD = 1.2


# --------------------------------------------------------------------------
# Shared UCFs
# --------------------------------------------------------------------------

def _byte_hist(payload: torch.Tensor, nbins: int = 16) -> torch.Tensor:
    """(B, L) bytes -> (B, nbins) normalized histogram over high nibbles.

    Counted with one bincount over row-offset bins instead of a (B, L,
    nbins) one-hot: the counts are exact integers either way, so the
    float32 histogram is the same, without the one-hot's B·L·nbins floats.
    """
    B = payload.shape[0]
    rows = torch.arange(B, dtype=torch.int32, device=payload.device) * nbins
    bins = (payload >> 4).to(torch.int32) + rows[:, None]        # (B, L)
    h = torch.bincount(bins.reshape(-1), minlength=B * nbins)
    h = h.reshape(B, nbins).to(torch.float32)
    return h / torch.clamp_min(h.sum(dim=1, keepdim=True), 1.0)


def _entropy(p: torch.Tensor) -> torch.Tensor:
    return -(p * torch.log2(torch.clamp_min(p, 1e-12))).sum(dim=-1)


def ddos_margin(pkt: PacketBatch) -> torch.Tensor:
    """Listing 1's entropy margin sum_ent - joint_ent, (B,) float32."""
    h1 = _byte_hist(pkt.payload[:, :750])
    h2 = _byte_hist(pkt.payload[:, 750:])
    sum_ent = _entropy(h1) + _entropy(h2)
    joint = _entropy((h1 + h2) / 2.0)
    return sum_ent - joint


def ddos_check(pkt: PacketBatch) -> torch.Tensor:
    """Listing 1 structure (sum_ent vs joint_ent): flood traffic is
    repetitive/low-entropy, so packets whose entropy margin collapses below
    THRESHOLD are flagged and dropped."""
    ddos_flag = ddos_margin(pkt) < DDOS_THRESHOLD
    return ~ddos_flag                                          # keep-mask


def url_filter(pkt: PacketBatch) -> torch.Tensor:
    """Post-regex verdict: drop packets with any rule hit."""
    return pkt.meta["match_num"] == 0


def encap(pkt: PacketBatch) -> PacketBatch:
    """ESP-style encap: bump proto, record SPI + original length in meta."""
    ft = pkt.five_tuple.clone()
    ft[:, 4] = 50                                              # proto = ESP
    return dataclasses.replace(pkt, five_tuple=ft).with_meta(
        spi=pkt.length * 0 + 0x1001, orig_len=pkt.length)


# --------------------------------------------------------------------------
# The applications
# --------------------------------------------------------------------------

def intrusion_detection(rules=SNORT_RULES, impl=None) -> MeiliApp:
    """3 functions: flow extraction, DPI regex, verdict. CPU + regex."""
    app = MeiliApp("intrusion-detection")
    app.flow_ext(lambda p: p.five_tuple[:, 0] ^ p.five_tuple[:, 2],
                 window=128, slide=64, name="flow_ext")
    app.accel(accel.regex(rules, impl=impl, name="dpi_regex"))
    app.pkt_flt(url_filter, name="verdict")
    app.declare_state("id_alerts", "full-access")
    return app


def ipcomp_gateway(impl=None) -> MeiliApp:
    """2 functions: encap + compression (RFC 3173). CPU + compression."""
    app = MeiliApp("ipcomp-gateway")
    app.pkt_trans(encap, name="ipcomp_encap")
    app.accel(accel.compression(rt=0.5, name="compress"))
    return app


def ipsec_gateway(rules=SNORT_RULES, impl=None) -> MeiliApp:
    """Listing 1 verbatim: ddos_check, url_check (regex), ipsec(encap+sha), AES.

    4 functions over CPU + regex + AES — deployable only by pooling BF-2
    (regex) with Pensando (AES): the paper's headline heterogeneity case.
    """
    app = MeiliApp("ipsec-gateway")
    app.pkt_flt(ddos_check, name="ddos_check")
    app.accel(accel.regex(rules, impl=impl, name="url_check"))

    def ipsec(pkt: PacketBatch) -> PacketBatch:
        return encap(pkt)

    app.pkt_trans(ipsec, name="ipsec_encap")
    app.accel(accel.sha(key=(7, 11, 13, 17), impl=impl, name="sha"))
    app.accel(accel.AES(key=(1, 2, 3, 4), impl=impl, name="aes"))
    return app


def firewall() -> MeiliApp:
    """2 functions: 5-tuple rule match + connection tracking. CPU only."""
    app = MeiliApp("firewall")

    def rule_match(pkt: PacketBatch) -> torch.Tensor:
        blocked_port = pkt.five_tuple[:, 3] == 23               # telnet
        blocked_src = ((pkt.five_tuple[:, 0] >> 24) & 0xFF) == 0xC0  # 192.0.0.0/8
        return ~(blocked_port | blocked_src)

    app.pkt_flt(rule_match, name="rule_match")

    def conn_track(pkt: PacketBatch, flows: FlowBatch) -> FlowBatch:
        seen = pkt.mask.to(torch.int32)
        return dataclasses.replace(flows, meta={**flows.meta, "conn_pkts": seen})

    app.flow_trans(conn_track, name="conn_track")
    app.declare_state("conn_table", "full-access")
    return app


def flow_monitor() -> MeiliApp:
    """2 functions: flow extraction + COMPUTE aggregation. CPU only.
    Uses the COMPUTE operator with a non-external-write pattern (paper §7)."""
    app = MeiliApp("flow-monitor")
    app.flow_ext(lambda p: p.five_tuple[:, 0], window=256, slide=256,
                 name="flow_ext")

    def metrics(pkt: PacketBatch, flows: FlowBatch) -> FlowBatch:
        return dataclasses.replace(flows, meta={
            **flows.meta,
            "pkt_count": pkt.mask.to(torch.int32),
            "byte_count": pkt.length * pkt.mask.to(torch.int32)})

    app.flow_trans(metrics, name="flow_metrics")
    app.declare_state("flow_counters", "non-external-write")
    return app


def l7_load_balancer(num_backends: int = 8) -> MeiliApp:
    """1 socket function: epoll_in — authenticate (hmac), rate-limit,
    redirect to a backend (Appendix B's API gateway shape)."""
    app = MeiliApp("l7-load-balancer")
    app.reg_sock()

    def epoll_in(pkt: PacketBatch) -> PacketBatch:
        # uint32 sum of the first 64 bytes times 2654435761, mod 2^32.
        total = pkt.payload[:, :64].to(torch.int64).sum(dim=1)
        hmac = _u32.mul(total, 2654435761)
        backend = (hmac % num_backends).to(torch.int32)
        return pkt.with_meta(hmac=_u32.narrow(hmac), backend=backend)

    app.epoll(epoll_in, name="epoll_in")
    app.declare_state("lb_sessions", "full-access")
    return app


def ALL_APPS(impl=None) -> Dict[str, MeiliApp]:
    return {
        "ID": intrusion_detection(impl=impl),
        "ICG": ipcomp_gateway(impl=impl),
        "ISG": ipsec_gateway(impl=impl),
        "FW": firewall(),
        "FM": flow_monitor(),
        "LLB": l7_load_balancer(),
    }


def app_resources(app: MeiliApp) -> List[str]:
    return sorted({f.resource for f in app.stages})
