"""Oracles: the Aho-Corasick table compiler, the plain PyTorch version of
each NIC kernel, and the naive attention oracles.

``build_aho_corasick`` is offline numpy rule compilation (the same table,
state for state, as the JAX package builds). The plain versions of the NIC
kernels live beside their kernels' wrappers (``dfa_regex``, ``crypto``) and
are re-exported here under the reference's names. ``mha_ref`` and
``decode_ref`` are the reference's naive softmax attention (full logits,
no blocking), the oracles of the flash and decode kernels; ``ssd_ref`` is
the step-by-step SSM recurrence, the oracle of the SSD chunked scan.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.crypto import arx_cipher_torch as arx_cipher
from repro_torch.kernels.crypto import keyed_hash_torch as keyed_hash
from repro_torch.kernels.dfa_regex import dfa_scan_torch as dfa_scan

__all__ = ["build_aho_corasick", "dfa_scan", "arx_cipher", "keyed_hash",
           "mha_ref", "decode_ref", "ssd_ref"]


def build_aho_corasick(patterns) -> tuple[np.ndarray, np.ndarray]:
    """Compile literal byte patterns into a dense DFA.

    Returns (table, out_count): table[s, b] = next state, out_count[s] = number
    of pattern occurrences ending when entering state s. Offline rule
    compilation — mirrors loading Snort rules into the regex accelerator.
    """
    patterns = [p.encode() if isinstance(p, str) else bytes(p) for p in patterns]
    # Trie build.
    goto = [{}]
    out = [0]
    for pat in patterns:
        s = 0
        for ch in pat:
            if ch not in goto[s]:
                goto.append({})
                out.append(0)
                goto[s][ch] = len(goto) - 1
            s = goto[s][ch]
        out[s] += 1
    # BFS failure links -> dense DFA.
    n = len(goto)
    fail = [0] * n
    table = np.zeros((n, 256), dtype=np.int32)
    q = deque()
    for ch in range(256):
        nxt = goto[0].get(ch, 0)
        table[0, ch] = nxt
        if nxt:
            fail[nxt] = 0
            q.append(nxt)
    while q:
        s = q.popleft()
        out[s] += out[fail[s]]
        for ch in range(256):
            if ch in goto[s]:
                nxt = goto[s][ch]
                fail[nxt] = table[fail[s], ch]
                table[s, ch] = nxt
                q.append(nxt)
            else:
                table[s, ch] = table[fail[s], ch]
    return table, np.asarray(out, dtype=np.int32)


# ---------------------------------------------------------------------------
# Attention oracles.
# ---------------------------------------------------------------------------

def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """Naive softmax attention with GQA. q: (B, Sq, Hq, D), k/v:
    (B, Sk, Hkv, D). Queries occupy the last Sq slots of the Sk timeline;
    ``window``: attend to keys within ``window`` positions back, inclusive
    of self (Gemma-3 local layers). A row with no valid key is NaN, as in
    the reference."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    assert Hq % Hkv == 0
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor, *, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Single-token decode attention. q: (B, Hq, D), k/v: (B, S, Hkv, D),
    kv_len: (B,) valid cache length. Returns (B, Hq, D)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, G, D) * scale
    logits = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    valid = (torch.arange(S, device=q.device)[None]
             < kv_len.to(q.device)[:, None])
    logits = logits.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD oracle (scalar-decay SSM, per-step recurrence).
# ---------------------------------------------------------------------------

def ssd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, h0: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P), a: (B, S, H) decays in (0, 1], b/c: (B, S, H, N),
    h0: (B, H, N, P) initial state (zeros when None). Returns
    (y (B, S, H, P) in x's dtype, h_final (B, H, N, P) f32) of
    h_t = a_t h_{t-1} + b_t ⊗ x_t, y_t = c_t · h_t, one step at a time."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = (a[:, t].float()[..., None, None] * h
             + b[:, t].float()[..., :, None] * x[:, t].float()[..., None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", c[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype), h
