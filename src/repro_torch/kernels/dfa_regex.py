"""Multi-pattern DFA scan (Aho-Corasick) — the paper's regex accelerator.

``dfa_regex`` steps each packet through the dense DFA over its valid prefix
and sums ``out_count`` of every state it enters: (B,) int32 match counts.
On a CUDA tensor it launches the hand-written kernel
(``csrc/dfa_regex.cu``: one thread per packet, the table in shared memory);
on a CPU tensor it runs ``dfa_scan_torch``, the plain PyTorch version of
the same walk, which is also the kernel's oracle on the card.

Match semantics: out_count[s] occurrences are credited when entering state
s, for bytes j < length only (``length`` is clamped to [0, L]).
"""
from __future__ import annotations

import torch

from repro_torch import hw
from repro_torch.kernels import _build


def dfa_scan_torch(payload: torch.Tensor, length: torch.Tensor,
                   table: torch.Tensor, out_count: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version: serial per-byte stepping over all B packets at once.
    payload: (B, L) uint8; length: (B,); table: (S, 256); out_count: (S,)."""
    B, L = payload.shape
    dev = payload.device
    tbl = table.to(device=dev, dtype=torch.int64).reshape(-1)
    oc = out_count.to(device=dev, dtype=torch.int32)
    length = length.to(device=dev, dtype=torch.int64)
    state = torch.zeros(B, dtype=torch.int64, device=dev)
    matches = torch.zeros(B, dtype=torch.int32, device=dev)
    for j in range(L):
        valid = j < length
        nxt = tbl[state * 256 + payload[:, j].to(torch.int64)]
        state = torch.where(valid, nxt, state)
        matches += torch.where(valid, oc[state], 0)
    return matches


def smem_bytes(num_states: int) -> int:
    """Shared memory the kernel needs for an S-state table + out_count."""
    return (num_states * 256 + num_states) * 4


def dfa_regex_cuda(payload: torch.Tensor, length: torch.Tensor,
                   table: torch.Tensor, out_count: torch.Tensor
                   ) -> torch.Tensor:
    """Launch the CUDA kernel; every tensor on one CUDA device."""
    name = "dfa_regex"
    dev = _build.require_cuda(name, payload, length, table, out_count)
    _build.require_dtype(name, "payload", payload, torch.uint8)
    _build.require_dtype(name, "length", length, torch.int32)
    _build.require_dtype(name, "table", table, torch.int32)
    _build.require_dtype(name, "out_count", out_count, torch.int32)
    if payload.dim() != 2:
        raise ValueError(f"{name}: payload must be (B, L), got "
                         f"{tuple(payload.shape)}")
    B, L = payload.shape
    S = table.shape[0]
    if (length.shape != (B,) or table.dim() != 2 or table.shape[1] != 256
            or out_count.shape != (S,)):
        raise ValueError(f"{name}: shapes length {tuple(length.shape)}, "
                         f"table {tuple(table.shape)}, out_count "
                         f"{tuple(out_count.shape)} do not fit payload "
                         f"{tuple(payload.shape)}")
    if smem_bytes(S) > hw.SMEM_PER_BLOCK_MAX:
        raise ValueError(f"{name}: a {S}-state table needs {smem_bytes(S)} B "
                         f"of shared memory, more than the "
                         f"{hw.SMEM_PER_BLOCK_MAX} B a block can have")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    _build.launch(name, dev, payload.data_ptr(), B, L, length.data_ptr(),
                  table.data_ptr(), out_count.data_ptr(), S, out.data_ptr())
    return out


def dfa_regex(payload: torch.Tensor, length: torch.Tensor,
              table: torch.Tensor, out_count: torch.Tensor) -> torch.Tensor:
    """(B,) int32 match counts: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if payload.is_cuda:
        return dfa_regex_cuda(payload, length, table, out_count)
    return dfa_scan_torch(payload, length, table, out_count)
