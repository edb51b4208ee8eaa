"""Oracles of the NIC kernels: the Aho-Corasick table compiler and the plain
PyTorch version of each kernel.

``build_aho_corasick`` is offline numpy rule compilation (the same table,
state for state, as the JAX package builds). The plain versions live beside
their kernels' wrappers (``dfa_regex``, ``crypto``) and are re-exported here
under the reference's names.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.kernels.crypto import arx_cipher_torch as arx_cipher
from repro_torch.kernels.crypto import keyed_hash_torch as keyed_hash
from repro_torch.kernels.dfa_regex import dfa_scan_torch as dfa_scan

__all__ = ["build_aho_corasick", "dfa_scan", "arx_cipher", "keyed_hash"]


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
