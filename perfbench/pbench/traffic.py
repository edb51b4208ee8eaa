"""The general traffic generator: a mix file's parameters in, token rows
out.

A mix (``traffic/<name>.json``) gives ``generator`` and its parameters.
``packed_documents`` is the benchmark's frozen copy of the program's
synthetic stream (``data/pipeline.py``): documents of exponential length
(mean ``mean_doc_len``, at least 8) drawn from a Zipfian unigram model
(exponent ``zipf_a``) with a little noise, packed with ``eos`` separators
into rows of ``seq_len`` tokens, no padding. Batch ``i`` of a seed is a
pure function of (seed, i), so every seed gives the same sizes and only
the tokens differ.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

SEED_MASK = 2**64 - 1


def _document(rng: np.random.Generator, vocab: int, mean_len: int,
              zipf_a: float) -> np.ndarray:
    n = max(8, int(rng.exponential(mean_len)))
    base = rng.zipf(zipf_a, size=n).astype(np.int64)
    return (base + rng.integers(0, 7, size=n)) % (vocab - 2) + 2


def pack_documents(sample_doc: Callable[[], np.ndarray], seq_len: int,
                   eos: int) -> np.ndarray:
    """Documents joined by ``eos`` until ``seq_len`` tokens are filled."""
    out: List[np.ndarray] = []
    n = 0
    while n < seq_len:
        d = sample_doc()
        out.append(d)
        out.append(np.array([eos], dtype=np.int64))
        n += len(d) + 1
    return np.concatenate(out)[:seq_len]


def packed_documents(mix: Dict, vocab: int, seed: int) -> List[np.ndarray]:
    """``mix["batches"]`` batches of (rows, seq_len) int32 tokens."""
    out = []
    for i in range(mix["batches"]):
        rng = np.random.default_rng((seed & SEED_MASK, i))
        doc = lambda: _document(rng, vocab, mix["mean_doc_len"],
                                mix["zipf_a"])
        out.append(np.stack([pack_documents(doc, mix["seq_len"], mix["eos"])
                             for _ in range(mix["rows"])]).astype(np.int32))
    return out


def batches(mix: Dict, vocab: int, seed: int) -> List[np.ndarray]:
    """The mix's batches; a mix names its generator."""
    if mix["generator"] != "packed_documents":
        raise ValueError(f"no traffic generator {mix['generator']!r}")
    return packed_documents(mix, vocab, seed)


def tokens_per_step(mix: Dict) -> int:
    return mix["rows"] * mix["seq_len"]
