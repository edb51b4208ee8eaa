"""Deterministic sharded data pipeline, the port's own copy of the
reference's ``data/pipeline.py`` (numpy only; the token stream is the
reference's bit for bit).

Index-based and stateless: batch ``i`` of host ``h`` is a pure function of
(seed, i, h), so a restart resumes exactly (a checkpoint stores only the
step counter). Documents are sampled from a Zipfian token model and packed
into fixed-length sequences with EOS separators.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    seed: int = 0
    eos: int = 1
    mean_doc_len: int = 512

    def _document(self, rng: np.random.Generator) -> np.ndarray:
        n = max(8, int(rng.exponential(self.mean_doc_len)))
        # Zipfian unigram stream with a little Markov structure.
        base = rng.zipf(1.3, size=n).astype(np.int64)
        toks = (base + rng.integers(0, 7, size=n)) % (self.vocab - 2) + 2
        return toks

    def batch(self, index: int, batch_size: int) -> Dict[str, np.ndarray]:
        """Batch ``index``, deterministically."""
        rng = np.random.default_rng((self.seed, index))
        rows = [pack_documents(
            lambda: self._document(rng), self.seq_len, self.eos)
            for _ in range(batch_size)]
        return {"tokens": np.stack(rows).astype(np.int32)}


def pack_documents(sample_doc, seq_len: int, eos: int) -> np.ndarray:
    """Concatenate documents with EOS until seq_len is filled (no padding)."""
    out: List[np.ndarray] = []
    n = 0
    while n < seq_len:
        d = sample_doc()
        out.append(d)
        out.append(np.array([eos], dtype=np.int64))
        n += len(d) + 1
    return np.concatenate(out)[:seq_len]


def host_shard_iterator(ds: SyntheticLMDataset, global_batch: int,
                        host_index: int, host_count: int,
                        start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Each host draws its disjoint slice of every global batch."""
    if global_batch % host_count:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{host_count} hosts")
    per_host = global_batch // host_count
    step = start_step
    while True:
        b = ds.batch(step, global_batch)
        lo = host_index * per_host
        yield {k: v[lo:lo + per_host] for k, v in b.items()}
        step += 1
