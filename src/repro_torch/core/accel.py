"""Accelerator Function APIs (paper §4.2).

``Meili.regex / Meili.AES / Meili.sha / Meili.compression`` — uniform
invocation over heterogeneous accelerator implementations. Users pass only
the shared parameters (data pointer + rules / key / ratio); Meili binds the
hardware-specific settings (here: kernel impl selection and the device the
constants live on). Each API returns a `Function` stage whose `resource`
field is the accelerator kind Algorithm 2 allocates.

A stage's constants (DFA table and out_count, cipher/digest key) are kept
as numpy arrays on its UCF (``ucf.consts``) and copied to a batch's device
on first use, once per device. The regex stage also keeps the table as its
kernel takes it (packed entries and the synchronisation depth), built on
the host when the rules are set, so no call of the walk copies anything
back from the card.

Payload word-packing (uint8 -> uint32) happens once per stage boundary: for
a contiguous payload whose length is a multiple of 4 it is a zero-copy view
(little-endian words on both the host and the card); otherwise the first
``(L//4)*4`` bytes are copied and the tail bytes pass through unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import pool
from repro_torch.core.graph import Function, PacketBatch
from repro_torch.kernels import dfa_regex, ops


class StageConstants:
    """Named numpy constants of one accelerator stage, copied to each
    device on first use and cached per device.

    ``derive``, where given, computes further constants from the arrays on
    the host (the regex stage's packed table and its synchronisation
    depth); they are recomputed whenever the arrays are replaced, and
    ``derived`` holds them: numpy arrays among them are copied to each
    device beside the arrays, other values stay as they are."""

    def __init__(self, derive: Optional[Callable[..., Dict]] = None,
                 **arrays: np.ndarray):
        self.arrays: Dict[str, np.ndarray] = {}
        self.derived: Dict[str, object] = {}
        self._derive = derive
        self._by_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self.set(**arrays)

    def set(self, **arrays: np.ndarray) -> None:
        """Replace constants (dropping every device copy)."""
        for k, v in arrays.items():
            self.arrays[k] = np.ascontiguousarray(v)
        if self._derive is not None:
            self.derived = dict(self._derive(**self.arrays))
        self._by_device.clear()

    def on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        got = self._by_device.get(device)
        if got is None:
            host = {**self.arrays,
                    **{k: v for k, v in self.derived.items()
                       if isinstance(v, np.ndarray)}}
            got = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in host.items()}
            self._by_device[device] = got
        return got


def _payload_words(batch: PacketBatch) -> torch.Tensor:
    pay = batch.payload
    B, L = pay.shape
    Lw = (L // 4) * 4
    if Lw != L or not pay.is_contiguous() or pay.storage_offset() % 4:
        pay = pay[:, :Lw].contiguous()
    return pay.view(torch.uint32)                    # (B, L//4)


def _words_to_payload(words: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    B, W = words.shape
    out = words.contiguous().view(torch.uint8)       # (B, 4W) little-endian
    L = orig.shape[1]
    return torch.cat([out, orig[:, W * 4:]], dim=1) if W * 4 < L else out[:, :L]


def _prepare_dfa(table: np.ndarray, out_count: np.ndarray) -> Dict:
    """The regex kernel's form of the DFA, built on the host once per rule
    set: the table's entries (with the counts beside them in the wide
    form) and the synchronisation depth. ``prepare`` refuses only what the
    reference cannot walk either (entries outside the table)."""
    try:
        prepared = dfa_regex.prepare(table, out_count)
    except ValueError as err:      # the plain version still runs it
        return {"depth": None, "refused": str(err)}
    return {"packed": prepared.packed, "depth": prepared.depth,
            "counts": prepared.counts}         # counts None: packed form


def _key(key) -> np.ndarray:
    return np.asarray(key, dtype=np.uint32)[:4]


def regex(rules: Sequence[str], *, impl: Optional[str] = None,
          name: str = "regex") -> Function:
    """Multi-pattern matching; match count lands in meta['match_num']."""
    table, out_count = ops.build_aho_corasick(rules)
    consts = StageConstants(derive=_prepare_dfa, table=table,
                            out_count=out_count)

    def ucf(batch: PacketBatch) -> PacketBatch:
        c = consts.on(batch.device)
        if "refused" in consts.derived and batch.payload.is_cuda \
                and impl != "torch":
            raise ValueError(consts.derived["refused"])
        matches = ops.regex_scan(batch.payload, batch.length, c["table"],
                                 c["out_count"], packed=c.get("packed"),
                                 depth=consts.derived["depth"],
                                 counts=c.get("counts"), impl=impl)
        return batch.with_meta(match_num=matches)

    ucf.consts = consts
    return Function(name, "accel", ucf, resource=pool.REGEX,
                    params={"rules": list(rules)})


def AES(key: np.ndarray | Sequence[int], *, impl: Optional[str] = None,
        name: str = "aes") -> Function:
    """Payload encryption in place (ARX analog)."""
    consts = StageConstants(key=_key(key))

    def ucf(batch: PacketBatch) -> PacketBatch:
        words = _payload_words(batch)
        enc = ops.cipher(words, consts.on(batch.device)["key"], impl=impl)
        return dataclasses.replace(batch,
                                   payload=_words_to_payload(enc, batch.payload))

    ucf.consts = consts
    return Function(name, "accel", ucf, resource=pool.CRYPTO)


def sha(key: np.ndarray | Sequence[int] = (1, 2, 3, 4), *,
        impl: Optional[str] = None, name: str = "sha") -> Function:
    """Keyed digest into meta['digest'] (B, 4) uint32 (HMAC stand-in)."""
    consts = StageConstants(key=_key(key))

    def ucf(batch: PacketBatch) -> PacketBatch:
        words = _payload_words(batch)
        return batch.with_meta(digest=ops.digest(
            words, consts.on(batch.device)["key"], impl=impl))

    ucf.consts = consts
    return Function(name, "accel", ucf, resource=pool.CRYPTO)


def compression(rt: float = 0.5, *, name: str = "compression") -> Function:
    """Compression accelerator analog: RLE cost model — computes the
    compressed length into meta['comp_len'] (the NIC engine is an opaque
    throughput box; Meili only needs its latency/throughput shape)."""

    def ucf(batch: PacketBatch) -> PacketBatch:
        pay = batch.payload
        runs = (pay[:, 1:] != pay[:, :-1]).sum(dim=1, dtype=torch.int32) + 1
        # float32 product truncated toward zero, as astype(int32) does.
        est = torch.minimum(runs * 2, (batch.length * rt).to(torch.int32))
        return batch.with_meta(comp_len=est)

    return Function(name, "accel", ucf, resource=pool.COMPRESSION)
