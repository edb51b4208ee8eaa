"""Public NIC-kernel API with backend dispatch.

Two implementations per op:
  * the hand-written CUDA kernel — taken for tensors on a CUDA device;
  * the plain PyTorch version   — taken for tensors on the CPU.

``impl=None`` dispatches by the tensors' device. ``impl="torch"`` forces the
plain version on any device: only the tests and ``chip_smoke.py`` use it, to
hold a kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import crypto as _crypto
from repro_torch.kernels import dfa_regex as _dfa
from repro_torch.kernels import ref as _ref

build_aho_corasick = _ref.build_aho_corasick

IMPLS = (None, "torch")


def _check_impl(impl: Optional[str]) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def regex_scan(payload, length, table, out_count, *,
               impl: Optional[str] = None):
    _check_impl(impl)
    if impl == "torch":
        return _dfa.dfa_scan_torch(payload, length, table, out_count)
    return _dfa.dfa_regex(payload, length, table, out_count)


def cipher(words, key, *, impl: Optional[str] = None):
    _check_impl(impl)
    if impl == "torch":
        return _crypto.arx_cipher_torch(words, key)
    return _crypto.arx_cipher(words, key)


def digest(words, key, *, impl: Optional[str] = None):
    _check_impl(impl)
    if impl == "torch":
        return _crypto.keyed_hash_torch(words, key)
    return _crypto.keyed_hash(words, key)
