"""ARX cipher / keyed-hash rounds — AES & SHA accelerator analogs.

An 8-round ARX permutation (add-rotate-xor) over uint32 payload words and a
keyed fold digest that chains over each row's words. Payloads are packed to
words outside the kernels (``core.accel``). On CUDA tensors ``arx_cipher``
and ``keyed_hash`` launch the hand-written kernels in ``csrc/crypto.cu``; on
CPU tensors they run the plain PyTorch versions beside them, which are also
the kernels' oracles on the card. Not cryptographically secure (structural
analog only).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _u32

ROUNDS = 8
GOLDEN = 0x9E3779B9


# -- plain versions --------------------------------------------------------------

def arx_cipher_torch(words: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """words: (..., W) uint32, key: (>=4,) uint32 -> (..., W) uint32. Each
    word's column index (its lane) enters every round."""
    x = _u32.widen(words)
    k = _u32.widen(key.to(words.device))
    lanes = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    for r in range(ROUNDS):
        rk = (k[r % 4] + r * GOLDEN) & _u32.MASK
        x = (x + rk) & _u32.MASK
        x = _u32.rotl(x, 5) ^ ((x + lanes) & _u32.MASK)
        x = ((x ^ _u32.rotl(x, 13)) + _u32.rotl(x, 7)) & _u32.MASK
    return _u32.narrow(x)


def keyed_hash_torch(words: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """words: (B, W) uint32, key: (>=4,) uint32 -> (B, 4) uint32 digest; a
    serial chain over the W word columns of every row."""
    x = _u32.widen(words)
    k = _u32.widen(key.to(words.device))
    B, W = x.shape
    h0, h1, h2, h3 = (k[i].expand(B) for i in range(4))
    for j in range(W):
        n0 = (h0 + x[:, j]) & _u32.MASK
        n1 = h1 ^ _u32.rotl(n0, 11)
        n2 = (h2 + _u32.rotl(n1, 7)) & _u32.MASK
        n3 = h3 ^ ((n2 + GOLDEN) & _u32.MASK)
        h0, h1, h2, h3 = n1, n2, n3, n0
    return _u32.narrow(torch.stack([h0, h1, h2, h3], dim=1))


# -- kernels -----------------------------------------------------------------------

def _check(name: str, words: torch.Tensor, key: torch.Tensor):
    dev = _build.require_cuda(name, words, key)
    _build.require_dtype(name, "words", words, torch.uint32)
    _build.require_dtype(name, "key", key, torch.uint32)
    if words.dim() != 2 or key.shape != (4,):
        raise ValueError(f"{name}: words must be (B, W) and key (4,), got "
                         f"{tuple(words.shape)} and {tuple(key.shape)}")
    return dev


def arx_cipher_cuda(words: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    name = "arx_cipher"
    key = key[:4].contiguous()
    dev = _check(name, words, key)
    B, W = words.shape
    # the output sits where the words do within a 16-byte chunk, so the
    # kernel's vector loads and stores line up (payload views may start at
    # any 4-byte offset)
    skew = words.data_ptr() % 16 // 4
    out = torch.empty(B * W + 3, dtype=torch.uint32, device=dev)
    out = out[skew:skew + B * W].view(B, W)
    _build.launch(name, dev, words.data_ptr(), B, W, key.data_ptr(),
                  out.data_ptr())
    return out


def keyed_hash_cuda(words: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    name = "keyed_hash"
    key = key[:4].contiguous()
    dev = _check(name, words, key)
    B, W = words.shape
    out = torch.empty((B, 4), dtype=torch.uint32, device=dev)
    _build.launch(name, dev, words.data_ptr(), B, W, key.data_ptr(),
                  out.data_ptr())
    return out


def arx_cipher(words: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """(B, W) uint32 ciphertext: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if words.is_cuda:
        return arx_cipher_cuda(words, key)
    return arx_cipher_torch(words, key)


def keyed_hash(words: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """(B, 4) uint32 digest: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if words.is_cuda:
        return keyed_hash_cuda(words, key)
    return keyed_hash_torch(words, key)
