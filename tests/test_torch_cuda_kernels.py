"""The port's CUDA kernels held against their plain PyTorch versions on the
card.

These tests need a CUDA device and skip without one (the ``cuda`` fixture
decides at run time). They import no JAX, so they run where the port runs:
``python -m pytest -q tests/test_torch_cuda_kernels.py`` on a machine with
an H100 and nvcc. The plain versions are pinned to the JAX package by the
other ``test_torch_*`` files; here every kernel output (integer, bool or
uint32 words) must equal its plain version bit for bit (tolerance 0), and
the data plane on the card must equal the same data plane on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.apps import ALL_APPS, synth_packets
from repro_torch.core.executor import ParallelDataPlane
from repro_torch.core.graph import run_pipeline
from repro_torch.kernels import _build, crypto, dfa_regex
from repro_torch.kernels import flow_lookup as fl
from repro_torch.kernels import ref

SNORT = ["attack", "GET /admin", "cmd.exe", "/etc/passwd", "SELECT *"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a CUDA kernel with its "
                    "plain version on the card")
    return torch.device("cuda")


def _u32(rng, shape):
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.flat[::7] = 0xFFFFFFFF
    return w


def test_dfa_kernel_equals_plain(cuda):
    rng = np.random.default_rng(5)
    table, out = ref.build_aho_corasick(SNORT)
    pay = rng.integers(0, 256, size=(300, 1500), dtype=np.uint8)
    for i in range(0, 300, 3):
        pay[i, 100 + i:106 + i] = np.frombuffer(b"attack", np.uint8)
    length = rng.integers(-2, 1510, size=300).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (pay, length, table, out)]
    before = _build.launch_counts()["dfa_regex"]
    got = dfa_regex.dfa_regex(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts()["dfa_regex"] == before + 1
    assert torch.equal(got, dfa_regex.dfa_scan_torch(*args))
    assert int(got.max()) > 0
    # odd row length: the kernel's byte-at-a-time path
    odd = args[0][:, :1499].contiguous()
    assert torch.equal(dfa_regex.dfa_regex(odd, *args[1:]),
                       dfa_regex.dfa_scan_torch(odd, *args[1:]))


def test_dfa_kernel_large_table_uses_dynamic_shared_memory(cuda):
    """A table above 48 KB opts in to dynamic shared memory."""
    rules = [f"rule{i:03d}x" for i in range(40)]
    table, out = ref.build_aho_corasick(rules)
    assert dfa_regex.smem_bytes(table.shape[0]) > 48 * 1024
    rng = np.random.default_rng(6)
    pay = rng.integers(0, 256, size=(64, 512), dtype=np.uint8)
    pay[::2, 10:18] = np.frombuffer(b"rule007x", np.uint8)
    args = [torch.from_numpy(a).to(cuda) for a in
            (pay, np.full(64, 512, np.int32), table, out)]
    got = dfa_regex.dfa_regex(*args)
    assert torch.equal(got, dfa_regex.dfa_scan_torch(*args))
    assert int(got.sum()) >= 32


@pytest.mark.parametrize("B,W", [(257, 375), (3, 1)])
def test_crypto_kernels_equal_plain(cuda, B, W):
    rng = np.random.default_rng(W)
    w = torch.from_numpy(_u32(rng, (B, W))).to(cuda)
    key = torch.from_numpy(_u32(rng, (4,))).to(cuda)
    for kern, plain in ((crypto.arx_cipher, crypto.arx_cipher_torch),
                        (crypto.keyed_hash, crypto.keyed_hash_torch)):
        got, want = kern(w, key), plain(w, key)
        assert got.dtype == torch.uint32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_lookup_kernel_equals_plain(cuda):
    rng = np.random.default_rng(9)
    cap, window = 1 << 17, 8
    fids = rng.choice(np.int64(1) << 40, size=60_000, replace=False)
    lo, hi = fl.split_fids(fids)
    key_lo = np.zeros(cap, np.uint32)
    key_hi = np.zeros(cap, np.uint32)
    pid = np.full(cap, -1, np.int32)
    ep = np.zeros(cap, np.int32)
    base = fl.bucket_hash(lo, hi) & np.uint32(cap - 1)
    for i in range(fids.size):
        for w in range(window):
            s = (int(base[i]) + w) & (cap - 1)
            if pid[s] < 0:
                key_lo[s], key_hi[s], pid[s] = lo[i], hi[i], i % 8
                ep[s] = i % 3
                break
    q = rng.choice(fids, size=8192)
    q[::3] |= np.int64(1) << 41                  # absent keys
    qlo, qhi = fl.split_fids(q)
    planes = [torch.from_numpy(a).to(cuda) for a in (key_lo, key_hi, pid, ep)]
    ql, qh = torch.from_numpy(qlo).to(cuda), torch.from_numpy(qhi).to(cuda)
    before = _build.launch_counts()["flow_lookup"]
    got = fl.lookup(*planes, ql, qh, 1, window)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flow_lookup"] == before + 1
    want = fl.lookup_torch(*planes, ql, qh, 1, window)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    host = fl.lookup_numpy(key_lo, key_hi, pid, ep, qlo, qhi, 1, window)
    np.testing.assert_array_equal(got[0].cpu().numpy(), host[0])
    assert bool(got[2].any()) and not bool(got[2].all())


def test_kernel_wrappers_reject_bad_input(cuda):
    w = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    key = torch.zeros(4, dtype=torch.uint32, device=cuda)
    with pytest.raises(TypeError):
        crypto.arx_cipher(w, key)
    with pytest.raises(ValueError):
        crypto.keyed_hash(torch.zeros((2, 8), dtype=torch.uint32,
                                      device=cuda)[:, ::2], key)
    with pytest.raises(ValueError):
        crypto.keyed_hash(w.view(torch.uint32), key.cpu())


@pytest.mark.parametrize("name", ["ID", "ICG", "ISG", "FW", "FM", "LLB"])
def test_dataplane_on_card_equals_cpu(cuda, name):
    kw = dict(batch=96, num_flows=12, pkt_bytes=256, seed=7)
    on_card = ParallelDataPlane(ALL_APPS()[name], num_pipelines=4,
                                capacity_per_pipeline=8, device=cuda)
    on_cpu = ParallelDataPlane(ALL_APPS()[name], num_pipelines=4,
                               capacity_per_pipeline=8, device="cpu")
    gb, cb = synth_packets(device=cuda, **kw), synth_packets(device="cpu", **kw)
    _build.reset_launch_counts()
    for _ in range(3):
        got, want = on_card.process(gb), on_cpu.process(cb)
        for x, y in zip(convert.leaves_to_numpy(got),
                        convert.leaves_to_numpy(want)):
            np.testing.assert_array_equal(x, y)
    plain = run_pipeline(ALL_APPS(impl="torch")[name], gb)
    for x, y in zip(convert.leaves_to_numpy(got),
                    convert.leaves_to_numpy(plain)):
        np.testing.assert_array_equal(x, y)
    assert _build.launch_counts()["flow_lookup"] >= 2   # cache hits after 1
