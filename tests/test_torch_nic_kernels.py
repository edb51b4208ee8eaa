"""Port NIC kernels (DFA regex, ARX cipher, keyed hash) held against the JAX
package.

The same seeded numpy inputs go through the JAX oracles (``repro.kernels.ref``),
the JAX Pallas kernels in interpret mode, and the port's plain PyTorch
versions. Every output is an integer or byte array, so the tolerance is 0:
bit for bit. The CUDA kernels are held against these plain versions on the
card in ``test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accel as jaccel
from repro.core.graph import make_packets as jmake_packets
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import accel
from repro_torch.core.graph import make_packets
from repro_torch.kernels import _build, crypto, dfa_regex, ops, ref

SNORT = ["attack", "GET /admin", "cmd.exe", "/etc/passwd", "SELECT *"]
RULE_SETS = [SNORT, ["he", "she", "his", "hers"], ["abc", "cab", "bbb"],
             [b"\xff\xfe\x80", b"\x00\x00", "x"]]


def _u32(rng, shape):
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.flat[::7] = 0xFFFFFFFF                   # high bit set, all ones
    w.flat[3::11] = 0x80000000
    return w


def _payload(rng, B, L, rules):
    pay = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    for i in range(B):
        pat = rules[i % len(rules)]
        pat = pat.encode() if isinstance(pat, str) else pat
        if len(pat) < L:
            pos = rng.integers(0, L - len(pat))
            pay[i, pos:pos + len(pat)] = np.frombuffer(pat, np.uint8)
    return pay


# -- DFA ------------------------------------------------------------------------

@pytest.mark.parametrize("rules", RULE_SETS)
def test_aho_corasick_tables_equal(rules):
    t, o = ref.build_aho_corasick(rules)
    jt, jo = jref.build_aho_corasick(rules)
    assert t.dtype == jt.dtype and o.dtype == jo.dtype
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(o, jo)


@pytest.mark.parametrize("B,L,block_b,rules", [
    (4, 64, 2, 0), (8, 96, 4, 1), (2, 128, 2, 2), (16, 256, 8, 3),
    (8, 1500, 8, 0)])
def test_dfa_plain_equals_reference_and_pallas(B, L, block_b, rules):
    rng = np.random.default_rng(B * 1000 + L)
    pats = RULE_SETS[rules]
    table, out = jref.build_aho_corasick(pats)
    pay = _payload(rng, B, L, pats)
    # lengths cover negative, zero, partial, full and past-the-end
    length = rng.integers(-3, L + 6, size=(B,)).astype(np.int32)
    length[:3] = [0, L, L + 5][:B]
    want = np.asarray(jref.dfa_scan(jnp.asarray(pay), jnp.asarray(length),
                                    jnp.asarray(table), jnp.asarray(out)))
    pallas = np.asarray(jops.regex_scan(jnp.asarray(pay), jnp.asarray(length),
                                        table, out, impl="interpret",
                                        block_b=block_b))
    got = ops.regex_scan(torch.from_numpy(pay), torch.from_numpy(length),
                         torch.from_numpy(table), torch.from_numpy(out))
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert want.max() > 0


def test_dfa_counts_overlapping_matches():
    table, out = ref.build_aho_corasick(["he", "she", "his", "hers"])
    pay = torch.from_numpy(np.frombuffer(b"ushers", np.uint8)[None].copy())
    n = ref.dfa_scan(pay, torch.tensor([6]), torch.from_numpy(table),
                     torch.from_numpy(out))
    assert int(n[0]) == 3                       # she, he, hers


# -- crypto ----------------------------------------------------------------------

@pytest.mark.parametrize("B,W,block_b", [(8, 16, 4), (4, 33, 2), (16, 64, 8),
                                         (2, 1, 2)])
def test_cipher_plain_equals_reference_and_pallas(B, W, block_b):
    rng = np.random.default_rng(W)
    w = _u32(rng, (B, W))
    key = _u32(rng, (4,))
    want = np.asarray(jref.arx_cipher(jnp.asarray(w), jnp.asarray(key)))
    pallas = np.asarray(jops.cipher(jnp.asarray(w), jnp.asarray(key),
                                    impl="interpret", block_b=block_b))
    got = ops.cipher(torch.from_numpy(w), torch.from_numpy(key))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert not np.array_equal(want, w)


@pytest.mark.parametrize("B,W,block_b", [(8, 32, 4), (4, 7, 2), (16, 96, 8),
                                         (2, 1, 2)])
def test_digest_plain_equals_reference_and_pallas(B, W, block_b):
    rng = np.random.default_rng(100 + W)
    w = _u32(rng, (B, W))
    key = _u32(rng, (4,))
    want = np.asarray(jref.keyed_hash(jnp.asarray(w), jnp.asarray(key)))
    pallas = np.asarray(jops.digest(jnp.asarray(w), jnp.asarray(key),
                                    impl="interpret", block_b=block_b))
    got = ops.digest(torch.from_numpy(w), torch.from_numpy(key))
    assert got.dtype == torch.uint32 and got.shape == (B, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("L", [64, 250, 257, 1501])
def test_word_packing_and_crypto_stages_equal_reference(L):
    """L not divisible by 4: the tail bytes pass through the cipher."""
    rng = np.random.default_rng(L)
    pay = rng.integers(0, 256, size=(6, L), dtype=np.uint8)
    length = np.full(6, L, np.int32)
    five = rng.integers(0, 2 ** 31, size=(6, 5)).astype(np.int32)
    jb = jmake_packets(jnp.asarray(pay), jnp.asarray(length), jnp.asarray(five))
    tb = make_packets(torch.from_numpy(pay), torch.from_numpy(length),
                      torch.from_numpy(five), device="cpu")
    np.testing.assert_array_equal(accel._payload_words(tb).numpy(),
                                  np.asarray(jaccel._payload_words(jb)))
    for jfn, fn in ((jaccel.AES((5, 6, 7, 8), impl="ref"),
                     accel.AES((5, 6, 7, 8))),
                    (jaccel.sha((9, 9, 9, 9), impl="ref"),
                     accel.sha((9, 9, 9, 9)))):
        jo, to = jfn.ucf(jb), fn.ucf(tb)
        np.testing.assert_array_equal(to.payload.numpy(),
                                      np.asarray(jo.payload))
        for k in jo.meta:
            np.testing.assert_array_equal(to.meta[k].numpy(),
                                          np.asarray(jo.meta[k]))
    enc = accel.AES((5, 6, 7, 8)).ucf(tb).payload.numpy()
    np.testing.assert_array_equal(enc[:, (L // 4) * 4:], pay[:, (L // 4) * 4:])


# -- dispatch rules that hold without a GPU --------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers raise on CPU tensors before building anything;
    only the device dispatch sends CPU tensors to the plain versions."""
    w = torch.zeros((2, 4), dtype=torch.uint32)
    key = torch.zeros(4, dtype=torch.uint32)
    before = _build.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        crypto.arx_cipher_cuda(w, key)
    with pytest.raises(ValueError, match="CUDA"):
        crypto.keyed_hash_cuda(w, key)
    with pytest.raises(ValueError, match="CUDA"):
        dfa_regex.dfa_regex_cuda(torch.zeros((2, 8), dtype=torch.uint8),
                                 torch.zeros(2, dtype=torch.int32),
                                 torch.zeros((1, 256), dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.cipher(w, key, impl="pallas")
    assert _build.launch_counts() == before


def test_build_is_keyed_by_sources_and_flags():
    assert {p.name for p in _build.sources()} == {
        "crypto.cu", "dfa_regex.cu", "flow_lookup.cu", "flash_attention.cu",
        "decode_attention.cu", "ssd_scan.cu"}
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    path = _build.library_path()
    assert path.name == _build.LIB_NAME and path.parent.name == _build._digest()
    assert set(_build.KERNELS.values()) == set(_build.SIGNATURES)
    assert dfa_regex.smem_bytes(43) == 44204
