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

from repro.apps import nf as jnf
from repro.core import accel as jaccel
from repro.core.graph import make_packets as jmake_packets
from repro.kernels import dfa_regex as jdfa
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


def _parity_table():
    """A two-state DFA that flips on byte 1: it remembers the parity of the
    1-bytes forever, so it has no synchronisation depth."""
    table = np.zeros((2, 256), np.int32)
    table[1, :] = 1
    table[0, 1], table[1, 1] = 1, 0
    return table, np.array([0, 1], np.int32)


def test_sync_depth_of_the_rule_sets():
    """d is 11 for the apps' rule set (its longest pattern, "/etc/passwd"),
    the longest pattern of the test rule sets, and None for parity."""
    table, _ = ref.build_aho_corasick(jnf.SNORT_RULES)
    assert table.shape[0] == 43 and dfa_regex.sync_depth(table) == 11
    for rules in RULE_SETS:
        table, _ = jref.build_aho_corasick(rules)
        longest = max(len(r.encode() if isinstance(r, str) else r)
                      for r in rules)
        assert dfa_regex.sync_depth(table) == longest
    assert dfa_regex.sync_depth(_parity_table()[0]) is None
    one = np.zeros((1, 256), np.int32)           # one state: nothing to forget
    assert dfa_regex.sync_depth(one) == 0


@pytest.mark.parametrize("seed", range(6))
def test_sync_depth_is_the_longest_pattern(seed):
    """For an Aho-Corasick table the depth is the longest pattern: from any
    state, the last `longest` bytes decide the state (a shorter string
    leaves the start of the longest pattern undecided)."""
    rng = np.random.default_rng(seed)
    alphabet = rng.integers(0, 256, size=rng.integers(2, 5))
    rules = [bytes(rng.choice(alphabet, size=rng.integers(1, 10)).astype(
        np.uint8)) for _ in range(rng.integers(1, 8))]
    table, out = jref.build_aho_corasick(rules)
    assert dfa_regex.sync_depth(table) == max(len(r) for r in rules)
    # brute force on a few strings: after d bytes every start agrees
    d = max(len(r) for r in rules)
    for _ in range(20):
        w = rng.choice(alphabet, size=d)
        ends = {_walk(table, q, w) for q in range(table.shape[0])}
        assert len(ends) == 1


def _walk(table, state, word):
    for byte in word:
        state = table[state, byte]
    return int(state)


def _rules_with_states(S):
    """Generated rules whose Aho-Corasick table has exactly S states:
    `q{i:03d}zz` rules, then single letters, one state each."""
    def states(rules):
        return ref.build_aho_corasick(rules)[0].shape[0]
    lo, hi = 1, 1000
    while lo < hi:                  # the most rules within S states
        mid = (lo + hi + 1) // 2
        if states([f"q{i:03d}zz" for i in range(mid)]) <= S:
            lo = mid
        else:
            hi = mid - 1
    rules = [f"q{i:03d}zz" for i in range(lo)]
    for ch in "abcdefghijklmnoprstuvwxy":
        if states(rules) == S:
            break
        rules.append(ch)
    assert states(rules) == S
    return rules


def test_prepare_packs_entries_and_refuses_what_does_not_fit():
    """SNORT_RULES packs (next | count << 16). What does not pack, a
    257-state table, a count of 2^16 and negative counts, is taken in the
    wide form (16-bit next states beside int32 counts), as the reference
    takes it: the kernel's segmented walk over it equals the reference's
    ``dfa_regex(interpret=True)``. Refused, as the reference cannot walk
    them either: entries outside [0, S) and shapes other than (S, 256)."""
    table, out = ref.build_aho_corasick(jnf.SNORT_RULES)
    prep = dfa_regex.prepare(table, out)
    assert prep.packed.dtype == np.int32 and prep.depth == 11
    assert prep.form == "packed" and prep.counts is None
    packed = prep.packed.view(np.uint32)
    np.testing.assert_array_equal(packed & 0xFFFF, table)
    np.testing.assert_array_equal(packed >> 16, out[table])
    big = out.copy()
    big[3] = 1 << 16
    rules257 = _rules_with_states(257)
    t257, o257 = ref.build_aho_corasick(rules257)
    rng = np.random.default_rng(257)
    for (t, o, pats) in ((table, big, jnf.SNORT_RULES),
                         (table, out - 2, jnf.SNORT_RULES),
                         (t257, o257, rules257)):
        wide = dfa_regex.prepare(t, o)
        assert wide.form == "wide16" and wide.packed.dtype == np.int16
        np.testing.assert_array_equal(wide.packed.view(np.uint16), t)
        np.testing.assert_array_equal(wide.counts, o)
        assert wide.depth == max(len(p) for p in pats)
        L = 200
        starts = [f for _, f in dfa_regex.segment_bounds(L, 4, wide.depth)]
        pay = _planted(rng, 48, L, pats, starts[1:])
        length = rng.integers(-2, L + 3, size=48).astype(np.int32)
        want = np.asarray(jdfa.dfa_regex(jnp.asarray(pay),
                                         jnp.asarray(length),
                                         jnp.asarray(t), jnp.asarray(o),
                                         interpret=True))
        for segments in (1, 4):
            np.testing.assert_array_equal(dfa_regex.segmented_scan_numpy(
                pay, length, wide, segments), want)
        assert want.max() > 0 or want.min() < 0
    bad = table.copy()
    bad[5, 7] = table.shape[0]
    with pytest.raises(ValueError, match="outside"):
        dfa_regex.prepare(bad, out)
    bad[5, 7] = -1
    with pytest.raises(ValueError, match="outside"):
        dfa_regex.prepare(bad, out)
    with pytest.raises(ValueError, match="not"):
        dfa_regex.prepare(table[:, :255], out)
    with pytest.raises(ValueError, match="not"):
        dfa_regex.prepare(table, out[:-1])
    par = dfa_regex.prepare(*_parity_table())
    assert par.depth is None
    assert dfa_regex.segment_bounds(100, 4, None) == [(0, 0)]


def test_sync_depth_memory_is_bounded():
    """A ~1,000-state Aho-Corasick table: ``prepare`` keeps its memory
    bounded (no S^2 pair table) and finds the exact depth, the longest
    pattern, checked by brute force; a table whose pairs never meet
    (parity over many states) or would pass the budget gives None."""
    import tracemalloc
    rules = [f"q{i:04d}zz" for i in range(320)]
    table, out = ref.build_aho_corasick(rules)
    assert table.shape[0] == 999
    tracemalloc.start()
    prep = dfa_regex.prepare(table, out)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 32 << 20
    assert prep.form == "wide16" and prep.depth == 7
    rng = np.random.default_rng(1)
    alphabet = np.frombuffer(b"q0123zx", np.uint8)
    for _ in range(30):
        w = rng.choice(alphabet, size=prep.depth)
        ends = {_walk(table, q, w) for q in range(0, table.shape[0], 7)}
        assert len(ends) == 1
    cyc = np.tile(np.arange(1, 301, dtype=np.int32)[:, None] % 300, (1, 256))
    assert dfa_regex.sync_depth(cyc) is None     # a 300-state cycle
    noisy = rng.integers(0, 1000, size=(1000, 256)).astype(np.int32)
    assert dfa_regex.sync_depth(noisy) is None   # past the budget


def _planted(rng, B, L, rules, starts):
    """Random payloads with the rules' patterns planted so that each one
    straddles a segment start, starts there, or ends just before it."""
    pay = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    pats = [r.encode() if isinstance(r, str) else r for r in rules]
    for i in range(B):
        for j, s in enumerate(starts):
            pat = pats[(i + j) % len(pats)]
            pos = s - (i % (len(pat) + 2))
            if 0 <= pos and pos + len(pat) <= L:
                pay[i, pos:pos + len(pat)] = np.frombuffer(pat, np.uint8)
    return pay


@pytest.mark.parametrize("segments", [1, 2, 4, 8])
@pytest.mark.parametrize("rules,L", [(0, 1500), (1, 97), (2, 64), (3, 40)])
def test_segmented_walk_equals_reference_and_pallas(rules, L, segments):
    """The kernel's segmented walk (numpy transcription: warm-up of d bytes
    from state 0, counting from the segment's start, the packet's sum)
    equals the serial oracle and the Pallas kernel bit for bit, with the
    patterns planted across every segment boundary and lengths 0, 1, d, L
    and ragged."""
    rng = np.random.default_rng(L * 10 + segments)
    pats = RULE_SETS[rules]
    table, out = jref.build_aho_corasick(pats)
    prep = dfa_regex.prepare(table, out)
    starts = [f for _, f in dfa_regex.segment_bounds(L, segments, prep.depth)]
    B = 48
    pay = _planted(rng, B, L, pats, starts[1:] + [L // 2])
    length = rng.integers(0, L + 1, size=B).astype(np.int32)
    length[:6] = [0, 1, prep.depth, L, L + 7, -2]
    length[6:6 + len(starts)] = [min(L, s + 1) for s in starts]
    got = dfa_regex.segmented_scan_numpy(pay, length, prep, segments)
    want = np.asarray(jref.dfa_scan(jnp.asarray(pay), jnp.asarray(length),
                                    jnp.asarray(table), jnp.asarray(out)))
    pallas = np.asarray(jops.regex_scan(jnp.asarray(pay), jnp.asarray(length),
                                        table, out, impl="interpret",
                                        block_b=16))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    assert want.max() > 0


def test_segmented_walk_without_depth_is_one_segment():
    """A table with no finite depth is walked as one segment, whatever
    number of segments is asked for: it still equals the oracle."""
    table, out = _parity_table()
    prep = dfa_regex.prepare(table, out)
    rng = np.random.default_rng(3)
    pay = rng.integers(0, 3, size=(16, 64), dtype=np.uint8)
    length = rng.integers(0, 65, size=16).astype(np.int32)
    want = np.asarray(jref.dfa_scan(jnp.asarray(pay), jnp.asarray(length),
                                    jnp.asarray(table), jnp.asarray(out)))
    np.testing.assert_array_equal(
        dfa_regex.segmented_scan_numpy(pay, length, prep, 8), want)


def test_dfa_plan_fills_the_card():
    """At the path's 32,768 rows of 1,500 bytes the table leaves room for
    a staged chunk a thread, and 4 segments give every SM a block of
    walks; no finite depth means one segment; a table too large for stages
    reads the payload from device memory."""
    assert dfa_regex.plan(32768, 1500, 43, 11) == (4, 1)
    assert dfa_regex.plan(32768, 1500, 43, None) == (1, 1)
    assert dfa_regex.plan(300, 1500, 43, 11) == (8, 1)
    assert dfa_regex.plan(32768, 40, 43, 11) == (1, 1)   # no room for 4 d
    assert dfa_regex.plan(1 << 20, 1500, 43, 11) == (1, 1)
    assert dfa_regex.plan(32768, 1500, 180, 11)[1] == 1
    assert dfa_regex.plan(32768, 1500, 226, 11)[1] == 0


def test_regex_stage_prepares_its_table_on_the_host():
    """The regex stage keeps the packed table and its depth beside the
    rules' table, and recomputes them when the table is replaced."""
    fn = accel.regex(jnf.SNORT_RULES)
    assert fn.ucf.consts.derived["depth"] == 11
    on = fn.ucf.consts.on(torch.device("cpu"))
    assert set(on) == {"table", "out_count", "packed"}
    t2, o2 = ref.build_aho_corasick(["zz", "abc"])
    fn.ucf.consts.set(table=t2, out_count=o2)
    assert fn.ucf.consts.derived["depth"] == 3
    np.testing.assert_array_equal(
        fn.ucf.consts.on(torch.device("cpu"))["packed"].numpy(),
        dfa_regex.prepare(t2, o2).packed)


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
        "flash_attention_bwd.cu", "decode_attention.cu", "ssd_scan.cu",
        "ssd_scan_bwd.cu", "launch_floor.cu"}
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    path = _build.library_path()
    assert path.name == _build.LIB_NAME and path.parent.name == _build._digest()
    assert set(_build.KERNELS.values()) == set(_build.SIGNATURES)
    assert dfa_regex.smem_bytes(43) == 44032      # the packed table
