"""The port's CUDA kernels held against their plain PyTorch versions on the
card.

These tests need a CUDA device and skip without one (the ``cuda`` fixture
decides at run time). They import no JAX, so they run where the port runs:
``python -m pytest -q tests/test_torch_cuda_kernels.py`` on a machine with
an H100 and nvcc. The plain versions are pinned to the JAX package by the
other ``test_torch_*`` files. Here every NIC kernel output (integer, bool or
uint32 words) must equal its plain version bit for bit (tolerance 0), and
the data plane on the card must equal the same data plane on the CPU. The
attention kernels do f32 math in another order than their plain versions
(f32 matmuls on the card run in full f32: TF32 is switched off here), so
f32 outputs are held to atol = rtol = 1e-5 and bf16 outputs to two bf16
ulps (atol 2**-8, rtol 2**-6); a reduced model on the card is held to the
same model on the CPU at atol = rtol = 1e-4 on its logits (f32 through 4
layers, see ``test_torch_lm.py``). The SSD kernel takes its decays as exp
of differences of f32 cumulative sums of log a, summed in another order
than the plain version's ``torch.cumsum``; at Mamba-2's decays those sums
reach ~110 (ulp 7.6e-6), so f32 outputs are held to atol = rtol = 1e-4
(see ``test_torch_ssd.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.apps import ALL_APPS, synth_packets
from repro_torch.configs import get_arch
from repro_torch.core.executor import ParallelDataPlane
from repro_torch.core.graph import run_pipeline
from repro_torch.kernels import _build, crypto, dfa_regex
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flow_lookup as fl
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels import ops, ref
from repro_torch.models import build, moe

SNORT = ["attack", "GET /admin", "cmd.exe", "/etc/passwd", "SELECT *"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a CUDA kernel with its "
                    "plain version on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


F32_TOL = dict(atol=1e-5, rtol=1e-5)
SSD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -6)
PAIRINGS = {"f32": (torch.float32, torch.float32),
            "bf16": (torch.bfloat16, torch.bfloat16),
            "f32q_bf16kv": (torch.float32, torch.bfloat16)}


def _close(got, want, dtype):
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(),
                               **(BF16_TOL if dtype == torch.bfloat16
                                  else F32_TOL))


def _u32(rng, shape):
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.flat[::7] = 0xFFFFFFFF
    return w


def _dfa_args(cuda, pay, length, table, out):
    """Device tensors of a walk: payload, length, table, out_count, and the
    table packed as the kernel takes it, with its depth."""
    prep = dfa_regex.prepare(table, out)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (pay, length, table, out)]
    return args, torch.from_numpy(prep.packed).to(cuda), prep.depth


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


def _straddling(rng, B, L, rules, segs, depth):
    """Payloads with a pattern across, at and just before every segment
    start of the kernel's plan."""
    pay = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    starts = [f for _, f in dfa_regex.segment_bounds(L, segs, depth)][1:]
    pats = [r.encode() for r in rules]
    for i in range(B):
        for j, st in enumerate(starts):
            pat = pats[(i + j) % len(pats)]
            pos = st - (i % (len(pat) + 2))
            if 0 <= pos <= L - len(pat):
                pay[i, pos:pos + len(pat)] = np.frombuffer(pat, np.uint8)
    return pay


def test_dfa_kernel_equals_plain(cuda):
    """SNORT_RULES at the path's row length, patterns straddling every
    segment boundary of the kernel's plan, lengths negative, 0, 1, d, in
    the row, L and past L; then the same rows cut to an odd length."""
    rng = np.random.default_rng(5)
    table, out = ref.build_aho_corasick(SNORT)
    B, L = 300, 1500
    segs, _ = dfa_regex.plan(B, L, table.shape[0], 11)
    assert segs > 1
    pay = _straddling(rng, B, L, SNORT, segs, 11)
    length = rng.integers(-2, 1510, size=B).astype(np.int32)
    length[:8] = [0, 1, 11, 12, L, L + 9, -5, 188]
    args, packed, depth = _dfa_args(cuda, pay, length, table, out)
    assert depth == 11
    before = _build.launch_counts()["dfa_regex"]
    got = dfa_regex.dfa_regex(*args, packed, depth)
    torch.cuda.synchronize()
    assert _build.launch_counts()["dfa_regex"] == before + 1
    want = dfa_regex.dfa_scan_torch(*args)
    assert torch.equal(got, want)
    assert int(got.max()) > 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), dfa_regex.segmented_scan_numpy(
            pay, length, dfa_regex.prepare(table, out), segs))
    odd = args[0][:, :1499].contiguous()
    assert torch.equal(dfa_regex.dfa_regex_cuda(odd, args[1], packed, depth),
                       dfa_regex.dfa_scan_torch(odd, *args[1:]))


@pytest.mark.parametrize("L", [1501, 1500, 37])
def test_dfa_kernel_odd_rows_and_offset_views(cuda, L):
    """Rows of 1,501 bytes (not 4- or 16-byte aligned), and a payload view
    that starts one byte into its storage (read from device memory)."""
    rng = np.random.default_rng(L)
    table, out = ref.build_aho_corasick(SNORT)
    B = 513
    store = _straddling(rng, B, L + 1, SNORT, 8, 11)
    length = rng.integers(-3, L + 4, size=B).astype(np.int32)
    args, packed, depth = _dfa_args(cuda, store[:, :L], length, table, out)
    got = dfa_regex.dfa_regex_cuda(args[0], args[1], packed, depth)
    assert torch.equal(got, dfa_regex.dfa_scan_torch(*args))
    flat = torch.from_numpy(store.reshape(-1)).to(cuda)
    view = flat[1:1 + B * L].view(B, L)
    assert view.data_ptr() % 16 and view.is_contiguous()
    got = dfa_regex.dfa_regex_cuda(view, args[1], packed, depth)
    assert torch.equal(got, dfa_regex.dfa_scan_torch(view, *args[1:]))


def test_dfa_kernel_table_without_depth(cuda):
    """A DFA that never forgets (parity of the 1-bytes) has no
    synchronisation depth: each packet is one walk."""
    table = np.zeros((2, 256), np.int32)
    table[1, :] = 1
    table[0, 1], table[1, 1] = 1, 0
    out = np.array([0, 1], np.int32)
    rng = np.random.default_rng(8)
    pay = rng.integers(0, 3, size=(2000, 700), dtype=np.uint8)
    length = rng.integers(-1, 710, size=2000).astype(np.int32)
    args, packed, depth = _dfa_args(cuda, pay, length, table, out)
    assert depth is None
    got = dfa_regex.dfa_regex_cuda(args[0], args[1], packed, depth)
    assert torch.equal(got, dfa_regex.dfa_scan_torch(*args))


def test_dfa_kernel_large_table_uses_dynamic_shared_memory(cuda):
    """A table above 48 KB opts in to dynamic shared memory: 90 and 177
    states (a staged chunk a thread) and 224 (no room for staged chunks,
    so the rows are read from device memory)."""
    for rules, chunks in (([f"rule{i:03d}x" for i in range(40)], 1),
                          ([f"q{i:03d}zz" for i in range(56)], 1),
                          ([f"q{i:03d}zz" for i in range(71)], 0)):
        table, out = ref.build_aho_corasick(rules)
        assert dfa_regex.plan(600, 512, table.shape[0], 8)[1] == chunks
        assert dfa_regex.smem_bytes(table.shape[0]) > 48 * 1024
        rng = np.random.default_rng(6)
        pay = rng.integers(0, 256, size=(600, 512), dtype=np.uint8)
        pat = rules[7].encode()
        pay[::2, 10:10 + len(pat)] = np.frombuffer(pat, np.uint8)
        args, packed, depth = _dfa_args(cuda, pay, np.full(600, 512, np.int32),
                                        table, out)
        got = dfa_regex.dfa_regex_cuda(args[0], args[1], packed, depth)
        assert torch.equal(got, dfa_regex.dfa_scan_torch(*args))
        assert int(got.sum()) >= 300


@pytest.mark.parametrize("S,counts", [
    (228, "rules"),        # one past what a block's shared memory packs
    (256, "rules"),        # the reference's own example size
    (300, "rules"),        # wide, in shared memory
    (1000, "rules"),       # wide, read from device memory (L2)
    (43, "2^16"),          # SNORT_RULES with a count that does not pack
    (43, "negative"),      # counts the reference sums as int32
    (70_000, "random"),    # 32-bit next states, no finite depth
])
def test_dfa_kernel_takes_every_rule_set_the_reference_takes(cuda, S,
                                                             counts):
    """Rule sets past the packed form's 227 states and counts outside
    [0, 2^16) take the wide form; each walk equals the plain version."""
    rng = np.random.default_rng(S)
    if counts == "random":
        table = rng.integers(0, S, size=(S, 256)).astype(np.int32)
        out = rng.integers(-3, 4, size=S).astype(np.int32)
        rules = []
    else:
        rules = SNORT if S == 43 else _rules_with_states(S)
        table, out = ref.build_aho_corasick(rules)
        assert table.shape[0] == S
        if counts == "2^16":
            out[out > 0] = (1 << 16) + 3
        elif counts == "negative":
            out[out > 0] = -7
    prep = dfa_regex.prepare(table, out)
    assert prep.form == ("wide32" if S > 65536 else "wide16")
    assert dfa_regex.in_shared(S, prep.form) == (S <= 400)
    B, L = 700, 600
    starts = [f for _, f in dfa_regex.segment_bounds(L, 4, prep.depth)]
    pay = (_straddling(rng, B, L, rules, 4, prep.depth) if rules
           else rng.integers(0, 256, size=(B, L), dtype=np.uint8))
    length = rng.integers(-2, L + 5, size=B).astype(np.int32)
    length[:4] = [0, 1, L, starts[-1] + 1]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (pay, length, table, out)]
    entries = torch.from_numpy(prep.packed).to(cuda)
    cnt = torch.from_numpy(prep.counts).to(cuda)
    before = _build.launch_counts()["dfa_regex"]
    got = dfa_regex.dfa_regex(*args, entries, prep.depth, cnt)
    torch.cuda.synchronize()
    assert _build.launch_counts()["dfa_regex"] == before + 1
    want = dfa_regex.dfa_scan_torch(*args)
    assert torch.equal(got, want)
    assert bool((got != 0).any())
    # the payload read byte by byte: a view one byte into its storage
    flat = torch.from_numpy(np.concatenate([pay.reshape(-1), pay[0]])).to(
        cuda)
    view = flat[1:1 + B * L].view(B, L)
    assert torch.equal(dfa_regex.dfa_regex_cuda(view, args[1], entries,
                                                prep.depth, cnt),
                       dfa_regex.dfa_scan_torch(view, *args[1:]))


def test_dfa_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    """A count of 2^16 is taken now (the wide form), through the regex
    stage as well; entries outside the table are refused by ``prepare``
    and on the stage's first CUDA batch, as is a call without the
    prepared table or with a table of the wrong dtype."""
    table, out = ref.build_aho_corasick(SNORT)
    big = out.copy()
    big[2] = 1 << 16
    assert dfa_regex.prepare(table, big).form == "wide16"
    pay = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    pay[:, 3:9] = torch.tensor(list(b"attack"), dtype=torch.uint8)
    lens = torch.full((4,), 64, dtype=torch.int32, device=cuda)
    args = [torch.from_numpy(a).to(cuda) for a in (table, out)]
    with pytest.raises(ValueError, match="prepare"):
        dfa_regex.dfa_regex(pay, lens, *args)
    from repro_torch.core import accel
    from repro_torch.core.graph import make_packets
    fn = accel.regex(SNORT)
    fn.ucf.consts.set(table=table, out_count=big)
    batch = make_packets(pay, lens, torch.zeros((4, 5), dtype=torch.int32,
                                                device=cuda), device=cuda)
    got = fn.ucf(batch).meta["match_num"]
    want = dfa_regex.dfa_scan_torch(pay, lens, args[0],
                                    torch.from_numpy(big).to(cuda))
    assert torch.equal(got, want) and int(want[0]) > 0
    bad = table.copy()
    bad[2, 7] = table.shape[0]
    with pytest.raises(ValueError, match="outside"):
        dfa_regex.prepare(bad, out)
    fn.ucf.consts.set(table=bad, out_count=out)
    with pytest.raises(ValueError, match="outside"):
        fn.ucf(batch)
    packed = torch.from_numpy(dfa_regex.prepare(table, out).packed).to(cuda)
    with pytest.raises(TypeError, match="packed"):
        dfa_regex.dfa_regex_cuda(pay, lens, packed.float(), 11)


@pytest.mark.parametrize("B,W,offset", [
    (257, 375, 0), (3, 1, 0),
    (64, 376, 0),          # even W
    (32768, 375, 0),       # the path's shape
    (100, 33, 0),          # W past one column stage (32 words) by one
    (65, 96, 0),           # W three whole column stages
    (41, 375, 1),          # a view 4, 8 and 12 bytes past a 16-byte line
    (40, 64, 2),
    (7, 5, 3),
])
def test_crypto_kernels_equal_plain(cuda, B, W, offset):
    """B3 and B4 bit for bit against their plain versions: the path's
    shape, odd and even row widths, widths across the digest's column
    stages, and word views whose base is not 16-byte aligned."""
    rng = np.random.default_rng(W * 10 + offset)
    flat = torch.from_numpy(_u32(rng, (B * W + offset,))).to(cuda)
    w = flat[offset:].view(B, W)
    assert (w.data_ptr() % 16 != 0) == (offset != 0)
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


def _planes_with(cap, window, rng, n, dup_every=5):
    """Host planes of n keys placed window-style from their buckets (some
    windows wrap past C - 1 when C is small), every ``dup_every``-th key
    placed twice (its second copy later in its window: the first live
    match must win), epochs in {0, 1, 2}, a few copies dead (pid -1)."""
    fids = rng.choice(np.int64(1) << 40, size=n, replace=False)
    lo, hi = fl.split_fids(fids)
    key_lo = np.zeros(cap, np.uint32)
    key_hi = np.zeros(cap, np.uint32)
    pid = np.full(cap, -1, np.int32)
    ep = np.zeros(cap, np.int32)
    base = fl.bucket_hash(lo, hi) & np.uint32(cap - 1)
    for i in range(n):
        copies = 2 if i % dup_every == 0 else 1
        for w in range(window):
            s = (int(base[i]) + w) & (cap - 1)
            if pid[s] < 0 and key_lo[s] == 0:
                key_lo[s], key_hi[s] = lo[i], hi[i]
                pid[s] = -1 if (i % 11 == 3 and copies == 2) else i % 8
                ep[s] = (i + copies) % 3
                copies -= 1
                if copies == 0:
                    break
    return (key_lo, key_hi, pid, ep), fids


@pytest.mark.parametrize("cap,window,F", [
    (1 << 17, 8, 8192),       # the flow cache's shape
    (1 << 17, 8, 8191),       # F not a multiple of a block's queries
    (64, 8, 333),             # windows wrapping past C - 1, duplicates
    (64, 1, 300),             # one slot a window: one lane a query
    (128, 40, 257),           # a window wider than a warp: rounds
    (16, 16, 100),            # the whole table one window
])
def test_lookup_kernel_edges_equal_plain(cuda, cap, window, F):
    rng = np.random.default_rng(cap + window + F)
    (key_lo, key_hi, pid, ep), fids = _planes_with(cap, window, rng,
                                                   min(cap, 60_000) * 3 // 4)
    q = rng.choice(fids, size=F)
    q[::4] |= np.int64(1) << 41                  # absent keys
    qlo, qhi = fl.split_fids(q)
    planes = [torch.from_numpy(a).to(cuda) for a in (key_lo, key_hi, pid, ep)]
    ql, qh = torch.from_numpy(qlo).to(cuda), torch.from_numpy(qhi).to(cuda)
    for cur in (0, 1, 2):                        # stale and fresh epochs
        before = _build.launch_counts()["flow_lookup"]
        got = fl.lookup_packed(*planes, ql, qh, cur, window)
        torch.cuda.synchronize()
        assert _build.launch_counts()["flow_lookup"] == before + 1
        assert got.dtype == torch.int32 and got.shape == (3, F)
        want = fl.pack(*fl.lookup_torch(*planes, ql, qh, cur, window))
        assert torch.equal(got, want)
        host = fl.lookup_numpy(key_lo, key_hi, pid, ep, qlo, qhi, cur,
                               window)
        np.testing.assert_array_equal(got[0].cpu().numpy(), host[0])
        assert bool((got[2] == 1).any()) and bool((got[0] == -1).any())


def test_flow_cache_lookup_copies_once(cuda):
    """``FlowCache.lookup`` on the card: one kernel launch and one
    device-to-host copy of the packed (3, F) buffer per probe; equal to the
    same cache on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.flowcache import FlowCache, FlowCacheConfig
    rng = np.random.default_rng(4)
    fids = rng.choice(np.int64(1) << 40, size=3000, replace=False)
    pids = rng.integers(0, 8, 2000).astype(np.int32)
    caches = [FlowCache(FlowCacheConfig(capacity=1 << 12), device=d)
              for d in ("cpu", cuda)]
    for c in caches:
        c.insert(fids[:2000], pids, 0)
    q = np.concatenate([fids[:1500], fids[2000:2500]])
    caches[1].lookup(q)                          # uploads the planes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = caches[1].lookup(q)
        torch.cuda.synchronize()
    d2h = [e for e in prof.events() if "DtoH" in e.name
           or "Device -> Host" in e.name]
    assert len(d2h) == 1, [e.name for e in d2h]
    want = caches[0].lookup(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


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


# -- attention (B5, B6) ------------------------------------------------------------

@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("D,Hq,Hkv,Sq,Sk,window", [
    (256, 4, 1, 1024, 1024, 512),      # gemma3-1b's local layers
    (256, 4, 1, 1024, 1024, None),     # gemma3-1b's global layers
    (128, 4, 4, 200, 330, None),       # MHA, ragged tiles, Sq < Sk
    (128, 8, 2, 130, 130, 40),         # GQA, window shorter than a tile
    (64, 2, 1, 64, 32, None),          # Sq > Sk: rows with no key give 0
    (16, 4, 1, 40, 40, 16),            # reduced gemma3-1b: local layers
    (16, 4, 1, 40, 40, None),          # ... and global ones
])
def test_flash_kernel_equals_plain(cuda, D, Hq, Hkv, Sq, Sk, window,
                                   pairing):
    q_dt, kv_dt = PAIRINGS[pairing]
    g = torch.Generator(device=cuda).manual_seed(D + Sq + Sk)
    q = torch.randn((2, Sq, Hq, D), generator=g, device=cuda).to(q_dt)
    k = torch.randn((2, Sk, Hkv, D), generator=g, device=cuda).to(kv_dt)
    v = torch.randn((2, Sk, Hkv, D), generator=g, device=cuda).to(kv_dt)
    before = _build.launch_counts()["flash_attention"]
    got = ops.attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention"] == before + 1
    _close(got, fa.flash_attention_torch(q, k, v, causal=True,
                                         window=window), q_dt)
    if Sq > Sk:
        assert not bool(got[:, :Sq - Sk].any())


@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("D,Hq,Hkv,S,kv_len", [
    (256, 4, 1, 1536, [1025, 1056, 1, 1536]),   # gemma3-1b after prefill
    (256, 4, 1, 64, [17, 17, 64, 70]),          # the engine's cache; pos >= S
    (256, 4, 1, 64, [40] * 8),                  # the engine's 8 rows
    (128, 8, 1, 1000, [0, 999, 500, 1000]),     # ragged S, an empty row
    (128, 4, 4, 4096, [4096, 3000, 129, 64]),   # MHA, two stages a warp
    (16, 4, 1, 64, [17, 17, 64, 70]),           # reduced gemma3-1b's engine
    (16, 16, 1, 300, [300, 1, 0, 129]),         # D 16, G 16
])
def test_decode_kernel_equals_plain(cuda, D, Hq, Hkv, S, kv_len, pairing):
    q_dt, kv_dt = PAIRINGS[pairing]
    g = torch.Generator(device=cuda).manual_seed(D + S)
    B = len(kv_len)
    q = torch.randn((B, Hq, D), generator=g, device=cuda).to(q_dt)
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(kv_dt)
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(kv_dt)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = _build.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert _build.launch_counts()["decode_attention"] == before + 1
    _close(got, da.decode_attention_torch(q, k, v, lens), q_dt)
    if 0 in kv_len:
        assert not bool(got[kv_len.index(0)].any())
    # back to back: the arrival counters were set back to 0
    again = ops.decode_attention(q, k, v, lens)
    assert torch.equal(got, again)


@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_decode_kernel_head_dims_and_groups(cuda, D, G, pairing):
    """Every head dim, dtype pairing and group size, with kv_len 0, 1, S
    and different on every row, over a cache deep enough for several
    clusters of splits."""
    q_dt, kv_dt = PAIRINGS[pairing]
    g = torch.Generator(device=cuda).manual_seed(D * 10 + G)
    Hkv, S = 2, 2000
    kv_len = [0, 1, S, 1999, 777, 33]
    B = len(kv_len)
    q = torch.randn((B, G * Hkv, D), generator=g, device=cuda).to(q_dt)
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(kv_dt)
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(kv_dt)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    got = da.decode_attention_cuda(q, k, v, lens)
    _close(got, da.decode_attention_torch(q, k, v, lens), q_dt)
    assert not bool(got[0].any())
    assert torch.equal(got, da.decode_attention_cuda(q, k, v, lens))


@pytest.mark.parametrize("S", [16, 2000, 2048, 16384])
@pytest.mark.parametrize("D,G", [(16, 2), (256, 4), (128, 8)])
def test_decode_kernel_lse_equals_plain(cuda, S, D, G):
    """B6 with ``return_lse``: each head's log-sum-exp (natural log) from
    the kernel's last merge, at one cluster of splits and at several
    (the split counts a rank's block of a sequence-sharded cache takes),
    kv_len 0 (LSE_EMPTY, output 0), 1, S, past S and ragged; the output as
    without lse, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(S + D + G)
    Hkv = 2
    kv_len = [0, 1, S, S + 5, max(1, S // 3), max(1, S - 7)]
    B = len(kv_len)
    q = torch.randn((B, G * Hkv, D), generator=g, device=cuda)
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda)
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    out, lse = da.decode_attention_cuda(q, k, v, lens, return_lse=True)
    want, want_lse = da.decode_attention_torch(q, k, v, lens,
                                               return_lse=True)
    _close(out, want, torch.float32)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    assert bool((lse[0] == fa.LSE_EMPTY).all()) and not bool(out[0].any())
    assert torch.equal(out, da.decode_attention_cuda(q, k, v, lens))


@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("D,Hq,Hkv,Sq,Sk,window", [
    (128, 2, 2, 300, 300, None),       # G 1: 128 positions a block
    (128, 4, 2, 300, 300, 100),        # G 2
    (64, 8, 2, 300, 300, None),        # G 4 (gemma3-1b's)
    (64, 8, 1, 257, 257, 64),          # G 8: 16 positions a block
    (64, 6, 2, 130, 130, 50),          # G 3: 126 of a block's 128 rows
    (256, 4, 1, 1000, 1003, None),     # Sq no multiple of 32; Sk - Sq odd
    (256, 4, 1, 1000, 1003, 200),
    (128, 4, 1, 200, 200, 5),          # window shorter than a key tile
    (64, 4, 1, 200, 200, 4096),        # window >= S
    (16, 8, 2, 300, 300, 50),          # D 16: one 16-column block a row
    (16, 4, 1, 1000, 1003, None),      # D 16, ragged, long causal split
])
def test_flash_kernel_edges_equal_plain(cuda, D, Hq, Hkv, Sq, Sk, window,
                                        pairing):
    """The kernel's design edges: G query heads folded into a block's 128
    rows, ragged query and key tails against its 16-key tiles, windows
    inside one tile and wider than the sequence, every head dim and dtype
    pairing."""
    q_dt, kv_dt = PAIRINGS[pairing]
    g = torch.Generator(device=cuda).manual_seed(D * 7 + Hq + Sq + Sk)
    q = torch.randn((2, Sq, Hq, D), generator=g, device=cuda).to(q_dt)
    k = torch.randn((2, Sk, Hkv, D), generator=g, device=cuda).to(kv_dt)
    v = torch.randn((2, Sk, Hkv, D), generator=g, device=cuda).to(kv_dt)
    got = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
    _close(got, fa.flash_attention_torch(q, k, v, causal=True,
                                         window=window), q_dt)


def test_attention_wrappers_reject_bad_input(cuda):
    x = torch.zeros((1, 64, 4, 128), device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(x.cpu(), x, x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(x.half(), x, x)
    with pytest.raises(ValueError, match="head dim"):
        d96 = x[..., :96].contiguous()
        fa.flash_attention_cuda(d96, d96, d96)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(x.transpose(1, 2), x, x)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_cuda(x, x, x, window=0)
    q = torch.zeros((1, 4, 128), device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q, x, x, lens.cpu())
    with pytest.raises(TypeError, match="kv_len"):
        da.decode_attention_cuda(q, x, x, lens.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        da.decode_attention_cuda(q, x.half(), x, lens)
    with pytest.raises(TypeError, match="share a dtype"):
        da.decode_attention_cuda(q, x, x.bfloat16(), lens)
    with pytest.raises(ValueError, match="outputs per block"):
        big = torch.zeros((1, 32, 128), device=cuda)
        kv1 = torch.zeros((1, 64, 1, 128), device=cuda)
        da.decode_attention_cuda(big, kv1, kv1, lens)
    with pytest.raises(ValueError, match="instances for"):
        g32 = torch.zeros((1, 32, 16), device=cuda)
        kv16 = torch.zeros((1, 64, 1, 16), device=cuda)
        da.decode_attention_cuda(g32, kv16, kv16, lens)
    with pytest.raises(ValueError, match="head dim"):
        d80 = torch.zeros((1, 64, 4, 80), device=cuda)
        da.decode_attention_cuda(torch.zeros((1, 4, 80), device=cuda), d80,
                                 d80, lens)


@pytest.mark.parametrize("name", ["gemma3-1b", "olmo-1b"])
@pytest.mark.parametrize("d_head", [16, 128])
def test_reduced_model_on_card_equals_cpu(cuda, name, d_head):
    """Prefill (B5 on every layer) and 8 decode steps (B6 on the global
    layers) of a reduced model, at its own head dim 16 and at 128, on the
    card against the same parameters on the CPU."""
    cfg = get_arch(name).reduced().replace(remat=False, d_head=d_head)
    cpu_model, card_model = build(cfg, "cpu"), build(cfg, cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0), torch.float32)
    card_params = cpu_model.init(torch.Generator().manual_seed(0),
                                 torch.float32).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(3, 40)))
    _build.reset_launch_counts()
    lg_card, c_card = card_model.prefill(card_params,
                                         {"tokens": toks.to(cuda)},
                                         max_len=64,
                                         cache_dtype=torch.float32)
    lg_cpu, c_cpu = cpu_model.prefill(params, {"tokens": toks}, max_len=64,
                                      cache_dtype=torch.float32)
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    for t in range(8):
        nxt = toks[:, t]
        lg_card, c_card = card_model.decode_step(card_params, c_card,
                                                 nxt.to(cuda))
        lg_cpu, c_cpu = cpu_model.decode_step(params, c_cpu, nxt)
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4,
                                   rtol=1e-4)
    counts = _build.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    n_global = sum(1 for *_, layer in card_params.all_layers()
                   if layer.spec.mixer == "attn")
    assert counts["decode_attention"] == 8 * n_global


def test_reduced_serve_on_card_equals_cpu(cuda):
    """``launch.serve --arch gemma3-1b --reduced`` on the card (B6 at head
    dim 16 in the engine) against a CPU engine with the same plan,
    parameters and requests: the same requests complete with equal tokens
    (a difference only where the top-2 margin is under 2e-3, as
    ``chip_smoke.py`` holds it), and each token's top-2 margin, a
    difference of two logits, within 2 x 1e-3 of the CPU run's."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine
    tol = 1e-3
    _build.reset_launch_counts()
    rep = serve.run(["--arch", "gemma3-1b", "--reduced"])
    assert _build.launch_counts()["decode_attention"] > 0
    assert rep.model.cfg.head_dim == 16
    assert len(rep.done) == rep.requests == 16
    cfg = rep.model.cfg
    cpu = ServingEngine(build(cfg, "cpu"), rep.params.to("cpu"),
                        num_pipelines=rep.plan.num_pipelines,
                        slots_per_pipeline=8, max_len=64)
    for req in serve.make_requests(cfg, rep.requests, 16):
        cpu.submit(req)
    done = cpu.run(max_steps=64 - 8)
    assert [r.rid for r in rep.done] == [r.rid for r in done]
    equal = 0
    for g, w in zip(rep.done, done):
        for a, b, ma, mb in zip(g.out, w.out, g.margins, w.margins):
            assert abs(ma - mb) <= 2 * tol
            if a != b:
                assert ma < 2 * tol
                break
            equal += 1
    assert equal >= 0.9 * rep.tokens


# -- SSD chunked scan (B7) ---------------------------------------------------------

def _ssd_inputs(dev, B, S, H, P, N, dtype, c_broadcast, seed, slow=False):
    """Mamba-2's decays at the reference's init, a = exp(-softplus(N(0,
    1))): a 128-step chunk sums -log a past exp's f32 overflow, so a kernel
    that took exp above the diagonal would give NaN, and the state carried
    into a chunk is forgotten within it. ``slow`` divides -log a by 100 (a
    trained head's slow decay): then the carry across chunks counts."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((B, S, H, P), generator=g, device=dev) * 0.5).to(dtype)
    a = torch.exp(-torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev))
        * (0.01 if slow else 1.0))
    b = (torch.randn((B, S, H, N), generator=g, device=dev) * 0.3).to(dtype)
    if c_broadcast:
        c = (torch.randn((B, S, 1, N), generator=g, device=dev) * 0.3).to(
            dtype).expand(B, S, H, N)
    else:
        c = (torch.randn((B, S, H, N), generator=g, device=dev) * 0.3).to(
            dtype)
    return x, a, b, c


@pytest.mark.parametrize("decay", ["init", "slow"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,c_broadcast", [
    (4, 1024, 32, 64, 128, 128, True),    # mamba2-370m's prefill
    (2, 256, 3, 8, 16, 64, False),        # the JAX test's shapes
    (1, 96, 2, 16, 32, 32, True),
    (2, 12, 16, 8, 16, 128, True),        # reduced mamba: one short chunk
])
def test_ssd_kernel_equals_plain(cuda, B, S, H, P, N, chunk, c_broadcast,
                                 dtype, decay):
    dt = getattr(torch, dtype)
    x, a, b, c = _ssd_inputs(cuda, B, S, H, P, N, dt, c_broadcast, S + N,
                             slow=decay == "slow")
    before = _build.launch_counts()["ssd_scan"]
    y, h = ops.ssd(x, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert _build.launch_counts()["ssd_scan"] == before + 1
    want_y, want_h = ss.ssd_scan_torch(x, a, b, c, chunk)
    assert bool(torch.isfinite(y.float()).all())
    if dt == torch.bfloat16:
        _close(y, want_y, dt)
    else:
        torch.testing.assert_close(y, want_y, **SSD_TOL)
    assert h.dtype == torch.float32
    torch.testing.assert_close(h, want_h, **SSD_TOL)


@pytest.mark.parametrize("c_broadcast", [True, False])
@pytest.mark.parametrize("B,S,H,P,N,chunk,decay,scale", [
    (1, 2048, 4, 64, 128, 64, "slow", 1.0),    # 32 chunks; the carry counts
    (2, 128, 4, 64, 128, 128, "init", 1.0),    # one chunk
    (2, 512, 4, 64, 128, 128, "slow", 1e3),    # inputs x 1e3
])
def test_ssd_kernel_edges_equal_plain(cuda, B, S, H, P, N, chunk, decay,
                                      scale, c_broadcast):
    """The chunked decomposition's edges: 32 chunks at slow decays, where
    the state passing between chunks decides the output; a single chunk
    (no state passing); c broadcast over H and contiguous. With x, b and c
    scaled by 1e3, y scales by 1e9 and h by 1e6: both are held at SSD_TOL
    after dividing those out, so the 3xTF32 error stays relative."""
    x, a, b, c = _ssd_inputs(cuda, B, S, H, P, N, torch.float32, c_broadcast,
                             S + chunk, slow=decay == "slow")
    x, b = x * scale, b * scale
    c = (c[:, :, :1] * scale).expand(c.shape) if c_broadcast else c * scale
    assert (c.stride(2) == 0) == c_broadcast
    y, h = ss.ssd_scan_cuda(x, a, b, c, chunk)
    want_y, want_h = ss.ssd_scan_torch(x, a, b, c, chunk)
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y / scale ** 3, want_y / scale ** 3, **SSD_TOL)
    torch.testing.assert_close(h / scale ** 2, want_h / scale ** 2, **SSD_TOL)


def test_ssd_wrapper_rejects_bad_input(cuda):
    x, a, b, c = _ssd_inputs(cuda, 1, 64, 2, 8, 16, torch.float32, True, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_cuda(x.cpu(), a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan_cuda(x.transpose(1, 2), a, b, c)
    with pytest.raises(ValueError, match="contiguous last"):
        ss.ssd_scan_cuda(x, a, b, c.transpose(-1, -2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ss.ssd_scan_cuda(x.half(), a, b, c)
    with pytest.raises(TypeError, match="a must be"):
        ss.ssd_scan_cuda(x, a.double(), b, c)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ss.ssd_scan_cuda(x, a, b, c, chunk=48)
    with pytest.raises(ValueError, match="at most"):
        wide = torch.zeros((1, 64, 2, 80), device=cuda)
        ss.ssd_scan_cuda(wide, a, b, c)
    long = _ssd_inputs(cuda, 1, 256, 1, 8, 16, torch.float32, True, 1)
    with pytest.raises(ValueError, match="at most"):
        ss.ssd_scan_cuda(*long, chunk=256)


def test_reduced_mamba_on_card_equals_cpu(cuda):
    """Prefill (B7 on every layer, S 256 = two chunks) and 8 decode steps
    (plain PyTorch, no kernel) of reduced mamba2-370m, on the card against
    the same parameters on the CPU."""
    cfg = get_arch("mamba2-370m").reduced().replace(remat=False)
    cpu_model, card_model = build(cfg, "cpu"), build(cfg, cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0), torch.float32)
    card_params = cpu_model.init(torch.Generator().manual_seed(0),
                                 torch.float32).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(3, 256)))
    _build.reset_launch_counts()
    lg_card, c_card = card_model.prefill(card_params,
                                         {"tokens": toks.to(cuda)})
    lg_cpu, c_cpu = cpu_model.prefill(params, {"tokens": toks})
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    assert _build.launch_counts()["ssd_scan"] == cfg.n_layers
    for t in range(8):
        nxt = toks[:, t]
        lg_card, c_card = card_model.decode_step(card_params, c_card,
                                                 nxt.to(cuda))
        lg_cpu, c_cpu = cpu_model.decode_step(params, c_cpu, nxt)
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4,
                                   rtol=1e-4)
    assert _build.launch_counts()["ssd_scan"] == cfg.n_layers
    torch.testing.assert_close(c_card["segments"][0][0]["h"].cpu(),
                               c_cpu["segments"][0][0]["h"], **SSD_TOL)


# -- B5's backward and the training step -------------------------------------------

# dK and dV sum up to Sk·G = 8,192 products an entry, dQ up to Sk, in
# another order than the plain version's einsums (3xTF32 tile sums added
# in f32 against cuBLAS f32; f32 FMAs at D 256): a few 1e-6 of their
# scale, held to atol = rtol = 1e-4.
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _bwd_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, window, seed, dtype=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    dtype = dtype or torch.float32
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).to(dtype)
    do = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).to(dtype)
    out, lse = fa.flash_attention_torch(q, k, v, window=window,
                                        return_lse=True)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("S", [40, 128, 1024])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_flash_bwd_kernel_equals_plain(cuda, D, window, G, S):
    Hkv = 2 if S < 1024 else 1
    B = 2 if S < 1024 else 1
    args = _bwd_inputs(cuda, B, S, S, Hkv * G, Hkv, D, window, D + G + S)
    before = _build.launch_counts()["flash_attention_bwd"]
    got = fa.flash_attention_bwd_cuda(*args, window=window)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention_bwd"] == before + 1
    want = fa.flash_attention_bwd_torch(*args, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == torch.float32, name
        torch.testing.assert_close(a, b, **BWD_TOL, msg=name)


@pytest.mark.parametrize("Sq,Sk,window", [(64, 200, None), (100, 37, 9)])
def test_flash_bwd_kernel_ragged_and_bf16(cuda, Sq, Sk, window):
    """Sq != Sk (rows with no key when Sq > Sk), ragged tiles, and bf16
    inputs widened by the wrapper, gradients cast back."""
    args = _bwd_inputs(cuda, 2, Sq, Sk, 4, 2, 64, window, Sq + Sk)
    got = fa.flash_attention_bwd_cuda(*args, window=window)
    want = fa.flash_attention_bwd_torch(*args, window=window)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **BWD_TOL)
    bf = [t.to(torch.bfloat16) if t.dtype == torch.float32 and t.dim() == 4
          else t for t in args]
    got = fa.flash_attention_bwd_cuda(*bf, window=window)
    want = fa.flash_attention_bwd_torch(*bf, window=window)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), atol=2.0 ** -6,
                                   rtol=2.0 ** -6)


def test_flash_bwd_kernel_is_bit_reproducible(cuda):
    args = _bwd_inputs(cuda, 4, 1024, 1024, 16, 16, 128, None, 0)
    first = fa.flash_attention_bwd_cuda(*args)
    second = fa.flash_attention_bwd_cuda(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Hq,Hkv,S,window", [(16, 16, 1024, None),
                                             (4, 1, 1024, 512),
                                             (8, 2, 130, 40)])
def test_flash_kernel_lse_equals_plain(cuda, Hq, Hkv, S, window):
    """The forward's lse, on the split path too (causal S 1,024 cuts the
    long query tiles' key ranges over blocks)."""
    g = torch.Generator(device=cuda).manual_seed(S + Hq)
    q, k, v = (torch.randn((2, S, h, 128), generator=g, device=cuda)
               for h in (Hq, Hkv, Hkv))
    out, lse = fa.flash_attention_cuda(q, k, v, window=window,
                                       return_lse=True)
    pout, plse = fa.flash_attention_torch(q, k, v, window=window,
                                          return_lse=True)
    torch.testing.assert_close(out, pout, **F32_TOL)
    torch.testing.assert_close(lse, plse, **F32_TOL)
    assert torch.equal(fa.flash_attention_cuda(q, k, v, window=window), out)


def test_attention_autograd_launches_both_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((2, 96, h, 64), generator=g, device=cuda)
               .requires_grad_() for h in (8, 2, 2))
    _build.reset_launch_counts()
    out = ops.attention(q, k, v, window=32)
    out.square().sum().backward()
    counts = _build.launch_counts()
    assert counts["flash_attention"] == 1 == counts["flash_attention_bwd"]
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    ops.attention(q, k, v, window=32, impl="torch").square().sum().backward()
    assert _build.launch_counts() == counts
    for a, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(a, t.grad, **BWD_TOL)


# B7's backward against its plain version, both from the kernel forward's
# scratch. Each gradient is a sum of up to a chunk's 128 terms weighted by
# exp of differences of f32 cumulative sums, in another order than the
# plain version's einsums, and da's terms cancel (row sums minus column
# sums, then a reverse cumulative sum): f32 gradients are held to 1e-4 of
# each tensor's largest entry (rtol 1e-4), as ``test_torch_ssd.py`` holds
# the plain version to the reference; bf16 dx, db, dc to two bf16 ulps of
# it (atol 2**-8 of the largest entry, rtol 2**-6), da (f32) at 1e-4.
def _close_grads(got, want, dtype, what=""):
    for name, g, w in zip(("dx", "da", "db", "dc"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = float(w.float().abs().max())
        if dtype == torch.float32 or name == "da":
            tol = dict(atol=1e-4 * scale, rtol=1e-4)
        else:
            tol = dict(atol=2.0 ** -8 * scale, rtol=2.0 ** -6)
        torch.testing.assert_close(g.float(), w.float(), **tol,
                                   msg=f"{what} {name}")


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("decay", ["init", "slow"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,c_broadcast", [
    (4, 1024, 32, 64, 128, 128, True),    # mamba2-370m's training shape
    (1, 1024, 256, 64, 128, 128, True),   # jamba's mixer: 256 heads
    (2, 256, 3, 8, 16, 64, False),        # the JAX test's shapes
    (1, 96, 2, 16, 32, 32, True),
    (2, 12, 16, 8, 16, 128, True),        # reduced mamba: one short chunk
    (1, 384, 5, 40, 72, 96, False),       # T, N, P off the 64-wide tiles
    (2, 512, 4, 64, 128, 64, True),       # mamba training's chunk-64 run
])
def test_ssd_bwd_kernel_equals_plain(cuda, B, S, H, P, N, chunk,
                                     c_broadcast, dtype, decay, with_dh):
    dt = getattr(torch, dtype)
    x, a, b, c = _ssd_inputs(cuda, B, S, H, P, N, dt, c_broadcast, S + H,
                             slow=decay == "slow")
    g = torch.Generator(device=cuda).manual_seed(S + N)
    dy = torch.randn(x.shape, generator=g, device=cuda).to(dt)
    dh = (torch.randn((B, H, N, P), generator=g, device=cuda)
          if with_dh else None)
    _, _, states, cl = ss.ssd_scan_cuda(x, a, b, c, chunk,
                                        return_scratch=True)
    before = _build.launch_counts()["ssd_scan_bwd"]
    got = ss.ssd_scan_bwd_cuda(x, a, b, c, dy, dh, states, cl, chunk)
    torch.cuda.synchronize()
    assert _build.launch_counts()["ssd_scan_bwd"] == before + 1
    want = ss.ssd_scan_bwd_torch(x, a, b, c, dy, dh, states, cl, chunk)
    for t in got:
        assert bool(torch.isfinite(t.float()).all())
    _close_grads(got, want, dt)
    again = ss.ssd_scan_bwd_cuda(x, a, b, c, dy, dh, states, cl, chunk)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


def test_ssd_kernel_scratch_equals_plain(cuda):
    """The forward's scratch the backward reads, from the kernel and from
    the plain version: each chunk's incoming state and cl, at SSD_TOL."""
    x, a, b, c = _ssd_inputs(cuda, 2, 512, 4, 64, 128, torch.float32, True,
                             3, slow=True)
    got = ss.ssd_scan_cuda(x, a, b, c, 128, return_scratch=True)
    want = ss.ssd_scan_torch(x, a, b, c, 128, return_scratch=True)
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, **SSD_TOL)


@pytest.mark.parametrize("c_broadcast", [True, False])
def test_ssd_autograd_launches_both_kernels(cuda, c_broadcast):
    """``ops.ssd`` under autograd on the card: one ``ssd_scan`` and one
    ``ssd_scan_bwd`` launch, nothing of the plain versions, and gradients
    (c broadcast over H summed by autograd) equal to the plain pair's."""
    x, a, b, c = _ssd_inputs(cuda, 2, 256, 4, 16, 32, torch.float32,
                             c_broadcast, 11, slow=True)
    c_leaf = c[:, :, :1].contiguous() if c_broadcast else c
    ts = [t.detach().clone().requires_grad_() for t in (x, a, b, c_leaf)]
    g = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(x.shape, generator=g, device=cuda)

    def grads(impl):
        for t in ts:
            t.grad = None
        cc = ts[3].expand(c.shape) if c_broadcast else ts[3]
        y, h = ops.ssd(ts[0], ts[1], ts[2], cc, chunk=64, impl=impl)
        ((y * dy).sum() + h.square().sum()).backward()
        return [t.grad.clone() for t in ts]

    _build.reset_launch_counts()
    got = grads(None)
    counts = _build.launch_counts()
    assert counts["ssd_scan"] == 1 == counts["ssd_scan_bwd"]
    assert sum(counts.values()) == 2
    want = grads("torch")
    assert _build.launch_counts() == counts
    for u, v in zip(got, want):
        scale = float(v.abs().max())
        torch.testing.assert_close(u, v, atol=1e-4 * scale, rtol=1e-4)


def test_ssd_bwd_wrapper_rejects_bad_input(cuda):
    x, a, b, c = _ssd_inputs(cuda, 1, 64, 2, 8, 16, torch.float32, True, 0)
    _, _, states, cl = ss.ssd_scan_cuda(x, a, b, c, 32, return_scratch=True)
    dy = torch.zeros_like(x)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_bwd_cuda(x.cpu(), a, b, c, dy, None, states, cl, 32)
    with pytest.raises(ValueError, match="dy must be"):
        ss.ssd_scan_bwd_cuda(x, a, b, c, dy.bfloat16(), None, states, cl,
                             32)
    with pytest.raises(ValueError, match="scratch"):
        ss.ssd_scan_bwd_cuda(x, a, b, c, dy, None, states, cl, 64)
    with pytest.raises(ValueError, match="dh_final"):
        ss.ssd_scan_bwd_cuda(x, a, b, c, dy, states[:, :, 0].double(),
                             states, cl, 32)


def test_plain_attention_pair_gradcheck_on_card(cuda):
    """The plain pair the backward kernel is held to, in f64 on the card:
    dq, dk, dv equal central finite differences of the forward
    (``torch.autograd.gradcheck``, as ``test_torch_attention.py`` holds
    it on the CPU)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(shape, generator=g, device=cuda,
                           dtype=torch.float64).requires_grad_()
               for shape in ((1, 6, 4, 4), (1, 7, 2, 4), (1, 7, 2, 4)))
    fn = lambda q, k, v: ops._Attention.apply(q, k, v, True, 3, 0.5, True,
                                             4)
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


def test_reduced_train_step_on_card_equals_cpu(cuda):
    """Three ``make_train_step`` steps of reduced olmo-1b (accumulation 2)
    on the card against the same on the CPU: losses and grad norms at
    atol = rtol = 1e-4 (f32 through 4 layers), parameters and moments at
    atol = rtol = 1e-4 but for a share under 1e-3 of the parameters (the
    AdamW update of a near-zero gradient follows its low bits, see
    ``test_torch_train.py``); exactly 2 x 4 backward launches a step and,
    the config keeping the reference's remat, twice as many forward ones
    (each checkpointed layer's recompute)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import make_train_step
    cfg = get_arch("olmo-1b").reduced().replace(microbatch=2, d_head=64,
                                                n_heads=2, n_kv_heads=1)
    shape = ShapeConfig("t", 64, 4, "train")
    runs = []
    for dev in ("cpu", cuda):
        model = build(cfg, dev)
        params = build(cfg, "cpu").init(torch.Generator().manual_seed(0),
                                        torch.float32).to(dev)
        params.requires_grad_(True)
        step_fn, opt_init = make_train_step(model, shape, base_lr=1e-3,
                                            warmup=1, total_steps=10)
        opt = opt_init(params)
        rng = np.random.default_rng(0)
        stats = []
        _build.reset_launch_counts()
        for s in range(3):
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab, size=(4, 64))).to(dev)
            params, opt, loss, gn = step_fn(params, opt, {"tokens": toks},
                                            s + 1)
            stats.append((float(loss), float(gn)))
        runs.append((params, opt, stats, _build.launch_counts()))
    (p_cpu, o_cpu, s_cpu, _), (p_card, o_card, s_card, counts) = runs
    assert cfg.remat
    assert counts["flash_attention"] == 2 * 3 * 2 * cfg.n_layers
    assert counts["flash_attention_bwd"] == 3 * 2 * cfg.n_layers
    np.testing.assert_allclose(s_card, s_cpu, atol=1e-4, rtol=1e-4)
    for k, v in o_cpu.mu.items():
        torch.testing.assert_close(o_card.mu[k].cpu(), v, atol=1e-4,
                                   rtol=1e-4)
    loose = total = 0
    for (k, a), b in zip(p_card.named_parameters(), p_cpu.parameters()):
        close = torch.isclose(a.detach().cpu(), b.detach(), atol=1e-4,
                              rtol=1e-4)
        loose += int((~close).sum())
        total += close.numel()
    assert loose < 1e-3 * total



# -- the MoE and hybrid families --------------------------------------------------

def test_decode_kernel_bf16_query_over_f32_cache(cuda):
    """A bf16 model's engine keeps an f32 cache: B6 takes a bf16 query over
    f32 keys and values (moonshot's G 1, D 128), held to two bf16 ulps."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn((8, 16, 128), generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((8, 64, 16, 128), generator=g, device=cuda)
            for _ in range(2))
    lens = torch.tensor([40, 41, 64, 1, 17, 70, 33, 2], dtype=torch.int32,
                        device=cuda)
    got = ops.decode_attention(q, k, v, lens)
    _close(got, da.decode_attention_torch(q, k, v, lens), torch.bfloat16)


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b",
                                  "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"])
def test_reduced_moe_and_hybrid_on_card_equal_cpu(cuda, name):
    """Reduced phi3.5-moe and moonshot (attention + MoE layers) and jamba
    (mamba, attention and MoE layers in one body: B5, B6 and B7 in one
    model) on the card against the same f32 parameters on the CPU: prefill
    and 8 decode steps, logits at atol = rtol = 1e-4 (f32 through 4-8
    layers; the routes agree at f32), exact launch counts, and two card
    prefills bit-equal."""
    cfg = get_arch(name).reduced().replace(remat=False)
    cpu_model, card_model = build(cfg, "cpu"), build(cfg, cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0), torch.float32)
    card_params = cpu_model.init(torch.Generator().manual_seed(0),
                                 torch.float32).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(3, 40)))
    _build.reset_launch_counts()
    lg_card, c_card = card_model.prefill(card_params,
                                         {"tokens": toks.to(cuda)},
                                         max_len=64,
                                         cache_dtype=torch.float32)
    per_prefill = _build.launch_counts()
    again, _ = card_model.prefill(card_params, {"tokens": toks.to(cuda)},
                                  max_len=64, cache_dtype=torch.float32)
    assert torch.equal(lg_card, again)
    lg_cpu, c_cpu = cpu_model.prefill(params, {"tokens": toks}, max_len=64,
                                      cache_dtype=torch.float32)
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    _build.reset_launch_counts()
    for t in range(8):
        nxt = toks[:, t]
        lg_card, c_card = card_model.decode_step(card_params, c_card,
                                                 nxt.to(cuda))
        lg_cpu, c_cpu = cpu_model.decode_step(params, c_cpu, nxt)
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4,
                                   rtol=1e-4)
    mixers = [layer.spec.mixer for *_, layer in card_params.all_layers()]
    assert per_prefill["flash_attention"] == mixers.count("attn")
    assert per_prefill["ssd_scan"] == mixers.count("mamba")
    counts = _build.launch_counts()
    assert counts["decode_attention"] == 8 * mixers.count("attn")
    assert counts["ssd_scan"] == 0


@pytest.mark.parametrize("E,k", [(8, 2), (64, 6)])
def test_moe_ffn_bf16_on_card_equals_cpu(cuda, E, k):
    """The MoE FFN in bf16 on the card against the CPU, from the same
    parameters: routes equal wherever the k-th and (k+1)-th router logits
    are more than two bf16 ulps of the largest apart (cuBLAS and the CPU
    sum the router product in other orders, each rounds to bf16 once),
    outputs of the tokens whose routes agree within four bf16 ulps (atol
    = rtol = 2**-6, see ``test_torch_moe.py``), and two card calls
    bit-equal (the combine is a fixed-order sum, no atomics)."""
    cfg = get_arch("moonshot-v1-16b-a3b").reduced().replace(
        n_experts=E, top_k=k, d_model=256, d_ff=128)
    p = moe.moe_init(torch.Generator().manual_seed(E), cfg, torch.bfloat16,
                     "cpu")
    x = torch.randn((4, 64, 256), generator=torch.Generator().manual_seed(k)
                    ).to(torch.bfloat16)
    pc = {n: t.to(cuda) for n, t in p.items()}
    got = moe.moe_ffn(pc, x.to(cuda), cfg)
    assert torch.equal(got, moe.moe_ffn(pc, x.to(cuda), cfg))
    want = moe.moe_ffn(p, x, cfg)
    xf = x.reshape(-1, 256)
    _, _, ids = moe.route(p, xf, cfg)
    _, _, cids = moe.route(pc, xf.to(cuda), cfg)
    same = (ids.sort(-1).values == cids.cpu().sort(-1).values).all(-1)
    lg = (xf @ p["router"]).float()
    top = lg.sort(-1, descending=True).values
    near = top[:, k - 1] - top[:, k] <= 2 * 2.0 ** -7 * lg.abs().amax(-1)
    assert bool((same | near).all())
    torch.testing.assert_close(got.cpu().float().reshape(-1, 256)[same],
                               want.float().reshape(-1, 256)[same],
                               atol=2.0 ** -6, rtol=2.0 ** -6)


# -- the remaining architectures: encoder-decoder, G 5 and G 7 ----------------------

@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("D,Hq,Hkv,Sq,Sk", [
    (64, 16, 16, 1024, 1024),    # seamless's encoder (and cross at Sq == Sk)
    (64, 16, 16, 200, 1024),     # cross-attention, Sq < Sk
    (64, 4, 2, 300, 130),        # Sq > Sk: every row still sees every key
    (128, 8, 2, 130, 257),       # D 128, GQA, ragged tiles
    (128, 4, 4, 1024, 1024),
])
def test_flash_kernel_noncausal_equals_plain(cuda, D, Hq, Hkv, Sq, Sk,
                                             pairing):
    """B5 with ``causal=False``: the encoder's bidirectional attention and
    the decoder's cross-attention, at Sq == Sk and Sq != Sk."""
    q_dt, kv_dt = PAIRINGS[pairing]
    g = torch.Generator(device=cuda).manual_seed(D + Hq + Sq + 3 * Sk)
    q = torch.randn((2, Sq, Hq, D), generator=g, device=cuda).to(q_dt)
    k = torch.randn((2, Sk, Hkv, D), generator=g, device=cuda).to(kv_dt)
    v = torch.randn((2, Sk, Hkv, D), generator=g, device=cuda).to(kv_dt)
    before = _build.launch_counts()["flash_attention"]
    got = ops.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention"] == before + 1
    _close(got, fa.flash_attention_torch(q, k, v, causal=False), q_dt)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=False,
                                       return_lse=True)
    pout, plse = fa.flash_attention_torch(q, k, v, causal=False,
                                          return_lse=True)
    torch.testing.assert_close(lse, plse, **F32_TOL)


@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("Hq,Hkv,S,causal,window", [
    (40, 8, 1024, True, None),   # qwen2.5-32b: G 5, 25 positions a block
    (56, 8, 1600, True, None),   # llava-next-34b: G 7, 18 positions
    (40, 8, 300, False, None),
    (56, 8, 130, True, 40),
    (10, 2, 257, True, None),    # the reduced qwen G 5 variant's heads
])
def test_flash_kernel_at_g5_and_g7_equals_plain(cuda, Hq, Hkv, S, causal,
                                                window, pairing):
    """G 5 and G 7 fold into 125 and 126 of a block's 128 rows (the
    other rows idle), with the causal key split at full length."""
    q_dt, kv_dt = PAIRINGS[pairing]
    g = torch.Generator(device=cuda).manual_seed(Hq + S)
    q = torch.randn((2, S, Hq, 128), generator=g, device=cuda).to(q_dt)
    k = torch.randn((2, S, Hkv, 128), generator=g, device=cuda).to(kv_dt)
    v = torch.randn((2, S, Hkv, 128), generator=g, device=cuda).to(kv_dt)
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    _close(got, fa.flash_attention_torch(q, k, v, causal=causal,
                                         window=window), q_dt)


# -- B5's bf16 instance (q, k and v bf16 at head dim 128) ---------------------

@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("G", [1, 5, 7, 8])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100)])
@pytest.mark.parametrize("Sq,Sk", [(1024, 1024), (300, 300), (200, 330),
                                   (64, 32)])
def test_flash_kernel_bf16_instance_equals_plain(cuda, Sq, Sk, causal,
                                                 window, G, split):
    """The bf16 instance against the plain version at two bf16 ulps
    (BF16_TOL), out and lse: causal, non-causal and windowed; G 1, 5, 7
    and 8 folded into a block's 128 rows; ragged query and key tails
    against its 64-key tiles, Sq < Sk and Sq > Sk; the key split on (the
    wrapper's plan on the card's SMs, or forced over 2 parts where the
    plan splits nothing) and off (one part). K and V are read as they
    are: the launch allocates nothing, and the wrapper requests out, lse
    and the split's scratch and nothing else (a widened f32 copy of K and
    V would add 8·B·Sk·Hkv·D bytes)."""
    Hkv = 2
    B, D = 2, 128
    g = torch.Generator(device=cuda).manual_seed(Sq * 3 + Sk + G)
    q, k, v = (torch.randn((B, s, h, D), generator=g, device=cuda)
               .to(torch.bfloat16)
               for s, h in ((Sq, G * Hkv), (Sk, Hkv), (Sk, Hkv)))
    assert fa.instance(q, k, v) == "bf16"
    kmax, parts = fa.split_plan(q, k, v, causal, window)
    if split and parts == 1:
        tiles = -(-Sk // fa.BLOCK_K_BF16)
        kmax, parts = -(-tiles // 2), 2
    elif not split:
        kmax, parts = 1 << 20, 1
    torch.cuda.synchronize()
    out = torch.empty_like(q)
    lse = torch.empty((B, G * Hkv, Sq), device=cuda)
    scratch = ([torch.empty((parts, B, Sq, G * Hkv, D), device=cuda),
                torch.empty((parts, B, Sq, G * Hkv, 2), device=cuda)]
               if parts > 1 else [None, None])
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    _build.launch("flash_attention", cuda, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), B, Sq, Sk, G * Hkv, Hkv, D,
                  int(causal), window or 0, D ** -0.5, 1, 1, kmax, parts,
                  *(t.data_ptr() if t is not None else None
                    for t in scratch), lse.data_ptr())
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) == base
    want, wlse = fa.flash_attention_torch(q, k, v, causal=causal,
                                          window=window, return_lse=True)
    _close(out, want, torch.bfloat16)
    torch.testing.assert_close(lse, wlse, **F32_TOL)
    # the wrapper: same instance, one launch, and it requests from the
    # allocator out, lse and the split's scratch, nothing more
    del scratch
    torch.cuda.synchronize()
    stat = "requested_bytes.all.{}"
    base = torch.cuda.memory_stats(cuda)[stat.format("current")]
    torch.cuda.reset_peak_memory_stats(cuda)
    before = _build.launch_counts()["flash_attention"]
    got, glse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention"] == before + 1
    kmax, parts = fa.split_plan(q, k, v, causal, window)
    rows = B * Sq * G * Hkv
    allowed = rows * D * 2 + rows * 4 + (
        parts * rows * (D + 2) * 4 if parts > 1 else 0)
    grown = torch.cuda.memory_stats(cuda)[stat.format("peak")] - base
    assert grown == allowed
    _close(got, want, torch.bfloat16)
    torch.testing.assert_close(glse, wlse, **F32_TOL)
    if Sq > Sk and causal:
        assert not bool(got[:, :Sq - Sk].any())


def test_flash_kernel_instances_by_pairing(cuda):
    """Which instance serves which pairing: bf16 q, k and v at head dim 128
    the bf16 one; f32 at any head dim, f32 q over bf16 k/v and bf16 at
    16, 64 and 256 the f32 one (bf16 K/V widened), as before."""
    for D in fa.HEAD_DIMS:
        for q_dt, kv_dt in PAIRINGS.values():
            q = torch.zeros((1, 4, 2, D), device=cuda, dtype=q_dt)
            kv = torch.zeros((1, 4, 2, D), device=cuda, dtype=kv_dt)
            want = ("bf16" if D == 128 and q_dt == kv_dt == torch.bfloat16
                    else "f32")
            assert fa.instance(q, kv, kv) == want
    q = torch.zeros((1, 4, 2, 128), device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros((1, 4, 2, 128), device=cuda)
    assert fa.instance(q, kv, kv) == "f32"        # bf16 q over f32 k/v


@pytest.mark.parametrize("G", [1, 5, 7])
@pytest.mark.parametrize("D,Sq,Sk", [(64, 1024, 1024), (64, 100, 300),
                                     (128, 300, 100), (16, 40, 24)])
def test_flash_bwd_kernel_noncausal_equals_plain(cuda, D, Sq, Sk, G):
    """B5's backward with ``causal=False`` (training the encoder and the
    cross-attention), at Sq == Sk and Sq != Sk, G 1, 5 and 7."""
    Hkv = 2
    g = torch.Generator(device=cuda).manual_seed(D + G + Sq + Sk)
    q = torch.randn((2, Sq, Hkv * G, D), generator=g, device=cuda)
    k, v = (torch.randn((2, Sk, Hkv, D), generator=g, device=cuda)
            for _ in range(2))
    do = torch.randn((2, Sq, Hkv * G, D), generator=g, device=cuda)
    out, lse = fa.flash_attention_torch(q, k, v, causal=False,
                                        return_lse=True)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=False)
    want = fa.flash_attention_bwd_torch(q, k, v, out, lse, do, causal=False)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, **BWD_TOL, msg=name)


@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("D,G,S,kv_len", [
    (128, 5, 1536, [1056, 1, 1536, 700]),   # qwen2.5-32b over its cache
    (128, 7, 1536, [1056, 0, 1536, 33]),    # llava-next-34b
    (64, 5, 300, [300, 17]),
    (16, 5, 64, [64, 3]),                   # the reduced qwen G 5 variant
    (64, 1, 4096, [4096] * 4),              # seamless's cross cache
    (64, 7, 4096, [4096, 4096]),
])
def test_decode_kernel_at_g5_g7_and_full_cross_cache(cuda, D, G, S, kv_len,
                                                     pairing):
    """B6 at G 5 and 7 (rounded up to the kernel's 8-head instance, the
    extra heads idle) and over a whole 4,096-row cross cache at D 64
    (``kv_len == S`` on every row), twice back to back (the arrival
    counters set back to 0)."""
    q_dt, kv_dt = PAIRINGS[pairing]
    g = torch.Generator(device=cuda).manual_seed(D + G + S)
    Hkv = 8 if D == 128 else 16 if S == 4096 and G == 1 else 2
    B = len(kv_len)
    q = torch.randn((B, G * Hkv, D), generator=g, device=cuda).to(q_dt)
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(kv_dt)
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(kv_dt)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens)
    _close(got, da.decode_attention_torch(q, k, v, lens), q_dt)
    assert torch.equal(got, ops.decode_attention(q, k, v, lens))


def _reduced_pair(cuda, name, **kw):
    cfg = get_arch(name).reduced().replace(remat=False, **kw)
    cpu_model, card_model = build(cfg, "cpu"), build(cfg, cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0), torch.float32)
    card_params = cpu_model.init(torch.Generator().manual_seed(0),
                                 torch.float32).to(cuda)
    return cfg, cpu_model, card_model, params, card_params


@pytest.mark.parametrize("name,kw", [
    ("minicpm-2b", {}),
    ("qwen2.5-32b", {}),
    ("qwen2.5-32b", {"n_heads": 10, "n_kv_heads": 2}),   # G 5
    ("llava-next-34b", {}),
])
def test_reduced_dense_and_vlm_on_card_equal_cpu(cuda, name, kw):
    """Reduced minicpm-2b, qwen2.5-32b (and its G 5 variant) and
    llava-next-34b (8 stub patches prepended) on the card against the same
    f32 parameters on the CPU: prefill and 8 decode steps, logits at atol
    = rtol = 1e-4, exact launch counts."""
    cfg, cpu_model, card_model, params, card_params = _reduced_pair(
        cuda, name, **kw)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     size=(3, 32)))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (3, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    _build.reset_launch_counts()
    lg_card, c_card = card_model.prefill(
        card_params, {k: t.to(cuda) for k, t in batch.items()}, max_len=64,
        cache_dtype=torch.float32)
    lg_cpu, c_cpu = cpu_model.prefill(params, batch, max_len=64,
                                      cache_dtype=torch.float32)
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    for t in range(8):
        nxt = batch["tokens"][:, t]
        lg_card, c_card = card_model.decode_step(card_params, c_card,
                                                 nxt.to(cuda))
        lg_cpu, c_cpu = cpu_model.decode_step(params, c_cpu, nxt)
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4,
                                   rtol=1e-4)
    counts = _build.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["decode_attention"] == 8 * cfg.n_layers


def test_reduced_encdec_on_card_equals_cpu(cuda):
    """Reduced seamless-m4t-medium on the card against the CPU: the
    prefill (per layer B5 non-causal in the encoder, causal and
    non-causal in the decoder: 6 launches for 2 + 2 layers), logits at
    atol = rtol = 1e-4, then 8 decode steps from ``init_cache`` (B6 on
    each decoder layer's self and cross caches: 4 a step), f32 cache."""
    cfg, cpu_model, card_model, params, card_params = _reduced_pair(
        cuda, "seamless-m4t-medium")
    rng = np.random.default_rng(3)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
                 (3, 40, cfg.d_model)).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     size=(3, 24)))}
    _build.reset_launch_counts()
    lg_card, none = card_model.prefill(
        card_params, {k: t.to(cuda) for k, t in batch.items()})
    assert none is None
    assert _build.launch_counts()["flash_attention"] == 3 * cfg.dec_layers
    lg_cpu, _ = cpu_model.prefill(params, batch)
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    c_card = card_model.init_cache(3, 16, torch.float32)
    c_cpu = cpu_model.init_cache(3, 16, torch.float32)
    _build.reset_launch_counts()
    for t in range(8):
        nxt = batch["tokens"][:, t]
        lg_card, c_card = card_model.decode_step(card_params, c_card,
                                                 nxt.to(cuda))
        lg_cpu, c_cpu = cpu_model.decode_step(params, c_cpu, nxt)
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, atol=1e-4,
                                   rtol=1e-4)
    assert _build.launch_counts()["decode_attention"] == 8 * 2 * \
        cfg.dec_layers


@pytest.mark.parametrize("name", ["seamless-m4t-medium", "minicpm-2b"])
def test_reduced_train_step_encdec_and_wsd_on_card_equal_cpu(cuda, name):
    """One ``make_train_step`` step (accumulation 2) of reduced seamless
    (the encoder's B5 forward and backward with ``causal=False``) and
    minicpm (WSD, in its decay at step 10 of 10) on the card against the
    CPU: loss and grad norm at atol = rtol = 1e-4, parameters at the same
    but for a share under 1e-3 (see ``test_reduced_train_step_on_card_
    equals_cpu``), exactly one forward and one backward launch per
    attention call of each microbatch."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import make_train_step
    cfg = get_arch(name).reduced().replace(remat=False, microbatch=2)
    shape = ShapeConfig("t", 32, 4, "train")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     size=(4, 32)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (4, 24, cfg.d_model)).astype(np.float32))
    runs = []
    for dev in ("cpu", cuda):
        model = build(cfg, dev)
        params = build(cfg, "cpu").init(torch.Generator().manual_seed(0),
                                        torch.float32).to(dev)
        params.requires_grad_(True)
        step_fn, opt_init = make_train_step(model, shape, base_lr=1e-2,
                                            warmup=1, total_steps=10)
        opt = opt_init(params)
        _build.reset_launch_counts()
        params, opt, loss, gn = step_fn(
            params, opt, {k: t.to(dev) for k, t in batch.items()}, 10)
        runs.append((params, float(loss), float(gn),
                     _build.launch_counts()))
    (p_cpu, l_cpu, g_cpu, _), (p_card, l_card, g_card, counts) = runs
    calls = 2 * (3 * cfg.dec_layers if cfg.family == "encdec"
                 else cfg.n_layers)
    assert counts["flash_attention"] == calls == counts["flash_attention_bwd"]
    np.testing.assert_allclose([l_card, g_card], [l_cpu, g_cpu], atol=1e-4,
                               rtol=1e-4)
    loose = total = 0
    for a, b in zip(p_card.parameters(), p_cpu.parameters()):
        close = torch.isclose(a.detach().cpu(), b.detach(), atol=1e-4,
                              rtol=1e-4)
        loose += int((~close).sum())
        total += close.numel()
    assert loose < 1e-3 * total


_ROUTE = moe.route


def _routing(monkeypatch, record=None, replay=None):
    """Installs, in place of ``moe.route``, a route that appends each
    call's (chosen ids, f32 router logits) to ``record``, or takes each
    call's experts from ``replay`` (such a list from another run), gated
    with this run's own probabilities renormalised as ``route`` does."""
    real = _ROUTE
    calls = iter(replay or ())

    def route(p, xf, cfg):
        probs, gate_w, ids = real(p, xf, cfg)
        if replay is not None:
            ids = next(calls)[0].to(ids.device)
            gate_w = probs.gather(1, ids)
            gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
        if record is not None:
            record.append((ids.detach().cpu(),
                           (xf @ p["router"]).float().detach().cpu()))
        return probs, gate_w, ids
    monkeypatch.setattr(moe, "route", route)


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b",
                                  "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"])
def test_reduced_moe_and_hybrid_train_step_on_card_equal_cpu(cuda, name,
                                                             monkeypatch):
    """One ``make_train_step`` step (accumulation 2) of the reduced MoE and
    hybrid configs on the card against the CPU. phi3.5-moe runs B5 at G 2,
    moonshot its dense first layer and MoE layers, jamba B5 on its
    attention layers and B7 with its backward (N 16, P 8) on its mamba
    layers, with bf16 optimizer state: gradients summed in bf16 and bf16
    moments.

    A token whose router logits nearly tie may take other experts on the
    card than on the CPU, and then moves its whole output (reduced jamba
    at this seed: one token of the second microbatch's first MoE layer).
    So the card's step takes the CPU step's routes (replayed, gated with
    its own probabilities), and a free forward on the card must route as
    the CPU does except at near ties: the CPU's k-th and (k+1)-th logits
    within twice the two runs' largest logit difference (plus 2**-20 of
    the largest logit). Loss at atol = rtol = 1e-4; grad norm at the
    same, jamba's at 2**-7 relative (each bf16-summed gradient within two
    bf16 ulps of the CPU's, see ``test_torch_moe_train.py``); parameters
    at atol = rtol = 1e-4 but for a share under 1e-3 (see
    ``test_reduced_train_step_on_card_equals_cpu``); exactly one forward
    and one backward launch per attention and per mamba layer of each
    microbatch."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    cfg = get_arch(name).reduced().replace(remat=False, microbatch=2)
    shape = ShapeConfig("t", 32, 4, "train")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(4, 32)))
    cpu_routes, free_routes = [], []
    runs = []
    for dev in ("cpu", cuda):
        if dev == "cpu":
            _routing(monkeypatch, record=cpu_routes)
        else:
            _routing(monkeypatch, replay=cpu_routes)
        model = build(cfg, dev)
        params = build(cfg, "cpu").init(torch.Generator().manual_seed(0),
                                        torch.float32).to(dev)
        params.requires_grad_(True)
        step_fn, opt_init = make_train_step(model, shape, base_lr=1e-2,
                                            warmup=1, total_steps=10)
        opt = opt_init(params)
        _build.reset_launch_counts()
        params, opt, loss, gn = step_fn(params, opt,
                                        {"tokens": tokens.to(dev)}, 1)
        runs.append((params, opt, float(loss), float(gn),
                     _build.launch_counts()))
    (p_cpu, o_cpu, l_cpu, g_cpu, _), (p_card, o_card, l_card, g_card,
                                      counts) = runs
    mixers = [spec.mixer for seg in lm.build_schedule(cfg)
              for _ in range(seg.count) for spec in seg.body]
    n_mamba = mixers.count("mamba")
    n_attn = len(mixers) - n_mamba
    assert counts["flash_attention"] == 2 * n_attn == \
        counts["flash_attention_bwd"]
    assert counts["ssd_scan"] == 2 * n_mamba == counts["ssd_scan_bwd"]
    state = torch.bfloat16 if cfg.bf16_optimizer_state else torch.float32
    assert all(v.dtype == state for v in o_card.mu.values())
    np.testing.assert_allclose(l_card, l_cpu, atol=1e-4, rtol=1e-4)
    if cfg.bf16_optimizer_state:
        np.testing.assert_allclose(g_card, g_cpu, atol=0, rtol=2.0 ** -7)
    else:
        np.testing.assert_allclose(g_card, g_cpu, atol=1e-4, rtol=1e-4)
    loose = total = 0
    for a, b in zip(p_card.parameters(), p_cpu.parameters()):
        close = torch.isclose(a.detach().cpu(), b.detach(), atol=1e-4,
                              rtol=1e-4)
        loose += int((~close).sum())
        total += close.numel()
    assert loose < 1e-3 * total
    # the card's own routes: as the CPU's but at near ties
    _routing(monkeypatch, record=free_routes)
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0),
                                    torch.float32).to(cuda)
    model = build(cfg, cuda)
    with torch.no_grad():
        for mb in tokens.reshape(2, 2, 32):
            model.loss(params, {"tokens": mb.to(cuda)})
    assert len(free_routes) == len(cpu_routes) > 0
    for (ids_k, lk), (ids_c, lc) in zip(free_routes, cpu_routes):
        flip = (ids_k.sort(-1).values != ids_c.sort(-1).values).any(-1)
        top = lc.sort(-1, descending=True).values
        gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
        bound = 2 * (lk - lc).abs().amax(-1) + 2.0 ** -20 * lc.abs().amax(-1)
        assert not bool((flip & (gap > bound)).any())


# -- the control plane's device parts (measure_app, bounded_sync_deltas) ----------

def test_measure_app_on_card_launches_each_kernel_stage(cuda):
    """ISG profiled on the card with iters 3 (2 warm-up calls): each kernel
    stage launches its kernel 2 + 3 + 1 times (the last call advances the
    chain), no other stage launches any, and the chain's output equals the
    same chain on the CPU."""
    from repro_torch.core import graph, profiler
    kw = dict(batch=192, num_flows=40, seed=5)
    app = ALL_APPS()["ISG"]
    on_card = synth_packets(device=cuda, **kw)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    prof = profiler.measure_app(app, on_card, iters=3)
    counts = _build.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "dfa_regex": 6,
                      "keyed_hash": 6, "arx_cipher": 6}
    assert prof.l_p == sum(prof.l_s.values())
    assert prof.batch_bits() == float(on_card.length.sum()) * 8.0
    got, want = on_card, synth_packets(device="cpu", **kw)
    for fn in app.stages:
        got = graph.stage_runner(fn)(got)
        want = graph.stage_runner(fn)(want)
    for x, y in zip(convert.leaves_to_numpy(got),
                    convert.leaves_to_numpy(want)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float32])
def test_bounded_sync_deltas_on_card_equals_cpu(cuda, dtype):
    """Eight replicas of 2^12 per-slot counters synced on the card: int64
    bit-equal to the CPU; f32 within P · 2^-24 · Σ|delta| (the sum's order
    may differ)."""
    from repro_torch.core import state_engine as se
    rng = np.random.default_rng(0)
    P, N = 8, 1 << 12
    v = torch.zeros(P, N, dtype=dtype)
    s = torch.zeros(P, N, dtype=dtype)
    for _ in range(4):
        inc = rng.integers(0, 1 << 16, size=(P, N)) if dtype == torch.int64 \
            else rng.normal(0, 100, size=(P, N))
        v = v + torch.from_numpy(inc).to(dtype)
        got, got_snap = se.bounded_sync_deltas(v.to(cuda), s.to(cuda))
        want, want_snap = se.bounded_sync(v, s)
        assert got.is_cuda and got_snap.data_ptr() != got.data_ptr()
        if dtype == torch.int64:
            assert torch.equal(got.cpu(), want)
        else:
            bound = P * 2.0 ** -24 * (v - s).abs().sum(0, keepdim=True)
            assert bool(((got.cpu() - want).abs() <= bound).all())
        v, s = want, want_snap


# -- the control plane's third slice: the DWRR tick and a deployment's plane ----

@pytest.mark.parametrize("n", [200, 1024])
def test_vectorized_scheduler_on_card_within_contract(cuda, n):
    """The governor's DWRR tick with ``VectorizedScheduler`` on the card
    (its default device) against the port's scalar governor on the same
    seeded inputs: every tick of a warm-up and 8 steady ticks within the
    contract (``sched_kernel.contract_errors``, order from the fresh ring),
    deficits on the card, no new shape key after the warm-up tick, and two
    device-to-host reads a tick."""
    import random
    from repro_torch.core import sched_kernel as sk
    from repro_torch.core.qos import ResourceGovernor, TenantQuota
    weights = {f"m{i:04d}": float(1 + i % 4) for i in range(n)}
    scalar, kernel = ResourceGovernor(), ResourceGovernor()
    for t, w in weights.items():
        scalar.register(t, TenantQuota(weight=w))
        kernel.register(t, TenantQuota(weight=w))
    sched = sk.VectorizedScheduler()
    kernel.attach_kernel(sched)
    rng = random.Random(0)
    caps = {t: 5e4 for t in weights}
    for tick in range(9):
        if tick == 1:
            sk.reset_trace_counts()
            sk.reset_host_reads()
        q = {t: rng.uniform(0.0, 1e5) for t in weights}
        o_s, s_s = scalar.dwrr_schedule(dict(q), caps, capacity_bytes=2e6)
        o_k, s_k = kernel.dwrr_schedule(dict(q), caps, capacity_bytes=2e6)
        assert sk.contract_errors(o_s, s_s, o_k, s_k, 2e6, weights,
                                  check_order=(tick == 0)) == []
    assert sched._deficits.is_cuda
    assert sk.trace_counts() == {}
    assert sk.host_reads() == {"dwrr_step": 2 * 8}


def test_plane_from_a_deployment_on_card_equals_cpu(cuda):
    """FW and ISG placed by the controller over ``paper_cluster()``, each
    deployment's data plane built as the service runtime builds it: the
    card's outputs equal the same plane's on the CPU, and the card's plane
    launches B1 and ISG's kernel stages once a batch."""
    from repro_torch.core.controller import MeiliController
    from repro_torch.core.pool import paper_cluster
    from repro_torch.core.profiler import synthetic_profile
    ctrl = MeiliController(paper_cluster())
    lat = {"FW": {"rule_match": 200e-6, "conn_track": 150e-6},
           "ISG": {"ddos_check": 400e-6, "url_check": 300e-6,
                   "ipsec_encap": 150e-6, "sha": 250e-6, "aes": 350e-6}}
    for key, target in (("FW", 20.0), ("ISG", 5.0)):
        app = ALL_APPS()[key]
        prof = synthetic_profile(app.stage_names(), lat[key],
                                 1500 * 8 * 256.0)
        dep = ctrl.submit(app, target, prof)
        assert dep.allocation.satisfied()
        cap = ctrl._pipeline_capacity(dep.profile, dep.num_pipelines)
        planes = {d: ParallelDataPlane(dep.app,
                                       num_pipelines=dep.num_pipelines,
                                       capacity_per_pipeline=cap,
                                       metrics=ctrl.obs.metrics,
                                       trace=ctrl.obs.trace, device=d)
                  for d in ("cpu", "cuda")}
        kw = dict(batch=512, num_flows=64, pkt_bytes=256)
        _build.reset_launch_counts()
        for seed in range(3):
            got = planes["cuda"].process(synth_packets(seed=seed, **kw))
            want = planes["cpu"].process(synth_packets(seed=seed,
                                                       device="cpu", **kw))
            for x, y in zip(convert.leaves_to_numpy(got),
                            convert.leaves_to_numpy(want)):
                np.testing.assert_array_equal(x, y)
        counts = _build.launch_counts()
        assert counts["flow_lookup"] == 3
        kernels = ("dfa_regex", "keyed_hash", "arx_cipher")
        assert all(counts[k] == (3 if key == "ISG" else 0) for k in kernels)


def test_service_runtime_on_card_equals_cpu(cuda, monkeypatch):
    """Four ticks of the service runtime over the six-tenant mix, every
    tenant's plane on every tick and the DWRR tick on tensors
    (``vectorized_sched``), on the card and on the CPU with fixed clocks:
    every tenant and cluster tick, the dispatch attribution and every plane
    output are equal, and the card's planes launch B1 once a dispatch and
    each kernel stage's kernel (B2 for t-id and t-isg, B3 and B4 for t-isg)
    once a dispatch of its tenant."""
    import dataclasses
    import itertools

    from repro_torch.core.controller import MeiliController
    from repro_torch.core.pool import paper_cluster
    from repro_torch.obs import Obs
    from repro_torch.service import (RuntimeConfig, ServiceRuntime,
                                     TenantRegistry, default_tenant_mix)
    from repro_torch.service.tenants import contracts
    from repro_torch.service.workload import make_scenario

    outs = []
    proc = ParallelDataPlane.process

    def process(dp, batch, tenant=None):
        out = proc(dp, batch, tenant=tenant)
        outs[-1].append((tenant, convert.leaves_to_numpy(out)))
        return out

    monkeypatch.setattr(ParallelDataPlane, "process", process)

    def clock():
        steps = itertools.count()
        return lambda: 0.25 * next(steps)

    runs = {}
    for dev in ("cuda", "cpu"):
        outs.append([])
        ctrl = MeiliController(paper_cluster(), clock=clock(),
                               obs=Obs(clock=clock()))
        registry = TenantRegistry(ctrl)
        mix = default_tenant_mix()
        for spec in mix:
            registry.register(spec)
        wl = make_scenario("bursty", contracts(mix), seed=0)
        rt = ServiceRuntime(ctrl, registry, wl, RuntimeConfig(
            dataplane_every=1, vectorized_sched=True), device=dev)
        registry.admit_all()
        _build.reset_launch_counts()
        rt.run(4)
        runs[dev] = (rt, _build.launch_counts())
    (card, counts), (cpu, _) = runs["cuda"], runs["cpu"]
    for a, b in ((card.telemetry.tenant_ticks, cpu.telemetry.tenant_ticks),
                 (card.telemetry.cluster_ticks, cpu.telemetry.cluster_ticks)):
        assert [dataclasses.asdict(x) for x in a] == [
            dataclasses.asdict(x) for x in b]
    assert card.dataplane_stats() == cpu.dataplane_stats()
    assert len(outs[0]) == len(outs[1]) == 4 * 6
    for (t1, xs), (t2, ys) in zip(*outs):
        assert t1 == t2
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, y)
    calls = {t: v["calls"] for t, v in card.dataplane_stats().items()}
    assert counts["flow_lookup"] == sum(calls.values()) == 24
    assert counts["dfa_regex"] == calls["t-id"] + calls["t-isg"]
    assert counts["keyed_hash"] == counts["arx_cipher"] == calls["t-isg"]
    assert card.ctrl.governor._kernel.device.type == "cuda"


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["olmo-1b", "mamba2-370m",
                                  "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_dry_run_counts_equal_the_card(cuda, name, kind):
    """The dry run's meta trace of a reduced config's step (f32, batch 4 x
    64, accumulation 2 in training, a decode at pos 63 of a 64-deep
    cache) against the same call on the card: the FLOPs outside the
    kernels equal ``FlopCounterMode``'s count with ``==`` (the kernels
    launch through ctypes, which no dispatch mode sees), and the kernel
    launches equal the trace's."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.steps import make_train_step
    cfg = get_arch(name).reduced().replace(microbatch=2)
    shape = ShapeConfig(kind, 64, 4, kind)
    meta = build(cfg, "meta")
    fn, _, _ = dryrun.step_call(meta, shape, torch.float32,
                                cache_dtype=torch.float32)
    want = rl.trace(fn)
    model = build(cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {k: (torch.randint(0, cfg.vocab, v.shape, generator=g,
                               device=cuda, dtype=torch.int32)
                 if k == "tokens" else
                 torch.randn(v.shape, generator=g, device=cuda))
             for k, v in meta.input_specs(shape, torch.float32).items()}
    params = model.init(g, torch.float32)
    if kind == "train":
        params.requires_grad_(True)
        step, opt_init = make_train_step(model, shape)
        opt = opt_init(params)
        call = lambda: step(params, opt, batch, 1)
    elif kind == "prefill":
        call = lambda: model.prefill(params, batch, max_len=64,
                                     cache_dtype=torch.float32)
    else:
        cache = model.init_cache(4, 64, torch.float32)
        cache["pos"] = 63
        call = lambda: model.decode_step(params, cache, batch["tokens"])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with FlopCounterMode(display=False) as fc:
        call()
    torch.cuda.synchronize()
    assert fc.get_total_flops() == want["aten_flops"] > 0
    assert {k: n for k, n in _build.launch_counts().items() if n} == {
        k: v["launches"] for k, v in want["kernels"].items()}


def test_expert_parallel_moe_over_two_ranks_on_card_equals_cpu(cuda,
                                                              tmp_path):
    """Two ranks on one card (gloo: NCCL refuses two ranks on one device;
    the collectives go through the host) over a (1, 2) mesh: the reduced
    MoE FFN's expert-parallel path (dp_heavy_rules, the batch over data x
    model) and the global dispatch's expert-block branch (default_rules),
    each rank's block equal to the same two ranks on the CPU (f32: the
    products sum in another order, F32_TOL), the same paths taken."""
    import _torch_ep_ranks as ranks
    rng = np.random.default_rng(11)
    D, Fd, E = 64, 128, 8
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) / 8,
         "gate": rng.standard_normal((E, D, Fd)).astype(np.float32) / 8,
         "up": rng.standard_normal((E, D, Fd)).astype(np.float32) / 8,
         "down": rng.standard_normal((E, Fd, D)).astype(np.float32) / 11}
    x = rng.standard_normal((2, 64, D)).astype(np.float32)
    cases = [{"name": name, "cfg": {"n_experts": E, "top_k": 2},
              "rules": name, "dtype": "float32", "params": p, "x": x}
             for name in ("dp_heavy", "default")]
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    card = ranks.run_world("moe", 2, 2, cases, str(tmp_path / "card"),
                           device="cuda")
    host = ranks.run_world("moe", 2, 2, cases, str(tmp_path / "cpu"))
    for got, want in zip(card, host):
        assert got["coords"] == want["coords"]
        for name in ("dp_heavy", "default"):
            assert got[name]["ep"] == want[name]["ep"] == (
                1 if name == "dp_heavy" else 0)
            assert got[name]["products"] == want[name]["products"]
            assert got[name]["collectives"]["host_copy_bytes"] > 0
            assert "host_copy_bytes" not in want[name]["collectives"]
            torch.testing.assert_close(got[name]["y"], want[name]["y"],
                                       **F32_TOL)
