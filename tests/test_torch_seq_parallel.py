"""The sequence-parallel ops (``kernels/ops.py``'s ``attention_seq``,
``decode_over_blocks`` with ``merge_partials``, ``ssd_seq``, and
``models/ssm.py``'s ``conv_seq``) on each rank's block of a sequence split
over 2 and 4 ranks, held against the same ops on one device; and B6's
plain ``return_lse`` against a numpy log-sum-exp.

The ranks are gloo worlds of spawned processes on (1, 2) and (1, 4)
meshes (``_torch_ep_ranks.run_world`` with
``_torch_partition_ranks.seq_ops_case``), the functional collectives
staged through the host as on the card; every op takes the plain versions
of the kernels here. The same numpy-seeded inputs go to the world and to
one device:

* attention, forward and gradient (dq, dk, dv of out · g): causal, causal
  under a window that reaches across a rank's boundary (12 keys over
  blocks of 8 or 16), and bidirectional;
* decode over a split cache: a row whose valid length ends in the first
  block (the later ranks hold no valid key), one past the cache's depth
  (``pos >= S``: the valid length clamped to each block), the windowed
  decode's partial (gemma's local layers);
* the SSD, at Mamba-2's decays (a = exp(-softplus(N(-3, 1))), near 1),
  against ``ref.ssd_ref``'s step-by-step recurrence: y, the final state
  (the ranks' partial terms summed, and the whole state every rank
  computes) and the gradients of y · gy + h · gh;
* the causal conv across a boundary: out and the gradients of x and w
  (w's summed over the ranks, each holding its block's share);
* the rank-local path (plain blocks of the installed tokens, as
  ``_torch_ep_ranks.prefill_case`` runs the LM): reduced gemma3-1b's and
  mamba2-370m's prefill and decode steps under ``dp_heavy_rules()``
  with 2 prompts on a (2, 2) world, each sequence over the model axis:
  every rank's logits (its rows) equal one device's.

Tolerances, from the arithmetic: a rank computes the one-device
function's sums over other blocks (the keys it keeps, the state carried
into its block), so f32 sums in other orders: attention and decode to
atol = rtol = 1e-5; the SSD and conv to 1e-4 of each output's largest
entry (``test_torch_ssd.py``'s for the chunked scan against the
recurrence).
"""
import numpy as np
import pytest
import torch

import _torch_ep_ranks as epr
import _torch_partition_ranks as pr
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import LSE_EMPTY
from repro_torch.models import attention as attn
from repro_torch.models import ssm

WORLD_TIMEOUT_S = 120
B, S, HQ, HKV, D = 2, 32, 4, 2, 16
ATTENTION = ((True, None), (True, 12), (False, None))
WINDOW = 12
KV_LENS = ((5, 29), (35, 32))          # ends in block 0; past the depth
SSD_H, SSD_P, SSD_N, CHUNK = 4, 8, 16, 8
CONV_K, CONV_CH = 4, 8
ATOL = RTOL = 1e-5
SCALED = 1e-4


def _inputs():
    rng = np.random.default_rng(34)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    softplus = lambda t: np.log1p(np.exp(t))
    return {
        "attention": ATTENTION,
        "attn": {"q": f(B, S, HQ, D), "k": f(B, S, HKV, D),
                 "v": f(B, S, HKV, D), "g": f(B, S, HQ, D)},
        "decode": {"q": f(B, HQ, D), "k": f(B, S, HKV, D),
                   "v": f(B, S, HKV, D), "kv_len": KV_LENS,
                   "window": WINDOW},
        "ssd": {"x": f(B, S, SSD_H, SSD_P),
                "a": np.exp(-softplus(f(B, S, SSD_H) - 3.0)),
                "b": f(B, S, SSD_H, SSD_N), "c": f(B, S, SSD_H, SSD_N),
                "gy": f(B, S, SSD_H, SSD_P), "gh": f(B, SSD_H, SSD_N, SSD_P),
                "chunk": CHUNK},
        "conv": {"x": f(B, S, CONV_CH), "w": f(CONV_K, CONV_CH),
                 "g": f(B, S, CONV_CH)},
    }


def _one_device(inp):
    """The same ops on one device: the whole tensors' outputs and
    gradients, as numpy, keyed as ``seq_ops_case``'s."""
    t = lambda a: torch.from_numpy(a).requires_grad_(True)
    out = {}
    a = inp["attn"]
    for causal, window in ATTENTION:
        q, k, v = t(a["q"]), t(a["k"]), t(a["v"])
        o = ops.attention(q, k, v, causal=causal, window=window)
        out[("attention", causal, window)] = [o.detach().numpy()] + [
            g.numpy() for g in torch.autograd.grad(
                o, (q, k, v), torch.from_numpy(a["g"]))]
    d = inp["decode"]
    q, k, v = (torch.from_numpy(d[n]) for n in ("q", "k", "v"))
    for lens in KV_LENS:
        kv_len = torch.tensor(lens, dtype=torch.int32)
        lo = (kv_len - WINDOW).clamp_min(0)
        out[("decode", lens)] = [
            ops.decode_attention(q, k, v, kv_len).numpy(),
            attn.window_partial(q, k, v, lo, kv_len, 0)[0].numpy()]
    z = inp["ssd"]
    x, a_, b, c = (t(z[n]) for n in ("x", "a", "b", "c"))
    y, h = ref.ssd_ref(x, a_, b, c)
    loss = (y * torch.from_numpy(z["gy"])).sum() + \
        (h * torch.from_numpy(z["gh"])).sum()
    out["ssd"] = [y.detach().numpy(), h.detach().numpy()] + [
        g.numpy() for g in torch.autograd.grad(loss, (x, a_, b, c))]
    cv = inp["conv"]
    x, w = t(cv["x"]), t(cv["w"])
    o = ssm._causal_conv(x, w)
    out["conv"] = [o.detach().numpy()] + [
        g.numpy() for g in torch.autograd.grad(o, (x, w),
                                               torch.from_numpy(cv["g"]))]
    return out


LOCAL_ARCHS = ("gemma3-1b", "mamba2-370m")


def _local_inputs():
    rng = np.random.default_rng(35)
    return {"archs": LOCAL_ARCHS,
            "tokens": rng.integers(0, 512, (2, S)).astype(np.int32),
            "decode": rng.integers(0, 512, (2, 2)).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("seq_ops"))
    inp = _inputs()
    worlds = {n: epr.run_world("seq_ops", n, n, inp, work, WORLD_TIMEOUT_S,
                               module="_torch_partition_ranks")
              for n in (2, 4)}
    local = epr.run_world("local_prefill", 4, 2, _local_inputs(), work,
                          WORLD_TIMEOUT_S, module="_torch_partition_ranks")
    return {"worlds": worlds, "one": _one_device(inp), "local": local}


def _block(a, r, n, dim=1):
    size = a.shape[dim] // n
    return np.take(a, np.arange(r * size, (r + 1) * size), axis=dim)


def _close(got, want, what, scaled=False):
    atol = SCALED * np.abs(want).max() if scaled else ATOL
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=0.0 if scaled else RTOL, err_msg=what)


WORLD_SIZES = (2, 4)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("causal,window", ATTENTION)
def test_attention_over_split_sequence_equals_one_device(runs, n, causal,
                                                         window):
    """Each rank's queries against the gathered keys it keeps: its block of
    the output and of dq, and of dk and dv (the reduce-scatter of every
    rank's gradient of the gathered keys)."""
    want = runs["one"][("attention", causal, window)]
    for r, rank in enumerate(runs["worlds"][n]):
        got = rank[("attention", causal, window)]
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            _close(g, _block(w, r, n), f"{name} rank {r} of {n}")


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("lens", KV_LENS)
def test_decode_over_split_cache_equals_one_device(runs, n, lens):
    """B6's partial (out, lse) over each rank's block, merged by
    log-sum-exp, and the windowed decode's, equal one device's decode on
    every rank: a block with no valid key (LSE_EMPTY) weighs nothing, and
    a valid length past the cache's depth is clamped to each block."""
    want = runs["one"][("decode", lens)]
    for r, rank in enumerate(runs["worlds"][n]):
        got = rank[("decode", lens)]
        for name, g, w in zip(("b6", "window"), got, want):
            _close(g, w, f"{name} rank {r} of {n}")


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_ssd_over_split_sequence_equals_recurrence(runs, n):
    """y on each rank's block with the state carried in from the earlier
    blocks; the final state as the ranks' partial terms' sum and as the
    whole state each rank computes; the gradients of x, a, b and c (the
    earlier blocks' through the state exchange's gather)."""
    y, h, *grads = runs["one"]["ssd"]
    ranks = runs["worlds"][n]
    _close(sum(rank["ssd"][1] for rank in ranks), h, "h (partial sum)",
           scaled=True)
    for r, rank in enumerate(ranks):
        got_y, _, got_h, *got = rank["ssd"]
        _close(got_y, _block(y, r, n), f"y rank {r}", scaled=True)
        _close(got_h, h, f"h rank {r}", scaled=True)
        for name, g, w in zip(("dx", "da", "db", "dc"), got, grads):
            _close(g, _block(w, r, n), f"{name} rank {r} of {n}",
                   scaled=True)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_conv_across_rank_boundary_equals_one_device(runs, n):
    """Each rank's block convolved after the previous rank's last K - 1
    rows (zeros on rank 0), its dx (the tail's share through the gather's
    adjoint), and dw summed over the ranks."""
    out, dx, dw = runs["one"]["conv"]
    ranks = runs["worlds"][n]
    for r, rank in enumerate(ranks):
        _close(rank["conv"][0], _block(out, r, n), f"out rank {r}",
               scaled=True)
        _close(rank["conv"][1], _block(dx, r, n), f"dx rank {r}",
               scaled=True)
    _close(sum(rank["conv"][2] for rank in ranks), dw, "dw", scaled=True)


def test_decode_attention_lse_equals_numpy_logsumexp():
    """B6's plain version with ``return_lse``: each row's log-sum-exp of
    its scaled logits over s < kv_len (f64 numpy), ``LSE_EMPTY`` and an
    output of 0 where kv_len is 0; the output as without lse."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, HQ, D)).astype(np.float32)
    k = rng.standard_normal((3, 40, HKV, D)).astype(np.float32)
    v = rng.standard_normal((3, 40, HKV, D)).astype(np.float32)
    lens = np.array([0, 17, 40], np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    out, lse = da.decode_attention_torch(*args, block_k=16, return_lse=True)
    assert torch.equal(out, da.decode_attention_torch(*args, block_k=16))
    assert lse.shape == (3, HQ) and lse.dtype == torch.float32
    G = HQ // HKV
    for b in range(3):
        if lens[b] == 0:
            assert (lse[b] == LSE_EMPTY).all() and (out[b] == 0).all()
            continue
        for h in range(HQ):
            s = (k[b, :lens[b], h // G].astype(np.float64)
                 @ q[b, h].astype(np.float64)) * D ** -0.5
            want = s.max() + np.log(np.exp(s - s.max()).sum())
            np.testing.assert_allclose(float(lse[b, h]), want, rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("arch", LOCAL_ARCHS)
def test_rank_local_prefill_over_split_sequence_equals_one_device(runs,
                                                                   arch):
    """A rank's plain block of the installed prompts, each sequence over
    the model axis: its positions are its block's, its attention (gemma's
    windowed and global layers) or its conv and SSD (mamba) run the
    sequence-parallel paths, its cache gets the gathered keys and values
    (or the last rank's conv tails and the whole state), and its logits
    of the prefill and 2 decode steps equal one device's rows."""
    inp = _local_inputs()
    one = pr.local_prefill(get_arch(arch).reduced(), inp["tokens"],
                           inp["decode"])["logits"]
    for r in runs["local"]:
        got = r[arch]
        assert got["spec"] == ("data", "model")
        rows = _block(one, r["coords"]["data"], 2)
        np.testing.assert_allclose(got["logits"], rows, atol=1e-4,
                                   rtol=1e-4)
        n = get_arch(arch).reduced().n_layers
        want = {"attention_seq": n} if arch == "gemma3-1b" else \
            {"ssd_seq": n, "conv_seq": 2 * n}
        assert {k: v for k, v in got["seq"].items() if v} == want
