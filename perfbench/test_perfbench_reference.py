"""The benchmark's plain reference against the program's plain path at the
program's reduced sizes, its blocked parts against their plain forms, and
its FLOP counts against ``FlopCounterMode``."""
import math

import pytest
import torch
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.utils.flop_counter import FlopCounterMode

from pbench import check, harness, spec, weights
from pbench.counts import dense as dense_counts
from pbench.counts import kernels
from pbench.counts import ssm as ssm_counts
from pbench.reference import common
from pbench.reference import ssm as ssm_ref

CELLS = ("olmo-1b.train.ctx2k", "mamba2-370m.train.seq16k")
SEED = 4_000_000_007


@pytest.mark.parametrize("name", CELLS)
def test_reference_loss_and_gradients_equal_the_program_plain_path(
        tiny_cell, name):
    cell, arch = tiny_cell(name)
    prog = harness.Program(cell, SEED, "cpu", arch, impl="torch")
    tokens = torch.from_numpy(prog.batches[0])
    named = dict(prog.params.named_parameters())
    loss = prog.model.loss(prog.params, {"tokens": tokens}, impl="torch")
    grads = torch.autograd.grad(loss, list(named.values()))
    fam = spec.family_module("reference", cell.config["family"])
    P = {n: t.requires_grad_(True) for n, t in
         weights.make(fam.leaves(cell.config["model"]), SEED, "cpu").items()}
    ref = fam.loss(cell.config["model"], P, tokens,
                   common.Products("f32", torch.device("cpu")))
    ref_grads = torch.autograd.grad(ref, [P[n] for n in named])
    assert float(loss.detach()) == pytest.approx(float(ref.detach()),
                                                 rel=1e-6)
    for n, g, r in zip(named, grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6 * r.abs().max(),
                                   msg=n)


@pytest.mark.parametrize("name", CELLS)
def test_checked_adamw_steps_equal_the_program_plain_path(tiny_cell, name):
    cell, arch = tiny_cell(name)
    prog = harness.Program(cell, SEED, "cpu", arch, impl="torch")
    mine = prog.checked_steps()
    ref = harness.reference_readings(cell, SEED, "cpu")
    nums = check.numbers(mine, ref)
    assert all(v < 1e-5 for v in nums.values()), nums
    assert mine.losses[0] != mine.losses[1]


def test_blocked_attention_equals_full_softmax_and_its_gradient():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 11, 3, 8, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    prod = common.Products("f32", torch.device("cpu"))
    out = common.attention(q, k, v, prod, block=4)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(8)
    s = s.masked_fill(torch.ones(11, 11, dtype=torch.bool).triu(1),
                      float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    torch.testing.assert_close(out, want)
    dout = torch.randn(out.shape, generator=g, dtype=torch.float64)
    got = torch.autograd.grad(out, (q, k, v), dout)
    exp = torch.autograd.grad(want, (q, k, v), dout)
    for a, b in zip(got, exp):
        torch.testing.assert_close(a, b)


def test_chunked_ssd_equals_the_recurrence():
    g = torch.Generator().manual_seed(1)
    B, S, H, P, N = 2, 24, 3, 4, 5
    x = torch.randn(B, S, H, P, generator=g, dtype=torch.float64)
    a = torch.rand(B, S, H, generator=g, dtype=torch.float64) * 0.9 + 0.05
    b = torch.randn(B, S, H, N, generator=g, dtype=torch.float64)
    c = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    y = ssm_ref.ssd(x, a, b, c, 8, common.Products("f32",
                                                   torch.device("cpu")))
    h = torch.zeros(B, H, N, P, dtype=torch.float64)
    for t in range(S):
        h = a[:, t, :, None, None] * h + b[:, t, :, :, None] * x[:, t, :,
                                                                  None, :]
        torch.testing.assert_close(y[:, t],
                                   torch.einsum("bn,bhnp->bhp", c[:, t], h))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 1.0 + 2**-12])
    assert common.to_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0]


def _counted(fn) -> int:
    """FLOPs of fn by FlopCounterMode, each checkpointed forward recomputed
    whole."""
    with set_checkpoint_early_stop(False), \
            FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _step_counted(cell, P, tokens, prod):
    fam = spec.family_module("reference", cell.config["family"])

    def fwd_bwd():
        leaves = {n: t.detach().requires_grad_(True) for n, t in P.items()}
        loss = fam.loss(cell.config["model"], leaves, tokens, prod)
        torch.autograd.grad(loss, list(leaves.values()))
    return _counted(fwd_bwd)


def test_dense_flops_equal_flop_counter(tiny_cell):
    """Every product counted, with causal attention at its pairs (one-row
    blocks compute no pair above the diagonal); FlopCounterMode also
    counts the backward's recompute of QKᵀ (2·D a pair) and the
    rematerialized forwards, which the model FLOPs leave out."""
    cell, _ = tiny_cell("olmo-1b.train.ctx2k", seq=12, rows=2)
    cfg = dict(cell.config["model"], attention_block=1)
    cell.config["model"] = cfg
    rows, seq = 2, 12
    P = weights.make(spec.family_module("reference", "dense").leaves(cfg),
                     SEED, "cpu")
    tokens = torch.randint(2, cfg["vocab"], (rows, seq),
                           generator=torch.Generator().manual_seed(3))
    prod = common.Products("f32", torch.device("cpu"))
    counted = _step_counted(cell, P, tokens, prod)
    parts = dense_counts.step_flops(cfg, rows, seq)
    L, H, D = cfg["n_layers"], cfg["n_heads"], cfg["head_dim"]
    pairs = rows * H * kernels.causal_pairs(seq, seq)
    fwd = (parts["gemm"] + parts["head"]) / 3 + L * 4 * D * pairs
    recompute = L * 2 * D * pairs
    assert counted == sum(parts.values()) + recompute + fwd


def test_ssm_flops_equal_flop_counter(tiny_cell, monkeypatch):
    """The projections and the table counted by FlopCounterMode (the SSD
    stood in for by a product-free recurrence; the conv is elementwise and
    counted apart); with the remat's forwards counted once more."""
    cell, _ = tiny_cell("mamba2-370m.train.seq16k", seq=16, rows=2)
    cfg = cell.config["model"]
    monkeypatch.setattr(
        ssm_ref, "ssd", lambda x, a, b, c, chunk, prod: x * a[..., None]
        + b.sum(-1, keepdim=True) * c.sum(-1)[:, :, None, None])
    P = weights.make(spec.family_module("reference", "ssm").leaves(cfg),
                     SEED, "cpu")
    tokens = torch.randint(2, cfg["vocab"], (2, 16),
                           generator=torch.Generator().manual_seed(4))
    prod = common.Products("f32", torch.device("cpu"))
    counted = _step_counted(cell, P, tokens, prod)
    parts = ssm_counts.step_flops(cfg, 2, 16)
    mm = parts["gemm"] + parts["head"]
    assert counted == mm + mm / 3
    H, Pd, N = cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["ssm_state"]
    assert parts["ssd"] == 3 * cfg["n_layers"] * 5 * 2 * 16 * H * N * Pd
    assert parts["conv"] == 6 * cfg["n_layers"] * 2 * 16 * \
        cfg["conv_kernel"] * (cfg["d_inner"] + 2 * N)


def test_kernel_bounds_count_pairs_and_bytes():
    assert kernels.causal_pairs(4, 4) == 10
    assert kernels.causal_pairs(2, 4) == 7
    f, b = kernels.attention_fwd(1, 4, 2, 2, 8)
    assert f == 4 * 8 * 2 * 10 and b == 4 * 4 * 2 * 8 * 4 + 2 * 4 * 4
    f, _ = kernels.attention_bwd(1, 4, 2, 2, 8)
    assert f == 8 * 8 * 2 * 10
    f, b = kernels.ssd_fwd(1, 8, 2, 4, 3)
    assert f == 5 * 8 * 2 * 4 * 3
    assert b == (2 * 8 * 2 * 4 + 8 * 2 * 3 + 8 * 3) * 4 + 8 * 2 * 4 \
        + 2 * 3 * 4 * 4
