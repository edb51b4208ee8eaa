"""Training the MoE and hybrid families, held against the JAX package.

Same numpy-seeded inputs through both packages, on the CPU (the port's
plain versions; the reference's global-dispatch MoE, its blocked attention
and, where a model has mamba layers, its step-by-step SSD):

* ``moe_ffn``'s gradients (tokens, router, gate, up and down) against
  ``jax.vjp`` of the reference's ``moe_ffn``, at (E, k) = (4, 2) and (8, 3),
  past an expert's capacity and at a top-k tie;
* reduced moonshot-v1-16b-a3b (a dense first layer, then MoE layers),
  phi3.5-moe-42b-a6.6b (GQA, G 2 reduced) and jamba-1.5-large-398b
  (attention every 4th layer, MoE every 2nd, mamba elsewhere) ``Model.loss``
  and its gradients against ``jax.value_and_grad`` of the reference's
  ``lm_loss``;
* one and three ``make_train_step`` steps (accumulation 2) against the
  reference's, from its parameters and AdamW state; jamba's config keeps
  bf16 optimizer state, so its gradients are summed in bf16 and its
  moments are bf16;
* ``launch.train`` on a reduced MoE config, ending as the reference's CLI
  ends.

What flows where: the gradient reaches the router through the renormalised
top-k gate weights (the softmax, then the gather of the chosen
probabilities), never through the sort that chose them; a (token, choice)
dropped past its expert's capacity gets no expert gradient, and its gate
weight gets none either.

Tolerances, from the arithmetic:
* f32 gradients. Both packages sum the same products in other orders
  (``torch.bmm`` against XLA's dots, a gather-and-add combine against a
  scatter-add), so every gradient entry agrees to a few f32 ulps of the
  largest entries it sums: held to 1e-5 of each gradient's largest entry
  (and rtol 1e-5). The reduced models' losses and gradients are held as
  olmo's are (``test_torch_train.py``: atol = rtol = 1e-5), jamba's A_log
  and dt_bias gradients as mamba's (1e-4 of their largest entry).
* f32 train steps: as olmo's (``test_torch_train.py``'s docstring): loss
  and grad norm at 1e-5, moments at atol 1e-5 / rtol 1e-4, parameters at
  the same but for a share under 1e-3, all within the bound AdamW puts on
  two runs' parameters.
* bf16 gradient sums and bf16 moments (jamba). Both packages round the
  same f32 gradients to bf16, sum the two microbatches and halve in bf16,
  and round the moments to bf16, in the same order; their f32 gradients
  differ by at most ~1e-5 of their scale (the f32 tolerance above). A
  bf16 rounding of two values that close gives the same value unless a
  rounding boundary lies between them, which happens for a share of about
  1e-5 / 2**-8 = 2.6e-3 of the entries per rounding; three roundings
  reach each moment. So the moments are bit-equal but for a share under
  1e-2 (a step that sums the gradients in f32 instead leaves about half
  of them unequal), and where they differ, by a few ulps of the largest
  value in the sum: every entry within 2**-6 (four ulps) of the moment's
  largest entry. The grad norm, a norm of gradients each within two ulps
  of the other package's (|‖a‖ − ‖b‖| ≤ ‖a − b‖), within 2**-7 relative.
  The f32 parameters move by lr times m̂ / (sqrt(v̂) + eps): held as
  olmo's parameters are (a share under 1e-3 off the tight tolerance, all
  within AdamW's bound).

On the card the backward of the two gathers (tokens into expert slots,
slot outputs into the combine) is an ``index_put`` with accumulation,
which there sorts its indices and adds each index's rows in that order:
two backward calls at moonshot's widths gave bit-equal gradients on an
H100 (``chip_smoke.py``'s ``moe_backward_repeat``). The card's MoE step is
still held to its plain version at a tolerance, as every step is: the
attention kernels' arithmetic differs from the plain versions'.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import train as jtrain
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build as jbuild
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build, lm, moe

GRAD_TOL = 1e-5                       # of each gradient's largest entry
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_GNORM_RTOL = 2.0 ** -7
BF16_MOMENT_SHARE = 1e-2              # of entries not bit-equal
BF16_MOMENT_ATOL = 2.0 ** -6          # of the moment's largest entry
ARCH_NAMES = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
              "jamba-1.5-large-398b"]


def _np(t):
    return t.detach().float().cpu().numpy()


def _cfgs(arch, **kw):
    jcfg = ARCHS[arch].reduced().replace(remat=False, **kw)
    tcfg = get_arch(arch).reduced().replace(remat=False, **kw)
    assert jcfg.__dict__ == tcfg.__dict__
    return jcfg, tcfg


def _tokens(rng, B, S, vocab):
    return rng.integers(2, vocab, size=(B, S)).astype(np.int32)


def _assert_grad_close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=GRAD_TOL * scale,
                               rtol=GRAD_TOL, err_msg=what)


# -- moe_ffn's backward -------------------------------------------------------

def _moe_params(jcfg, seed):
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return {k: np.asarray(v, np.float32) for k, v in jp.items()}


def _moe_grads(jcfg, tcfg, p, x, dy):
    """(output, {name: gradient}) of each package's ``moe_ffn`` at (p, x)
    under the cotangent dy; names x, router, gate, up, down."""
    @jax.jit
    def f(pj, xj):
        return jmoe.moe_ffn(pj, xj, jcfg)
    jout, vjp = jax.vjp(f, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    want = {"x": np.asarray(jgx), **{k: np.asarray(v)
                                     for k, v in jgp.items()}}
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in
          p.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    out = moe.moe_ffn(tp, tx, tcfg)
    out.backward(torch.from_numpy(dy))
    got = {"x": _np(tx.grad), **{k: _np(v.grad) for k, v in tp.items()}}
    np.testing.assert_allclose(_np(out), np.asarray(jout), **LOSS_TOL)
    return got, want


def _exact_inputs(rng, T, D):
    """Tokens of -1, 0 and 1 halves: with router entries in eighths, every
    logit is an exact f32 sum, so equal router columns tie exactly."""
    return (rng.integers(-1, 2, size=(T, D)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("E,k,B,S", [(4, 2, 2, 24), (8, 3, 3, 40)])
def test_moe_grads_equal_reference(E, k, B, S):
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", n_experts=E, top_k=k)
    p = _moe_params(jcfg, seed=E + k)
    rng = np.random.default_rng(E * k + S)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    got, want = _moe_grads(jcfg, tcfg, p, x, dy)
    for name in ("x", "router", "gate", "up", "down"):
        assert np.abs(want[name]).max() > 0, name
        _assert_grad_close(got[name], want[name], name)


def test_moe_grads_past_capacity_equal_reference():
    """Every token prefers expert 0: 200 tokens x top-2 over 4 experts give
    C = 128, so the last 72 tokens' first choices drop. Gradients equal
    the reference's, and a cotangent on the dropped tokens alone reaches
    no weight of expert 0."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b")
    D = jcfg.d_model
    rng = np.random.default_rng(4)
    p = _moe_params(jcfg, seed=1)
    router = rng.integers(-2, 3, size=(D, 4)).astype(np.float32) / 8
    router[0] = [8.0, 0.0, 0.0, 0.0]
    p["router"] = router
    x = _exact_inputs(rng, 200, D)
    x[:, 0] = 1.0
    x = x.reshape(2, 100, D)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    got, want = _moe_grads(jcfg, tcfg, p, x, dy)
    for name in ("x", "router", "gate", "up", "down"):
        _assert_grad_close(got[name], want[name], name)
    dropped = np.zeros(x.shape, np.float32)
    dropped.reshape(200, D)[128:] = dy.reshape(200, D)[128:]
    got, want = _moe_grads(jcfg, tcfg, p, x, dropped)
    for name in ("gate", "up", "down"):
        assert not got[name][0].any() and not want[name][0].any(), name
        assert got[name][1:].any(), name
        _assert_grad_close(got[name], want[name], name)


def test_moe_grads_at_a_top_k_tie_equal_reference():
    """Router columns 1 and 2 equal, column 0 far above and column 3 far
    below: every token's second choice ties between experts 1 and 2, both
    packages take expert 1, and expert 2 gets no gradient."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b")
    D = jcfg.d_model
    rng = np.random.default_rng(3)
    p = _moe_params(jcfg, seed=0)
    router = rng.integers(-2, 3, size=(D, 4)).astype(np.float32) / 8
    router[:, 2] = router[:, 1]
    router[0] = [8.0, 0.0, 0.0, -8.0]
    p["router"] = router
    x = _exact_inputs(rng, 24, D)
    x[:, 0] = 1.0
    x = x.reshape(2, 12, D)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    _, _, ids = moe.route({k: torch.tensor(v) for k, v in p.items()},
                          torch.tensor(x.reshape(24, D)), tcfg)
    assert (ids.numpy() == [0, 1]).all()
    got, want = _moe_grads(jcfg, tcfg, p, x, dy)
    for name in ("x", "router", "gate", "up", "down"):
        _assert_grad_close(got[name], want[name], name)
    for name in ("gate", "up", "down"):
        assert not got[name][2].any() and not want[name][2].any(), name


# -- the reduced models' loss and gradients -----------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_equal_reference(arch):
    """Reduced moonshot (its first layer dense), phi3.5-moe (G 2) and jamba
    (B 2, S 32; the reference's SSD ``impl="ref"``, the step-by-step
    recurrence: its blocked SSD is NaN at Mamba-2's decays over long
    chunks, ROADMAP §C) against ``jax.value_and_grad`` of ``lm_loss``."""
    jcfg, tcfg = _cfgs(arch)
    jparams, _ = jbuild(jcfg).init(jax.random.PRNGKey(6), jnp.float32)
    tokens = _tokens(np.random.default_rng(7), 2, 32, jcfg.vocab)
    impl = "ref" if jcfg.ssm_state else "blocked"
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(jcfg, p, jnp.asarray(tokens), impl=impl)))(
            jparams)
    params = convert.lm_params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                           jparams),
                                        "cpu").requires_grad_(True)
    loss = lm.lm_loss(tcfg, params, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    want = convert.lm_named_from_jax(tcfg, jax.tree.map(np.asarray, jgrads),
                                     "cpu")
    named = dict(params.named_parameters())
    assert set(named) == set(want)
    assert any(".moe." in k for k in named)
    for k, p in named.items():
        w = _np(want[k])
        if k.endswith(("A_log", "dt_bias")):
            tol = dict(atol=1e-4 * np.abs(w).max(), rtol=1e-4)
        else:
            tol = LOSS_TOL
        np.testing.assert_allclose(_np(p.grad), w, **tol, err_msg=k)


# -- train steps --------------------------------------------------------------

def _adamw_bound(steps, lr=1e-2, b1=0.9, b2=0.95):
    """The most two runs' parameters can part after ``steps`` AdamW steps
    at ``lr`` from one start (``test_torch_train.py``'s docstring)."""
    return sum(2 * lr * 0.1 / np.sqrt(0.05)
               * np.sqrt(sum((b1 * b1 / b2) ** k for k in range(t)))
               * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
               for t in range(1, steps + 1))


S_TRAIN = 32


@functools.lru_cache(maxsize=None)
def _reference_step(arch):
    """The reference's seeded parameters, AdamW state and jitted
    ``make_train_step`` (batch 4 x S_TRAIN, accumulation 2) for ``arch``,
    compiled once for the one- and three-step tests."""
    jcfg, _ = _cfgs(arch, microbatch=2)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(8), jnp.float32)
    jstep, jopt_init = jmake_train_step(jmodel, JShapeConfig(
        "t", S_TRAIN, 4, "train"), make_host_mesh(), base_lr=1e-2,
        warmup=1, total_steps=10)
    assert jstep.accum == 2
    return jparams, jopt_init(jparams), jax.jit(jstep)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_steps_equal_reference(arch, steps):
    """``steps`` steps of the port's ``make_train_step`` (batch 4 x 32,
    accumulation 2) against the reference's, from the reference's
    parameters and AdamW state. jamba's steps sum gradients in bf16 and
    keep bf16 moments (its config's ``bf16_optimizer_state``), and each
    starts from the reference's state after the step before, as the
    mamba steps do (``test_torch_train.py``): left free, its mamba layers
    carry AdamW's near-eps differences into later gradients."""
    jcfg, tcfg = _cfgs(arch, microbatch=2)
    bf16 = tcfg.bf16_optimizer_state
    assert bf16 == (arch == "jamba-1.5-large-398b")
    B, S = 4, S_TRAIN
    jparams, jopt, jstep = _reference_step(arch)
    step_fn, _ = make_train_step(build(tcfg, "cpu"),
                                 ShapeConfig("t", S, B, "train"),
                                 base_lr=1e-2, warmup=1, total_steps=10)
    assert step_fn.accum == 2
    load = lambda tree: jax.tree.map(np.asarray, tree)
    params = opt = None
    rng = np.random.default_rng(steps + len(arch))
    for s in range(steps):
        if s == 0 or bf16:
            params = convert.lm_params_from_jax(
                tcfg, load(jparams), "cpu").requires_grad_(True)
            opt = convert.adamw_state_from_jax(tcfg, load(jopt), "cpu")
        tokens = _tokens(rng, B, S, jcfg.vocab)
        jparams, jopt, jloss, jgn = jstep(jparams, jopt,
                                          {"tokens": jnp.asarray(tokens)},
                                          jnp.int32(s + 1))
        params, opt, loss, gn = step_fn(params, opt,
                                        {"tokens": torch.from_numpy(tokens)},
                                        s + 1)
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
        gn_tol = dict(atol=0, rtol=BF16_GNORM_RTOL) if bf16 else LOSS_TOL
        np.testing.assert_allclose(float(gn), float(jgn), **gn_tol)
    assert int(opt.count) == int(jopt.count) == steps
    state_dtype = torch.bfloat16 if bf16 else torch.float32
    for what, got, want in (("mu", opt.mu, jopt.mu), ("nu", opt.nu,
                                                      jopt.nu)):
        want = convert.lm_named_from_jax(tcfg, load(want), "cpu")
        unequal = total = 0
        for k in want:
            assert got[k].dtype == want[k].dtype == state_dtype, k
            g, w = _np(got[k]), _np(want[k])
            tol = (dict(atol=BF16_MOMENT_ATOL * np.abs(w).max(), rtol=0)
                   if bf16 else STEP_TOL)
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} {k}")
            unequal += int((g != w).sum())
            total += g.size
        if bf16:
            assert unequal < BF16_MOMENT_SHARE * total, what
    bound = _adamw_bound(1 if bf16 else steps)
    want = convert.lm_named_from_jax(tcfg, load(jparams), "cpu")
    loose = total = 0
    for k, p in params.named_parameters():
        g, w = _np(p), _np(want[k])
        assert np.abs(g - w).max() <= bound * 1.001, k
        loose += int((~np.isclose(g, w, **STEP_TOL)).sum())
        total += g.size
    assert loose < 1e-3 * total


# -- the training CLI ---------------------------------------------------------

def test_train_cli_on_a_reduced_moe_arch(tmp_path, capsys):
    """``launch.train --arch moonshot-v1-16b-a3b --reduced --device cpu``
    runs its steps and ends as the reference's CLI ends: exit code 0, a
    log line at every ``--log-every`` step and the ``done`` line, each of
    the same form; a finite loss that falls over the run."""
    args = ["--arch", "moonshot-v1-16b-a3b", "--reduced", "--steps", "6",
            "--batch", "4", "--seq", "32", "--log-every", "2",
            "--ckpt-every", "100"]
    assert jtrain.main(args + ["--ckpt-dir", str(tmp_path / "j")]) == 0
    want = capsys.readouterr().out.splitlines()
    assert train.main(args + ["--ckpt-dir", str(tmp_path / "t"),
                              "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    form = lambda line: " ".join(w if not any(c.isdigit() for c in w)
                                 else "#" for w in line.split())
    assert [form(l) for l in got] == [form(l) for l in want]
    assert len(got) == 4 and got[-1].startswith("[train] done: loss ")
    first, last = (float(v) for v in got[-1].split()[3:6:2])
    assert np.isfinite(first) and last < first
