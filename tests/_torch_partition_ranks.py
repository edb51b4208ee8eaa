"""Rank workers of the partitioned-step tests, and the one function that
runs a reduced model's steps on one device or over a mesh.

No JAX here: the workers run in processes spawned from a test (gloo over
localhost, one process a rank, through ``_torch_ep_ranks.run_world``) or
from ``chip_smoke.py`` on the card.

``run_steps(cfg, params, inputs, mesh, rules, device)`` takes whole
parameters (the same on every rank), places them (``Model.distribute``),
runs one ``make_train_step`` step, then, from the same starting
parameters, one ``make_prefill_step`` and ``len(decode)`` ``make_serve_step``
steps, and returns every result whole (``full_tensor``) as numpy: with
``mesh=None`` the same calls on one device, which is what the ranks are
held to.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import _build
from repro_torch.launch import roofline
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step, partitioned,
                                      place_batch)
from repro_torch.models import build
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh

LR = dict(base_lr=1e-2, warmup=1, total_steps=10)


def rules_of(name: str, cfg, mesh):
    """``"auto"``: the table ``rules_for`` picks on ``mesh``; else
    ``"dp_heavy"``."""
    if name == "auto":
        return sh.rules_for(cfg, mesh)
    assert name == "dp_heavy", name
    return sh.dp_heavy_rules()


def _np(t: torch.Tensor) -> np.ndarray:
    if sh.is_dtensor(t):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def _block(t: torch.Tensor):
    """(this rank's block of a DTensor as numpy, the block's (offset,
    size) in each dim of the whole tensor)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return (t.to_local().detach().float().cpu().numpy(),
            tuple(zip(offset, shape)))


def blocks_of(want: Dict[str, Any], got: Dict[str, Any]) -> Dict[str, Any]:
    """``want`` (whole results) with its parameters and moments cut to
    the blocks ``got`` holds (``run_steps(..., whole=False)``)."""
    cut = lambda a, ix: a[tuple(slice(o, o + n) for o, n in ix)]
    out = dict(want)
    for m in ("params", "mu", "nu"):
        out[m] = {k: cut(a, got["index"][k]) for k, a in want[m].items()}
    return out


def _lm(cfg, params, device):
    """A fresh LM from whole parameters: a numpy tree in the reference's
    layout (converted), or a function of the device that makes one."""
    if callable(params):
        return params(device)
    return convert.lm_params_from_jax(cfg, params, device=device)


def run_steps(cfg, params, inputs: Dict[str, Any], mesh, rules,
              device="cpu", impl: Optional[str] = None,
              counted: bool = True, whole: bool = True) -> Dict[str, Any]:
    """One train step, a prefill and decode steps of ``cfg`` from
    ``params``; ``inputs`` holds numpy ``train`` tokens (B, S), ``prefill``
    tokens (B, S), ``decode`` tokens (steps, B) and ``max_len``. Returns
    the loss, grad norm, every parameter and moment after the step, the
    prefill's and each decode step's logits, with ``counted`` the
    collectives each phase issued (``roofline.collective_bytes``), and
    each phase's seconds (on the card, synchronised) and kernel launches
    (``_build.launch_counts``). Without ``whole`` the parameters and
    moments are this rank's blocks, placed by ``index`` (``blocks_of``),
    and no collective gathers them."""
    model = build(cfg, device)
    mesh = mesh if partitioned(mesh) else None
    out: Dict[str, Any] = {"seconds": {}, "launches": {}}
    clock = _Clock(out, device)
    tok = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    meter = (lambda: roofline.collective_bytes(mesh)) if counted and mesh \
        is not None else contextlib.nullcontext

    train = tok(inputs["train"])
    shape = ShapeConfig("t", train.shape[1], train.shape[0], "train")
    params_t = _lm(cfg, params, device).requires_grad_(True)
    if mesh is not None:
        model.distribute(params_t, mesh, rules)
    step_fn, opt_init = make_train_step(model, shape, mesh, rules,
                                        impl=impl, **LR)
    opt = opt_init(params_t)
    batch = place_batch(model, {"tokens": train}, shape, mesh, rules)
    with meter() as m, clock("train"):
        params_t, opt, loss, gn = step_fn(params_t, opt, batch, 1)
    out["collectives_train"] = getattr(m, "result", None)
    out.update(loss=float(loss), grad_norm=float(gn), accum=step_fn.accum)
    named = dict(params_t.named_parameters())
    if whole or mesh is None:
        out.update(params={k: _np(p) for k, p in named.items()},
                   mu={k: _np(t) for k, t in opt.mu.items()},
                   nu={k: _np(t) for k, t in opt.nu.items()})
    else:
        out["index"] = {k: _block(p)[1] for k, p in named.items()}
        for m, ts in (("params", named), ("mu", opt.mu), ("nu", opt.nu)):
            out[m] = {k: _block(t)[0] for k, t in ts.items()}
    del params_t, opt, batch

    prompt = tok(inputs["prefill"])
    B, S = prompt.shape
    params_s = _lm(cfg, params, device)
    if mesh is not None:
        model.distribute(params_s, mesh, rules)
    prefill = make_prefill_step(model, inputs["max_len"], mesh, rules,
                                impl=impl, cache_dtype=torch.float32)
    serve = make_serve_step(model, mesh, rules, impl=impl)
    with torch.no_grad(), meter() as m:
        batch = place_batch(model, {"tokens": prompt},
                            ShapeConfig("p", S, B, "prefill"), mesh, rules)
        with clock("prefill"):
            lg, cache = prefill(params_s, batch)
        logits = [_np(lg)]
        for t in inputs["decode"]:
            tokens = place_batch(model, {"tokens": tok(t)},
                                 ShapeConfig("d", S, B, "decode"), mesh,
                                 rules)["tokens"]
            with clock("decode"):
                lg, cache = serve(params_s, cache, tokens)
            logits.append(_np(lg))
    out["collectives_serve"] = getattr(m, "result", None)
    out["logits"] = np.stack(logits)
    return out


class _Clock:
    """``with clock(phase):`` adds the block's seconds (after a
    synchronise on the card) and kernel launches to the phase's."""

    def __init__(self, out, device):
        self.out, self.cuda = out, torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def __call__(self, phase):
        if self.cuda:
            torch.cuda.synchronize()
        before = _build.launch_counts()
        t0 = time.perf_counter()
        yield
        if self.cuda:
            torch.cuda.synchronize()
        s = self.out["seconds"]
        s[phase] = s.get(phase, 0.0) + time.perf_counter() - t0
        n = self.out["launches"].setdefault(phase, {})
        for k, v in _build.launch_counts().items():
            if v != before.get(k, 0):
                n[k] = n.get(k, 0) + v - before.get(k, 0)


@contextlib.contextmanager
def drop_model_reduction():
    """A faulted partition: the first pin that meets a sum still partial
    over a mesh axis (the attention or mixer output, whose heads or inner
    dim the model axis splits) takes each rank's partial block as if it
    were the sum, dropping that all-reduce."""
    from torch.distributed.tensor import DTensor, Replicate
    real = sh.constrain
    state = {"dropped": 0}

    def faulty(x, axes, rules, mesh):
        if sh.is_dtensor(x) and not state["dropped"] and \
                any(p.is_partial() for p in x.placements):
            state["dropped"] += 1
            x = DTensor.from_local(
                x.to_local(), x.device_mesh,
                [Replicate() if p.is_partial() else p for p in x.placements],
                run_check=False)
        return real(x, axes, rules, mesh)
    sh.constrain = faulty
    try:
        yield state
    finally:
        sh.constrain = real


def steps_case(mesh, inputs, device) -> Dict[str, Any]:
    """Each arch's ``run_steps`` on this rank, and for the first arch the
    train loss of a faulted partition (``drop_model_reduction``). With
    ``stage`` the collectives go through ``collectives.stage_through_host``
    (as on the card), and the bytes it staged are returned."""
    out = {"coords": sh.coordinates(mesh), "axes": sh.mesh_axes(mesh)}
    if inputs.get("stage"):
        coll.stage_through_host(device)
        coll.reset_stats()
    for c in inputs["archs"]:
        cfg = get_arch(c["arch"]).reduced().replace(**c.get("cfg", {}))
        rules = rules_of(c["rules"], cfg, mesh)
        out[c["arch"]] = run_steps(cfg, c["params"], c, mesh, rules, device)
    c = inputs["archs"][0]
    cfg = get_arch(c["arch"]).reduced().replace(**c.get("cfg", {}))
    with drop_model_reduction() as fault:
        r = run_steps(cfg, c["params"], dict(c, decode=[]), mesh,
                      rules_of(c["rules"], cfg, mesh), device, counted=False)
    out["fault"] = {"arch": c["arch"], "dropped": fault["dropped"],
                    "loss": r["loss"], "logits": r["logits"]}
    out["staged"] = coll.stats()
    out["refusal"] = refusal(mesh, device)
    return out


def compare(got: Dict[str, Any], want: Dict[str, Any], tol: Dict[str, Any],
            keys=("loss", "grad_norm", "logits", "mu", "nu", "params")
            ) -> list:
    """What parts ``got`` from ``want`` (two ``run_steps`` results) past
    ``tol``: ``loss`` (atol, rtol) for the loss and grad norm, ``logits``
    (atol, rtol), ``moments`` (atol, rtol) for AdamW's mu and nu,
    ``param_bound`` for every parameter entry and ``param_tol`` (atol,
    rtol) for all but a ``param_share`` of them. An empty list passes."""
    bad = []
    for k in ("loss", "grad_norm"):
        if k in keys and not np.isclose(got[k], want[k], atol=tol["loss"][0],
                                        rtol=tol["loss"][1]):
            bad.append(f"{k} {got[k]} vs {want[k]}")
    if "logits" in keys:
        a, r = tol["logits"]
        if got["logits"].shape != want["logits"].shape or not np.allclose(
                got["logits"], want["logits"], atol=a, rtol=r):
            bad.append(f"logits apart by "
                       f"{np.abs(got['logits'] - want['logits']).max()}")
    for m in ("mu", "nu"):
        if m in keys:
            a, r = tol["moments"]
            bad += [f"{m} {k}" for k in want[m]
                    if not np.allclose(got[m][k], want[m][k], atol=a, rtol=r)]
    if "params" in keys:
        loose = total = 0
        for k, w in want["params"].items():
            d = np.abs(got["params"][k] - w)
            if d.max() > tol["param_bound"]:
                bad.append(f"param {k} apart by {d.max()}")
            loose += int((~np.isclose(got["params"][k], w,
                                      atol=tol["param_tol"][0],
                                      rtol=tol["param_tol"][1])).sum())
            total += w.size
        if loose >= tol["param_share"] * total:
            bad.append(f"{loose} of {total} parameter entries loose")
    return bad


def refusal(mesh, device) -> Optional[str]:
    """What attention over a sequence the rules split raises: reduced
    gemma3-1b under ``rules_for`` on a mesh whose model axis its one kv
    head does not divide (the rules put the sequence there). None if it
    ran."""
    cfg = get_arch("gemma3-1b").reduced()
    rules = sh.rules_for(cfg, mesh)
    model = build(cfg, device)
    params = model.distribute(model.init(torch.Generator(device=device)
                                         .manual_seed(0), torch.float32),
                              mesh, rules)
    tokens = torch.zeros((4, 16), dtype=torch.int64, device=device)
    try:
        make_prefill_step(model, 16, mesh, rules)(params, place_batch(
            model, {"tokens": tokens}, ShapeConfig("p", 16, 4, "prefill"),
            mesh, rules))
    except NotImplementedError as e:
        return str(e)
    return None


CASES = {"steps": steps_case}
