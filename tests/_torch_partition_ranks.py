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
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import _build
from repro_torch.launch import roofline
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step, partitioned,
                                      place_batch, place_cache)
from repro_torch.models import attention, build, moe, remat
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh

LR = dict(base_lr=1e-2, warmup=1, total_steps=10)


def rules_of(name: str, cfg, mesh):
    """``"auto"``: the table ``rules_for`` picks on ``mesh``;
    ``"kv_indivisible"``: the table it picks for the arch's full config on
    the production mesh's model axis, where the kv heads do not divide it
    (heads and kv heads whole, the sequence over the model axis); else
    ``"dp_heavy"``."""
    if name == "auto":
        return sh.rules_for(cfg, mesh)
    if name == "kv_indivisible":
        return kv_indivisible_rules(cfg.name)
    assert name == "dp_heavy", name
    return sh.dp_heavy_rules()


def kv_indivisible_rules(arch: str):
    """``rules_for`` of the full ``arch`` on the (16, 16) production mesh,
    checked to be the table for kv heads that do not divide its model
    axis."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_arch(arch)
    mesh = make_production_mesh()
    rules = sh.rules_for(cfg, mesh)
    if rules["kv_heads"] or rules["heads"] or rules["seq"] != [("model",)]:
        raise ValueError(f"{arch}'s kv heads divide the production mesh's "
                         f"model axis")
    return rules


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


def _lm(cfg, params, device):
    """A fresh LM (an EncDec for the encdec family) from whole
    parameters: a numpy tree in the reference's layout (converted), or a
    function of the device that makes one."""
    if callable(params):
        return params(device)
    if cfg.family == "encdec":
        return convert.encdec_params_from_jax(cfg, params, device=device)
    return convert.lm_params_from_jax(cfg, params, device=device)


EMBEDS = ("frames", "patches")


def _batch(inputs, kind, tok):
    """The ``kind`` ("train" or "prefill") batch: its tokens, and the
    encoder's frames or the vlm's patches where ``inputs`` has them
    (``<kind>_frames``, ``<kind>_patches``: float32 numpy)."""
    out = {"tokens": tok(inputs[kind])}
    for k in EMBEDS:
        if f"{kind}_{k}" in inputs:
            out[k] = tok(inputs[f"{kind}_{k}"])
    return out


def run_steps(cfg, params, inputs: Dict[str, Any], mesh, rules,
              device="cpu", impl: Optional[str] = None,
              counted: bool = True, whole: bool = True,
              serve: bool = True, state: bool = True) -> Dict[str, Any]:
    """One train step, a prefill and decode steps of ``cfg`` from
    ``params``; ``inputs`` holds numpy ``train`` tokens (B, S), ``prefill``
    tokens (B, S), ``decode`` tokens (steps, B) and ``max_len``, and for
    the encdec and vlm families the train and prefill batches' frames or
    patches (``_batch``). The encoder-decoder's prefill makes no cache (as
    the reference's): its decode steps start from a zero cache of
    ``max_len`` (``Model.init_cache``, f32, placed). Returns
    the loss, grad norm, every parameter and moment after the step, the
    prefill's and each decode step's logits, with ``counted`` the
    collectives each phase issued (``roofline.collective_bytes``), and
    each phase's seconds (on the card, synchronised) and kernel launches
    (``_build.launch_counts``). Without ``whole`` the parameters and
    moments are this rank's blocks, placed by ``index`` (each dim's
    offset and size in the whole), and no collective gathers them. Without ``state`` no parameter or
    moment is returned; without ``serve``, the train step alone."""
    model = build(cfg, device)
    mesh = mesh if partitioned(mesh) else None
    out: Dict[str, Any] = {"seconds": {}, "launches": {}}
    clock = _Clock(out, device)
    tok = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    meter = (lambda: roofline.collective_bytes(mesh)) if counted and mesh \
        is not None else contextlib.nullcontext

    train = _batch(inputs, "train", tok)
    shape = ShapeConfig("t", train["tokens"].shape[1],
                        train["tokens"].shape[0], "train")
    params_t = _lm(cfg, params, device).requires_grad_(True)
    if mesh is not None:
        model.distribute(params_t, mesh, rules)
        _release(device)
    step_fn, opt_init = make_train_step(model, shape, mesh, rules,
                                        impl=impl, **LR)
    opt = opt_init(params_t)
    batch = place_batch(model, train, shape, mesh, rules)
    with meter() as m, clock("train"):
        params_t, opt, loss, gn = step_fn(params_t, opt, batch, 1)
    out["collectives_train"] = getattr(m, "result", None)
    out.update(loss=float(loss), grad_norm=float(gn), accum=step_fn.accum)
    named = dict(params_t.named_parameters())
    if not state:
        pass
    elif whole or mesh is None:
        out.update(params={k: _np(p) for k, p in named.items()},
                   mu={k: _np(t) for k, t in opt.mu.items()},
                   nu={k: _np(t) for k, t in opt.nu.items()})
    else:
        out["index"] = {k: _block(p)[1] for k, p in named.items()}
        for m, ts in (("params", named), ("mu", opt.mu), ("nu", opt.nu)):
            out[m] = {k: _block(t)[0] for k, t in ts.items()}
    del params_t, opt, batch
    if not serve:
        return out

    prompt = _batch(inputs, "prefill", tok)
    B, S = prompt["tokens"].shape
    params_s = _lm(cfg, params, device)
    if mesh is not None:
        model.distribute(params_s, mesh, rules)
        _release(device)
    prefill = make_prefill_step(model, inputs["max_len"], mesh, rules,
                                impl=impl, cache_dtype=torch.float32)
    serve = make_serve_step(model, mesh, rules, impl=impl)
    with torch.no_grad(), meter() as m:
        batch = place_batch(model, prompt, ShapeConfig("p", S, B, "prefill"),
                            mesh, rules)
        with clock("prefill"):
            lg, cache = prefill(params_s, batch)
        if cache is None:
            cache = place_cache(model, model.init_cache(
                B, inputs["max_len"], torch.float32), mesh, rules)
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


def _release(device) -> None:
    """Hand the card the whole parameters' cached blocks back once the
    rank holds its own (ranks that share one card)."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


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


@contextlib.contextmanager
def drop_cross_reduction():
    """A faulted partition: the model-axis all-reduce after the first
    cross-attention's output projection (the decoder's first layer, the
    first microbatch's forward) is dropped, as ``drop_model_reduction``
    drops one; a checkpointed body's recompute keeps it."""
    real = attention.attn_apply
    state = {"dropped": 0}

    def faulty(p, x, cfg, **kw):
        if kw.get("kv_x") is None or state["dropped"] or \
                remat.recomputing():
            return real(p, x, cfg, **kw)
        with drop_model_reduction() as inner:
            y = real(p, x, cfg, **kw)
        state["dropped"] += inner["dropped"]
        return y
    attention.attn_apply = faulty
    try:
        yield state
    finally:
        attention.attn_apply = real


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
    rtol) for all but a ``param_share`` of them. With ``moments_of_max``
    the moments' atol is of each moment's largest entry, and with
    ``moment_share`` all but that share of their entries are bit-equal.
    An empty list passes."""
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
        if m not in keys:
            continue
        a, r = tol["moments"]
        unequal = total = 0
        for k, w in want[m].items():
            g = got[m][k]
            scale = np.abs(w).max() if tol.get("moments_of_max") else 1.0
            if not np.allclose(g, w, atol=a * scale, rtol=r):
                bad.append(f"{m} {k}")
            unequal += int((g != w).sum())
            total += w.size
        if unequal >= tol.get("moment_share", 1.0) * total:
            bad.append(f"{m}: {unequal} of {total} entries unequal")
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


def refusal(mesh, device) -> Dict[str, Any]:
    """Attention over a sequence the rules split: reduced gemma3-1b's
    prefill under ``rules_for`` on a mesh whose model axis its one kv head
    does not divide (the rules put the sequence there). What it raised
    (None since sequence-parallel attention runs) and its logits (None
    where it raised)."""
    cfg = get_arch("gemma3-1b").reduced()
    rules = sh.rules_for(cfg, mesh)
    model = build(cfg, device)
    params = model.distribute(model.init(torch.Generator(device=device)
                                         .manual_seed(0), torch.float32),
                              mesh, rules)
    tokens = torch.arange(64, dtype=torch.int64, device=device).reshape(
        4, 16) % cfg.vocab
    try:
        lg, _ = make_prefill_step(model, 16, mesh, rules)(
            params, place_batch(model, {"tokens": tokens},
                                ShapeConfig("p", 16, 4, "prefill"), mesh,
                                rules))
    except NotImplementedError as e:
        return {"error": str(e), "logits": None}
    return {"error": None, "logits": _np(lg)}


class moe_paths:
    """While installed, counts the MoE FFN's calls by path (``ep``: expert
    parallelism, ``global``: the partitioned global dispatch, ``block``:
    the expert products on a rank's block of the slots), per ``dispatch``
    call the choices dropped past capacity, and per ``route`` call each
    token's chosen experts (ascending) and the gap between the log
    probabilities of its k-th and (k+1)-th choices (numpy). With
    ``replay`` (each call's experts, recorded so from another run), each
    call takes those experts, gated by its own probabilities renormalised
    as ``route`` does, and still records its own choices: where the two
    runs choose alike nothing changes but the order of a k-term sum.
    A checkpointed body's recompute (``remat.recomputing()``) is not
    recorded or counted: the records are the first forward's; replaying,
    the recompute takes the experts its forward took (found by the
    layer's router weights: ``route`` gets a fresh dict each call)."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        self.calls = {"ep": 0, "global": 0, "block": 0}
        self.drops, self.routes, self._taken = [], [], {}
        self._real = (moe._moe_ep, moe._moe_global_partitioned,
                      moe._expert_matmuls, moe.dispatch, moe.route)

        def route(p, xf, cfg):
            probs, gate_w, ids = self._real[4](p, xf, cfg)
            if remat.recomputing():
                if self.replay is not None:
                    ids = self._taken[p["router"].data_ptr()].to(ids.device)
                    gate_w = probs.gather(1, ids)
                    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(
                        1e-9)
                return probs, gate_w, ids
            top = probs.detach().topk(cfg.top_k + 1).values.log()
            self.routes.append((ids.sort(-1).values.cpu().numpy(),
                                (top[:, -2] - top[:, -1]).cpu().numpy()))
            if self.replay is not None:
                ids = torch.from_numpy(self.replay[len(self.routes) - 1]).to(
                    ids.device)
                self._taken[p["router"].data_ptr()] = ids
                gate_w = probs.gather(1, ids)
                gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
            return probs, gate_w, ids

        def counted(key, fn):
            def wrapped(*a, **k):
                self.calls[key] += not remat.recomputing()
                return fn(*a, **k)
            return wrapped

        def dispatch(ids, T, E, C):
            dest = self._real[3](ids, T, E, C)
            if not remat.recomputing():
                self.drops.append(int((dest == E * C).sum()))
            return dest
        moe._moe_ep = counted("ep", self._real[0])
        moe._moe_global_partitioned = counted("global", self._real[1])
        moe._expert_matmuls = counted("block", self._real[2])
        moe.dispatch, moe.route = dispatch, route
        return self

    def __exit__(self, *exc):
        (moe._moe_ep, moe._moe_global_partitioned, moe._expert_matmuls,
         moe.dispatch, moe.route) = self._real


def route_flips(got, want, rows) -> Dict[str, Any]:
    """The tokens whose chosen experts differ between a rank's recorded
    routes ``got`` and one device's ``want`` (``moe_paths.routes`` of the
    same calls in the same order), the rank's tokens of call i being
    one device's ``rows(i, rank tokens, one device's tokens)``: how many,
    of how many, and the largest gap (one device's log-probability gap
    between its k-th and (k+1)-th choices) among them."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} routed calls against "
                             f"{len(want)}")
    flips = tokens = 0
    worst = 0.0
    for i, ((ids, _), (ids1, gap1)) in enumerate(zip(got, want)):
        sl = rows(i, ids.shape[0], ids1.shape[0])
        diff = (ids != ids1[sl]).any(-1)
        flips += int(diff.sum())
        tokens += ids.shape[0]
        if diff.any():
            worst = max(worst, float(gap1[sl][diff].max()))
    return {"flips": flips, "tokens": tokens, "max_flip_gap": worst}


@contextlib.contextmanager
def unswapped_all_to_all_backward():
    """A faulted world: the all-to-all's backward issues the all-to-all
    with the forward's split and concat dims, not swapped, and takes the
    result as the gradient (the same number of entries in another
    layout)."""
    real = coll._AllToAll.backward

    def faulty(ctx, g):
        group, n, split_dim, concat_dim = ctx.args
        shape = list(g.shape)                        # the input's
        shape[concat_dim] //= n
        shape[split_dim] *= n
        out = coll._all_to_all(g, group, n, split_dim, concat_dim)
        return out.reshape(shape), None, None, None, None
    coll._AllToAll.backward = staticmethod(faulty)
    try:
        yield
    finally:
        coll._AllToAll.backward = real


@contextlib.contextmanager
def dropped_weight_reduce_scatter():
    """A faulted world: a tiled all-gather's backward (the experts'
    weights gathered over their FSDP axes) keeps the rank's own slice of
    the gradient instead of the reduce-scatter's sum over the ranks."""
    real = coll._AllGather.backward

    def faulty(ctx, g):
        group, n, dim = ctx.args
        size = g.shape[dim] // n
        return g.narrow(dim, dist.get_rank(group) * size, size), None, \
            None, None
    coll._AllGather.backward = staticmethod(faulty)
    try:
        yield
    finally:
        coll._AllGather.backward = real


@contextlib.contextmanager
def dropped_state_exchange():
    """A faulted world: the SSD over a split sequence runs B7 on each
    rank's block from a zero state and carries no state between the
    ranks (``ops.ssd_seq`` without its exchange)."""
    from repro_torch.kernels import ops
    real = ops.ssd_seq

    def faulty(x, a, b, c, entry, mesh, *, chunk=128, impl=None,
               partial_state=False):
        return ops._ssd_local(x, a, b, c, chunk, impl)
    ops.ssd_seq = faulty
    try:
        yield
    finally:
        ops.ssd_seq = real


FAULTS = {"unswapped_all_to_all": unswapped_all_to_all_backward,
          "dropped_reduce_scatter": dropped_weight_reduce_scatter}
# the faulted worlds of the sequence-parallel paths: the K/V gather's
# reduce-scatter (the tiled all-gather's backward) keeping the rank's own
# slice, and the SSD's state exchange left out
SEQ_FAULTS = {"dropped_kv_reduce_scatter": dropped_weight_reduce_scatter,
              "dropped_state_exchange": dropped_state_exchange}


def moe_case(mesh, inputs, device) -> Dict[str, Any]:
    """The MoE and hybrid cases' ``run_steps`` over this world, the
    collectives staged through the host, with the paths their MoE layers
    took and their drops; the train step of ``inputs["fault_case"]``
    under each of ``FAULTS``; and ``collective_grads``."""
    coll.stage_through_host(device)
    coll.reset_stats()
    out = {"coords": sh.coordinates(mesh), "axes": sh.mesh_axes(mesh)}
    for c in inputs["cases"]:
        cfg = get_arch(c["arch"]).reduced().replace(**c.get("cfg", {}))
        with moe_paths() as paths:
            r = run_steps(cfg, c["params"], c, mesh,
                          rules_of(c["rules"], cfg, mesh), device)
        r.update(paths=paths.calls, drops=paths.drops)
        out[c["name"]] = r
    c = next(c for c in inputs["cases"] if c["name"] == inputs["fault_case"])
    cfg = get_arch(c["arch"]).reduced().replace(**c.get("cfg", {}))
    out["faults"] = {}
    for name, fault in FAULTS.items():
        with fault():
            r = run_steps(cfg, c["params"], dict(c, decode=[]), mesh,
                          rules_of(c["rules"], cfg, mesh), device,
                          counted=False)
        out["faults"][name] = {k: r[k] for k in ("loss", "grad_norm",
                                                 "params", "mu", "nu")}
    out["grads"] = collective_grads(mesh)
    out["staged"] = coll.stats()
    out["placed"] = placed_experts(mesh, device)
    return out


def placed_experts(mesh, device) -> Dict[str, Any]:
    """Reduced moonshot's expert weights after ``Model.distribute`` under
    each rule table: {rules: {name: (placements, local shape)}}."""
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    out = {}
    for name in ("auto", "dp_heavy"):
        model = build(cfg, device)
        params = model.distribute(model.init(torch.Generator().manual_seed(
            0), torch.float32), mesh, rules_of(name, cfg, mesh))
        out[name] = {k: (tuple(str(q) for q in p.placements),
                         tuple(p.to_local().shape))
                     for k, p in params.named_parameters() if ".moe." in k}
    return out


def collective_grads(mesh) -> Dict[str, Any]:
    """The collectives' gradients against their explicit adjoints, on
    integer-valued f32 tensors (every sum exact, so any order gives the
    same bits): the all-to-all over "model" (split 0, concat 1) against
    the all-to-all of the gradient with the dims swapped; the tiled
    all-gather over "data" along dim 1 against the sum of every rank's
    gradient, in rank order, cut to this rank's block. With the
    collectives each direction issued (``roofline.collective_bytes``) and
    the calls ``stats()`` counted."""
    rank = dist.get_rank()
    rng = np.random.default_rng(100 + rank)
    ints = lambda *shape: torch.from_numpy(
        rng.integers(-8, 9, shape).astype(np.float32))
    d, m = sh.mesh_axes(mesh)["data"], sh.mesh_axes(mesh)["model"]
    out = {}
    x = ints(2 * m, 3, 5).requires_grad_(True)
    before = coll.stats()
    with roofline.collective_bytes(mesh) as fwd:
        y = coll.all_to_all(x, mesh, "model", 0, 1)
    g = ints(*y.shape)
    with roofline.collective_bytes(mesh) as bwd:
        (dx,) = torch.autograd.grad(y, x, g)
    with torch.no_grad():
        want = coll.all_to_all(g, mesh, "model", 1, 0)
    out["all_to_all"] = {"shape": tuple(y.shape), "equal": torch.equal(
        dx, want), "moved": not torch.equal(dx, g.reshape(dx.shape)),
        "forward": fwd.result, "backward": bwd.result}
    w = ints(3, 2, 5).requires_grad_(True)
    with roofline.collective_bytes(mesh) as fwd:
        y = coll.all_gather(w, mesh, "data", 1)
    g = ints(*y.shape)
    with roofline.collective_bytes(mesh) as bwd:
        (dw,) = torch.autograd.grad(y, w, g)
    with torch.no_grad():
        every = coll.all_gather(g[None], mesh, "data", 0)   # (d, 3, 2d, 5)
        total = every[0]
        for i in range(1, d):
            total = total + every[i]
        me = sh.coordinates(mesh)["data"]
        want = total[:, 2 * me:2 * me + 2]
    out["all_gather"] = {"shape": tuple(y.shape), "equal": torch.equal(
        dw, want), "forward": fwd.result, "backward": bwd.result}
    after = coll.stats()
    out["counted"] = {k: after.get(k, 0) - before.get(k, 0)
                      for k in after if k.endswith("_calls")}
    return out


def encdec_case(mesh, inputs, device) -> Dict[str, Any]:
    """The encdec and vlm cases' ``run_steps`` over this world, the
    collectives staged through the host, and the train step of
    ``inputs["fault_case"]`` with the cross-attention's reduction dropped
    (``drop_cross_reduction``)."""
    coll.stage_through_host(device)
    coll.reset_stats()
    out = {"coords": sh.coordinates(mesh), "axes": sh.mesh_axes(mesh)}
    for c in inputs["cases"]:
        cfg = get_arch(c["arch"]).reduced().replace(**c.get("cfg", {}))
        out[c["name"]] = run_steps(cfg, c["params"], c, mesh,
                                   rules_of(c["rules"], cfg, mesh), device)
    c = next(c for c in inputs["cases"] if c["name"] == inputs["fault_case"])
    cfg = get_arch(c["arch"]).reduced().replace(**c.get("cfg", {}))
    with drop_cross_reduction() as fault:
        r = run_steps(cfg, c["params"], c, mesh,
                      rules_of(c["rules"], cfg, mesh), device,
                      counted=False, serve=False, state=False)
    out["fault"] = {"name": c["name"], "dropped": fault["dropped"],
                    "loss": r["loss"], "grad_norm": r["grad_norm"]}
    out["staged"] = coll.stats()
    return out


def seq_case(mesh, inputs, device) -> Dict[str, Any]:
    """The sequence-parallel cases' ``run_steps`` over this world, the
    collectives staged through the host, with the calls of the
    sequence-parallel paths (``seq_paths``), the MoE paths and drops; and
    the train step of each ``inputs["faults"]`` case (fault name -> case
    name) under its fault."""
    coll.stage_through_host(device)
    coll.reset_stats()
    out = {"coords": sh.coordinates(mesh), "axes": sh.mesh_axes(mesh)}
    for c in inputs["cases"]:
        cfg = get_arch(c["arch"]).reduced().replace(**c.get("cfg", {}))
        with moe_paths() as paths, seq_paths() as seq:
            r = run_steps(cfg, c["params"], c, mesh,
                          rules_of(c["rules"], cfg, mesh), device)
        r.update(paths=paths.calls, drops=paths.drops, seq=seq.calls)
        out[c["name"]] = r
    out["faults"] = {}
    for fault, name in inputs["faults"].items():
        c = next(c for c in inputs["cases"] if c["name"] == name)
        cfg = get_arch(c["arch"]).reduced().replace(**c.get("cfg", {}))
        with SEQ_FAULTS[fault]():
            r = run_steps(cfg, c["params"], c, mesh,
                          rules_of(c["rules"], cfg, mesh), device,
                          counted=False, serve=False, state=False)
        out["faults"][fault] = {k: r[k] for k in ("loss", "grad_norm")}
    out["staged"] = coll.stats()
    return out


class seq_paths:
    """While installed, counts the calls of the sequence-parallel paths
    (``ops.attention_seq``, ``ops.decode_over_blocks``, ``ops.ssd_seq``,
    ``ssm.conv_seq``) and of ``ops.merge_partials``, a checkpointed
    body's recompute included (``calls``), and the all-gathers each
    issues in its forward, calls and bytes (``gathers``: K/V, the decode
    partials', the SSD's state exchange, the conv's halo; their adjoints,
    reduce-scatters, run in the backward)."""

    NAMES = (("ops", "attention_seq"), ("ops", "decode_over_blocks"),
             ("ops", "merge_partials"), ("ops", "ssd_seq"),
             ("ssm", "conv_seq"))

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import ssm
        mods = {"ops": ops, "ssm": ssm}
        self.calls = {n: 0 for _, n in self.NAMES}
        self.gathers = {n: {"all_gather_calls": 0, "all_gather_bytes": 0}
                        for _, n in self.NAMES}
        self._real = [(mods[m], n, getattr(mods[m], n))
                      for m, n in self.NAMES]
        for mod, n, fn in self._real:
            def counted(*a, _fn=fn, _n=n, **k):
                self.calls[_n] += 1
                before = coll.stats()
                out = _fn(*a, **k)
                after = coll.stats()
                for key, v in self.gathers[_n].items():
                    self.gathers[_n][key] = v + after.get(key, 0) - \
                        before.get(key, 0)
                return out
            setattr(mod, n, counted)
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self._real:
            setattr(mod, n, fn)

    def report(self) -> Dict[str, Any]:
        """The forward gathers of each path that ran (``merge_partials``'
        within ``decode_over_blocks``')."""
        return {n: dict(self.gathers[n], calls=self.calls[n])
                for _, n in self.NAMES
                if self.calls[n] and n != "merge_partials"}


def _requiring(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def _grads(out, ins, g) -> list:
    return [t.numpy() for t in torch.autograd.grad(out, ins, g)]


def seq_ops_case(mesh, inputs, device) -> Dict[str, Any]:
    """Each sequence-parallel op on this rank's block of ``inputs``' whole
    numpy tensors, the sequence split over the model axis: attention
    (``attention_seq``: out, dq, dk, dv) in each of ``inputs["attention"]``
    (causal, window), decode (``decode_over_blocks`` with B6's partial,
    and with the windowed decode's: out) at each ``kv_len``, the SSD
    (``ssd_seq``: y, its partial and its whole final state, dx, da, db,
    dc of y·gy + h·gh) and the conv (``conv_seq``: out, dx, dw)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    coll.stage_through_host(device)
    entry = "model"
    mine = lambda a, dim=1: sh.block(torch.from_numpy(a), sh.PartitionSpec(
        *([None] * dim + [entry])), mesh).contiguous().numpy()
    out = {"coords": sh.coordinates(mesh)}
    a = inputs["attn"]
    for causal, window in inputs["attention"]:
        q, k, v = _requiring(mine(a["q"]), mine(a["k"]), mine(a["v"]))
        o = ops.attention_seq(q, k, v, entry, mesh, causal=causal,
                              window=window)
        out[("attention", causal, window)] = [o.detach().numpy()] + _grads(
            o, (q, k, v), torch.from_numpy(mine(a["g"])))
    d = inputs["decode"]
    q = torch.from_numpy(d["q"])
    kb, vb = (torch.from_numpy(mine(d[n])) for n in ("k", "v"))
    for lens in d["kv_len"]:
        kv_len = torch.tensor(lens, dtype=torch.int32)
        lo = (kv_len - d["window"]).clamp_min(0)
        out[("decode", tuple(lens))] = [
            ops.decode_over_blocks(ops.b6_partial(), q, kb, vb, None, kv_len,
                                   entry, mesh).numpy(),
            ops.decode_over_blocks(attn.window_partial, q, kb, vb, lo,
                                   kv_len, entry, mesh).numpy()]
    z = inputs["ssd"]
    x, a_, b, c = _requiring(*(mine(z[n]) for n in ("x", "a", "b", "c")))
    y, h_part = ops.ssd_seq(x, a_, b, c, entry, mesh, chunk=z["chunk"],
                            partial_state=True)
    loss = (y * torch.from_numpy(mine(z["gy"]))).sum() + \
        (h_part * torch.from_numpy(z["gh"])).sum()
    with torch.no_grad():
        _, h_whole = ops.ssd_seq(x, a_, b, c, entry, mesh, chunk=z["chunk"])
    out["ssd"] = [y.detach().numpy(), h_part.detach().numpy(),
                  h_whole.numpy()] + _grads(loss, (x, a_, b, c), None)
    v = inputs["conv"]
    x, w = _requiring(mine(v["x"]), v["w"])
    o = ssm.conv_seq(x, w, entry, mesh)
    out["conv"] = [o.detach().numpy()] + _grads(
        o, (x, w), torch.from_numpy(mine(v["g"])))
    return out


def local_prefill(cfg, tokens, decode, mesh=None, rules=None):
    """Reduced ``cfg``'s prefill of ``tokens`` (numpy (B, S)) into a cache
    of S + len(decode) rows and its decode steps, on one device or, with
    a live ``mesh``, on this rank's plain block of the tokens with
    ``rules`` and the global (B, S) installed (the rank-local path
    ``_torch_ep_ranks.prefill_case`` takes): the logits of the prefill's
    last position and of each decode step, the rank's rows."""
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), torch.float32)
    tok = torch.from_numpy(np.asarray(tokens))
    B, S = tok.shape
    spec = sh.PartitionSpec(None, None) if mesh is None else \
        sh.token_spec((B, S, 1), rules, mesh)[:2]
    rows = (lambda t: t) if mesh is None else \
        (lambda t: sh.block(t, sh.PartitionSpec(spec[0]), mesh))
    out = []
    with torch.no_grad():
        with sh.activation_sharding(rules, mesh, (B, S)):
            lg, cache = model.prefill(params, {"tokens": sh.block(
                tok, spec, mesh) if mesh is not None else tok},
                max_len=S + len(decode), cache_dtype=torch.float32)
        out.append(lg)
        with sh.activation_sharding(rules, mesh, (B, 1)):
            for t in decode:
                lg, cache = model.decode_step(params, cache, rows(
                    torch.from_numpy(np.asarray(t))))
                out.append(lg)
    return {"logits": torch.stack(out).numpy(), "spec": tuple(spec)}


def local_prefill_case(mesh, inputs, device) -> Dict[str, Any]:
    """``local_prefill`` of each of ``inputs["archs"]`` on this rank under
    ``dp_heavy_rules()``, its calls of the sequence-parallel paths."""
    coll.stage_through_host(device)
    out = {"coords": sh.coordinates(mesh)}
    for arch in inputs["archs"]:
        with seq_paths() as seq:
            r = local_prefill(get_arch(arch).reduced(), inputs["tokens"],
                              inputs["decode"], mesh, sh.dp_heavy_rules())
        out[arch] = dict(r, seq=seq.calls)
    return out


CASES = {"steps": steps_case, "moe": moe_case, "encdec": encdec_case,
         "seq": seq_case, "seq_ops": seq_ops_case,
         "local_prefill": local_prefill_case}
