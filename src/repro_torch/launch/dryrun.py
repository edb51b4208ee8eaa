"""Dry run of every (arch × shape) cell, as the reference's
``launch/dryrun.py``: what one step costs, without running it.

Mesh kinds:
  * ``card`` (default): the one H100 the port runs on. The whole step is
    traced on the meta device (``roofline.trace``; the attention and SSD
    kernels through their kernel-shaped branches), giving its FLOPs and
    bytes, the roofline built from them, its predicted peak memory and
    whether that fits the card. With ``--decompose`` the record also
    carries the per-piece view (``decompose.py``), whose totals equal the
    whole step's.
  * ``single`` / ``multi``: the reference's (16, 16) and (2, 16, 16)
    meshes of H100s. A cell whose layout the port partitions (every
    cell of every family: ``partition_reason``) is traced as the
    partitioned step over a fake process group of 256 or 512 ranks
    (``mesh.fake_mesh``): DTensors on
    the meta device, placed by the resolver, the counter seeing rank 0's
    local ops. Its record holds that device's FLOPs and bytes, its
    predicted peak memory against the card's, the collectives the step
    issues (``collectives_full_step``: ``roofline.collective_bytes`` by
    kind and by mesh axis) and the roofline with its collective term
    (each axis's bytes over its link rate, ``hw.axis_link_bw``); where
    the rules split a sequence, the K/V gathers of sequence-parallel
    attention, the decode partials' gathers and the SSD's state exchange
    among them. A cell the port could not partition would stay
    ``"analytic": true``, with a ``reason``: only what the resolver's
    specs give per device would be recorded.

Every kind records the parameter counts, tokens per step, the
accumulation count and the per-device bytes of the step's arguments
(parameters, AdamW state, batch, and the cache for decode). Parameters
and caches are bf16, as in the reference's dry run; AdamW's moments are
f32 (bf16 where the config says so). A decode step is traced at the
cache's last position (pos = S - 1).

The card's name and memory come from ``hw.device_spec`` (the data sheet
with ``--device cpu``, which runs the whole table on a machine without a
card).

Usage (``--arch`` and ``--shape`` take comma-separated lists; their
cells run, their skips are recorded):
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \
      --decompose --device cpu
  python -m repro_torch.launch.dryrun --all --device cpu --out build/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import hw
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import SHAPES, ShapeConfig, cells, skipped_cells
from repro_torch.launch import roofline as rl
from repro_torch.launch.decompose import decompose_cell
from repro_torch.launch.mesh import (fake_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import (choose_microbatch, make_prefill_step,
                                      make_serve_step, make_train_step,
                                      partitioned, place_batch, place_cache)
from repro_torch.models.registry import Model, build, cache_leaves
from repro_torch.parallel.sharding import (entry_axes, mesh_axes, mesh_size,
                                           rules_for, spec_for, tree_specs)

MESH_KINDS = ("card", "single", "multi")


def mesh_for(kind: str):
    if kind == "card":
        return make_host_mesh()
    return make_production_mesh(multi_pod=kind == "multi")


def all_cells():
    """The (arch, shape) cells and the documented skips, in the
    reference's order."""
    run = [c for a in ARCHS for c in cells(a)]
    skip = [s for a in ARCHS for s in skipped_cells(a)]
    return run, skip


def step_call(model: Model, shape: ShapeConfig, dtype=torch.bfloat16,
              cache_dtype=torch.bfloat16, tokens_dtype=torch.int32,
              max_len: Optional[int] = None, mesh=None, rules=None,
              **train_kw):
    """(fn, hold, extra): the step of ``shape`` on meta tensors, as a
    caller runs it, and the tensors that exist before it (its arguments).
    Training: ``make_train_step``'s step from AdamW's initial state (step
    1); prefill: ``make_prefill_step``'s, into a ``max_len`` cache
    (default S); decode: ``make_serve_step``'s at pos = S - 1 of an
    S-deep cache. With a partitioned ``mesh`` (``fake_mesh``) the
    parameters, state, batch and cache are DTensors placed by ``rules``."""
    meta = torch.device("meta")
    mesh = mesh if partitioned(mesh) else None
    batch = {k: torch.empty(v.shape, dtype=tokens_dtype if k == "tokens"
                            else v.dtype, device=meta)
             for k, v in model.input_specs(shape, dtype).items()}
    batch = place_batch(model, batch, shape, mesh, rules)
    params = model.param_struct(dtype)
    if mesh is not None:
        model.distribute(params, mesh, rules)
    if shape.kind == "train":
        params.requires_grad_(True)
        step_fn, opt_init = make_train_step(model, shape, mesh, rules,
                                            **train_kw)
        opt = opt_init(params)
        hold = (list(params.parameters()), opt.mu, opt.nu, opt.count, batch)
        return (lambda: step_fn(params, opt, batch, 1)), hold, \
            {"accum": step_fn.accum}
    if shape.kind == "prefill":
        prefill = make_prefill_step(model, max_len or shape.seq_len, mesh,
                                    rules, cache_dtype=cache_dtype)
        return (lambda: prefill(params, batch)), \
            (list(params.parameters()), batch), {}
    cache = place_cache(model, model.cache_struct(shape, cache_dtype), mesh,
                        rules)
    cache["pos"] = shape.seq_len - 1
    serve = make_serve_step(model, mesh, rules)
    return (lambda: serve(params, cache, batch["tokens"])), \
        (list(params.parameters()), cache_leaves(cache), batch), {}


def partition_reason(model: Model, shape: ShapeConfig, mesh, rules
                     ) -> Optional[str]:
    """Why the port cannot trace the partitioned step of this cell, or
    None where it can: a layout whose rules split a head's features over
    a mesh axis (no rule table of the reference does; ``kernels/ops.py``
    refuses it). A sequence or a decode cache split over ranks runs
    sequence-parallel attention and decode (``ops.attention_seq``,
    ``ops.decode_over_blocks``)."""
    cfg = model.cfg
    if not cfg.n_heads:
        return None
    B = shape.global_batch
    if shape.kind == "train":
        B //= choose_microbatch(cfg, B, mesh, rules)
    q = spec_for(("batch", "seq", "heads", "head_dim"),
                 (B, shape.seq_len, cfg.n_heads, cfg.head_dim), rules, mesh)
    if entry_axes(q[3]):
        return (f"attention with a head's features split over {q[3]!r} is "
                f"not ported")
    return None


def _bytes(t: torch.Tensor, spec, sizes: Dict[str, int],
           dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of one device's shard of ``t`` under ``spec``."""
    split = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            split *= sizes[a]
    item = torch.empty((), dtype=dtype or t.dtype).element_size()
    return t.numel() * item // split


def argument_bytes(model: Model, shape: ShapeConfig, mesh, rules,
                   dtype=torch.bfloat16) -> Dict[str, int]:
    """Per-device bytes of the step's arguments under the resolver's
    specs: parameters, AdamW moments (train), batch, cache (decode)."""
    sizes = mesh_axes(mesh)
    params = dict(model.param_struct(dtype).named_parameters())
    specs = tree_specs(model.param_axes(), params, rules, mesh)
    out = {"params": sum(_bytes(t, specs[k], sizes)
                         for k, t in params.items())}
    if shape.kind == "train":
        st = torch.bfloat16 if model.cfg.bf16_optimizer_state else \
            torch.float32
        out["optimizer"] = 2 * sum(_bytes(t, specs[k], sizes, st)
                                   for k, t in params.items())
    batch, axes = model.input_specs(shape, dtype), model.input_axes(shape)
    out["batch"] = sum(_bytes(t, spec_for(axes[k], t.shape, rules, mesh),
                              sizes)
                       for k, t in batch.items())
    if shape.kind == "decode":
        cache = cache_leaves(model.cache_struct(shape, dtype))
        c_specs = tree_specs(model.cache_axes(), cache, rules, mesh)
        out["cache"] = sum(_bytes(t, c_specs[k], sizes)
                           for k, t in cache.items())
    out["total"] = sum(out.values())
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str = "card",
             device: str = "cuda", verbose: bool = True,
             decompose: bool = False) -> dict:
    """One cell's record; ``device`` names where the card's spec comes
    from (``"cpu"``: the data sheet). The card kind with ``"cuda"`` on a
    machine without a card raises, as every entry point does. With
    ``decompose`` a traced cell also records the step's pieces
    (``decompose_cell``, over the same mesh)."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    model = build(cfg, "meta")
    desc = mesh_for(mesh_kind)
    chips = mesh_size(desc)
    rules = rules_for(cfg, desc)
    total, active = model.param_counts()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": chips, "status": "ok", "params_total": total,
           "params_active": active, "tokens_per_step": tokens,
           "model_flops": rl.model_flops(total, active, shape.kind, tokens)}
    if shape.kind == "train":
        rec["accum"] = choose_microbatch(cfg, shape.global_batch, desc, rules)
    t0 = time.perf_counter()
    args = argument_bytes(model, shape, desc, rules)
    rec["memory"] = {"argument_size_bytes": args["total"],
                     "arguments": args}
    reason = None if mesh_kind == "card" else \
        partition_reason(model, shape, desc, rules)
    if reason is not None:
        rec["analytic"] = True
        rec["reason"] = reason
        rec["compile_s"] = time.perf_counter() - t0
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh_kind}: analytic "
                  f"({reason}), {args['total'] / 1e9:.2f} GB of arguments "
                  f"per device")
        return rec
    if mesh_kind == "card" and hw.resolve_device(device).type == "cuda":
        spec = hw.device_spec(0)
    else:                 # the production meshes are of H100s: the sheet
        spec = hw.DeviceSpec("H100 SXM (data sheet)", hw.NUM_SMS,
                             hw.HBM_BYTES, hw.L2_BYTES)
    coll = None
    with (fake_mesh(desc) if mesh_kind != "card"
          else contextlib.nullcontext()) as mesh:
        fn, hold, extra = step_call(model, shape, mesh=mesh, rules=rules)
        with (rl.collective_bytes(mesh) if mesh is not None
              else contextlib.nullcontext()) as meter:
            step = rl.trace(fn, hold=hold, memory=True)
        coll = meter.result if mesh is not None else None
        del fn, hold
        if decompose:
            t1 = time.perf_counter()
            dec = decompose_cell(model, shape, mesh, rules)
            rec["decompose_s"] = time.perf_counter() - t1
            rec["pieces"] = {k: {kk: vv for kk, vv in v.items()
                                 if kk != "bytes_by_op"}
                             for k, v in dec["pieces"].items()}
    t_trace = step.pop("seconds")
    peak = step.pop("peak_bytes")
    rec.update(extra)
    rec["device"] = {"name": spec.name, "mem_bytes": spec.mem_bytes}
    rec["memory"].update({
        "held_bytes": step.pop("held_bytes"), "peak_bytes": peak,
        "temp_size_bytes": peak - args["total"],
        "fits": peak <= spec.mem_bytes})
    rec["compile_s"] = t_trace
    step.pop("bytes_by_op")
    rec["step"] = step
    if coll is not None:
        rec["collectives_full_step"] = coll
    rec["roofline"] = rl.build(
        step["flops"], step["bytes"], rec["model_flops"],
        mesh=None if coll is None else desc, coll=coll).to_dict()
    if verbose:
        roof = rec["roofline"]
        print(f"[dryrun] {arch} × {shape_name} × {mesh_kind}: OK (trace "
              f"{t_trace:.1f}s, dominant={roof['dominant']}, "
              f"roofline={roof['roofline_fraction']:.3f}, "
              f"useful={roof['useful_flops_ratio']:.3f}, peak "
              f"{peak / 1e9:.2f} GB a device, fits {rec['memory']['fits']}"
              + ("" if coll is None else
                 f", collectives {coll['total'] / 1e9:.2f} GB") + ")")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card",
                    choices=list(MESH_KINDS) + ["all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--missing", action="store_true",
                    help="run only cells without an ok record yet")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the card's spec comes from (cpu: the data "
                         "sheet)")
    ap.add_argument("--decompose", action="store_true",
                    help="also record each card cell's pieces")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    run, skip = all_cells()
    if not (args.all or args.missing):
        assert args.arch and args.shape, "--arch/--shape or --all"
        archs, shapes = args.arch.split(","), args.shape.split(",")
        for a in archs:
            get_arch(a)
        for s in shapes:
            SHAPES[s]
        run = [c for c in run if c[0] in archs and c[1] in shapes]
        skip = [c for c in skip if c[0] in archs and c[1] in shapes]
    meshes = list(MESH_KINDS) if args.mesh == "all" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in run:
        for mk in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mk}.json")
            if args.missing and os.path.exists(path):
                try:
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            continue
                except (OSError, ValueError):
                    pass
            try:
                rec = run_cell(arch, shape, mk, device=args.device,
                               decompose=args.decompose)
            except Exception as e:  # noqa: BLE001 — record and continue
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "status": "fail", "error": repr(e)}
                failures += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            sys.stdout.flush()
    for aa, ss, why in skip:
        with open(os.path.join(args.out, f"{aa}__{ss}__skip.json"),
                  "w") as f:
            json.dump({"arch": aa, "shape": ss, "status": "skipped",
                       "reason": why}, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
