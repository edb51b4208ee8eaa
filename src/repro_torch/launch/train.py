"""Training entry point, as the reference's ``launch/train.py``.

A deterministic resumable data stream, AdamW with a warmup schedule,
gradient accumulation, a checkpoint every ``--ckpt-every`` steps with an
atomic COMMIT, ``--resume`` from the last committed step, and
``--fail-at N``, which stops after step N as a crash would (exit code 17),
to exercise the restart path end to end.

Usage (on the card; ``--device cpu`` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --batch 8 --seq 1024 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --reduced --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLMDataset, host_shard_iterator
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build

CRASH_EXIT = 17


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="simulate a crash after N steps (tests failover)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(microbatch=min(cfg.microbatch, 2))
    model = build(cfg, args.device)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16

    gen = torch.Generator(device=model.device).manual_seed(0)
    params = model.init(gen, dtype).requires_grad_(True)
    step_fn, opt_init = make_train_step(model, shape, base_lr=args.lr,
                                        warmup=20, total_steps=args.steps)
    opt_state = opt_init(params)
    named = dict(params.named_parameters())
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        (saved, opt_state), start = restore_checkpoint(
            args.ckpt_dir, ({k: p.detach() for k, p in named.items()},
                            opt_state))
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(saved[k])
        print(f"[train] resumed from step {start}")

    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq + 1)
    it = host_shard_iterator(ds, args.batch, 0, 1, start_step=start)
    ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = next(it)
        tokens = torch.from_numpy(batch["tokens"][:, :args.seq]).to(
            model.device)
        params, opt_state, loss, gnorm = step_fn(
            params, opt_state, {"tokens": tokens}, step)
        losses.append(float(loss))
        if step % args.log_every == 0:
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {float(loss):.4f} "
                  f"gnorm {float(gnorm):.3f} ({dt:.1f}s)")
        ckpt.maybe_save(step + 1, ({k: p.detach() for k, p in named.items()},
                                   opt_state))
        if args.fail_at and step + 1 == args.fail_at:
            print(f"[train] simulating crash at step {step + 1}")
            return CRASH_EXIT
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
