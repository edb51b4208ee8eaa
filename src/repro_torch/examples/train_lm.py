"""End-to-end training example: ~100M-parameter LM, a few hundred steps,
with checkpointing and a simulated crash + resume.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \
      [--device cpu]

Uses a ~100M-param olmo-family config (12L x 768), registered in the
port's registry as ``olmo-100m``; the full configs train through the same
``launch.train`` path. Its 768 attention dims are 12 heads of 64 where
the reference's script has 8 of 96: the attention kernel takes head dims
16, 64, 128 and 256 (the parameter count is the same).
"""
import argparse
import os
import shutil
import tempfile

from repro_torch import configs
from repro_torch.configs import olmo_1b as olmo
from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_example_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt, ignore_errors=True)

    # ~100M params: 12 x 768 with 12 heads of 64 over olmo's family.
    configs.ARCHS["olmo-100m"] = olmo.CONFIG.replace(
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=2048,
        d_head=64, vocab=32768, microbatch=1)

    common = ["--arch", "olmo-100m", "--steps", str(args.steps),
              "--batch", "8", "--seq", "256", "--ckpt-dir", args.ckpt,
              "--ckpt-every", "50", "--log-every", "20",
              "--device", args.device]
    print("=== phase 1: train until a simulated crash at step "
          f"{args.steps // 2} ===")
    rc = train_mod.main(common + ["--fail-at", str(args.steps // 2)])
    if rc != train_mod.CRASH_EXIT:
        raise SystemExit(f"expected the simulated crash, got exit {rc}")
    print("\n=== phase 2: resume from the last committed checkpoint ===")
    rc = train_mod.main(common + ["--resume"])
    if rc != 0:
        raise SystemExit(f"the resumed run exited {rc}")
    print("\ntraining complete; checkpoints in", args.ckpt)


if __name__ == "__main__":
    main()
