"""Meili-planned LM serving example: per-segment replication (Algorithm 1)
over heterogeneous model stages + batched request serving.

  PYTHONPATH=src python -m repro_torch.examples.serve_pipeline \
      [--arch jamba-1.5-large-398b] [--device cpu]

The jamba-family reduced config has genuinely heterogeneous stages (mamba vs
attention vs MoE segments), so the Meili planner produces a non-trivial
replication plan — the paper's partial pipeline replication applied to an LM.
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-1.5-large-398b")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    return serve_mod.main(["--arch", args.arch, "--device", args.device]
                          + rest + ["--reduced", "--requests", "12",
                                    "--tokens", "8", "--slots", "4",
                                    "--max-len", "32"])


if __name__ == "__main__":
    main()
