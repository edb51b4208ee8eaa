"""The readings that the limits of a cell's comparison are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \\
        [--control 1,2,3] [--fault 1,2,3] [--faults half_batch,...] \\
        [--witness]

On the card, in one process, at the cell's own sizes. For each seed: the
program's two checked steps against the reference's (the sound
readings); with ``--control``, the reference computed with TF32 in the
program's place (the control); on the ``--fault`` seeds, the program with
each of ``--faults`` planted (``harness.plant_<fault>``: ``half_batch``,
half of each microbatch left out; ``state_dropped``, the SSD's state
between chunks dropped); with ``--witness``, the program's own plain path
(``impl="torch"``) against the reference, and the program against it.
One JSON line per reading on standard output.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "perfbench")]


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--fault", type=seeds, default=[])
    ap.add_argument("--faults", type=lambda s: s.split(","),
                    default=["half_batch"])
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from pbench import check, harness, spec
    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0)

    def emit(seed, kind, readings, ref, **extra):
        print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind,
                          "numbers": check.numbers(readings, ref),
                          "losses": readings.losses, "ref_losses": ref.losses,
                          "gnorms": readings.gnorms,
                          "ref_gnorms": ref.gnorms,
                          "quiet": check.quiet_leaves(ref),
                          "worst": check.worst_leaves(readings, ref),
                          **extra}),
              flush=True)

    for seed in args.seeds:
        t = time.monotonic()
        prog = harness.Program(cell, seed, dev)
        mine = prog.checked_steps()
        prog.free()
        del prog
        t_prog = time.monotonic() - t
        t = time.monotonic()
        ref = harness.reference_readings(cell, seed, dev)
        emit(seed, "program", mine, ref, program_s=t_prog,
             reference_s=time.monotonic() - t)
        if args.witness:
            prog = harness.Program(cell, seed, dev, impl="torch")
            plain = prog.checked_steps()
            prog.free()
            del prog
            emit(seed, "witness_plain", plain, ref)
            emit(seed, "program_vs_plain", mine, plain)
        if seed in args.control:
            emit(seed, "control_tf32",
                 harness.reference_readings(cell, seed, dev, "tf32"), ref)
        for fault in args.faults if seed in args.fault else []:
            prog = harness.Program(cell, seed, dev)
            getattr(harness, f"plant_{fault}")(prog)
            bad = prog.checked_steps()
            prog.free()
            del prog
            emit(seed, f"fault_{fault}", bad, ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
