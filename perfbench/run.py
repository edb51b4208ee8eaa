"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Set-up builds the cell's training step with
the benchmark's seeded weights and runs its two checked steps; the
window then runs whole steps for ``--seconds``; after it the reference
runs the same two steps and the two sides are compared. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics, read from a profiler trace of the window),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, and when JAX or the JAX package is loaded at the end,
just before the result would be printed (after the window, the reference,
the comparison and the per-layer readers). The program's kernel builds
and caches stay in the checkout (``build/``).
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench-cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "perfbench")]

EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def finite(x: float):
    """x, or None where it is not finite (JSON has no NaN)."""
    return x if math.isfinite(x) else None


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from pbench import check, harness, spec

    cell = spec.cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    dev = torch.device("cuda", 0)
    prog = harness.Program(cell, args.seed, dev)
    mine = prog.checked_steps()
    setup_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.monotonic() - T_START
    win = prog.window(args.seconds, bool(args.trace))
    prog.free()
    limits = cell.workload["limits"]
    t_ref = time.monotonic()
    nums = check.numbers(mine, harness.reference_readings(cell, args.seed,
                                                          dev))
    t_ref = time.monotonic() - t_ref
    correct = check.verdict(nums, limits) and win["failed"] == 0

    metrics = harness.per_layer(cell, win) if args.trace else \
        harness.end_to_end(cell, win, setup_s)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": 1,
              "memory_peak_bytes": max(setup_peak, win["peak_bytes"]),
              "power_limit_w": harness.power_limit_w()}
    result = {"correct": correct, "attempted": win["steps"],
              "failed": win["failed"], "metrics": metrics, "device": device}
    if args.trace:
        tr = win["trace"]
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.top_gaps()}
    result["checks"] = {k: {"value": finite(nums[k]), "limit": lim}
                        for k, lim in limits.items()}
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: loaded by the end of the run: {', '.join(found)}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    print(json.dumps(result))
    sys.stdout.flush()
    print(f"setup_s {setup_s!r} window_s {win['seconds']!r} reference_s "
          f"{t_ref!r} step_s {win['step_s']!r}", file=sys.stderr)
    for k, lim in limits.items():
        print(f"check {k} {nums[k]!r} limit {lim!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
