"""The port's kernel sources against the accounting that reads them.

``chip_smoke.py`` times each kernel's launches by the names of the
``__global__`` functions it runs (``FUNCTIONS``, read from the profiler's
trace and from ptxas' report) and reads each kernel's source from
``SOURCES``. A redesign that adds, renames or drops a sub-kernel must update
both, or a kernel row counts the wrong launches: read the two tables with
``ast`` (``chip_smoke.py`` imports torch's CUDA parts and is not imported
here) and hold them to the functions each source defines.

The backward SSD's bound is pinned at mamba2-370m's training shape.
"""
import ast
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ssd_scan as ss

ROOT = Path(__file__).resolve().parents[1]
GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def _smoke_table(name):
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise AssertionError(f"chip_smoke.py has no {name}")


def _globals(path):
    return set(GLOBAL.findall((ROOT / path).read_text()))


def test_smoke_tables_name_the_same_kernels():
    assert set(_smoke_table("FUNCTIONS")) == set(_smoke_table("SOURCES"))


@pytest.mark.parametrize("source", sorted(set(_smoke_table("SOURCES")
                                              .values())))
def test_smoke_functions_are_each_sources_globals(source):
    """Every ``__global__`` function of a kernel source is named by exactly
    the kernels ``SOURCES`` maps to it, and nothing else is."""
    functions = _smoke_table("FUNCTIONS")
    named = set()
    for kernel, src in _smoke_table("SOURCES").items():
        if src == source:
            named.update(functions[kernel])
    assert named == _globals(source)


def test_ssd_bwd_sub_kernels():
    """B7's backward: the four kernels of its tensor-core design, dcl
    folded into ``ssd_bwd_rows``."""
    assert set(_smoke_table("FUNCTIONS")["ssd_scan_bwd"]) == {
        "ssd_bwd_dstate", "ssd_bwd_reverse", "ssd_bwd_cols", "ssd_bwd_rows"}
    assert _globals(_smoke_table("SOURCES")["ssd_scan_bwd"]) == set(
        _smoke_table("FUNCTIONS")["ssd_scan_bwd"])


def test_work_bwd_at_the_training_shape():
    """x (4, 1,024, 32, 64), N 128, c broadcast over H, no dh_final: the
    numbers B7-backward's bound (0.1013 ms, by bytes) is computed from."""
    B, S, H, P, N = 4, 1024, 32, 64, 128
    x = torch.empty(B, S, H, P, device="meta")
    b = torch.empty(B, S, H, N, device="meta")
    c = torch.empty(B, S, 1, N, device="meta").expand(B, S, H, N)
    assert ss.work_bwd(x, b, c, False) == (15_032_385_536, 339_214_336)
