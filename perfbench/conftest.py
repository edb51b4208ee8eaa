"""Fixtures of the benchmark's CPU tests: a cell of ``BENCHMARK.json`` cut
to a size the CPU runs in a second, and the card for the tests that need
one (decided inside the fixture, never at import)."""
import copy
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from pbench import spec  # noqa: E402


def _tiny(name: str, seq: int = 32, rows: int = 4, micro: int = 2):
    """(cell, ArchConfig): the cell's configuration at the program's
    ``reduced()`` widths (MHA, two layers, microbatch ``micro``) and its
    mix at ``rows`` × ``seq``; limits as the cell states them."""
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import pad_vocab
    c = copy.deepcopy(spec.cell(name))
    arch = get_arch(c.config["arch"]).reduced().replace(
        microbatch=micro, n_layers=2)
    if c.config["family"] == "dense":
        arch = arch.replace(n_kv_heads=arch.n_heads)
    model = {k: getattr(arch, k) if hasattr(arch, k) else v
             for k, v in c.config["model"].items()}
    model["vocab_rows"] = pad_vocab(arch.vocab)
    c.config["model"] = model
    c.traffic.update(rows=rows, seq_len=seq, batches=5, mean_doc_len=12)
    return c, arch


@pytest.fixture
def tiny_cell():
    return _tiny


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs the control in the card's "
                    "own TF32")
    return torch.device("cuda", 0)
