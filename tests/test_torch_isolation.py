"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``, the
package imports with JAX made unimportable, and its entry points default to
the card (raising, not falling back, on a machine without one). Pass/fail
checks only; nothing numeric is compared.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_module_imports_jax_or_reference():
    files = _port_files()
    assert len(files) > 15 and (ROOT / "chip_smoke.py").exists()
    bad = [(str(p.relative_to(ROOT)), mod) for p in files
           for mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_port_imports_with_jax_unimportable():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    assert {"repro_torch.models.ssm", "repro_torch.kernels.ssd_scan",
            "repro_torch.configs.mamba2_370m"} <= names


def test_entry_points_default_to_cuda():
    from repro_torch.apps import ALL_APPS, synth_packets
    from repro_torch.configs import get_arch
    from repro_torch.core.executor import ParallelDataPlane
    from repro_torch.core.flowcache import FlowCache
    from repro_torch.core.graph import make_packets
    from repro_torch.models import Model, build
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import ServingEngine
    from repro_torch.core.controller import MeiliController
    from repro_torch.core.pool import paper_cluster
    from repro_torch.service import (ServiceRuntime, TenantRegistry,
                                     run_comparison)
    from repro_torch.service.workload import make_scenario

    cfg = get_arch("gemma3-1b").reduced()
    ssm_cfg = get_arch("mamba2-370m").reduced()

    z = np.zeros((2, 5), np.int32)
    calls = [lambda: synth_packets(batch=4, num_flows=2, pkt_bytes=64),
             lambda: make_packets(torch.zeros((2, 8), dtype=torch.uint8),
                                  torch.zeros(2), torch.from_numpy(z)),
             lambda: FlowCache(),
             lambda: ParallelDataPlane(ALL_APPS()["FW"], num_pipelines=2),
             lambda: build(cfg),
             lambda: init_lm(cfg),
             lambda: build(ssm_cfg),
             lambda: init_lm(ssm_cfg),
             lambda: ServingEngine(Model(cfg, torch.device("cuda")), None,
                                   num_pipelines=1),
             lambda: make_scenario("steady", {"t": 1.0}).batch_for("t", 0),
             lambda: ServiceRuntime(ctrl, TenantRegistry(ctrl),
                                    make_scenario("steady", {})),
             lambda: run_comparison(ticks=1, scenarios=("steady",))]
    ctrl = MeiliController(paper_cluster())
    if torch.cuda.is_available():
        assert synth_packets(batch=4, num_flows=2, pkt_bytes=64).payload.is_cuda
        assert FlowCache().device.type == "cuda"
        model = build(cfg)
        assert model.device.type == "cuda"
        params = model.init(dtype=torch.float32)
        assert params.embed["table"].is_cuda
        engine = ServingEngine(model, params, num_pipelines=1)
        assert engine.pipelines[0].cache["segments"][0][0]["k"].is_cuda
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
