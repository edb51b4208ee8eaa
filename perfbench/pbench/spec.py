"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics; each has a file of its own under ``perfbench/``:

* ``configs/<config>.json``   the source's sizes (``model``), what the
  program runs otherwise (``as_run``, each a ``departures`` entry),
  assumptions, deployment;
* ``workloads/<cell>.json``   configuration, traffic mix, why, limits;
* ``traffic/<traffic>.json``  the mix's parameters, read by ``traffic.py``;
* ``metrics/<metric>.py``     a reader with ``read(ctx)`` for a per-layer
  metric; a metric split by the cells it is reported in
  (``<metric>.<part>``) shares its quantity's reader.

An end-to-end metric's quantity is likewise its name before the first
``.`` (``quantity``).

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; no code here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict            # the cell's entry in BENCHMARK.json
    workload: Dict         # workloads/<cell>.json
    config: Dict           # configs/<config>.json
    traffic: Dict          # traffic/<traffic>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _in_cell(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name``, with its files; raises where one is
    missing or disagrees with ``BENCHMARK.json``."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; have "
                       f"{sorted(entries)}")
    entry = entries[name]
    bench_dir = root / "perfbench"
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json says {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    config["model"] = {**config["model"], **config.get("as_run", {})}
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, entry=entry, workload=workload, config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _in_cell(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _in_cell(m, name)])


def quantity(name: str) -> str:
    """What a metric measures: its name before the first ``.``
    (``train_tokens_per_s.ssm`` is ``train_tokens_per_s``)."""
    return name.split(".", 1)[0]


def metric_reader(name: str, root: Path = ROOT):
    """``metrics/<quantity>.py`` loaded as a module; its ``read(ctx)``
    returns the metric's value, or None where the trace holds nothing to
    read."""
    base = quantity(name)
    path = root / "perfbench" / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{base.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_module(kind: str, family: str):
    """``pbench.<kind>.<family>``: a family's reference or counts."""
    return importlib.import_module(f"pbench.{kind}.{family}")

