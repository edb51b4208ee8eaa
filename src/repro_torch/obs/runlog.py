"""Structured run-logger for the benchmark harness.

The figure benchmarks historically reported through bare ``print`` of
``name,us_per_call,derived`` CSV rows. ``RunLogger`` keeps that console
contract (every row still echoes to stdout so existing pipelines parse
unchanged) while capturing each row as a structured record and — when an
output directory is given (``--emit-obs``) — writing per-run artifacts:

  ``rows.jsonl``    every emitted row as {"name", "us_per_call", "derived"}
  ``meta.json``     run metadata (argv-ish config, wall-clock, row count)
  ``<sub>/...``     any ``Obs`` contexts attached via ``artifact()``
                    (trace.jsonl + metrics.jsonl + metrics.prom each)
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Dict, List, Optional


class RunLogger:
    def __init__(self, name: str, out_dir: Optional[str] = None, echo=print):
        self.name = name
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self.echo = echo
        self.rows: List[dict] = []
        self.meta: Dict[str, Any] = {"run": name,
                                     "started": time.strftime(
                                         "%Y-%m-%dT%H:%M:%S")}
        self.artifacts: Dict[str, dict] = {}
        self._t0 = time.perf_counter()

    # -- the print-compatible row channel --------------------------------------
    def emit(self, line: str) -> None:
        """Accepts the benchmarks' CSV row strings (``name,us,derived``);
        anything unparseable is kept verbatim as a note row."""
        if self.echo is not None:
            self.echo(line)
        parts = str(line).split(",", 2)
        if len(parts) == 3:
            try:
                us = float(parts[1])
            except ValueError:
                us = None
            self.rows.append({"name": parts[0], "us_per_call": us,
                              "derived": parts[2]})
        else:
            self.rows.append({"note": str(line)})

    def note(self, **kv: Any) -> None:
        self.meta.update(kv)

    # -- obs artifact attachment -----------------------------------------------
    def artifact(self, obs, sub: str) -> Optional[dict]:
        """Dump an ``Obs`` context under ``<out_dir>/<sub>/``; no-op (returns
        None) when the logger has no output directory."""
        if self.out_dir is None:
            return None
        paths = obs.dump(self.out_dir / sub)
        self.artifacts[sub] = paths
        return paths

    # -- flush ------------------------------------------------------------------
    def close(self) -> Optional[pathlib.Path]:
        if self.out_dir is None:
            return None
        self.out_dir.mkdir(parents=True, exist_ok=True)
        with (self.out_dir / "rows.jsonl").open("w") as f:
            for r in self.rows:
                f.write(json.dumps(r) + "\n")
        self.meta.update(rows=len(self.rows),
                         wall_s=time.perf_counter() - self._t0,
                         artifacts=self.artifacts)
        (self.out_dir / "meta.json").write_text(
            json.dumps(self.meta, indent=2) + "\n")
        return self.out_dir
