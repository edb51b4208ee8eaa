"""The port's examples (``repro_torch.examples``) held against the
reference's scripts (``examples/``) on the CPU.

Both run in this process with their standard output captured; the lines
that do not depend on a clock are compared with ``==``:

* ``nic_apps``: each app's name, stage count, packets kept and
  ``pipeline==oracle`` (the times and rates are this host's);
* ``quickstart``: the pool line, the app's stages, the oracle line and
  the packets kept (the profiled latencies, and so the plan, are timed);
* ``serve_tenants``: its whole output at 12 ticks, admissions, the
  watched tenant's per-tick table, the controller's events, the SLO
  report and the pool's usage. Both packages run it analytic
  (``--no-dataplane``: the reference's planes take ~30 s to compile
  here); the port's run with its planes on prints the same;
* ``serve_pipeline``: the Meili plan and the request count;
* ``train_lm``: the crash's exit code, the resume's, and the step it
  resumed from, with ``--reduced --seq 32`` added to each of its training
  runs (the ~100M-parameter config at 256 tokens takes minutes a run on
  this CPU) and 100 steps, so the crash at 50 resumes from the checkpoint
  of step 50.
"""
import importlib.util
import os
import re
import sys

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _run(capsys, monkeypatch, main, argv=()):
    """``main``'s standard output; scripts that read ``sys.argv`` see
    ``argv``."""
    monkeypatch.setattr(sys, "argv", ["example"] + list(argv))
    capsys.readouterr()
    main()
    return capsys.readouterr().out


def test_nic_apps_equal_reference(capsys, monkeypatch):
    cols = lambda out: [(ln.split()[0], ln.split()[1], ln.split()[-2],
                         ln.split()[-1]) for ln in out.splitlines()[1:]
                        if ln.strip()]
    want = cols(_run(capsys, monkeypatch, _reference("nic_apps").main))
    got = cols(_run(capsys, monkeypatch,
                    lambda: _port("nic_apps").main(["--device", "cpu"])))
    assert len(want) == 6 and all(row[-1] == "True" for row in want)
    assert got == want


def test_quickstart_equals_reference(capsys, monkeypatch):
    keep = ("pool:", "app '", "parallel data plane ==", "packets kept:")
    lines = lambda out: [ln for ln in out.splitlines() if ln.startswith(keep)]
    want = lines(_run(capsys, monkeypatch, _reference("quickstart").main))
    got = lines(_run(capsys, monkeypatch,
                     lambda: _port("quickstart").main(["--device", "cpu"])))
    assert "parallel data plane == single-pipeline oracle: True" in want
    assert len(want) == 4 and got == want


def test_serve_tenants_equals_reference(capsys, monkeypatch):
    argv = ["--ticks", "12", "--no-dataplane"]
    want = _run(capsys, monkeypatch,
                lambda: _reference("serve_tenants").main(argv))
    port = _port("serve_tenants").main
    got = _run(capsys, monkeypatch, lambda: port(argv + ["--device", "cpu"]))
    planes = _run(capsys, monkeypatch,
                  lambda: port(["--ticks", "12", "--device", "cpu"]))
    assert "failover t-fw" in want and "tenants alive: 6/6" in want
    assert got == want
    assert planes == got


def test_serve_pipeline_equals_reference(capsys, monkeypatch):
    def plan(out):
        lines = out.splitlines()
        start = lines.index("[serve] Meili plan:")
        served = re.search(r"\[serve\] (\d+/\d+ requests, \d+ tokens)", out)
        return lines[start:start + 5], served.group(1)
    want = plan(_run(capsys, monkeypatch, _reference("serve_pipeline").main))
    got = plan(_run(capsys, monkeypatch, lambda: _port(
        "serve_pipeline").main(["--device", "cpu"])))
    assert want[1] == "12/12 requests, 96 tokens"
    assert got == want


def test_train_lm_crashes_and_resumes_as_reference(capsys, monkeypatch,
                                                   tmp_path):
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    runs = {}

    def reduced(pkg, main):
        def run(argv):
            rc = main(argv + ["--reduced", "--seq", "32"])
            runs.setdefault(pkg, []).append(rc)
            return rc
        return run
    for pkg, mod, registry in (("reference", jtrain, jconfigs.ARCHS),
                               ("port", ttrain, tconfigs.ARCHS)):
        monkeypatch.setitem(registry, "olmo-100m", None)
        monkeypatch.setattr(mod, "main", reduced(pkg, mod.main))
    ckpt = str(tmp_path / "reference")
    want = _run(capsys, monkeypatch, _reference("train_lm").main,
                ["--steps", "100", "--ckpt", ckpt])
    got = _run(capsys, monkeypatch, lambda: _port("train_lm").main(
        ["--steps", "100", "--ckpt", str(tmp_path / "port"), "--device",
         "cpu"]))
    resumed = lambda out: re.findall(r"\[train\] resumed from step (\d+)",
                                     out)
    assert runs["reference"] == runs["port"] == [17, 0]
    assert resumed(want) == resumed(got) == ["50"]
    assert "simulating crash at step 50" in got
