"""The benchmark is driven by data: every cell, configuration, mix and
metric named in ``BENCHMARK.json`` has its file, names and units keep to
their characters, and a cell or metric added as files is found with no
code edited."""
import json
import math
import shutil
import subprocess
import sys

import pytest

from pbench import check, spec

BENCH = spec.benchmark()
NUMBERS = set(check.numbers(
    check.Readings([1.0], [1.0], {"a": 1.0}, {"a": 1.0}, {"a": 1.0}),
    check.Readings([1.0], [1.0], {"a": 1.0}, {"a": 1.0}, {"a": 1.0})))
TEXT_KEYS = ("why", "layer", "source")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][1].startswith("perfbench/")
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files(w):
    c = spec.cell(w["name"])
    assert c.workload["why"] == w["why"]
    assert w["chips"] == 1
    assert set(c.workload["limits"]) <= NUMBERS
    for kind in ("reference", "counts"):
        spec.family_module(kind, c.config["family"])
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert "train_tokens_per_s" in {spec.quantity(n) for n in e2e}
    assert c.per_layer
    assert {m["moves"] for m in c.per_layer} <= e2e


def test_a_split_metric_is_read_by_its_quantity():
    """``train_tokens_per_s.ssm`` is ``train_tokens_per_s`` in other cells:
    its bound differs, the quantity and the reader are the same."""
    assert spec.quantity("train_tokens_per_s.ssm") == "train_tokens_per_s"
    assert spec.quantity("setup_s") == "setup_s"
    assert spec.metric_reader("device_idle_share.ssm").read.__code__ \
        .co_filename == spec.metric_reader("device_idle_share").read \
        .__code__.co_filename


def test_each_cell_reports_an_end_to_end_metric_once_per_quantity():
    for w in BENCH["workloads"]:
        names = [m["name"] for m in spec.cell(w["name"]).end_to_end]
        quantities = [spec.quantity(n) for n in names]
        assert len(set(quantities)) == len(quantities), (w["name"], names)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_has_its_file(c):
    cfg = spec.load_json(spec.ROOT / c["file"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert c["file"].startswith("perfbench/")
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def _named():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_named()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_text(group, entry):
    assert spec.NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert spec.NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert spec.NAME.match(key)
    if "unit" in entry:
        assert spec.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in TEXT_KEYS:
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_reader_loads(m):
    assert callable(spec.metric_reader(m["name"]).read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_bounds_and_set_up_metric():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    first = bench["workloads"][0]
    new = dict(first, name="olmo-1b.train.added", traffic="packed.added")
    bench["workloads"].append(new)
    bench["per_layer"].append(
        {"name": "added_metric", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "the card",
         "moves": "train_tokens_per_s", "workloads": [new["name"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = spec.load_json(spec.BENCH_DIR / "traffic" /
                         f"{first['traffic']}.json")
    (root / "perfbench" / "traffic" / "packed.added.json").write_text(
        json.dumps(dict(mix, rows=2)))
    (root / "perfbench" / "workloads" / "olmo-1b.train.added.json"
     ).write_text(json.dumps({"config": new["config"],
                              "traffic": "packed.added", "why": new["why"],
                              "limits": {"loss_gap": 1e-5}}))
    (root / "perfbench" / "metrics" / "added_metric.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    c = spec.cell("olmo-1b.train.added", root=root)
    assert c.traffic["rows"] == 2
    assert [m["name"] for m in c.per_layer] == ["added_metric"]
    assert spec.metric_reader("added_metric", root=root).read(None) == 1.5
    with pytest.raises(KeyError):
        spec.cell("olmo-1b.train.added")


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    r = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"),
                        "--workload", BENCH["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=spec.ROOT, env={"PATH": "/usr/bin:/bin",
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_limits_are_finite_and_positive():
    for w in BENCH["workloads"]:
        for k, v in spec.cell(w["name"]).workload["limits"].items():
            assert math.isfinite(v) and v > 0, (w["name"], k)
