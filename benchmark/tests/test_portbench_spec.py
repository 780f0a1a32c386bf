"""BENCHMARK.json against the contract's shape, and the harness finding a
configuration, a cell and a per-layer metric that were added as new
files only."""

import json
import re
import time

import pytest

from benchmark import harness, spec
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.Spec()
BENCH_CELL = BENCH.data["workloads"][0]["name"]


def test_benchmark_json_keys_and_names():
    data = BENCH.data
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert data["paths"] == ["benchmark"]
    assert 1 <= data["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in data[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in data["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in data["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in data["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(data)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH.data["workloads"]])
def test_every_cell_has_its_files(cell):
    entry = BENCH.cell(cell)
    config = BENCH.config(entry["config"])
    traffic = BENCH.traffic(entry["traffic"])
    loop = spec.loop(traffic["loop"])
    reported = [m["name"] for m in BENCH.end_to_end(cell)]
    assert "setup_s" in reported and set(reported) - {"setup_s"} <= set(loop.REPORTS)
    assert all(name in harness.END_TO_END for name in loop.REPORTS)
    per_layer = BENCH.per_layer(cell)
    assert per_layer, "every cell reports a per-layer metric"
    for m in per_layer:
        assert m["moves"] in reported
        assert callable(BENCH.metric_reader(m["name"]))
    assert BENCH.limits(cell) and all(v >= 0 for v in BENCH.limits(cell).values())
    assert config["model"]["num_classes"] == 21


def test_every_metric_file_is_read():
    """No reader lies unused: each file under metrics/ reads a metric,
    named after it or after its base (the name less its last suffix)."""
    names = {m["name"] for m in BENCH.data["per_layer"]}
    files = {p.stem for p in (spec.HERE / "metrics").glob("*.py")} - {"__init__"}
    assert files <= names | {n.rsplit(".", 1)[0] for n in names}
    for name in names:
        assert BENCH.metric_reader(name).__module__[len("benchmark.metrics."):] in files


def test_a_metric_file_of_its_own_comes_before_its_base(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "benchmark" / "metrics" / "launches.train.py").write_text(
        "def read(trace):\n    return -1.0\n")
    found = spec.Spec(root)
    assert found.metric_reader("launches.train")(None) == -1.0
    assert found.metric_reader("launches.eval")(harness.Trace(launches=6, steps=3)) == 2.0


def test_a_cell_config_and_metric_added_as_new_files(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "benchmark" / "metrics" / "steps_seen.train.py").write_text(
        "def read(trace):\n    return float(trace.untraced['steps'])\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "loops",
                              "moves": "train_images_per_s", "workloads": ["tiny-r101-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    found = spec.Spec(root)
    assert found.config("tiny-r101")["model"]["layers"] == [1, 1, 1, 1]
    assert "steps_seen.train" in {m["name"] for m in found.per_layer("tiny-r101-train")}
    assert "steps_seen.train" not in {m["name"] for m in found.per_layer(BENCH_CELL)}
    read = found.metric_reader("steps_seen.train")
    assert read(harness.Trace(untraced={"steps": 7})) == 7.0
    result = harness.run_cell(found, "tiny-r101-train", 12345, 0.5, False, "cpu",
                              time.perf_counter())
    assert result["correct"] and set(result["metrics"]) == {
        "train_images_per_s", "train_step_p95_ms", "setup_s"}
