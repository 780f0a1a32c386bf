"""A checkout root holding a copy of the benchmark's files and tiny cells
of its own, for the CPU tests: R101 with one block a stage and full-width
Xception-65, f32, 33x33 crops, batches of 2."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import spec

R101 = "deeplabv3plus-r101-os16-voc"
XCEPTION = "deeplabv3plus-xception65-os16-voc"
LIMITS = {"loss_gap": 1e-3, "loss1_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-2,
          "grad_median_gap": 1e-3, "change_median_gap": 1e-2}


def make_root(tmp: Path) -> Path:
    """A root with BENCHMARK.json and benchmark/{configs,traffic,limits,
    metrics} copied, and the tiny configurations "tiny-r101" and
    "tiny-xception" and the tiny cell "tiny-r101-train" added as new files
    and entries."""
    files = tmp / "benchmark"
    for part in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(spec.HERE / part, files / part)
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for name, source, layers in (("tiny-r101", R101, [1, 1, 1, 1]), ("tiny-xception", XCEPTION, None)):
        cfg = json.loads((spec.HERE / "configs" / f"{source}.json").read_text())
        cfg["name"] = name
        cfg["model"]["compute_dtype"] = "float32"
        if layers:
            cfg["model"]["layers"] = layers
        (files / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "https://arxiv.org/abs/1802.02611",
                                 "file": f"benchmark/configs/{name}.json", "reduced": [],
                                 "why": "tiny"})
    tiny = {"batch": 2, "crop": 33, "pool_batches": 3, "ignore_band": 1, "warmup_steps": 1,
            "trace_steps": 2}
    traffic = json.loads((spec.HERE / "traffic" / "seen-train-b48.json").read_text())
    traffic.update(tiny, schedule_steps=100)
    (files / "traffic" / "tiny-seen-train-b48.json").write_text(json.dumps(traffic))
    cell = "tiny-r101-train"
    bench["workloads"].append({"name": cell, "config": "tiny-r101",
                               "traffic": "tiny-seen-train-b48", "chips": 1, "why": "tiny"})
    (files / "limits" / f"{cell}.json").write_text(json.dumps({"limits": LIMITS}))
    for metric in bench["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
