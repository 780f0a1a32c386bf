"""Where the benchmark finds what a cell is made of, by name.

BENCHMARK.json (at the checkout's root) names every cell with its
configuration and traffic mix, and every metric.  Each piece lives in a
file of its own under this directory, found by name:

  configs/<config>.json    a configuration (the file BENCHMARK.json names)
  traffic/<traffic>.json   a traffic mix: the loop it drives and its parameters
  limits/<cell>.json       the limits of the numbers a cell's check compares
  loops/<loop>.py          one loop kind (train)
  metrics/<metric>.py      the reader of a per-layer metric; a metric
                           `<base>.<loop>` without a file of its own is
                           read by metrics/<base>.py

so a later change adds a configuration, a cell or a metric with new files
and new entries, and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json at `root` (the checkout's root by default), and the
    files of its cells under root/benchmark/."""

    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else ROOT
        self.files = self.root / HERE.name
        self.data = read_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> Dict[str, Any]:
        for entry in self.data["workloads"]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return read_json(self.root / entry["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return read_json(self.files / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return read_json(self.files / "limits" / f"{cell}.json")["limits"]

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        """The end-to-end metrics `cell` reports."""
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        """The per-layer metrics `cell` reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def metric_reader(self, name: str):
        """The `read(trace)` of metrics/<name>.py, or else of
        metrics/<base>.py for a name `<base>.<suffix>`."""
        path = self.files / "metrics" / f"{name}.py"
        if not path.exists() and "." in name:
            path = self.files / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
        module_spec = importlib.util.spec_from_file_location(
            f"benchmark.metrics.{path.stem}", path)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
        return module.read


def loop(kind: str):
    return importlib.import_module(f"benchmark.loops.{kind}")
