"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`--trace 0` prints the cell's end-to-end metrics, taken on the host's
clock over the whole window: the images of every step completed in it
over its length, and for train loops the 95th percentile of the
intervals between consecutive steps' completion events (CUDA events
recorded after every step, read once the window has closed).
`--trace 1` prints its per-layer metrics: it runs the same untraced
window (the utilisation reads its rate), then `trace_steps` steps under
torch.profiler, then the host's time to queue one step on an idle card
and the syncs one step makes; each per-layer metric is read from those
by its own reader (metrics/<name>.py), and a reader that finds nothing
returns None and leaves its metric out.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "zs3_tpu")
BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)


class Refused(Exception):
    """A run that must print no result."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the latter's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def window(loop, seconds: float, sync, event) -> Dict:
    """Calls loop.step() until `seconds` have passed on the host clock,
    then waits for the device: steps, images, seconds and the intervals
    between consecutive steps' completion events (ms)."""
    sync()
    marks = [event()]
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        loop.step()
        marks.append(event())
        steps += 1
    sync()
    elapsed = time.perf_counter() - t0
    intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return {"steps": steps, "images": steps * loop.images_per_step, "seconds": elapsed,
            "intervals_ms": intervals}


class HostMark:
    """A host-clock stand-in for a CUDA event, for runs on the CPU."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, later: "HostMark") -> float:
        return 1e3 * (later.t - self.t)


def p95(values: List[float]) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18]


END_TO_END = {
    "train_images_per_s": lambda w: w["images"] / w["seconds"],
    "train_step_p95_ms": lambda w: p95(w["intervals_ms"]),
}


class Trace:
    """What a per-layer reader may read (see metrics/)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def run_cell(spec, cell_name: str, seed: int, seconds: float, trace: bool, device,
             started: float) -> Dict:
    """The result line of one run (see the module's docstring)."""
    import torch

    from benchmark import counts, devtrace
    from benchmark import spec as spec_lib

    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    kind = spec_lib.loop(traffic["loop"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def event():
        if not cuda:
            return HostMark()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    loop = kind.Loop(config, traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - started
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    measured = window(loop, seconds, sync, event)
    metrics, breakdown = {}, None
    if not trace:
        reported = {m["name"]: m for m in spec.end_to_end(cell_name)}
        for name, m in reported.items():
            if name != "setup_s":
                metrics[name] = {"value": END_TO_END[name](measured), "unit": m["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": reported["setup_s"]["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1}
    if trace:
        dispatch_ms = devtrace.host_ms(loop.step)
        syncs = devtrace.host_syncs(loop.step)
        prof = devtrace.profile_window(loop.step, traffic["trace_steps"])
        watts = power_limit_w()
        flops = counts.forward_flops(cell["config"], traffic["crop"])
        info = Trace(
            config=config, traffic=traffic, profile=prof,
            steps=prof["steps"], window_s=prof["window_s"], busy_s=prof["busy_s"],
            launches=prof["launches"],
            dispatch_ms=dispatch_ms, syncs=syncs,
            flops_per_image=None if flops is None else flops * loop.forward_passes,
            untraced=measured, peak_flops=BF16_PEAK_FLOPS,
        )
        for m in spec.per_layer(cell_name):
            value = spec.metric_reader(m["name"])(info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"],
                           power_limit_w=watts)
        breakdown = {
            "device_ops": devtrace.top({k: v[0] for k, v in prof["device_ops"].items()}),
            "idle_gaps": devtrace.top(prof["idle_gaps"]),
        }
    sync()
    device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    numbers = loop.check()
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in spec.limits(cell_name).items()}
    failed = sum(c["value"] > c["limit"] for c in checks.values())
    result = {"correct": failed == 0, "attempted": measured["steps"], "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    found = forbidden_modules()  # after the check, which imports the most
    if found:
        raise Refused(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    return result


def main(argv=None) -> int:
    started = time.perf_counter()
    import argparse

    parser = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import spec as spec_lib

    try:
        spec = spec_lib.Spec()
        chips = spec.cell(args.workload)["chips"]
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"the cell asks for {chips} CUDA device(s); "
                          f"torch sees {torch.cuda.device_count()}")
        result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                          "cuda", started)
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
