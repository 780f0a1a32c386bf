"""The span readings of one cell (benchmark/spans.py), in a run of their own:

    python3 -m benchmark.spanrun --workload <cell> --seed <n>

Set-up builds the cell's loop with the program's recorder on, so the
run's first step is recorded; then, recorder off, the host's time to
queue one step on an idle card (devtrace.host_ms, as dispatch_ms reads
it); then `trace_steps` steps under torch.profiler, the spans' ranges
among the kernels; then a pass of 11 recorded calls, each on an idle
card.  It prints one JSON line: the span metrics (spans.metrics), and
the sums that hold them together: the device ms a step in every span and
outside them beside the window's busy ms, the four host phases beside
the step span's median and dispatch_ms, and the device's idle ms a step
by span.  Nothing here is timed for an end-to-end metric and nothing is
checked against the reference: the train step's results are
harness.py's.
"""

from __future__ import annotations

import json
import sys
from typing import Dict


def run_spans(spec, cell_name: str, seed: int, device) -> Dict:
    """The result line of one run (see the module's docstring)."""
    import torch

    from benchmark import devtrace, harness, spans
    from benchmark import spec as spec_lib
    from zs3_tpu_torch.utils.profiling import recording

    cell = spec.cell(cell_name)
    traffic = spec.traffic(cell["traffic"])
    kind = spec_lib.loop(traffic["loop"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with recording() as setup:
        loop = kind.Loop(spec.config(cell["config"]), traffic, seed, device)
    sync()
    dispatch_ms = devtrace.host_ms(loop.step) if cuda else None
    window = spans.profile_window(loop.step, traffic["trace_steps"], sync)
    host = spans.host_ms(spans.host_pass(loop.step, sync))
    steps = window["steps"]

    def per_step(seconds):
        return {name: 1e3 * s / steps for name, s in sorted(seconds.items())}

    device_ms = per_step(window["device_s"])
    return {
        "metrics": spans.metrics(host, window["device_s"], steps, spans.first_step_ms(setup)),
        "sums": {
            "busy_ms": 1e3 * window["busy_s"] / steps,
            "device_ms": device_ms,
            "device_phases_ms": sum(device_ms.get(spans.PREFIX + p, 0.0)
                                    for p in spans.DEVICE_PHASES),
            "host_ms": host,
            "host_phases_ms": sum(host.get(spans.PREFIX + p, 0.0) for p in spans.HOST_PHASES),
            "dispatch_ms": dispatch_ms,
            "idle_ms": per_step(window["idle_s"]),
            "window_s": window["window_s"],
            "steps": steps,
        },
        "device": {"kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "power_limit_w": harness.power_limit_w() if cuda else None},
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python3 -m benchmark.spanrun")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)

    import torch

    from benchmark import spec as spec_lib

    if not torch.cuda.is_available():
        print("benchmark.spanrun: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(run_spans(spec_lib.Spec(), args.workload, args.seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
