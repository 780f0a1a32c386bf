"""The readings the limits of a cell's check are set from (not run by
the benchmark's own runs):

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--variants sound,fp8_reference,half_batch]

For each seed, one reference and, held against it, the numbers of each
variant: `sound` (the program as the configuration states),
`fp8_reference` (the control: the reference itself with every operation
in fp8, reference/lowp.py) and the planted faults of faults.py.  Each
variant runs the cell's set-up at its own size, and serves every pool
batch once, so it compares as much as a run does.  One JSON line per
seed and variant.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def readings(kind, config, traffic, seed, device, variant):
    from benchmark import faults

    if variant == "fp8_reference":
        return kind.reference(config, traffic, seed, device, fp8=True)
    fault = variant if variant in faults.FAULTS else None
    with faults.planted(fault) if fault else contextlib.nullcontext():
        loop = kind.Loop(config, dict(traffic, warmup_steps=0), seed, device)
        for _ in range(len(loop.pool)):
            loop.step()
        return loop.program_readings()


def leaves(prog: dict, ref: dict, n: int = 4) -> dict:
    """The leaves of largest gap with their norms, and the leaf gaps'
    quantiles."""
    from benchmark.reference import compare

    keep = compare.kept_leaves(ref["grad"])
    out = {}
    for key in ("grad", "change"):
        median = sorted(ref[key][k] for k in keep)[len(keep) // 2]
        gaps = sorted(((abs(prog[key][k] - ref[key][k]) / max(ref[key][k], median), k)
                       for k in keep), reverse=True)
        out[key] = [[k, g, prog[key][k], ref[key][k]] for g, k in gaps[:n]]
        values = sorted(g for g, _ in gaps)
        out[key + "_quantiles"] = {q: values[int(q * (len(values) - 1))]
                                   for q in (0.25, 0.5, 0.75, 0.9)}
    out["steps"] = {"loss": [prog["loss"], ref["loss"]]}
    out["left_out"] = sorted(set(ref["grad"]) - set(keep))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--variants", default="sound,fp8_reference")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from benchmark import spec as spec_lib

    spec = spec_lib.Spec()
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    kind = spec_lib.loop(traffic["loop"])
    for seed in (int(s) for s in args.seeds.split(",")):
        got = {}
        for variant in args.variants.split(","):
            t0 = time.perf_counter()
            got[variant] = readings(kind, config, traffic, seed, args.device, variant)
            got[variant + "_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = kind.reference(config, traffic, seed, args.device)
        ref_s = time.perf_counter() - t0
        for variant in args.variants.split(","):
            line = {"workload": args.workload, "seed": seed, "variant": variant,
                    "numbers": kind.compare_readings(got[variant], ref),
                    "seconds": got[variant + "_s"], "reference_s": ref_s,
                    "leaves": leaves(got[variant], ref)}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
