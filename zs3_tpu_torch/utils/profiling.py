"""Device-time attribution of a GPU loop with torch.profiler
(the counterpart of zs3_tpu.utils.profiling's trace summary)."""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch


def profile_device(fn: Callable[[], None], steps: int) -> Dict:
    """Run fn() `steps` times under the profiler after one untraced call.

    Returns the wall time of the window (ending in a synchronize), the
    count and summed time of the device's own events (kernels, copies,
    sets; not user annotations), the device's idle share (1 - busy/wall, unclamped;
    one stream, so they do not overlap), and the kernels and the host
    ops, each sorted by the device time it accounts for.  An op's device time is that of the
    kernels it launched, so the two lists overlap and only the kernels add
    up to the busy time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    # A user annotation (record_function, such as the optimizers' own
    # "Optimizer.step#...") also shows on the device as a span over the
    # kernels it launched: not a kernel, and not busy time of its own.
    kernels = [e for e in events if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False)]
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def rows(entries):
        return [
            {"name": e.key[:100], "device_ms": e.self_device_time_total / 1e3,
             "calls": e.count}
            for e in entries
        ]

    return {
        "steps": steps,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels": rows(kernels),
        "ops": rows(ops),
    }
