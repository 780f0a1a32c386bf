"""What a `--trace 1` run reads from the card: a profiled window, the
host's time to queue one step, and the syncs a step makes.

The arithmetic is copied from the port's `utils/profiling.py::
profile_device` (busy time: the device events that are not user
annotations; idle share 1 - busy / wall) and from `chip_smoke.py`
(`host_ms`, `host_syncs`), so that a later change to the program cannot
move the yardstick.
"""

from __future__ import annotations

import bisect
import time
import warnings
from collections import defaultdict
from typing import Callable, Dict, List, Tuple


def profile_window(step: Callable[[], None], steps: int) -> Dict:
    """`steps` calls of step() under torch.profiler, the window ending in
    a synchronize: wall seconds, busy seconds, device events by name, and
    the idle gaps of the device labelled by the host op running then."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    device, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CPU:
            host.append(span)
        elif not getattr(e, "is_user_annotation", False):
            # A user annotation also shows on the device as a span over the
            # kernels it launched: no busy time of its own.
            device.append(span)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for start, end, name in device:
        by_name[name][0] += (end - start) * 1e-6
        by_name[name][1] += 1
    busy_s = sum(v[0] for v in by_name.values())
    return {
        "steps": steps,
        "window_s": wall_s,
        "busy_s": busy_s,
        "launches": sum(v[1] for v in by_name.values()),
        "device_ops": {name: (s, n) for name, (s, n) in by_name.items()},
        "idle_gaps": idle_gaps(device, host),
    }


def idle_gaps(device: List[Tuple[float, float, str]], host: List[Tuple[float, float, str]],
              least_us: float = 5.0) -> Dict[str, float]:
    """Seconds the device sat idle between two of its events, summed by the
    innermost host op that was running at each gap's midpoint ("host"
    where none was)."""
    device = sorted(device)
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    busy_until = device[0][1] if device else 0.0
    for start, end, _ in device[1:]:
        if start - busy_until >= least_us:
            mid = 0.5 * (start + busy_until)
            label = "host"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            gaps[label] += (start - busy_until) * 1e-6
        busy_until = max(busy_until, end)
    return dict(gaps)


def top(entries: Dict[str, float], n: int = 10) -> List[list]:
    return [[name, s] for name, s in sorted(entries.items(), key=lambda kv: -kv[1])[:n]]


def host_syncs(fn: Callable[[], None]) -> int:
    """How many times one fn() made the host wait for the device (calls
    that torch's sync debug mode reports)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def host_ms(fn: Callable[[], None], calls: int = 11) -> float:
    """The host's own time for one fn() in ms, median over `calls`: each
    call starts after a synchronize, on an idle device, and is timed until
    it returns, so it measures queueing the work while the device runs it."""
    import torch

    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return sorted(times)[calls // 2]
