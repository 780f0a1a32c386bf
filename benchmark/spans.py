"""The program's spans in the seen train step, read for the benchmark.

`zs3_tpu_torch.utils.profiling.span` opens `zs3.train.step` over
`zs3.train.prepare`, `.forward`, `.backward` (one each a microbatch) and
`.optimizer`.  Under the program's `recording()` they are records
(name, parent, call id, start ns, end ns) on the host's clock; under
torch.profiler they are record_function ranges among the kernels.  From
these this module gives:

- host ms a step in each span: summed over the spans of one call, the
  median over the calls of a pass (`host_pass`, `host_ms`), and the first
  step of a run (`first_step_ms`);
- device seconds of the work launched inside each span (`attribute`):
  each device event is matched to its runtime launch by the profiler's
  correlation id, whatever thread launched it (autograd's device thread
  launches the backward while the main thread waits in backward()), and
  put down to the innermost span open on the host at the launch; and the
  device's idle seconds by the span open at each gap's midpoint
  (`idle_by_span`).

Only the span names and the recorder come from the program; the
arithmetic is the benchmark's own, as devtrace's is (busy time: device
events that are not user annotations; idle gaps of 5 us or more), so a
later change to the program cannot move the yardstick.  `metrics` names
the per-layer metrics they give; `benchmark/spanrun.py` runs them.
"""

from __future__ import annotations

import bisect
import statistics
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

PREFIX = "zs3.train."
STEP = "zs3.train.step"
HOST_PHASES = ("prepare", "forward", "backward", "optimizer")
DEVICE_PHASES = ("forward", "backward", "optimizer")
OUTSIDE = "outside"  # launched, or idle, while the host was in no span
LEAST_GAP_NS = 5000  # devtrace.idle_gaps' least gap

Span = Tuple[int, int, str]  # start ns, end ns, name


def host_ms(records: Sequence[tuple]) -> Dict[str, float]:
    """Host ms a call in each span name: the spans of one call id summed
    (a step's microbatches), the median over the calls that have it."""
    per_call: Dict[str, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for name, _, call, start, end in records:
        per_call[name][call] += end - start
    return {name: 1e-6 * statistics.median(calls.values()) for name, calls in per_call.items()}


def first_step_ms(records: Sequence[tuple]) -> Optional[float]:
    """Host ms of the first recorded `zs3.train.step`."""
    steps = [r for r in records if r[0] == STEP]
    if not steps:
        return None
    first = min(steps, key=lambda r: r[3])
    return 1e-6 * (first[4] - first[3])


def host_pass(step: Callable[[], None], sync: Callable[[], None], calls: int = 11) -> List[tuple]:
    """The records of `calls` calls of step() under the program's
    recording(), each after sync() on an idle device: the conditions of
    devtrace.host_ms."""
    from zs3_tpu_torch.utils.profiling import recording

    with recording() as records:
        for _ in range(calls):
            sync()
            step()
    sync()
    return records


def innermost(spans: Sequence[Span], starts: Sequence[int], t: float) -> str:
    """The name of the latest-opened span of `spans` (sorted by start;
    `starts` their starts) that is open at `t`, or OUTSIDE."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[i][1] >= t:
            return spans[i][2]
    return OUTSIDE


def attribute(spans: Sequence[Span], launches: Dict[int, int],
              device: Sequence[Tuple[int, int, int]]) -> Dict[str, float]:
    """Device seconds by span.  `spans`: host spans (start, end, name);
    `launches`: correlation id -> launch time of each runtime launch, of
    any thread; `device`: (start, end, correlation id) of each device
    event that is not a user annotation.  An event whose launch is not
    found counts under OUTSIDE.  Times in ns."""
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    seconds: Dict[str, float] = defaultdict(float)
    for start, end, corr in device:
        t = launches.get(corr)
        seconds[OUTSIDE if t is None else innermost(spans, starts, t)] += 1e-9 * (end - start)
    return dict(seconds)


def idle_by_span(spans: Sequence[Span], device: Sequence[Tuple[int, int, int]],
                 least_ns: int = LEAST_GAP_NS) -> Dict[str, float]:
    """Seconds the device sat idle between two of its events, by the
    innermost span open on the host at each gap's midpoint."""
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    device = sorted(device)
    idle: Dict[str, float] = defaultdict(float)
    busy_until = device[0][1] if device else 0
    for start, end, _ in device[1:]:
        if start - busy_until >= least_ns:
            idle[innermost(spans, starts, 0.5 * (start + busy_until))] += 1e-9 * (start - busy_until)
        busy_until = max(busy_until, end)
    return dict(idle)


def device_phases(events: Iterable) -> Dict:
    """From the kineto events of a torch.profiler window
    (prof.profiler.kineto_results.events()): busy seconds (device events
    that are not user annotations), their seconds by span (`attribute`)
    and the idle seconds by span."""
    from torch.autograd import DeviceType

    spans, launches, device = [], {}, []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith(PREFIX):
                spans.append((start, end, e.name()))
            elif e.linked_correlation_id() > 0:  # a runtime call, linked to its op
                launches[e.correlation_id()] = start
        elif not e.is_user_annotation():
            device.append((start, end, e.correlation_id()))
    return {"busy_s": 1e-9 * sum(end - start for start, end, _ in device),
            "device_s": attribute(spans, launches, device),
            "idle_s": idle_by_span(spans, device)}


def profile_window(step: Callable[[], None], steps: int, sync: Callable[[], None]) -> Dict:
    """`steps` calls of step() under torch.profiler (CUDA activity where
    torch sees a card), the window ending in sync(): its wall seconds and
    device_phases."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        window_s = time.perf_counter() - t0
    return {"steps": steps, "window_s": window_s,
            **device_phases(prof.profiler.kineto_results.events())}


def metrics(host: Dict[str, float], device_s: Dict[str, float], steps: int,
            first_ms: Optional[float]) -> Dict[str, float]:
    """The per-layer metrics of the spans by name, in ms a step: host ms in
    each phase (`host_ms` of a pass), device ms launched in the forward,
    the backward and the optimizer (`device_s` of a window of `steps`),
    and the first step's host ms.  A metric with nothing to read is left
    out: the device ones where the window saw no device event."""
    out = {f"{phase}_host_ms.train": host[f"{PREFIX}{phase}"]
           for phase in HOST_PHASES if f"{PREFIX}{phase}" in host}
    if device_s:
        out.update({f"{phase}_device_ms.train": 1e3 * device_s.get(f"{PREFIX}{phase}", 0.0) / steps
                    for phase in DEVICE_PHASES})
    if first_ms is not None:
        out["first_step_host_ms.train"] = first_ms
    return out
