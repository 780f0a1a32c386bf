"""Device-time attribution of a GPU loop with torch.profiler
(the counterpart of zs3_tpu.utils.profiling's trace summary), a step
timer, `cli profile`, and the spans the train step opens (`span`,
`recording`)."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


# One span: (name, parent's name or None, call id, start ns, end ns), on
# time.perf_counter_ns.  The spans of one outermost span (one train_step
# call) share its call id.
SpanRecord = Tuple[str, Optional[str], int, int, int]


class _Recorder:
    def __init__(self):
        self.records: List[SpanRecord] = []
        self.open: List[str] = []  # the spans open now, outermost first
        self.calls = 0


_recorder: Optional[_Recorder] = None
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "recorder", "range", "parent", "call", "start")

    def __init__(self, name: str, recorder: Optional[_Recorder], profiled: bool):
        self.name, self.recorder = name, recorder
        self.range = torch.autograd.profiler.record_function(name) if profiled else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        rec = self.recorder
        if rec is not None:
            if not rec.open:
                rec.calls += 1
            self.parent = rec.open[-1] if rec.open else None
            self.call = rec.calls
            rec.open.append(self.name)
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.recorder
        if rec is not None:
            end = time.perf_counter_ns()
            rec.open.pop()
            rec.records.append((self.name, self.parent, self.call, self.start, end))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager over one phase of the program.  Under
    `recording()` it records (name, parent, call id, start ns, end ns) on
    the host's perf_counter_ns when it closes; while torch.profiler
    records, it is also a record_function range, so the phase sits on the
    kernels' timeline.  With both off it is one shared no-op object."""
    profiled = torch.autograd._profiler_enabled()
    if _recorder is None and not profiled:
        return _OFF
    return _Span(name, _recorder, profiled)


@contextlib.contextmanager
def recording() -> Iterator[List[SpanRecord]]:
    """Records every span that closes in its extent into the list it
    yields; the recorder before it comes back at its end.  The spans must
    open on one thread: their parents follow one stack."""
    global _recorder
    saved, _recorder = _recorder, _Recorder()
    try:
        yield _recorder.records
    finally:
        _recorder = saved


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


class StepTimer:
    """Per-step wall times (zs3_tpu.utils.profiling.StepTimer), the first
    `warmup` steps left out.  `sync` runs before each clock read (a CUDA
    synchronize on the GPU), so a step's time covers its device work."""

    def __init__(self, warmup: int = 1, sync: Callable[[], None] = lambda: None):
        self.warmup = warmup
        self.sync = sync
        self.times = []
        self._count = 0

    def __enter__(self):
        self.sync()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        dt = time.perf_counter() - self._start
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")


def per_step(report: Dict, top: int = 10) -> Dict:
    """profile_device's report as per-step figures: device busy ms,
    kernel launches and the `top` kernels' device ms, each over the steps."""
    steps = report["steps"]
    return {
        "device_busy_ms": report["device_busy_ms"] / steps,
        "kernel_launches": report["kernel_launches"] / steps,
        "idle_share": report["idle_share"],
        "kernels": [{"name": k["name"], "device_ms": k["device_ms"] / steps,
                     "calls": k["calls"] / steps} for k in report["kernels"][:top]],
    }


def profile_command(cfg, mode: str, steps: int, trace_dir: Optional[str], device):
    """`cli profile`: time `steps` steps of `mode` on one real batch after
    one warm-up (zs3_tpu's `profile`): "train" the seen train step, "fwd"
    the eval forward, "int8-fwd" that forward with every eligible conv on
    int8 at constant stand-in scales (quant.default_conv_scales).  With
    `trace_dir` the timed steps also run under torch.profiler, whose trace
    goes to trace_dir/trace.json; on the GPU a second window gives
    `device_attribution_per_step` (profile_device).  Returns (the
    reference's result keys, the SeenTrainer)."""
    import contextlib
    import os

    from torch.profiler import ProfilerActivity, profile

    from zs3_tpu_torch import quant
    from zs3_tpu_torch.data.transforms import batched_normalize_device
    from zs3_tpu_torch.train.seen import SeenTrainer, device_batch

    trainer = SeenTrainer(cfg, device=device)
    cuda = trainer.device.type == "cuda"
    batch = device_batch(next(iter(trainer.train_loader)), trainer.device)
    if mode == "train":
        def run_once():
            trainer.train_step(trainer.model, trainer.optimizer, batch)
    else:
        images = batch["image"]
        if images.dtype == torch.uint8:  # device_preprocess batches
            images = batched_normalize_device(images)
        scales = quant.default_conv_scales(trainer.model) if mode == "int8-fwd" else None
        trainer.model.eval()

        def run_once():
            with torch.inference_mode(), (quant.quantized(scales) if scales
                                          else contextlib.nullcontext()):
                trainer.model(images)

    n = max(steps, 2)
    timer = StepTimer(warmup=1, sync=torch.cuda.synchronize if cuda else lambda: None)
    tracer = contextlib.nullcontext()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        tracer = profile(activities=activities)
    with tracer:
        for _ in range(n):
            with timer:
                run_once()
    result = {
        "mode": mode,
        "steps": n - 1,
        "mean_step_ms": round(timer.mean * 1000, 2),
        "p50_step_ms": round(timer.p50 * 1000, 2),
        "images_per_sec": round(cfg.data.batch_size / timer.mean, 2),
        "trace_dir": trace_dir,
    }
    if trace_dir:
        tracer.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        result["device_attribution_per_step"] = (
            per_step(profile_device(run_once, n - 1)) if cuda else None)
    return result, trainer
