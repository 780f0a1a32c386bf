"""Device-time attribution of a GPU loop with torch.profiler
(the counterpart of zs3_tpu.utils.profiling's trace summary), a step
timer, and `cli profile`."""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
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
