"""GPU smoke run of the PyTorch/CUDA port (zs3_tpu_torch) on one card.

    python3 chip_smoke.py

Builds every hand-written kernel of the port from zs3_tpu_torch/csrc,
holds each against its plain PyTorch version on the card (and the
space-to-batch dilated conv against cuDNN's), then drives
`python -m zs3_tpu_torch.cli evaluate` at full width (DeepLabv3+
ResNet-101, os16, 513x513, bf16, synthetic val, 2 unseen classes) and
checks that every kernel of that path was launched and that what comes
out is right; it times and profiles that eval loop, and compares the
port on the card with the port on the CPU at a small size.  Each phase
prints one JSON line; a failed phase exits nonzero.  The line before the
last is the kernel table, the last line is {"ok": true, "device": {...}}.
Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SLEEP_CYCLES = 100_000_000  # ~50 ms of device clock: covers the host queueing
KERNEL_SOURCES = ("upsample_argmax",)
SLICE_ARGS = [
    "evaluate", "--dataset", "synthetic", "--backbone", "resnet101",
    "--out-stride", "16", "--crop-size", "513", "--base-size", "513",
    "--eval-batch-size", "4", "--compute-dtype", "bfloat16",
    "--unseen-split", "2", "--seed", "0", "--device", "cuda",
]


def emit(**fields):
    print(json.dumps(fields), flush=True)


def fail(phase: str, message: str):
    print(json.dumps({"phase": phase, "ok": False, "error": message}), file=sys.stderr)
    sys.exit(1)


def check(cond: bool, phase: str, message: str):
    if not cond:
        fail(phase, message)


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one fn() in ms: CUDA events around `reps` calls,
    median over `rounds`.  The calls queue behind a sleep kernel, so the
    device runs them back to back and the host's launch overhead stays
    out of the time; the run fails if the host took longer to queue them
    than the sleep lasted."""
    fn()  # warm-up: build, caches, allocator
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        sleep_start = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sleep_start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        end.synchronize()
        check(host_ms < sleep_start.elapsed_time(start), "timing",
              f"queueing {reps} calls took {host_ms:.2f} ms, longer than the sleep")
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


def near_ties(logits: torch.Tensor, size) -> torch.Tensor:
    """Pixels whose top-2 upsampled logits (plain version, f32) are within
    1e-5 * max(1, |top|): another product order may flip them."""
    from zs3_tpu_torch.ops.resize import resize_bilinear

    top2 = resize_bilinear(logits.float(), size).topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    return gap < 1e-5 * top2[..., 0].abs().clamp(min=1.0)


def compare_labels(got, want, logits, size, phase, what):
    """Fail unless labels agree outside near-ties; returns (near-ties,
    max |label difference| outside them)."""
    ties = near_ties(logits, size)
    diff = got != want
    bad = int((diff & ~ties).sum())
    check(bad == 0, phase, f"{what}: {bad} labels differ outside near-ties")
    outside = (got.long() - want.long()).abs().masked_fill(ties, 0)
    return int(ties.sum()), int(outside.max())


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(
        phase="env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count(), nvidia_smi=smi,
    )
    return smi


def phase_build():
    from zs3_tpu_torch.ops import cuda_build

    t0 = time.time()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:  # one nvcc per source
        libs = list(pool.map(cuda_build.build, KERNEL_SOURCES))
    seconds = time.time() - t0
    for name, lib in zip(KERNEL_SOURCES, libs):
        log = open(str(lib) + ".log").read()
        ptxas = [ln.strip() for ln in log.splitlines() if "ptxas info" in ln]
        emit(phase="build", kernel=name, library=os.path.relpath(lib), ptxas=ptxas)
    emit(phase="build", seconds=seconds)


def k1_bound(bsz, hi, wi, c, ho, wo):
    """(least time in ms, "bytes" or "operations") for K1 on these shapes."""
    bytes_moved = bsz * (hi * wi * c * 4 + ho * wo * 4)
    # H blend (2 mul + 1 add per source element of each output row), W
    # blend (2 mul + 1 add per class and output pixel), compare.
    flops = bsz * ho * c * (3 * wi + 4 * wo)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels():
    import torch.nn.functional as F

    from zs3_tpu_torch.ops.eval_kernels import upsample_argmax, upsample_argmax_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ((4, 129, 129, 21), (513, 513), True),   # main path, eval batch 4
        ((16, 129, 129, 21), (513, 513), True),  # main path, eval batch 16
        ((3, 17, 17, 59), (65, 65), False),      # Pascal-Context class count
        ((1, 9, 11, 7), (33, 45), False),        # ragged rows and columns
        ((2, 17, 17, 21), (65, 65), False),
        ((1, 33, 129, 128), (65, 513), False),   # 66 KB of shared memory
    ]
    timings = {}
    for shape, size, timed in cases:
        logits = torch.randn(shape, device="cuda", generator=gen)
        got = upsample_argmax(logits, size)
        want = upsample_argmax_reference(logits, size)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == torch.int32, "kernels",
              f"{shape}: got {tuple(got.shape)} {got.dtype}")
        ties, err = compare_labels(got, want, logits, size, "kernels", str(shape))
        row = dict(phase="kernels", kernel="upsample_argmax", shape=list(shape),
                   size=list(size), near_ties=ties, max_abs_err=err)
        if timed:
            nchw = logits.permute(0, 3, 1, 2)
            bound_ms, bound_by = k1_bound(*shape, *size)
            row.update(
                bound_ms=bound_ms,
                bound_by=bound_by,
                kernel_ms=time_ms(lambda: upsample_argmax(logits, size)),
                plain_ms=time_ms(lambda: upsample_argmax_reference(logits, size)),
                library_ms=time_ms(lambda: F.interpolate(
                    nchw, size=size, mode="bilinear", align_corners=True).argmax(1)),
            )
            timings[shape[0]] = row
        emit(**row)
    flat = torch.zeros((1, 8, 8, 4), device="cuda")
    got = upsample_argmax(flat, (16, 16))
    check(bool((got == 0).all()), "kernels", "all-equal logits must give label 0")
    emit(phase="kernels", kernel="upsample_argmax", case="all-equal", ok=True)
    return timings


def phase_dilated():
    """The ASPP's dilated 3x3 convs at the main path's shape, in bf16, as
    cuDNN runs them and as space-to-batch (models/layers.py): the two must
    agree to 2 bf16 ulps of the largest output."""
    import torch.nn.functional as F

    from zs3_tpu_torch.models.layers import (
        SPACE_TO_BATCH_MIN_DILATION,
        conv2d_space_to_batch,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((4, 33, 33, 2048), device="cuda", generator=gen).to(torch.bfloat16)
    x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory, as in the model
    w = torch.randn((256, 2048, 3, 3), device="cuda", generator=gen) * 0.02
    w = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    # 6, 12, 18: the os16 ASPP; 10 and 11: either side of the threshold.
    for d in (6, 10, 11, 12, 18):
        direct = lambda: F.conv2d(x, w, None, 1, d, d)
        s2b = lambda: conv2d_space_to_batch(x, w, None, d)
        want, got = direct().float(), s2b().float()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(got.shape == want.shape and err <= 2**-7 * scale, "dilated",
              f"dilation {d}: space-to-batch differs by {err} (max |y| {scale})")
        emit(phase="dilated", shape=[4, 33, 33, 2048], features=256, dilation=d,
             max_abs_err=err, cudnn_ms=time_ms(direct, reps=3, rounds=3),
             space_to_batch_ms=time_ms(s2b, reps=3, rounds=3),
             port_uses="space_to_batch" if d >= SPACE_TO_BATCH_MIN_DILATION else "cudnn")


def phase_slice():
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data.loader import make_val_loader
    from zs3_tpu_torch.metrics.evaluator import Evaluator
    from zs3_tpu_torch.ops import eval_kernels
    from zs3_tpu_torch.train.seen import build_eval_model, device_batch, make_eval_step
    from zs3_tpu_torch.utils.profiling import profile_device

    cfg = cli.build_config(cli.make_parser().parse_args(SLICE_ARGS))
    loader, num_classes = make_val_loader(cfg.data)

    # The main path, through the entry point a user calls; counts from 0.
    eval_kernels.upsample_argmax.launches = 0
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = cli.main(SLICE_ARGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = eval_kernels.upsample_argmax.launches
    check(rc == 0, "slice", f"cli evaluate returned {rc}")
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])
    check(launches == len(loader), "slice",
          f"K1 launched {launches} times for {len(loader)} eval batches")
    check(all(isinstance(v, float) and v == v and abs(v) != float("inf")
              for v in metrics.values()), "slice", f"non-finite metrics {metrics}")
    check({"seen_miou", "unseen_miou", "harmonic_miou"} <= metrics.keys(), "slice",
          "seen/unseen/harmonic mIoU missing")
    emit(phase="slice", command="python -m zs3_tpu_torch.cli " + " ".join(SLICE_ARGS),
         metrics=metrics, k1_launches=launches, eval_batches=len(loader),
         wall_seconds_with_setup=wall)

    # The same loop again on the same model and batches: its counts must
    # add up and its metrics equal the main path's.
    model = build_eval_model(cfg, "cuda")
    step = make_eval_step(num_classes, cfg.data.ignore_index)
    batches = [device_batch(b, torch.device("cuda")) for b in loader]
    evaluator = Evaluator(num_classes, cfg.data.ignore_index, cfg.data.unseen_classes)
    for batch in batches:
        evaluator.add_confusion(step(model, batch))
    valid = sum(int((b["label"] != cfg.data.ignore_index).sum()) for b in batches)
    check(int(evaluator.confusion.sum()) == valid, "slice",
          f"confusion sums to {evaluator.confusion.sum()}, expected {valid}")
    again = evaluator.compute().as_dict()
    check(all(abs(again[k] - metrics[k]) <= 1e-3 for k in metrics), "slice",
          f"second pass disagrees: {again} vs {metrics}")

    # Eval images/s over device batches (host clock, ends in a synchronize).
    def one_pass():
        for batch in batches:
            step(model, batch)

    passes = 3
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(passes):
        one_pass()
    torch.cuda.synchronize()
    images = passes * sum(int(b["image"].shape[0]) for b in batches)
    images_per_sec = images / (time.time() - t0)
    emit(phase="slice", step="timed passes, batches already on the card", images=images,
         images_per_sec=images_per_sec,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    # Where the device time of that loop goes (torch.profiler, 2 passes).
    # The profiler slows the host, so the idle share of the untraced loop
    # is computed from its images/s and the traced device time per image.
    prof = profile_device(one_pass, steps=2)
    check(prof["device_busy_ms"] > 0, "profile", "the profiler saw no device time")
    k1_ms = sum(e["device_ms"] for e in prof["kernels"] if "upsample_argmax" in e["name"])
    device_ms_per_image = prof["device_busy_ms"] / (2 * images // passes)
    prof["kernels"], prof["ops"] = prof["kernels"][:15], prof["ops"][:15]
    emit(phase="profile", images=2 * images // passes, k1_device_ms=k1_ms,
         device_ms_per_image=device_ms_per_image,
         idle_share_untraced=max(0.0, 1.0 - device_ms_per_image * images_per_sec / 1e3),
         **prof)

    # One batch with TF32 off: K1 against the plain version on the same logits.
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            first = batches[0]["image"]
            logits = model.classify(model.forward_features(first)).float().contiguous()
            size = tuple(first.shape[1:3])
            got = eval_kernels.upsample_argmax(logits, size)
            want = eval_kernels.upsample_argmax_reference(logits, size)
            ties, _ = compare_labels(got, want, logits, size, "slice", "tf32-off batch")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    emit(phase="slice", check="tf32-off batch, K1 vs plain", near_ties=ties,
         pixels=got.numel(), ok=True)
    return launches


def phase_reference():
    """The port on the card against the port on the CPU (plain versions,
    f32, TF32 off): ResNet-50 at 65x65, same weights, same batch."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data.loader import make_val_loader
    from zs3_tpu_torch.train.seen import build_eval_model, device_batch, make_eval_step

    args = ["evaluate", "--dataset", "synthetic", "--backbone", "resnet50",
            "--crop-size", "65", "--eval-batch-size", "8", "--compute-dtype",
            "float32", "--unseen-split", "2"]
    cfg = cli.build_config(cli.make_parser().parse_args(args))
    loader, n = make_val_loader(cfg.data)
    batch = next(iter(loader))
    step = make_eval_step(n, cfg.data.ignore_index)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = step(build_eval_model(cfg, "cuda"), device_batch(batch, torch.device("cuda")))
        cpu = step(build_eval_model(cfg, "cpu"), device_batch(batch, torch.device("cpu")))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    gpu = gpu.cpu()
    valid = int((batch["label"] != cfg.data.ignore_index).sum())
    moved = int((gpu - cpu).abs().sum()) // 2
    check(int(gpu.sum()) == int(cpu.sum()) == valid, "reference", "confusion counts differ")
    check(moved <= 0.001 * valid, "reference", f"{moved} of {valid} pixels differ GPU vs CPU")
    emit(phase="reference", pixels=valid, pixels_moved=moved, ok=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import zs3_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_env()
    phase_build()
    timings = phase_kernels()
    phase_dilated()
    launches = phase_slice()
    phase_reference()
    b4, b16 = timings[4], timings[16]
    print(json.dumps({"kernels": [{
        "name": "upsample_argmax",
        "route": "cuda",
        "source": "zs3_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "zs3_tpu/ops/pallas_eval.py:30",
        "launches": launches,
        "max_abs_err": b4["max_abs_err"],
        "ms": b4["kernel_ms"],
        "plain_ms": b4["plain_ms"],
        "bound_ms": b4["bound_ms"],
        "bound_by": b4["bound_by"],
        "library_ms": b4["library_ms"],
        "shape": b4["shape"],
        "b16": {k: b16[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
