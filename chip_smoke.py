"""GPU smoke run of the PyTorch/CUDA port (zs3_tpu_torch) on one card.

    python3 chip_smoke.py

Builds every hand-written kernel of the port from zs3_tpu_torch/csrc
(one nvcc per source, all at once) and holds each against its plain
PyTorch version on the card: K1 (upsample+argmax), K2 and K3 (the MMD's
kernel sums and their gradient), K4 (the fused classify+upsample tail),
K5 (the fused eval-mode bottleneck), and the space-to-batch dilated conv
against cuDNN's.  Then it drives the port's paths at full width
(DeepLabv3+ ResNet-101, os16, 513x513, bf16, synthetic data, unseen
split 2), each with the launch counts set to 0 just before and read
just after:

  * `evaluate` (eval batch 4): one K1 launch per eval batch;
  * `train-gmmn` (train batch 8, 128 pixels per class, 4 steps, then one
    validation): each step launches K2 three times (fake-fake, real-real,
    fake-real) and K3 twice (fake-fake once, for both of its equal sides,
    and fake-real for x: only the generated features need a gradient),
    and the validation one K1 per eval batch;
  * `serve --fused-tail --serve-batch 8`: an in-process InferenceServer
    answering 64 concurrent POSTs of VOC-sized PNGs, 2 sliding-window
    requests and 1 colorized one; one K4 launch per batched forward and
    per batch of sliding windows;
  * `infer --fused-tail` on 8 PNG files, plain and with --sliding;
  * `evaluate --fused-tail --eval-flip --eval-scales 0.75,1.0` (ms+flip
    TTA): one K4 launch per view and eval batch;
  * `train-seen` (train batch 8, 4 steps, then one validation): one K1
    launch per eval batch, a checkpoint and `best` written;
  * the chained pipeline through the port's checkpoints: `train-gmmn
    --resume <seen checkpoint> --no-val` (1 step), `evaluate-gmmn
    --gmmn-resume <its checkpoint>`, `evaluate --resume <seen checkpoint>`;
  * K5 over the 29 identity blocks of that trained trunk, reloaded from
    its checkpoint, in eval mode at eval batch 4: one launch per block.

It checks that what comes out is right, times and profiles the loops,
and compares the port on the card with the port on the CPU at a small
size (ResNet-50, 65x65, f32).  Checkpoints go to build/chip_smoke_run/,
removed at the end.  Each phase prints one JSON line; a failed
phase exits nonzero.  The line before the last is the kernel table, the
last line is {"ok": true, "device": {...}}.  Needs one CUDA card;
imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import http.client
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
SLEEP_CYCLES = 100_000_000  # ~50 ms of device clock, the shortest sleep
KERNEL_SOURCES = ("upsample_argmax", "mmd_kernel_sum", "classify_resize", "fused_bottleneck")
FULL_WIDTH = [
    "--dataset", "synthetic", "--backbone", "resnet101", "--out-stride", "16",
    "--crop-size", "513", "--base-size", "513", "--compute-dtype", "bfloat16",
    "--seed", "0", "--device", "cuda",
]
SERVE_BATCH = 8
SERVE_ARGS = ["serve", *FULL_WIDTH, "--fused-tail", "--serve-batch", str(SERVE_BATCH),
              "--port", "0"]
TTA_ARGS = ["evaluate", *FULL_WIDTH, "--eval-batch-size", "4", "--unseen-split", "2",
            "--fused-tail", "--eval-flip", "--eval-scales", "0.75,1.0"]
SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
# Checkpoints and metric logs of the training and evaluation commands.
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_run")
CKPT_ARGS = ["--checkpoint-dir", CKPT_DIR, "--checkname", "chip-smoke"]
TTA_ARGS += CKPT_ARGS
SLICE_ARGS = [
    "evaluate", "--dataset", "synthetic", "--backbone", "resnet101",
    "--out-stride", "16", "--crop-size", "513", "--base-size", "513",
    "--eval-batch-size", "4", "--compute-dtype", "bfloat16",
    "--unseen-split", "2", "--seed", "0", "--device", "cuda", *CKPT_ARGS,
]
ZS3_STEPS = 4
ZS3_ARGS = [
    "train-gmmn", "--dataset", "synthetic", "--backbone", "resnet101",
    "--out-stride", "16", "--crop-size", "513", "--base-size", "513",
    "--batch-size", "8", "--eval-batch-size", "4", "--compute-dtype", "bfloat16",
    "--unseen-split", "2", "--epochs", "1", "--steps-per-epoch", str(ZS3_STEPS),
    "--seed", "0", "--device", "cuda", *CKPT_ARGS,
]
SEEN_STEPS = 4
SEEN_WINDOW = 20  # steps per timed window
SEEN_ARGS = [
    "train-seen", *FULL_WIDTH, "--batch-size", "8", "--eval-batch-size", "4",
    "--unseen-split", "2", "--epochs", "1", "--steps-per-epoch", str(SEEN_STEPS), *CKPT_ARGS,
]
MMD_BUDGETS = (128, 512, 2048)


def emit(**fields):
    print(json.dumps(fields), flush=True)


def fail(phase: str, message: str):
    print(json.dumps({"phase": phase, "ok": False, "error": message}), file=sys.stderr)
    sys.exit(1)


def check(cond: bool, phase: str, message: str):
    if not cond:
        fail(phase, message)


def time_ms(fn, reps: int = 20, rounds: int = 5, what: str = "") -> float:
    """Device time of one fn() in ms: CUDA events around `reps` calls,
    median over `rounds`.  The calls queue behind a sleep kernel, so the
    device runs them back to back and the host's launch overhead stays
    out of the time; the sleep lasts at least 50 ms and four times what
    the host took to queue one call, and the run fails if the host took
    longer to queue them than the sleep lasted (a host sync in fn does)."""
    fn()  # warm-up: build, caches, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    one_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = max(SLEEP_CYCLES, int(SLEEP_CYCLES * 4 * reps * one_ms / 50))
    times = []
    for _ in range(rounds):
        sleep_start = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        gc.collect()
        gc.disable()  # a collection while queueing would outlast the sleep
        try:
            sleep_start.record()
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host_ms = 1e3 * (time.perf_counter() - t0)
            end.record()
        finally:
            gc.enable()
        end.synchronize()
        check(host_ms < sleep_start.elapsed_time(start), "timing",
              f"{what}: queueing {reps} calls took {host_ms:.2f} ms, longer than the sleep")
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


def rate_windows(fn, calls: int, windows: int = 5):
    """fn() calls per second on the host clock, over `windows` windows of
    `calls` calls each, every window ending in a synchronize: (the median
    window's rate, every window's rate)."""
    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        rates.append(calls / (time.perf_counter() - t0))
    return sorted(rates)[windows // 2], rates


def host_syncs(fn) -> int:
    """How many times one fn() made the host wait for the device (calls
    that torch's sync debug mode reports)."""
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


def host_ms(fn, calls: int = 21) -> float:
    """The host's own time for one fn() in ms, median over `calls`: each
    call starts after a synchronize, on an idle device, and is timed until
    it returns, so it measures queueing the work while the device runs it
    (fn must not synchronize: see host_syncs)."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return sorted(times)[calls // 2]


def near_ties(logits: torch.Tensor, size, tol=None) -> torch.Tensor:
    """Pixels whose top-2 upsampled logits (plain version, f32) are within
    1e-5 * max(1, |top|), or within `tol` (a per-pixel tensor) when given:
    another product order, or another rounding, may flip them."""
    from zs3_tpu_torch.ops.resize import resize_bilinear

    top2 = resize_bilinear(logits.float(), size).topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    if tol is not None:
        return gap <= tol
    return gap < 1e-5 * top2[..., 0].abs().clamp(min=1.0)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, exp = torch.frexp(x.float().abs())  # |x| = m * 2**exp, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def tap_max(logits: torch.Tensor, size) -> torch.Tensor:
    """(B, HO, WO): the largest |logit| over all classes at the (up to
    four) source pixels an align-corners output pixel blends.  Rounding
    in bf16 happens at the taps' scale, so bf16 tolerances are counted in
    ulps of this value."""
    m = logits.float().abs().amax(-1)
    m = torch.maximum(m, torch.cat([m[:, 1:], m[:, -1:]], 1))
    m = torch.maximum(m, torch.cat([m[:, :, 1:], m[:, :, -1:]], 2))
    (hi, wi), (ho, wo) = m.shape[1:3], size
    rows = (torch.arange(ho, device=m.device) * (hi - 1)) // max(ho - 1, 1)
    cols = (torch.arange(wo, device=m.device) * (wi - 1)) // max(wo - 1, 1)
    return m[:, rows][:, :, cols]


def compare_labels(got, want, logits, size, phase, what, tol=None):
    """Fail unless labels agree outside near-ties; returns (near-ties,
    max |label difference| outside them)."""
    ties = near_ties(logits, size, tol)
    diff = got != want
    bad = int((diff & ~ties).sum())
    check(bad == 0, phase, f"{what}: {bad} labels differ outside near-ties")
    outside = (got.long() - want.long()).abs().masked_fill(ties, 0)
    return int(ties.sum()), int(outside.max())


def reset_counts():
    """Every kernel's launch count to 0."""
    from zs3_tpu_torch.ops import bottleneck_kernels, eval_kernels, tail_kernels
    from zs3_tpu_torch.ops import mmd_kernels as mk

    eval_kernels.upsample_argmax.launches = 0
    mk.kernel_sum.launches = mk.kernel_sum_grad.launches = 0
    tail_kernels.classify_resize.launches = 0
    bottleneck_kernels.fused_bottleneck.launches = 0


def read_counts() -> dict:
    from zs3_tpu_torch.ops import bottleneck_kernels, eval_kernels, tail_kernels
    from zs3_tpu_torch.ops import mmd_kernels as mk

    return {
        "K1": eval_kernels.upsample_argmax.launches,
        "K2": mk.kernel_sum.launches,
        "K3": mk.kernel_sum_grad.launches,
        "K4": tail_kernels.classify_resize.launches,
        "K5": bottleneck_kernels.fused_bottleneck.launches,
    }


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


def k4_bound(bsz, hi, wi, c, k, dtype):
    """(least time in ms, "bytes" or "operations") for K4 on these shapes:
    read the features once, write the logits once (the weights are
    negligible); classify (2 C K per source pixel, at the dtype's peak),
    then the two-tap resize, H blend then W blend (3 f32 ops each)."""
    size = 2 if dtype == torch.bfloat16 else 4
    ho, wo = 4 * (hi - 1) + 1, 4 * (wi - 1) + 1
    bytes_moved = bsz * (hi * wi * c + ho * wo * k) * size + (c * k + k) * 4
    classify = 2 * bsz * hi * wi * c * k
    blends = 3 * bsz * k * (ho * wi + ho * wo)
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = classify / rate + blends / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tail_inputs(gen, bsz, hi, wi, c, k, dtype):
    feats = torch.randn((bsz, hi, wi, c), device="cuda", generator=gen).to(dtype)
    w = torch.randn((c, k), device="cuda", generator=gen) / c**0.5
    b = torch.randn((k,), device="cuda", generator=gen) * 0.1
    return feats, w, b


def check_k4(feats, w, b, what):
    """K4 against its plain version on the same inputs.  f32 (TF32 off):
    rtol/atol 1e-5.  bf16: within 4 bf16 ulps of the largest |logit| at
    the output pixel's source taps (the plain version rounds after the
    classify, the bias and each resize product; K4 once at the store).
    Labels equal outside near-ties (top-2 gap under 1e-5 relative in f32,
    under 8 ulps of the taps' scale in bf16).  Returns the errors."""
    from zs3_tpu_torch.ops.tail_kernels import classify_resize, classify_resize_reference

    size = (4 * (feats.shape[1] - 1) + 1, 4 * (feats.shape[2] - 1) + 1)
    got = classify_resize(feats, w, b, size)
    want = classify_resize_reference(feats, w, b, size)
    torch.cuda.synchronize()
    phase = "tail kernels"
    check(got.shape == want.shape and got.dtype == feats.dtype, phase,
          f"{what}: got {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), phase, f"{what}: non-finite logits")
    err = (got.float() - want.float()).abs()
    src = feats.float() @ w.to(feats.dtype).float() + b.to(feats.dtype).float()
    out = {"max_abs_err": float(err.max())}
    if feats.dtype == torch.float32:
        ok = bool((err <= 1e-5 + 1e-5 * want.abs()).all())
        check(ok, phase, f"{what}: f32 K4 off by {out['max_abs_err']}")
        tol = None
    else:
        ulp = bf16_ulp(tap_max(src, size))[..., None]
        out["max_err_in_tap_ulps"] = float((err / ulp).max())
        check(out["max_err_in_tap_ulps"] <= 4, phase,
              f"{what}: bf16 K4 off by {out['max_err_in_tap_ulps']} ulps")
        tol = 8 * ulp[..., 0]
    out["near_ties"], _ = compare_labels(
        got.float().argmax(-1), want.float().argmax(-1), src, size, phase, what, tol)
    return out


def phase_tail():
    """K4 on the card against its plain version at the serve path's shapes
    (bf16, and f32 with TF32 off), the edge shapes of
    tests/test_pallas_tail.py, a C that is not a multiple of 4; its
    refusals; and its times beside the bound, the plain version and
    F.interpolate(F.conv2d(...))."""
    import torch.nn.functional as F

    from zs3_tpu_torch.ops.tail_kernels import classify_resize, classify_resize_reference

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ((1, 129, 129, 256, 21), bf16, True),   # one request
        ((8, 129, 129, 256, 21), bf16, True),   # serve batch 8, the main path
        ((1, 129, 129, 256, 21), f32, False),
        ((8, 129, 129, 256, 21), f32, True),
        ((4, 97, 97, 256, 21), bf16, False),    # TTA scale 0.75 (385x385 input)
        ((4, 161, 161, 256, 21), bf16, False),  # TTA scale 1.25 (641x641 input)
        ((2, 17, 17, 16, 5), f32, False),       # crop-65 geometry, odd class count
        ((1, 9, 9, 8, 21), f32, False),         # one band, clamped last row
        ((3, 17, 17, 32, 128), f32, False),     # K = 128
        ((2, 17, 23, 30, 21), f32, False),      # C = 30, W != H, ragged column tile
        ((2, 17, 17, 16, 7), bf16, False),      # tests/test_pallas_tail.py's bf16 case
    ]
    timings = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for shape, dtype, timed in cases:
            feats, w, b = tail_inputs(gen, *shape, dtype)
            row = dict(phase="tail kernels", kernel="classify_resize", shape=list(shape),
                       dtype=str(dtype).split(".")[-1],
                       **check_k4(feats, w, b, f"{shape} {dtype}"))
            if timed:
                bsz, hi, wi, c, k = shape
                size = (4 * (hi - 1) + 1, 4 * (wi - 1) + 1)
                x_nchw = feats.permute(0, 3, 1, 2)  # channels_last view
                w4, b4 = w.t().to(dtype)[:, :, None, None].contiguous(), b.to(dtype)
                row.update(zip(("bound_ms", "bound_by"), k4_bound(*shape, dtype)))
                row.update(
                    kernel_ms=time_ms(lambda: classify_resize(feats, w, b, size),
                                      what=f"K4 {shape}"),
                    plain_ms=time_ms(lambda: classify_resize_reference(feats, w, b, size),
                                     what=f"K4 plain {shape}"),
                    library_ms=time_ms(lambda: F.interpolate(
                        F.conv2d(x_nchw, w4, b4), size=size, mode="bilinear",
                        align_corners=True), what=f"K4 library {shape}"),
                )
                timings[(shape[0], row["dtype"])] = row
            emit(**row)
    finally:
        torch.backends.cudnn.allow_tf32 = True

    before = classify_resize.launches
    feats, w, b = tail_inputs(gen, 1, 17, 17, 16, 5, f32)
    refusals = {
        "cpu tensor": (ValueError, lambda: classify_resize(feats.cpu(), w.cpu(), b.cpu(),
                                                           (65, 65))),
        "requires_grad": (RuntimeError, lambda: classify_resize(
            feats.clone().requires_grad_(True), w, b, (65, 65))),
        "unsupported geometry": (ValueError, lambda: classify_resize(
            feats[:, :16, :16].contiguous(), w, b, (61, 61))),
    }
    for what, (error, fn) in refusals.items():
        try:
            fn()
        except error:
            continue
        fail("tail kernels", f"K4 did not refuse a {what}")
    check(classify_resize.launches == before, "tail kernels", "a refused call counted")
    emit(phase="tail kernels", refused=sorted(refusals), ok=True)
    return timings


K5_STAGES = (  # (layer, main-path input shape, planes): R101 os16 at 513x513, batch 4
    ("layer1", (4, 129, 129, 256), 64),
    ("layer2", (4, 65, 65, 512), 128),
    ("layer3", (4, 33, 33, 1024), 256),
    ("layer4", (4, 33, 33, 2048), 512),
)


def k5_bound(bsz, h, w, c, p, dtype):
    """(least time in ms, "bytes" or "operations") for one K5 block: read
    x, write out, read the weights once (biases in f32); 2 B H W (2 C P +
    9 P^2) FLOPs at the dtype's peak."""
    size = 2 if dtype == torch.bfloat16 else 4
    bytes_moved = 2 * bsz * h * w * c * size + (2 * c * p + 9 * p * p) * size + (2 * p + c) * 4
    flops = 2 * bsz * h * w * (2 * c * p + 9 * p * p)
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def unfused_block(x_nchw, w1, b1, w2, b2, w3, b3, d):
    """The block as three cuDNN convolutions with the folded weights (the
    library yardstick), NCHW channels_last in and out."""
    import torch.nn.functional as F

    dt = x_nchw.dtype
    conv = lambda t, w, b, **kw: F.conv2d(t, w.to(dt), b.to(dt), **kw)
    y = torch.relu(conv(x_nchw, w1.t()[:, :, None, None], b1))
    y = torch.relu(conv(y, w2.permute(3, 2, 0, 1), b2, padding=d, dilation=d))
    return torch.relu(conv(y, w3.t()[:, :, None, None], b3) + x_nchw)


def phase_bottleneck(model=None, images=None):
    """K5 on a trunk's identity blocks (layerN[1:] of R101: 29 blocks) in
    eval mode, on the activations that enter them at eval batch 4 and
    513x513.  Each block against the plain version on the same input (bf16:
    within 4 bf16 ulps of the pixel's largest |output|; f32 with TF32 off:
    within 1e-5 of the largest |output|) and against the trunk's own block
    (cuDNN convs, BN, ReLU; bf16 within 2^-4 of the pixel's largest
    |output|, f32 within 1e-4 of the block's), then the 29-launch pass of
    the fused stages with the counts from 0, and times per stage shape."""
    import copy

    from zs3_tpu_torch.ops import bottleneck as plain
    from zs3_tpu_torch.ops import bottleneck_kernels as k5

    phase = "bottleneck kernels"
    if model is None:  # a seeded trunk when run alone
        from zs3_tpu_torch import cli
        from zs3_tpu_torch.train.seen import build_eval_model

        model = build_eval_model(cli.build_config(cli.make_parser().parse_args(SLICE_ARGS)),
                                 "cuda")
    if images is None:
        gen = torch.Generator(device="cuda").manual_seed(5)
        images = torch.randn((4, 513, 513, 3), device="cuda", generator=gen)
    model.eval()
    backbone = model.backbone
    inputs, outputs = {}, {}

    def keep(key):
        def hook(module, args, out):
            inputs[key], outputs[key] = args[0], out

        return hook

    hooks = []
    for layer, _, _ in K5_STAGES:
        for i, block in enumerate(getattr(backbone, layer)):
            if i:
                hooks.append(block.register_forward_hook(keep((layer, i))))
    try:
        with torch.inference_mode():
            backbone(images.to(model.compute_dtype))
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    check(len(inputs) == 29, phase, f"{len(inputs)} identity blocks, expected 29")

    rows, timings = [], {}
    worst = {"bf16_plain_ulps": 0.0, "f32_plain": 0.0, "bf16_trunk": 0.0, "f32_trunk": 0.0}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            for layer, shape, planes in K5_STAGES:
                blocks = list(getattr(backbone, layer))[1:]
                for i, block in enumerate(blocks, start=1):
                    params = plain.fold_bottleneck(block)
                    d = block.conv2.dilation[0]
                    x_nchw = inputs[(layer, i)]
                    x = x_nchw.permute(0, 2, 3, 1)  # NHWC view of channels_last memory
                    check(tuple(x.shape) == shape and x.is_contiguous(), phase,
                          f"{layer}[{i}] input {tuple(x.shape)}")
                    got = k5.fused_bottleneck(x, *params, dilation=d).float()
                    want = plain.fused_bottleneck(x, *params, dilation=d).float()
                    trunk = outputs[(layer, i)].permute(0, 2, 3, 1).float()
                    ulp = bf16_ulp(want.abs().amax(-1, keepdim=True))
                    ulps = float(((got - want).abs() / ulp).max())
                    bf16_abs = float((got - want).abs().max())
                    trunk_rel = float(((got - trunk).abs()
                                       / want.abs().amax(-1, keepdim=True).clamp(min=1e-6)).max())
                    check(ulps <= 4, phase, f"{layer}[{i}] bf16: K5 {ulps} ulps off the plain")
                    check(trunk_rel <= 2**-4, phase,
                          f"{layer}[{i}] bf16: K5 off the trunk's block by {trunk_rel} of |out|")
                    # f32 (TF32 off): the same block on the same input in f32.
                    xf = x.float().contiguous()
                    got32 = k5.fused_bottleneck(xf, *params, dilation=d)
                    want32 = plain.fused_bottleneck(xf, *params, dilation=d)
                    block32 = copy.deepcopy(block).float()
                    for conv in (block32.conv1, block32.conv2, block32.conv3):
                        conv.compute_dtype = torch.float32
                    trunk32 = block32(xf.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                    scale = float(want32.abs().max())
                    err32 = float((got32 - want32).abs().max())
                    trunk32_err = float((got32 - trunk32).abs().max())
                    check(err32 <= 1e-5 * scale, phase,
                          f"{layer}[{i}] f32: K5 off the plain by {err32} (max |out| {scale})")
                    check(trunk32_err <= 1e-4 * scale, phase,
                          f"{layer}[{i}] f32: K5 off the trunk's block by {trunk32_err}")
                    for key, v in (("bf16_plain_ulps", ulps), ("f32_plain", err32 / scale),
                                   ("bf16_trunk", trunk_rel), ("f32_trunk", trunk32_err / scale)):
                        worst[key] = max(worst[key], v)
                    rows.append({"block": f"{layer}.{i}", "dilation": d, "bf16_plain_ulps": ulps,
                                 "bf16_plain_abs": bf16_abs,
                                 "bf16_trunk_rel": trunk_rel, "f32_plain_abs": err32,
                                 "f32_trunk_abs": trunk32_err, "f32_max_abs_out": scale})
    finally:
        torch.backends.cudnn.allow_tf32 = True
    emit(phase=phase, check="per block, bf16 and f32", worst=worst,
         bounds={"bf16_plain_ulps": 4, "f32_plain": 1e-5, "bf16_trunk": 2**-4,
                 "f32_trunk": 1e-4}, blocks=rows)

    # The main path: the fused stages over the trunk's identity blocks,
    # counts from 0: one launch per block.
    reset_counts()
    with torch.inference_mode():
        chained = {}
        for layer, _, _ in K5_STAGES:
            blocks = list(getattr(backbone, layer))[1:]
            x = inputs[(layer, 1)].permute(0, 2, 3, 1)
            out = k5.fused_stage(x, [plain.fold_bottleneck(b) for b in blocks],
                                 [b.conv2.dilation[0] for b in blocks])
            trunk = outputs[(layer, len(blocks))].permute(0, 2, 3, 1).float()
            chained[layer] = float((out.float() - trunk).abs().max() / trunk.abs().max())
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["K5"] == 29 and launches["K1"] == launches["K4"] == 0, phase,
          f"launches {launches} for 29 identity blocks")
    emit(phase=phase, check="fused stages over the trunk", launches=launches,
         stage_err_over_max_out=chained)

    # Times per stage shape: one identity block (the stage's first).
    with torch.inference_mode():
        for layer, shape, planes in K5_STAGES:
            block = getattr(backbone, layer)[1]
            params = plain.fold_bottleneck(block)
            d = block.conv2.dilation[0]
            x_nchw = inputs[(layer, 1)]
            x = x_nchw.permute(0, 2, 3, 1)
            row = {"shape": list(shape), "planes": planes, "dilation": d, "dtype": "bfloat16",
                   "tile": k5.plan(shape, planes, d, x.dtype)}
            row.update(zip(("bound_ms", "bound_by"), k5_bound(*shape, planes, x.dtype)))
            row.update(
                kernel_ms=time_ms(lambda: k5.fused_bottleneck(x, *params, dilation=d),
                                  what=f"K5 {layer}"),
                plain_ms=time_ms(lambda: plain.fused_bottleneck(x, *params, dilation=d),
                                 reps=5, what=f"K5 plain {layer}"),
                library_ms=time_ms(lambda: unfused_block(x_nchw, *params, d),
                                   what=f"K5 library {layer}"),
            )
            timings[layer] = row
            emit(phase=phase, stage=layer, **row)
    errors = {"max_abs_err": max(r["bf16_plain_abs"] for r in rows),
              "f32_max_abs_err": max(r["f32_plain_abs"] for r in rows), **worst}
    return launches, errors, timings


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
    from zs3_tpu_torch.ops import mmd_kernels as mk
    from zs3_tpu_torch.ops import tail_kernels
    from zs3_tpu_torch.train.seen import build_eval_model, device_batch, make_eval_step
    from zs3_tpu_torch.utils.profiling import profile_device

    cfg = cli.build_config(cli.make_parser().parse_args(SLICE_ARGS))
    loader, num_classes = make_val_loader(cfg.data)

    # The main path, through the entry point a user calls; counts from 0.
    reset_counts()
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
    check(mk.kernel_sum.launches == mk.kernel_sum_grad.launches == 0, "slice",
          "evaluate launched an MMD kernel")
    check(tail_kernels.classify_resize.launches == 0, "slice",
          "evaluate without --fused-tail launched K4")
    check(all(is_finite(v) for v in metrics.values()), "slice", f"non-finite metrics {metrics}")
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

    # Eval images/s over device batches: 5 windows of 100 batches (host
    # clock, each ending in a synchronize).  The step waits for the device
    # (its confusion counts sync), so no host-only time is taken here.
    def one_pass():
        for batch in batches:
            step(model, batch)

    per_pass = sum(int(b["image"].shape[0]) for b in batches)
    passes_per_sec, window_rates = rate_windows(one_pass, calls=100 // len(batches))
    images_per_sec = per_pass * passes_per_sec
    emit(phase="slice", step="timed windows, batches already on the card",
         images_per_window=per_pass * (100 // len(batches)),
         images_per_sec=images_per_sec,
         images_per_sec_windows=[per_pass * r for r in window_rates],
         host_syncs_per_batch=host_syncs(lambda: step(model, batches[0])),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    # Where the device time of that loop goes (torch.profiler, 2 passes).
    # The profiler slows the host, so the idle share of the untraced loop
    # is computed from its images/s and the traced device time per image.
    prof = profile_device(one_pass, steps=2)
    check(prof["device_busy_ms"] > 0, "profile", "the profiler saw no device time")
    k1_ms = sum(e["device_ms"] for e in prof["kernels"] if "upsample_argmax" in e["name"])
    device_ms_per_image = prof["device_busy_ms"] / (2 * per_pass)
    prof["kernels"], prof["ops"] = prof["kernels"][:15], prof["ops"][:15]
    emit(phase="profile", images=2 * per_pass, k1_device_ms=k1_ms,
         device_ms_per_image=device_ms_per_image,
         idle_share_untraced=1.0 - device_ms_per_image * images_per_sec / 1e3,
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


def voc_like_images(seed: int, count: int, sizes=((375, 500), (500, 375))):
    """`count` smooth synthetic RGB images of VOC's sizes (500x375 and
    375x500 in turn): a coarse random field upsampled, plus noise."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    images = []
    for i in range(count):
        h, w = sizes[i % len(sizes)]
        coarse = rng.integers(0, 256, (h // 25, w // 25, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
        img = img + rng.integers(-8, 9, img.shape)
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def png_bytes(image) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def post(port: int, body: bytes, query: str = ""):
    """POST /predict; returns (status, decoded PNG or error text, seconds)."""
    import numpy as np
    from PIL import Image

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/predict" + query, body=body)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    seconds = time.perf_counter() - t0
    if resp.status != 200:
        return resp.status, data.decode(errors="replace"), seconds
    return resp.status, np.asarray(Image.open(io.BytesIO(data))), seconds


def percentile(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(round(q / 100 * (len(values) - 1))))]


def fused_vs_standard(predictor, canvases, phase):
    """Labels of `predictor` on letterboxed uint8 canvases with the fused
    tail (K4) and with the standard tail: equal outside near-ties (top-2
    gap within 8 bf16 ulps of the taps' scale).  Returns the counts."""
    from zs3_tpu_torch.data.transforms import batched_normalize_device

    model = predictor.model
    with torch.inference_mode():
        fused = predictor._logits(canvases)
        model.fused_tail = False
        try:
            standard = predictor._logits(canvases)
        finally:
            model.fused_tail = True
        x = torch.from_numpy(canvases).cuda()
        src = model.classify(model.forward_features(batched_normalize_device(x))).float()
    size = tuple(fused.shape[1:3])
    tol = 8 * bf16_ulp(tap_max(src, size))
    ties, _ = compare_labels(fused.argmax(-1), standard.argmax(-1), src, size, phase,
                             "fused vs standard tail", tol)
    return {"pixels": fused.shape[0] * size[0] * size[1], "near_ties": ties,
            "labels_differ": int((fused.argmax(-1) != standard.argmax(-1)).sum()),
            "max_abs_logit_diff": float((fused - standard).abs().max())}


def phase_serve():
    """`serve --fused-tail --serve-batch 8` at full width: an in-process
    InferenceServer on port 0 answers 64 POSTs from 16 client threads,
    then 2 sliding-window requests of a 750x1000 image and 1 colorized
    request; K4 launches once per batched forward (the warmup's too) and
    once per batch of sliding windows.  Then the Predictor's throughput
    with and without the fused tail, and its device time."""
    import numpy as np

    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data.transforms import letterbox_image
    from zs3_tpu_torch.serve import InferenceServer
    from zs3_tpu_torch.train.predict import sliding_windows
    from zs3_tpu_torch.utils.profiling import profile_device

    phase = "serve slice"
    args = cli.make_parser().parse_args(SERVE_ARGS)
    cfg = cli.build_config(args)
    images = voc_like_images(4, 64)
    bodies = [png_bytes(img) for img in images]
    big = voc_like_images(5, 1, sizes=((750, 1000),))[0]
    big_body = png_bytes(big)
    n_classes = cfg.model.num_classes

    # The main path, through the entry point a user calls; counts from 0.
    reset_counts()
    t_setup = time.time()
    server = InferenceServer(cfg, port=args.port, serve_batch=args.serve_batch,
                             device=args.device).start(warmup=True)
    try:
        setup_s = time.time() - t_setup
        batcher = server.service.batcher
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            results = list(pool.map(lambda body: (*post(server.port, body),
                                                  time.perf_counter()), bodies))
        wall = time.perf_counter() - t0
        sliding = [post(server.port, big_body, "?sliding=1") for _ in range(2)]
        colored = post(server.port, bodies[1], "?color=1")
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        server.stop()
    for (status, pred, _, _), img in zip(results, images):
        check(status == 200, phase, f"status {status}: {pred}")
        check(pred.shape == img.shape[:2] and int(pred.max()) < n_classes, phase,
              f"answer {pred.shape} max {pred.max()} for an image {img.shape}")
    for status, pred, _ in sliding:
        check(status == 200 and pred.shape == big.shape[:2] and int(pred.max()) < n_classes,
              phase, f"sliding answer {status} {getattr(pred, 'shape', pred)}")
    check(colored[0] == 200 and colored[1].shape == (*images[1].shape[:2], 3), phase,
          f"color answer {colored[0]} {getattr(colored[1], 'shape', colored[1])}")
    sizes = list(batcher.batch_sizes)
    check(sum(sizes) == 64 + 1 + 1 and max(sizes) > 1, phase,
          f"batch sizes {sizes}: 64 requests, the colorized one and the warmup")
    windows = len(sliding_windows(big.shape[:2], cfg.data.crop_size))
    window_batches = 2 * -(-windows // 8)
    check(launches["K4"] == batcher.groups + window_batches, phase,
          f"K4 launched {launches['K4']} times for {batcher.groups} batched forwards "
          f"and {window_batches} batches of sliding windows")
    check(launches["K1"] == launches["K2"] == launches["K3"] == launches["K5"] == 0, phase,
          f"serving launched {launches}")

    # Requests/s over 4 windows of 16 consecutive completions.
    ends = sorted(r[3] for r in results)
    marks = [t0] + ends[15::16]
    window_rates = [16 / (b - a) for a, b in zip(marks, marks[1:])]
    latencies = [r[2] for r in results]
    predictor = server.service.predictor
    canvases = np.stack([letterbox_image(img, cfg.data.crop_size)[0] for img in images[:8]])
    agree = fused_vs_standard(predictor, canvases, phase)
    emit(phase=phase, command="python -m zs3_tpu_torch.cli " + " ".join(SERVE_ARGS),
         requests=64, client_threads=16, setup_seconds_with_warmup=setup_s,
         requests_per_sec=64 / wall, requests_per_sec_windows=window_rates,
         latency_p50_ms=1e3 * percentile(latencies, 50),
         latency_p99_ms=1e3 * percentile(latencies, 99),
         sliding_ms=[1e3 * r[2] for r in sliding], batch_groups=batcher.groups,
         batch_sizes=sizes, sliding_windows_per_image=windows, launches=launches,
         fused_vs_standard=agree)

    # Predictor.predict_batch images/s on 8 letterboxed images, standard
    # tail and fused tail in turns (off, on, on, off), 5 windows of 5 calls.
    model = predictor.model
    frames = list(canvases)
    rates = {}
    for turn, fused in enumerate((False, True, True, False)):
        model.fused_tail = fused
        median, spread = rate_windows(lambda: predictor.predict_batch(frames), calls=5)
        rates[f"{turn}_{'fused' if fused else 'standard'}"] = {
            "images_per_sec": 8 * median, "windows": [8 * r for r in spread]}
    model.fused_tail = True
    prof = profile_device(lambda: predictor.predict_batch(frames), steps=3)
    check(prof["device_busy_ms"] > 0, phase, "the profiler saw no device time")
    k4_ms = sum(e["device_ms"] for e in prof["kernels"] if "classify_resize" in e["name"])
    fused_rate = rates["1_fused"]["images_per_sec"]
    device_ms_per_batch = prof["device_busy_ms"] / 3
    prof["kernels"], prof["ops"] = prof["kernels"][:12], prof["ops"][:12]
    emit(phase="serve profile", step="Predictor.predict_batch, 8 letterboxed 513x513 images",
         predict_batch=rates, device_ms_per_batch=device_ms_per_batch,
         k4_device_ms_per_batch=k4_ms / 3, k4_share=k4_ms / prof["device_busy_ms"],
         idle_share_untraced=1.0 - device_ms_per_batch * fused_rate / 8 / 1e3, **prof)
    return launches


def phase_infer():
    """`cli infer --fused-tail` on 8 PNG files at full width, plain and
    with --sliding: every file written (labels and colorized), K4 launched
    once per batch of 8 images (plain) and once per image (sliding: a
    500x375 image pads to one 513x513 window)."""
    from zs3_tpu_torch import cli

    phase = "infer"
    src = os.path.join(SCRATCH, "infer_in")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(src)
    paths = []
    for i, img in enumerate(voc_like_images(6, 8)):
        paths.append(os.path.join(src, f"image_{i}.png"))
        with open(paths[-1], "wb") as f:
            f.write(png_bytes(img))
    out = {}
    for mode, extra, want_k4 in (("plain", [], 1), ("sliding", ["--sliding"], 8)):
        target = os.path.join(SCRATCH, f"infer_{mode}")
        argv = ["infer", *paths, "--output", target, *FULL_WIDTH, "--fused-tail", *extra]
        reset_counts()
        t0 = time.time()
        result, predictor = cli.run(argv)
        torch.cuda.synchronize()
        launches = read_counts()
        check(result["written"] == 16 and len(os.listdir(target)) == 16, phase,
              f"{mode}: wrote {result['written']} files, {len(os.listdir(target))} on disk")
        check(launches == {"K1": 0, "K2": 0, "K3": 0, "K4": want_k4, "K5": 0}, phase,
              f"{mode}: launches {launches}, want K4 {want_k4}")
        out[mode] = {"written": result["written"], "launches": launches,
                     "wall_seconds_with_setup": time.time() - t0}
        del predictor
    emit(phase=phase, command="python -m zs3_tpu_torch.cli infer <8 PNGs> --output DIR "
         + " ".join(FULL_WIDTH) + " --fused-tail [--sliding]", **out)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    return out


def phase_tta():
    """`cli evaluate --fused-tail --eval-flip --eval-scales 0.75,1.0` at
    full width on the synthetic val set: K4 launches once per view (2
    scales x 2 mirrors) and eval batch; then the TTA step again on the
    same model and batches, whose confusion sums to the valid pixels and
    whose metrics are the CLI's."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data.loader import make_val_loader
    from zs3_tpu_torch.metrics.evaluator import Evaluator
    from zs3_tpu_torch.metrics.tta import make_tta_eval_step
    from zs3_tpu_torch.train.seen import build_eval_model, device_batch

    phase = "tta"
    cfg = cli.build_config(cli.make_parser().parse_args(TTA_ARGS))
    loader, num_classes = make_val_loader(cfg.data)
    views = len(cfg.train.eval_scales) * 2
    reset_counts()
    t0 = time.time()
    metrics, _ = cli.run(TTA_ARGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    check(launches == {"K1": 0, "K2": 0, "K3": 0, "K4": views * len(loader), "K5": 0}, phase,
          f"launches {launches} for {views} views x {len(loader)} eval batches")
    check(all(is_finite(v) for v in metrics.values()), phase, f"non-finite metrics {metrics}")
    model = build_eval_model(cfg, "cuda")
    step = make_tta_eval_step(num_classes, cfg.data.ignore_index, cfg.train.eval_scales,
                              cfg.train.eval_flip)
    evaluator = Evaluator(num_classes, cfg.data.ignore_index, cfg.data.unseen_classes)
    valid = 0
    t1 = time.perf_counter()
    for batch in loader:
        batch = device_batch(batch, torch.device("cuda"))
        evaluator.add_confusion(step(model, batch))
        valid += int((batch["label"] != cfg.data.ignore_index).sum())
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1
    check(int(evaluator.confusion.sum()) == valid, phase,
          f"confusion sums to {evaluator.confusion.sum()}, expected {valid}")
    again = evaluator.compute().as_dict()
    check(all(abs(again[k] - metrics[k]) <= 1e-3 for k in metrics), phase,
          f"TTA again disagrees: {again} vs {metrics}")
    emit(phase=phase, command="python -m zs3_tpu_torch.cli " + " ".join(TTA_ARGS),
         metrics=metrics, launches=launches, views=views, eval_batches=len(loader),
         pixels=valid, wall_seconds_with_setup=wall,
         images_per_sec_tta_loop_with_host_batches=len(loader.dataset) / loop_s)
    return launches


def phase_serve_reference():
    """The Predictor on the card against the Predictor on the CPU (fused
    tail, f32, TF32 off): ResNet-50 at 65x65, the same seeded weights, 4
    letterboxed images and one sliding-window image.  Logits within 1e-4
    of the largest, labels equal outside near-ties."""
    import numpy as np

    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data.transforms import batched_normalize_device, letterbox_image
    from zs3_tpu_torch.ops import tail_kernels
    from zs3_tpu_torch.train.predict import Predictor

    phase = "serve reference"
    args = ["serve", "--dataset", "synthetic", "--backbone", "resnet50", "--crop-size", "65",
            "--base-size", "65", "--compute-dtype", "float32", "--fused-tail"]
    cfg = cli.build_config(cli.make_parser().parse_args(args))
    images = voc_like_images(7, 4)
    canvases = np.stack([letterbox_image(img, 65)[0] for img in images])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu, cpu = Predictor(cfg, device="cuda"), Predictor(cfg, device="cpu")
        before = tail_kernels.classify_resize.launches
        got = gpu._logits(canvases).cpu()
        check(tail_kernels.classify_resize.launches == before + 1, phase,
              "the card's Predictor did not run K4")
        want = cpu._logits(canvases)
        sliding_gpu = gpu.predict_sliding(images[0][:100, :150])
        sliding_cpu = cpu.predict_sliding(images[0][:100, :150])
        with torch.inference_mode():
            m = cpu.model
            src = m.classify(m.forward_features(batched_normalize_device(
                torch.from_numpy(canvases)))).float()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= 1e-4 * scale, phase, f"logits off by {err} (max |logit| {scale})")
    ties, _ = compare_labels(got.argmax(-1), want.argmax(-1), src, (65, 65), phase,
                             "card vs CPU labels")
    moved = int((sliding_gpu != sliding_cpu).sum())
    check(moved <= 0.001 * sliding_cpu.size, phase,
          f"sliding labels: {moved} of {sliding_cpu.size} differ card vs CPU")
    emit(phase=phase, max_abs_logit_err=err, max_abs_logit=scale, near_ties=ties,
         sliding_pixels_differ=moved, ok=True)


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


def mmd_bounds(c, n, m, d, s):
    """{"K2": (ms, by), "K3": (ms, by)}: the least time of one call of each
    at these shapes.  K2 reads x, y and both weights and writes C sums; it
    does the dot (2D), d2 (3), per sigma a scale, an exp and a sum (3S),
    and the weights (6 in all with d2's clamp) for each of the N*M pairs.
    K3 (dx only, as the step calls it) reads the same and writes dx; per
    pair the dot (2D), d2 (3), per sigma scale, exp, two sums and a scale
    (5S), the weighted C and K (3), and C.y plus the row sums (2D + 2)."""
    pairs = c * n * m
    k2 = (4 * c * (n * d + m * d + n + m + 1), pairs * (2 * d + 3 * s + 6))
    k3 = (4 * c * (n * d + m * d + n + m + n * d), pairs * (4 * d + 5 * s + 8))
    out = {}
    for name, (bytes_moved, ops) in (("K2", k2), ("K3", k3)):
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        out[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def mmd_inputs(gen, c, n, m, d, empty=()):
    """Post-ReLU-like features and 0/1 masks with ~30% empty slots; the
    classes in `empty` have no real pixels."""
    x = torch.relu(torch.randn((c, n, d), device="cuda", generator=gen))
    y = torch.relu(torch.randn((c, m, d), device="cuda", generator=gen) + 0.2)
    wx = (torch.rand((c, n), device="cuda", generator=gen) > 0.3).float()
    wy = (torch.rand((c, m), device="cuda", generator=gen) > 0.3).float()
    wy[list(empty)] = 0.0
    return x, y, wx, wy


def grad_term_magnitude(x, y, wx, wy, sigmas):
    """sum_j |C_ij||y_j| + |rowsum(C)_i||x_i|: the size of the terms whose
    sum is dx, against which its rounding is measured."""
    from zs3_tpu_torch.ops.mmd import pairwise_sq_dists

    d2 = pairwise_sq_dists(x, y)
    c = sum(torch.exp(d2 * (-1.0 / (2.0 * s))) / s for s in sigmas)
    cw = wx[..., :, None] * c * wy[..., None, :]
    return cw.abs() @ y.abs() + cw.sum(-1, keepdim=True).abs() * x.abs()


def check_k2_k3(x, y, wx, wy, what):
    """K2 and K3 against their plain versions on the same inputs, and each
    against a second call (same bits).  Sums to rtol 1e-4; dwx to rtol
    1e-3 / atol 1e-6; dx to rtol 1e-3 / atol 1e-6 plus 1e-5 of the
    magnitude of the terms it sums (dx = C.y - rowsum(C) x cancels, and
    sums taken in another order round differently).  Returns the max
    absolute errors."""
    from zs3_tpu_torch.ops import mmd_kernels as mk
    from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS as sig

    got = mk.kernel_sum(x, y, wx, wy, sig)
    want = mk.kernel_sum_reference(x, y, wx, wy, sig)
    dx, dwx = mk.kernel_sum_grad(x, y, wx, wy, sig)
    want_dx, want_dwx = mk.kernel_sum_grad_reference(x, y, wx, wy, sig)
    dx_only, none = mk.kernel_sum_grad(x, y, wx, wy, sig, with_dwx=False)
    torch.cuda.synchronize()
    phase = "mmd kernels"
    check(bool(((got - want).abs() <= 1e-4 * want.abs()).all()), phase,
          f"{what}: K2 {got.tolist()[:4]} vs plain {want.tolist()[:4]}")
    mag = grad_term_magnitude(x, y, wx, wy, sig)
    err_dx = (dx - want_dx).abs()
    plain_tol = 1e-6 + 1e-3 * want_dx.abs()
    check(bool((err_dx <= plain_tol + 1e-5 * mag).all()), phase,
          f"{what}: K3 dx off by {float(err_dx.max())}")
    check(torch.allclose(dwx, want_dwx, rtol=1e-3, atol=1e-6), phase,
          f"{what}: K3 dwx off by {float((dwx - want_dwx).abs().max())}")
    check(none is None and torch.equal(dx_only, dx), phase, f"{what}: dx without dwx differs")
    again = mk.kernel_sum(x, y, wx, wy, sig)
    dx2, dwx2 = mk.kernel_sum_grad(x, y, wx, wy, sig)
    check(torch.equal(again, got) and torch.equal(dx2, dx) and torch.equal(dwx2, dwx),
          phase, f"{what}: a second call gave other bits")
    return {
        "k2_max_abs_err": float((got - want).abs().max()),
        "k2_max_rel_err": float(((got - want).abs() / want.abs().clamp(min=1e-30)).max()),
        "k3_dx_max_abs_err": float(err_dx.max()),
        "k3_dx_outside_plain_tol": int((err_dx > plain_tol).sum()),
        "k3_dwx_max_abs_err": float((dwx - want_dwx).abs().max()),
    }


def phase_mmd():
    """K2 and K3 on the card against their plain versions (f32, TF32
    off), the batched loss and its gradient on KernelSum against the plain
    oracle with autograd, and times at budgets 128, 512 and 2048."""
    from zs3_tpu_torch.ops import mmd_kernels as mk
    from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS as sig
    from zs3_tpu_torch.ops.mmd import batched_mmd_loss

    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default: f32 products
    cases = [
        ("main path", (21, 128, 128, 256), (10, 14, 3)),
        ("budget 512", (21, 512, 512, 256), (10, 14)),
        ("budget 2048", (4, 2048, 2048, 256), ()),
        ("ragged", (3, 50, 70, 16), ()),
        ("ragged, D not a multiple of 4", (2, 33, 45, 30), ()),
    ]
    errors = {}
    for what, (c, n, m, d), empty in cases:
        x, y, wx, wy = mmd_inputs(gen, c, n, m, d, empty)
        errors[what] = check_k2_k3(x, y, wx, wy, what)
        emit(phase="mmd kernels", case=what, shape=[c, n, m, d], **errors[what])
    x, y, wx, wy = mmd_inputs(gen, 2, 40, 40, 16)
    zero = torch.zeros_like(wx)
    s = mk.kernel_sum(x, y, zero, zero, sig)
    dx, dwx = mk.kernel_sum_grad(x, y, zero, zero, sig)
    torch.cuda.synchronize()
    check(not s.any() and not dx.any() and not dwx.any(), "mmd kernels",
          "all-zero weights must give exact zeros")
    emit(phase="mmd kernels", case="all-zero weights", ok=True)
    x, _, wx, _ = mmd_inputs(gen, 4, 96, 96, 64)
    errors["x is y"] = check_k2_k3(x, x, wx, wx, "x is y")
    emit(phase="mmd kernels", case="x is y (zero diagonal)", **errors["x is y"])

    # The step's loss and its gradient with respect to the generated side.
    fake, real, _, rmask = mmd_inputs(gen, 21, 128, 128, 256, (10, 14, 3))
    fmask = torch.ones_like(rmask)
    fmask[[10, 14]] = 0.0
    rmask[[10, 14]] = 0.0
    fake.requires_grad_(True)

    def kernel_loss():
        loss = mk.batched_kernel_mmd_loss(fake, real, fmask, rmask, sig)
        return loss.detach(), torch.autograd.grad(loss, fake)[0]

    def plain_loss():
        loss = batched_mmd_loss(fake, real, fmask, rmask, sig)
        return loss.detach(), torch.autograd.grad(loss, fake)[0]

    (loss, grad), (loss2, grad2) = kernel_loss(), kernel_loss()
    want_loss, want_grad = plain_loss()
    torch.cuda.synchronize()
    loss, want_loss = float(loss), float(want_loss)
    check(abs(loss - want_loss) <= 1e-4 * abs(want_loss), "mmd kernels",
          f"loss {loss} vs plain {want_loss}")
    check(torch.allclose(grad, want_grad, rtol=1e-3, atol=1e-6), "mmd kernels",
          f"loss gradient off by {float((grad - want_grad).abs().max())}")
    check(loss == float(loss2) and torch.equal(grad, grad2), "mmd kernels",
          "a second loss and gradient gave other bits")
    emit(phase="mmd kernels", case="batched loss and gradient, main path",
         loss=loss, plain_loss=want_loss,
         grad_max_abs_err=float((grad - want_grad).abs().max()))

    timings = {}
    for budget in MMD_BUDGETS:
        x, y, wx, wy = mmd_inputs(gen, 21, budget, budget, 256, (10, 14))
        fake = x.clone().requires_grad_(True)
        fm = torch.ones_like(wx)
        bounds = mmd_bounds(21, budget, budget, 256, len(sig))
        reps = 20 if budget <= 512 else 3
        row = {"shape": [21, budget, budget, 256]}
        for name, kernel, plain in (
            ("K2", lambda: mk.kernel_sum(x, y, wx, wy, sig),
             lambda: mk.kernel_sum_reference(x, y, wx, wy, sig)),
            ("K3", lambda: mk.kernel_sum_grad(x, y, wx, wy, sig, with_dwx=False),
             lambda: mk.kernel_sum_grad_reference(x, y, wx, wy, sig, with_dwx=False)),
        ):
            row[name] = {
                "kernel_ms": time_ms(kernel, reps=reps, what=f"{name} {budget}"),
                "plain_ms": time_ms(plain, reps=reps, what=f"{name} plain {budget}"),
                "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                "library_ms": None,
            }
        # The whole loss, forward and backward, as the step runs it.
        # One call per timing: a forward and backward launches some 100
        # kernels, and a few calls fill the launch queue behind the sleep.
        row["loss_fwd_bwd"] = {
            "kernel_ms": time_ms(lambda: torch.autograd.grad(
                mk.batched_kernel_mmd_loss(fake, y, fm, wy, sig), fake), reps=1, rounds=7,
                what=f"loss {budget}"),
            "plain_ms": time_ms(lambda: torch.autograd.grad(
                batched_mmd_loss(fake, y, fm, wy, sig), fake), reps=1, rounds=7,
                what=f"loss plain {budget}"),
        }
        timings[budget] = row
        emit(phase="mmd kernels", budget=budget, **row)
    return errors, timings


MMD_KERNEL_NAMES = ("kernel_sum_blocks", "kernel_sum_classes", "kernel_sum_grad_x")


def mmd_kernel_ms(prof) -> float:
    """Device ms of K2's and K3's kernels in a profile_device summary."""
    return sum(e["device_ms"] for e in prof["kernels"]
               if any(k in e["name"] for k in MMD_KERNEL_NAMES))


def is_finite(v) -> bool:
    return isinstance(v, (int, float)) and v == v and abs(v) != float("inf")


def _params(trainer):
    return [p.detach().clone() for p in trainer.generator.parameters()] + [
        v.detach().clone() for v in trainer.step.cls.values()
    ]


def phase_zs3():
    """`cli train-gmmn` at full width; then, on the trainer it ran, check
    its validation, time its step over device batches and split its
    device time by stage."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.metrics.evaluator import Evaluator
    from zs3_tpu_torch.train.seen import device_batch
    from zs3_tpu_torch.utils.profiling import profile_device

    phase = "zs3 slice"

    # The main path, through the entry point a user calls (`cli.run` is
    # `cli.main` without the print); counts from 0.
    reset_counts()
    t0 = time.time()
    result, trainer = cli.run(ZS3_ARGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    eval_batches = len(trainer.val_loader)
    want = {"K1": eval_batches, "K2": 3 * ZS3_STEPS, "K3": 2 * ZS3_STEPS, "K4": 0, "K5": 0}
    check(launches == want, phase,
          f"launches {launches} for {ZS3_STEPS} steps and {eval_batches} eval batches")
    check(all(is_finite(v) for k, v in result.items() if k != "epoch"), phase,
          f"non-finite results {result}")
    check(result["mmd"] > 0, phase, f"mmd {result['mmd']} is not positive")
    check({"seen_miou", "unseen_miou", "harmonic_miou"} <= result.keys(), phase,
          "seen/unseen/harmonic mIoU missing")
    emit(phase=phase, command="python -m zs3_tpu_torch.cli " + " ".join(ZS3_ARGS),
         result=result, launches=launches, steps=ZS3_STEPS,
         eval_batches=eval_batches, wall_seconds_with_setup=wall)

    # The validation once more on the same classifier: its confusion sums
    # to the valid pixels and its metrics are the main path's.
    evaluator = Evaluator(trainer.num_classes, 255, trainer.unseen)
    valid = 0
    for batch in trainer.val_loader:
        batch = device_batch(batch, torch.device("cuda"))
        evaluator.add_confusion(trainer.eval_fn(trainer.model, trainer.step.cls, batch))
        valid += int((batch["label"] != 255).sum())
    check(int(evaluator.confusion.sum()) == valid, phase,
          f"confusion sums to {evaluator.confusion.sum()}, expected {valid}")
    again = evaluator.compute().as_dict()
    check(all(abs(again[k] - result[k]) <= 1e-3 for k in again), phase,
          f"validation again disagrees: {again} vs {result}")
    emit(phase=phase, check="validation again: counts add up, metrics agree",
         pixels=valid, ok=True)

    # Steps/s over device batches: 5 windows of 100 steps (host clock,
    # each ending in a synchronize), the host's own ms per step, and the
    # host syncs in one step (none, or host_ms would include device time).
    host_batches = [b for _, b in zip(range(ZS3_STEPS), trainer.train_loader)]
    batches = [device_batch(b, torch.device("cuda")) for b in host_batches]
    turn = itertools.cycle(batches)

    def one_step():
        trainer.step(next(turn))

    def one_pass():
        for batch in batches:
            trainer.step(batch)

    before = _params(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_per_sec, window_rates = rate_windows(one_step, calls=100)
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = [not torch.equal(a, b) for a, b in zip(before, _params(trainer))]
    check(all(moved), phase, f"parameters that did not move: {moved}")
    syncs = host_syncs(one_step)
    host_ms_per_step = host_ms(one_step)
    emit(phase=phase, step="timed windows, batches already on the card",
         steps_per_window=100, steps_per_sec=steps_per_sec,
         steps_per_sec_windows=window_rates,
         images_per_sec=steps_per_sec * batches[0]["image"].shape[0],
         host_ms_per_step=host_ms_per_step, host_syncs_per_step=syncs,
         params_moved=True, peak_mem_gib=peak)

    # Where the step's device time goes: the whole step under the
    # profiler, then each stage alone on the first batch.
    prof = profile_device(one_pass, steps=2)
    check(prof["device_busy_ms"] > 0, "zs3 profile", "the profiler saw no device time")
    step_ms = prof["device_busy_ms"] / (2 * len(batches))
    mmd_ms = mmd_kernel_ms(prof)
    step = trainer.step
    feats, labels = step.features(batches[0])
    u, noise1, noise2 = step.draw(labels.shape[0])
    real, real_mask = step.sample(feats, labels, u)
    stages = {
        "trunk": lambda: step.features(batches[0]),
        "draws": lambda: step.draw(labels.shape[0]),
        "sampling": lambda: step.sample(feats, labels, u),
        "generator_update": lambda: step.generator_update(real, real_mask, noise1),
        "classifier_update": lambda: step.classifier_update(real, real_mask, noise2),
    }
    split = {}
    for name, fn in stages.items():
        p = profile_device(fn, steps=4)
        split[name] = p["device_busy_ms"] / 4
        if name == "generator_update":
            split["of_which_k2_k3"] = mmd_kernel_ms(p) / 4
    prof["kernels"], prof["ops"] = prof["kernels"][:15], prof["ops"][:15]
    emit(phase="zs3 profile", steps_per_pass=len(batches), device_ms_per_step=step_ms,
         k2_k3_device_ms_per_step=mmd_ms / (2 * len(batches)),
         host_ms_per_step=host_ms_per_step, stage_device_ms=split,
         idle_share_untraced=1.0 - step_ms * steps_per_sec / 1e3, **prof)
    return launches


def phase_zs3_reference():
    """One ZS3 step on the card against the same step on the CPU: same
    weights, batch and draws; ResNet-50 at 65x65, f32, TF32 off.  mmd and
    cls_ce to rtol 1e-4, gradients to rtol 1e-3 with an atol of 1e-4 of
    the tensor's largest entry, updated params to 1e-6 where
    |g| > 1e-3 max|g| (Adam's first step is +-lr, whatever |g|)."""
    import copy

    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data.loader import make_train_loader
    from zs3_tpu_torch.data.synthetic import synthetic_class_embeddings
    from zs3_tpu_torch.models.gmmn import build_gmmn, init_gmmn
    from zs3_tpu_torch.train.gmmn import ZS3Step, extract_classifier
    from zs3_tpu_torch.train.seen import build_eval_model, device_batch

    phase = "zs3 reference"
    args = ["train-gmmn", "--dataset", "synthetic", "--backbone", "resnet50",
            "--crop-size", "65", "--base-size", "65", "--batch-size", "8",
            "--compute-dtype", "float32", "--unseen-split", "2"]
    cfg = cli.build_config(cli.make_parser().parse_args(args))
    loader, n = make_train_loader(cfg.data)
    batch = next(iter(loader))
    unseen = torch.zeros(n)
    unseen[list(cfg.data.unseen_classes)] = 1.0
    emb = torch.from_numpy(synthetic_class_embeddings(n, cfg.gmmn.embed_dim))
    generator = init_gmmn(build_gmmn(cfg.gmmn), 1)

    def make_step(dev):
        model = build_eval_model(cfg, dev)
        return ZS3Step(model, copy.deepcopy(generator).to(dev), extract_classifier(model),
                       emb.to(dev), unseen.to(dev), cfg, seed=0)

    cpu_step, gpu_step = make_step("cpu"), make_step("cuda")
    cpu_batch = device_batch(batch, torch.device("cpu"))
    gpu_batch = device_batch(batch, torch.device("cuda"))
    _, labels = cpu_step.features(cpu_batch)
    draws = cpu_step.draw(labels.shape[0])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = cpu_step.body(cpu_batch, draws)
        got = gpu_step.body(gpu_batch, tuple(d.cuda() for d in draws))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    for key in ("mmd", "cls_ce"):
        a, b = float(got[key]), float(want[key])
        check(abs(a - b) <= 1e-4 * abs(b), phase, f"{key}: card {a} vs CPU {b}")

    def tensors(step):
        return list(step.generator.named_parameters()) + list(step.cls.items())

    worst = {}
    for (name, p), (_, q) in zip(tensors(gpu_step), tensors(cpu_step)):
        g, want_g = p.grad.cpu(), q.grad
        scale = float(want_g.abs().max())
        check(torch.allclose(g, want_g, rtol=1e-3, atol=1e-4 * scale), phase,
              f"{name}: gradient off by {float((g - want_g).abs().max())} (max |g| {scale})")
        big = want_g.abs() > 1e-3 * scale
        err = float((p.detach().cpu() - q.detach())[big].abs().max())
        check(err <= 1e-6, phase, f"{name}: updated params off by {err}")
        worst[name] = float((g - want_g).abs().max()) / scale
    emit(phase=phase, mmd=float(got["mmd"]), cpu_mmd=float(want["mmd"]),
         cls_ce=float(got["cls_ce"]), cpu_cls_ce=float(want["cls_ce"]),
         grad_max_err_over_max_grad=worst, ok=True)


def conv_fwd_bwd_ms(x, weight, dilation, space_to_batch):
    """Device ms of one forward and backward (dgrad and wgrad) of a dilated
    3x3 "same" conv, as cuDNN runs it or as space-to-batch."""
    import torch.nn.functional as F

    from zs3_tpu_torch.models.layers import conv2d_space_to_batch

    x = x.detach().requires_grad_(True)
    w = weight.detach().requires_grad_(True)

    def fwd_bwd():
        if space_to_batch:
            y = conv2d_space_to_batch(x, w, None, dilation)
        else:
            y = F.conv2d(x, w, None, 1, dilation, dilation)
        torch.autograd.grad(y.float().sum(), (x, w))

    return time_ms(fwd_bwd, reps=3, rounds=3, what=f"conv d={dilation}")


def phase_seen():
    """`cli train-seen` at full width (train batch 8, loss at full
    resolution, dropout on), 4 steps and one validation; then, on the
    trainer it ran, its steps/s over 5 windows of 20 steps on batches on
    the card, the host's ms per step, the device ms per step and the top
    kernels, and the backward of the dilated convs of layer4 and the ASPP."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.train.seen import device_batch
    from zs3_tpu_torch.utils.profiling import profile_device
    from zs3_tpu_torch.utils.saver import Saver

    phase = "seen slice"
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    reset_counts()
    t0 = time.time()
    result, trainer = cli.run(SEEN_ARGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    eval_batches = len(trainer.val_loader)
    check(launches == {"K1": eval_batches, "K2": 0, "K3": 0, "K4": 0, "K5": 0}, phase,
          f"launches {launches} for {eval_batches} eval batches")
    check(all(is_finite(v) for v in result.values()), phase, f"non-finite results {result}")
    check(trainer.step == SEEN_STEPS, phase, f"{trainer.step} steps taken")
    exp = trainer.saver.directory
    ckpt = Saver.latest_checkpoint(exp)
    check(os.path.basename(exp) == "experiment_0" and ckpt is not None
          and Saver.best_checkpoint(exp) is not None, phase,
          f"checkpoints in {exp}: {sorted(os.listdir(exp))}")
    saved, live = Saver.restore(ckpt)["model"], trainer.model.state_dict()
    check(saved.keys() == live.keys()
          and all(torch.equal(saved[k], live[k].cpu()) for k in saved), phase,
          "the checkpoint does not reload to the trained model's tensors")
    emit(phase=phase, command="python -m zs3_tpu_torch.cli " + " ".join(SEEN_ARGS),
         result=result, launches=launches, steps=SEEN_STEPS, eval_batches=eval_batches,
         checkpoint=os.path.relpath(ckpt), checkpoint_mib=os.path.getsize(ckpt) / 2**20,
         wall_seconds_with_setup=wall)

    # Steps/s over batches on the card: 5 windows of 20 steps (host clock,
    # each ending in a synchronize); the host's own ms per step and its syncs.
    host_batches = [b for _, b in zip(range(SEEN_STEPS), trainer.train_loader)]
    batches = [device_batch(b, trainer.device) for b in host_batches]
    turn = itertools.cycle(batches)

    def one_step():
        return trainer.train_step(trainer.model, trainer.optimizer, next(turn))

    losses = [float(one_step()["loss"]) for _ in batches]
    check(all(is_finite(v) for v in losses), phase, f"non-finite losses {losses}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_per_sec, window_rates = rate_windows(one_step, calls=SEEN_WINDOW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    syncs = host_syncs(one_step)
    host_ms_per_step = host_ms(one_step, calls=11)
    emit(phase=phase, step="timed windows, batches already on the card",
         steps_per_window=SEEN_WINDOW, steps_per_sec=steps_per_sec,
         steps_per_sec_windows=window_rates,
         images_per_sec=steps_per_sec * batches[0]["image"].shape[0],
         host_ms_per_step=host_ms_per_step, host_syncs_per_step=syncs, losses=losses,
         peak_mem_gib=peak)

    prof = profile_device(one_step, steps=4)
    check(prof["device_busy_ms"] > 0, "seen profile", "the profiler saw no device time")
    step_ms = prof["device_busy_ms"] / 4
    bn_ms = sum(e["device_ms"] for e in prof["kernels"] if "batch_norm" in e["name"]) / 4
    prof["kernels"], prof["ops"] = prof["kernels"][:15], prof["ops"][:15]

    emit(phase="seen profile", device_ms_per_step=step_ms, batch_norm_device_ms_per_step=bn_ms,
         host_ms_per_step=host_ms_per_step,
         idle_share_untraced=1.0 - step_ms * steps_per_sec / 1e3,
         dilated_conv_fwd_bwd_ms=dilated_backward_ms(), bn_fwd_bwd_ms=bn_train_ms(), **prof)
    return launches, trainer, ckpt


def dilated_backward_ms():
    """The train step's dilated convs, forward + dgrad + wgrad in bf16 at
    train batch 8: layer4's 3x3 512 -> 512 at d = 2, 4, 8 (cuDNN) and the
    ASPP's 2048 -> 256 at d = 12, 18 (space-to-batch)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    make = lambda shape, scale: (torch.randn(shape, device="cuda", generator=gen) * scale).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x4, w4 = make((8, 512, 33, 33), 1.0), make((512, 512, 3, 3), 0.02)
    xa, wa = make((8, 2048, 33, 33), 1.0), make((256, 2048, 3, 3), 0.02)
    out = {f"layer4 d={d}": conv_fwd_bwd_ms(x4, w4, d, False) for d in (2, 4, 8)}
    for d in (12, 18):
        out[f"aspp d={d} space_to_batch"] = conv_fwd_bwd_ms(xa, wa, d, True)
    return out


def bn_train_ms():
    """Train-mode BN forward + backward in bf16 at layer1's widest shape,
    (8, 256, 129, 129) channels_last: the port's BatchNorm (flax's running
    variance from the normalisation's saved statistics) against torch's
    BatchNorm2d (cuDNN or native, unbiased running variance)."""
    from zs3_tpu_torch.models.layers import BatchNorm

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((8, 256, 129, 129), device="cuda", generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    out = {}
    for name, bn in (("port BatchNorm", BatchNorm(256)), ("torch BatchNorm2d",
                                                          torch.nn.BatchNorm2d(256))):
        bn = bn.cuda().train()

        def fwd_bwd():
            torch.autograd.grad(bn(x).float().sum(), (x, bn.weight))

        out[name] = time_ms(fwd_bwd, reps=5, rounds=3, what=name)
    return out


def phase_chained(seen_ckpt):
    """The pipeline through the port's checkpoints: `train-gmmn --resume
    <seen checkpoint>` for one step with --no-val (it writes the -gmmn
    checkpoint), `evaluate-gmmn --gmmn-resume <it>` and `evaluate --resume
    <seen checkpoint>`; both checkpoints reload to bit-equal tensors."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.utils.saver import Saver

    phase = "chained"
    common = [*FULL_WIDTH, "--eval-batch-size", "4", "--unseen-split", "2", *CKPT_ARGS,
              "--resume", seen_ckpt]
    stages = {}

    def same(a, b, what):
        check(a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a),
              phase, f"{what}: tensors differ")

    def stage(name, argv, k1=True, k2=0, k3=0):
        """cli.run(argv) with the counts from 0: the launches it must make
        (K1 once per eval batch when k1), finite results, a checkpoint."""
        reset_counts()
        t0 = time.time()
        result, trainer = cli.run(argv)
        torch.cuda.synchronize()
        launches = read_counts()
        want = {"K1": len(trainer.val_loader) if k1 else 0, "K2": k2, "K3": k3, "K4": 0, "K5": 0}
        check(launches == want, phase, f"{name}: launches {launches}, want {want}")
        check(all(is_finite(v) for v in result.values()), phase, f"{name}: {result}")
        ckpt = Saver.latest_checkpoint(trainer.saver.directory)
        check(ckpt is not None, phase, f"{name} wrote no checkpoint")
        stages[name] = {"result": result, "launches": launches, "checkpoint": os.path.relpath(ckpt),
                        "wall_seconds_with_setup": time.time() - t0}
        return trainer, ckpt

    trainer, gmmn_ckpt = stage("train-gmmn", ["train-gmmn", *common, "--batch-size", "8",
                                              "--epochs", "1", "--steps-per-epoch", "1",
                                              "--no-val"], k1=False, k2=3, k3=2)
    gmmn = Saver.restore(gmmn_ckpt)
    same(gmmn["gen"], trainer.generator.state_dict(), "gmmn checkpoint: generator")
    same(gmmn["cls"], {k: v.detach() for k, v in trainer.step.cls.items()},
         "gmmn checkpoint: classifier")
    del trainer
    trainer, _ = stage("evaluate-gmmn", ["evaluate-gmmn", *common, "--gmmn-resume", gmmn_ckpt])
    same(gmmn["gen"], trainer.generator.state_dict(), "evaluate-gmmn's generator")
    check(trainer.global_step == gmmn["step"] == 1, phase, "evaluate-gmmn's step")
    del trainer
    trainer, _ = stage("evaluate", ["evaluate", *common])
    same(Saver.restore(seen_ckpt)["model"], trainer.model.state_dict(), "evaluate's model")
    check(trainer.step == SEEN_STEPS, phase, f"evaluate resumed at step {trainer.step}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase=phase, seen_checkpoint=os.path.relpath(seen_ckpt), stages=stages, ok=True)


def to_f64(trainer):
    """The trainer's model in f64: parameters, statistics and compute."""
    trainer.model.double()
    for module in trainer.model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float64
    return trainer


def phase_seen_reference():
    """One train-seen step on the card against the same step on the CPU:
    ResNet-50 at 65x65, dropout off, the same seeded weights and batch.  In
    f64 on both, where rounding cannot hide a wrong gradient: the loss to
    rtol 1e-10, each gradient within 1e-7 of its max |g|, the updated
    parameters and the BN running statistics within 1e-9.  Train-mode BN
    over the few pixels of layer4 (5x5 a channel and image) amplifies
    rounding, so in f32 (TF32 off) the deep gradients of either device
    differ from the f64 ones by percents; those errors are reported, and
    the f32 loss held to rtol 1e-4."""
    import dataclasses

    from zs3_tpu_torch import cli
    from zs3_tpu_torch.train.seen import SeenTrainer, device_batch

    phase = "seen reference"
    args = ["train-seen", "--dataset", "synthetic", "--backbone", "resnet50", "--crop-size", "65",
            "--base-size", "65", "--batch-size", "8", "--compute-dtype", "float32",
            "--unseen-split", "2", *CKPT_ARGS]
    cfg = cli.build_config(cli.make_parser().parse_args(args))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=False))
    steps = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, device, f64 in (("cpu64", "cpu", True), ("card64", "cuda", True),
                                  ("cpu32", "cpu", False), ("card32", "cuda", False)):
            trainer = SeenTrainer(cfg, device)
            if f64:
                to_f64(trainer)
            batch = device_batch(next(iter(trainer.train_loader)), trainer.device)
            if f64:
                batch["image"] = batch["image"].double()
            out = trainer.train_step(trainer.model, trainer.optimizer, batch)
            torch.cuda.synchronize()
            steps[name] = (float(out["loss"]), trainer.model)
    finally:
        torch.backends.cudnn.allow_tf32 = True

    def errors(name):
        """(loss, max gradient error over max |g|, updated params where
        |g| > 1e-3 max|g|, BN statistics) of a step against the CPU's f64."""
        loss, model = steps[name]
        ref_loss, ref = steps["cpu64"]
        got = dict(model.named_parameters())
        grad = param = 0.0
        for pname, p64 in ref.named_parameters():
            g64, p = p64.grad, got[pname]
            scale = float(g64.abs().max())
            grad = max(grad, float((p.grad.cpu().double() - g64).abs().max()) / scale)
            big = g64.abs() > 1e-3 * scale
            if big.any():
                param = max(param, float(
                    (p.detach().cpu().double()[big] - p64.detach()[big]).abs().max()))
        buffers = dict(model.named_buffers())
        bn = max(float((buffers[b].cpu().double() - v).abs().max())
                 for b, v in ref.named_buffers() if b.endswith(("running_mean", "running_var")))
        return {"loss": abs(loss - ref_loss), "grad": grad, "param": param, "bn": bn}

    card64, cpu32, card32 = errors("card64"), errors("cpu32"), errors("card32")
    loss64 = steps["cpu64"][0]
    check(card64["loss"] <= 1e-10 * abs(loss64) and card64["grad"] <= 1e-7
          and card64["param"] <= 1e-9 and card64["bn"] <= 1e-9, phase,
          f"f64: the card's step is off the CPU's by {card64}")
    check(card32["loss"] <= 1e-4 * abs(loss64), phase, f"f32: the card's loss off by {card32}")
    emit(phase=phase, loss_f64=loss64, card_f64_vs_cpu_f64=card64,
         card_f32_vs_cpu_f64=card32, cpu_f32_vs_cpu_f64=cpu32, ok=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import zs3_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from zs3_tpu_torch.train.seen import build_eval_model, device_batch

    phase_env()
    phase_build()
    timings = phase_kernels()
    mmd_errors, mmd_timings = phase_mmd()
    tail_timings = phase_tail()
    phase_dilated()
    launches = phase_slice()
    zs3_launches = phase_zs3()
    serve_launches = phase_serve()
    infer_launches = phase_infer()
    tta_launches = phase_tta()
    seen_launches, seen, seen_ckpt = phase_seen()
    images = device_batch(next(iter(seen.val_loader)), torch.device("cuda"))["image"]
    trunk_cfg = seen.cfg.replace(train=dataclasses.replace(seen.cfg.train, resume=seen_ckpt))
    del seen
    gc.collect()
    torch.cuda.empty_cache()
    phase_chained(seen_ckpt)
    # K5 on the trunk train-seen trained and wrote, reloaded from its checkpoint.
    k5_launches, k5_errors, k5_timings = phase_bottleneck(build_eval_model(trunk_cfg, "cuda"),
                                                          images)
    del images
    gc.collect()
    torch.cuda.empty_cache()
    phase_reference()
    phase_zs3_reference()
    phase_serve_reference()
    phase_seen_reference()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    b4, b16 = timings[4], timings[16]
    k4 = tail_timings[(SERVE_BATCH, "bfloat16")]
    k4_fields = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
    main_err, main_t = mmd_errors["main path"], mmd_timings[128]

    def mmd_row(name, key, source_line, err):
        t = main_t[key]
        return {
            "name": name,
            "route": "cuda",
            "source": "zs3_tpu_torch/csrc/mmd_kernel_sum.cu",
            "replaces": f"zs3_tpu/ops/pallas_mmd.py:{source_line}",
            "launches": zs3_launches[key],
            "max_abs_err": err,
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": main_t["shape"],
            "budgets": {b: mmd_timings[b][key] for b in MMD_BUDGETS},
        }

    print(json.dumps({"kernels": [{
        "name": "upsample_argmax",
        "route": "cuda",
        "source": "zs3_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "zs3_tpu/ops/pallas_eval.py:30",
        "launches": launches,
        "launches_train_gmmn": zs3_launches["K1"],
        "max_abs_err": b4["max_abs_err"],
        "ms": b4["kernel_ms"],
        "plain_ms": b4["plain_ms"],
        "bound_ms": b4["bound_ms"],
        "bound_by": b4["bound_by"],
        "library_ms": b4["library_ms"],
        "shape": b4["shape"],
        "b16": {k: b16[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
    },
        mmd_row("mmd_kernel_sum", "K2", 54, main_err["k2_max_abs_err"]),
        mmd_row("mmd_kernel_sum_grad", "K3", 79, main_err["k3_dx_max_abs_err"]),
        {
            "name": "classify_resize",
            "route": "cuda",
            "source": "zs3_tpu_torch/csrc/classify_resize.cu",
            "replaces": "zs3_tpu/ops/pallas_tail.py:95",
            "launches": serve_launches["K4"],
            "launches_infer": {m: v["launches"]["K4"] for m, v in infer_launches.items()},
            "launches_tta": tta_launches["K4"],
            "max_abs_err": k4["max_abs_err"],
            "max_err_in_tap_ulps": k4["max_err_in_tap_ulps"],
            "ms": k4["kernel_ms"],
            "plain_ms": k4["plain_ms"],
            "bound_ms": k4["bound_ms"],
            "bound_by": k4["bound_by"],
            "library_ms": k4["library_ms"],
            "shape": k4["shape"],
            "dtype": "bfloat16",
            "b1": {f: tail_timings[(1, "bfloat16")][f] for f in k4_fields},
            "b8_f32": {f: tail_timings[(SERVE_BATCH, "float32")][f] for f in k4_fields},
        },
        {
            "name": "fused_bottleneck",
            "route": "cuda",
            "source": "zs3_tpu_torch/csrc/fused_bottleneck.cu",
            "replaces": "zs3_tpu/ops/pallas_bottleneck.py:64",
            "launches": k5_launches["K5"],
            "launches_train_seen": seen_launches["K5"],
            "max_abs_err": k5_errors["max_abs_err"],
            "errors": k5_errors,
            **{f: k5_timings["layer3"][f] for f in ("bound_ms", "bound_by", "plain_ms",
                                                   "library_ms", "shape", "dtype")},
            "ms": k5_timings["layer3"]["kernel_ms"],
            "stages": k5_timings,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
