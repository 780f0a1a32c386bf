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

  * `evaluate` (eval batch 4): one K1 launch per eval batch, on the
    model's bf16 logits as they are (no cast launch before it);
  * `train-gmmn` (train batch 8, 128 pixels per class, 4 steps, then one
    validation): each step launches K2 three times (fake-fake, real-real,
    fake-real) and K3 twice (fake-fake once, for both of its equal sides,
    and fake-real for x: only the generated features need a gradient),
    and the validation one K1 per eval batch; the same with
    `--graph-context` (the graph-context generator), its step's device
    time split with the graph branch as a stage of its own;
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
    --gmmn-resume <its checkpoint>` (whose next draws must be the
    uninterrupted run's second step's, not its first's), `evaluate
    --resume <seen checkpoint>`, then `train-zs5 --resume <seen
    checkpoint>` (4 steps, one validation): K1 once per tagged train
    image on f32 logits restricted with finfo(float32).min, and per eval
    batch, K2 3 and K3 2 a step; its PNGs hold only seen classes, the
    image's tags or ignore;
  * K5 over the 29 identity blocks of that trained trunk, reloaded from
    its checkpoint, in eval mode at eval batch 4: one launch per block
    (and, before the paths, K5 on small and ragged shapes and its
    refusal of bf16 widths that are not multiples of 64).
  * on fabricated trees (build/chip_smoke_data/, removed at the end):
    a VOC2012 (48 train, 16 val), SBD (32) and Pascal-Context (24, 8)
    tree, the Context labels rebuilt by `prepare-context` from their
    detail-API JSON, VOC and Context registries by `build-embeddings`
    from a 300-d word2vec binary; `train-seen --use-sbd` at BASELINE
    config 3's split (10 unseen, device_preprocess on through --config),
    from its checkpoint `train-gmmn`, `evaluate-gmmn` and `evaluate`;
    a 59-class `train-seen --dataset context --unseen-split 4`, and from
    it `train-zs5` and `train-gmmn --graph-context` (configs 4 and 5),
    each with its K1/K2/K3 launches; K1 at 59 classes (f32, bf16, ZS5's
    restricted logits) and K2/K3 at the Context step's shape against
    their plain versions; the loader's images/s, one batch's copy to the
    card, and the seen step fed by the loader beside bypassing it.
  * input_pipeline="tfdata" (data/tfdata.py, zs3_tpu's tf.data stream
    without TensorFlow, 4 worker processes) on those trees:
    `train-seen` on VOC2012 at split 2 with --compilation-cache in a
    fresh directory (K1 built there), `train-zs5` on Context from the
    59-class trunk (its pseudo-labels read through the stream), then
    `evaluate` with the same directory (no nvcc: K1's library keeps its
    mtime); batches byte-equal at 0 and 4 workers, epochs repeatable; the
    stream's images/s at 4 and 8 workers beside the python loader's, and
    the seen step fed by each.
  * int8 (zs3_tpu_torch/quant.py): `evaluate --int8` (calibration on 2
    val batches, 112 int8 convs a forward, K1 once per eval batch); the
    s8 x s8 -> s32 route (im2col + torch._int_mm) held bit-equal to its
    plain version (a float64 conv of the int8 values) for every conv form
    on the inputs that path gives; absmax and 99.99th-percentile
    calibration; int8 against bf16 eval in turns; `serve --int8
    --calib-images --int8-percentile 99.99` under the served load (K4
    once per batched forward); `train-seen --qat` (3 steps);
    `train-gmmn --int8-features` (2 steps, K2/K3, an int8 validation);
    and the route's time on three shapes against cuDNN's bf16 conv.
  * backbones: Xception-65 and MobileNetV2 at os16 and DRN-D-54 (os8 by
    nature), each at 513x513, bf16, full depth: `evaluate` (K1 per eval
    batch, held against its plain version), `train-seen` (3 steps at
    batch 8, a checkpoint), from it `train-gmmn` (2 steps: K2 6 and K3 4
    launches, held against their plain versions on the step's inputs) and
    `evaluate-gmmn`, `serve --fused-tail` (8 requests, K4's logits against
    the standard tail), `profile --mode fwd|train`, `convert-weights` of
    the trained backbone's keys (equal tensors back), an f32 TF32-off
    65x65 forward on the card against the port on the CPU, MobileNetV2's
    `evaluate --int8` (depthwise convs float); every distinct depthwise
    conv in channels_last against contiguous_format, DRN's 7x7 stem, and
    DRN's os8 ASPP through space-to-batch against cuDNN's conv.

  * export (after the chained pipeline, on its checkpoints): `export`
    of R101 at batch 8 (labels, the retrained classifier spliced), 1
    (logits) and 8 (`--int8`), each artifact against the eager Predictor
    (the labels one loaded by a process without the port), `serve
    --artifact` against a checkpoint server, the refusals, MobileNetV2;
  * data parallel: two gloo ranks on the card (CUDA tensors), each
    running cli.run: `train-seen` (bf16 513², and f32 65² with TF32 off),
    `train-gmmn` (K2 6 and K3 4 on each rank) and `evaluate` (K1 per eval
    batch on each rank) against one rank, with each rank's step time,
    all-reduce share and peak memory;
  * spatial (zs3_tpu_torch/parallel/spatial.py): three gloo ranks on the
    card split H of the R101 eval forward at 2049x2049 bf16 (K4 once a
    rank on the os4 features gathered whole, and without the fused tail)
    and 513x513 f32; two split the seen train step at 1024x1024 bf16 and
    128x128 f32; each against one rank, with each rank's wall and device
    ms, exchanges and peak memory.
  * rehearsal (zs3_tpu_torch/release_rehearsal.py, `rehearse` at its
    card defaults): fabricated VOC+SBD trees and a torchvision-shaped
    R101 .pth, then convert-weights, train-seen --ft (25 steps),
    train-gmmn --int8-features, train-zs5, evaluate, evaluate --int8,
    the QAT fine-tune and its int8 evaluation, evaluate-gmmn with TTA,
    the synthetic zero-shot stage at acceptance depth (ResNet-50 at
    49x49, f32: seen, ZS3 and its int8 validation, ZS5), export and
    serve, with the no-op runs (train-seen at LR 0, the ZS3 leg at a
    generator LR of 0); every bar of the card asserted and each above its
    no-op run, within 300 s; K1/K2/K3 counted per stage, and K1 on the
    synthetic stage's eval and pseudo-label logits and K2/K3 on its ZS3
    step's own inputs against their plain versions.

It checks that what comes out is right, times and profiles the loops,
and compares the port on the card with the port on the CPU at a small
size (ResNet-50, 65x65, f32): among them the ZS3, graph-context and ZS5
steps, and ZS5's pseudo-labels.  Checkpoints go to build/chip_smoke_run/,
removed at the end.  Each phase prints one JSON line; a failed
phase exits nonzero.  The line before the last is the kernel table, the
last line is {"ok": true, "device": {...}}.  Needs one CUDA card;
imports no JAX.
"""

from __future__ import annotations

import contextlib
import copy
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
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
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
GRAPH_ARGS = [*ZS3_ARGS, "--graph-context"]
SEEN_STEPS = 4
SEEN_WINDOW = 10  # steps per timed window
SEEN_ARGS = [
    "train-seen", *FULL_WIDTH, "--batch-size", "8", "--eval-batch-size", "4",
    "--unseen-split", "2", "--epochs", "1", "--steps-per-epoch", str(SEEN_STEPS), *CKPT_ARGS,
]
MMD_BUDGETS = (128, 512, 2048)
# The int8 phase: R101's quantized convs (33 bottlenecks x 3, 4 downsamples,
# 6 of the ASPP, 3 of the decoder; the stem and the classifier stay float),
# zs3_tpu.quant's count on the same architecture
# (tests/test_torch_port_quant.py::test_r101_quantized_conv_count).
INT8_CONVS = 112
INT8_ARGS = [*SLICE_ARGS, "--int8"]
QAT_STEPS = 3
QAT_ARGS = [
    "train-seen", *FULL_WIDTH, "--batch-size", "8", "--unseen-split", "2", "--epochs", "1",
    "--steps-per-epoch", str(QAT_STEPS), "--no-val", "--qat",
    "--checkpoint-dir", CKPT_DIR, "--checkname", "chip-smoke-qat",
]
INT8_ZS3_STEPS = 2
INT8_ZS3_ARGS = [*ZS3_ARGS[:ZS3_ARGS.index("--steps-per-epoch")], "--steps-per-epoch",
                 str(INT8_ZS3_STEPS), "--seed", "0", "--device", "cuda",
                 "--checkpoint-dir", CKPT_DIR, "--checkname", "chip-smoke-int8",
                 "--int8-features"]
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
# Numbers of the bf16 loops, kept by their phases for the int8 phase to
# set beside its own (same run, same card).
MEASURED = {}


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
    gc.collect()  # once: a full collection takes ~0.1 s with the port's modules loaded
    for _ in range(rounds):
        sleep_start = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def rate_windows(fn, calls: int, windows: int = 3):
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

    from zs3_tpu_torch import quant

    eval_kernels.upsample_argmax.launches = 0
    mk.kernel_sum.launches = mk.kernel_sum_grad.launches = 0
    tail_kernels.classify_resize.launches = 0
    bottleneck_kernels.fused_bottleneck.launches = 0
    quant.int8_conv.launches = 0


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
        ptxas = [ln.strip() for ln in log.splitlines() if "ptxas info" in ln or "spill" in ln]
        emit(phase="build", kernel=name, library=os.path.relpath(lib), ptxas=ptxas)
    emit(phase="build", seconds=seconds)


def k1_bound(bsz, hi, wi, c, ho, wo, itemsize=4):
    """(least time in ms, "bytes" or "operations") for K1 on these shapes,
    with logits of `itemsize` bytes."""
    bytes_moved = bsz * (hi * wi * c * itemsize + ho * wo * 4)
    # H blend (2 mul + 1 add per source element of each output row), W
    # blend (2 mul + 1 add per class and output pixel), compare.
    flops = bsz * ho * c * (3 * wi + 4 * wo)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


K1_BARS = [[4, 129, 129, 21], [16, 129, 129, 21]]  # f32, -> 513^2: the eval batches
K1_TIMES = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from zs3_tpu_torch.ops.eval_kernels import upsample_argmax
gen = torch.Generator(device="cuda").manual_seed(0)
out = []
for shape in json.loads(sys.argv[1]):
    logits = torch.randn(shape, device="cuda", generator=gen)
    out.append(c.time_ms(lambda: upsample_argmax(logits, (513, 513)), what=str(shape)))
print(json.dumps(out))
"""


def k1_against(other_root: str):
    """K1 (f32) of this checkout against another checkout's at K1_BARS, in
    turns."""
    return against(other_root, K1_TIMES, K1_BARS, "k1 against")


def restricted_logits(gen, shape):
    """ZS5's pseudo-label logits: f32, finfo(float32).min in the classes
    not allowed (zs3_tpu/train/self_training.py:65); (logits, allowed)."""
    logits = torch.randn(shape, device="cuda", generator=gen)
    allowed = torch.rand(shape[-1], device="cuda", generator=gen) < 0.5
    allowed[0] = True
    allowed[-1] = False
    return logits.masked_fill(~allowed, torch.finfo(torch.float32).min), allowed


def phase_kernels():
    import torch.nn.functional as F

    from zs3_tpu_torch.ops.eval_kernels import (card_plan, upsample_argmax,
                                                upsample_argmax_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (shape, size, dtype, timed)
        ((4, 129, 129, 21), (513, 513), f32, True),   # main path, eval batch 4
        ((16, 129, 129, 21), (513, 513), f32, True),  # main path, eval batch 16
        ((4, 129, 129, 21), (513, 513), bf16, True),  # the model's bf16 logits
        ((16, 129, 129, 21), (513, 513), bf16, True),
        ((4, 129, 129, 59), (513, 513), f32, True),   # Pascal-Context's 59 classes
        ((4, 129, 129, 59), (513, 513), bf16, True),  # (bf16 rows of 15,222 bytes)
        ((3, 17, 17, 59), (65, 65), f32, False),
        ((1, 9, 11, 7), (33, 45), f32, False),        # ragged rows and columns
        ((1, 9, 11, 7), (33, 45), bf16, False),
        ((2, 17, 17, 21), (65, 65), f32, False),
        ((2, 33, 33, 21), (9, 9), f32, False),        # downsample: runs of one
        ((8, 13, 13, 10), (49, 49), f32, True),       # the rehearsal's synthetic eval
        ((1, 33, 129, 128), (65, 513), f32, False),   # 138 KB of shared memory
        ((1, 33, 129, 128), (65, 513), bf16, False),
    ]
    timings = {}
    for shape, size, dtype, timed in cases:
        logits = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        got = upsample_argmax(logits, size)
        want = upsample_argmax_reference(logits, size)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == torch.int32, "kernels",
              f"{shape}: got {tuple(got.shape)} {got.dtype}")
        what = f"{shape} {dtype}"
        ties, err = compare_labels(got, want, logits, size, "kernels", what)
        layout = card_plan(shape, size, True, dtype, torch.cuda.current_device())[0]
        row = dict(phase="kernels", kernel="upsample_argmax", shape=list(shape),
                   size=list(size), dtype=str(dtype).split(".")[-1], near_ties=ties,
                   max_abs_err=err,
                   **{k: layout[k] for k in ("band_rows", "ctas", "threads", "smem_bytes")})
        if timed:
            nchw = logits.permute(0, 3, 1, 2)
            bound_ms, bound_by = k1_bound(*shape, *size, logits.element_size())
            row.update(
                bound_ms=bound_ms,
                bound_by=bound_by,
                kernel_ms=time_ms(lambda: upsample_argmax(logits, size), what=what),
                plain_ms=time_ms(lambda: upsample_argmax_reference(logits, size), what=what),
                library_ms=time_ms(lambda: F.interpolate(
                    nchw, size=size, mode="bilinear", align_corners=True).argmax(1), what=what),
                host_ms=host_ms(lambda: upsample_argmax(logits, size)),
            )
            timings[(shape[0], shape[-1], row["dtype"])] = row
        emit(**row)
    # ZS5's restricted logits at a 4x and a ragged geometry, at the
    # rehearsal's synthetic pseudo-label pass's, and as the Context
    # pseudo-label pass makes them (one image, 59 classes, timed):
    # only allowed classes, the plain version's labels.
    for shape, size in (((4, 129, 129, 21), (513, 513)), ((2, 11, 11, 21), (45, 45)),
                        ((1, 13, 13, 10), (49, 49)), ((1, 129, 129, 59), (513, 513))):
        logits, allowed = restricted_logits(gen, shape)
        got = upsample_argmax(logits, size)
        want = upsample_argmax_reference(logits, size)
        ties, err = compare_labels(got, want, logits, size, "kernels", f"restricted {shape}")
        check(bool(allowed[got.long()].all()), "kernels",
              f"restricted {shape}: a class not allowed won")
        row = dict(phase="kernels", kernel="upsample_argmax", case="finfo.min restricted",
                   shape=list(shape), size=list(size), near_ties=ties, max_abs_err=err, ok=True)
        if shape[-1] in (59, 10):  # the Context pass's and the synthetic stage's
            what, nchw = f"restricted {shape}", logits.permute(0, 3, 1, 2)
            row["bound_ms"], row["bound_by"] = k1_bound(*shape, *size)
            row.update(
                kernel_ms=time_ms(lambda: upsample_argmax(logits, size), what=what),
                plain_ms=time_ms(lambda: upsample_argmax_reference(logits, size), what=what),
                library_ms=time_ms(lambda: F.interpolate(
                    nchw, size=size, mode="bilinear", align_corners=True).argmax(1), what=what))
            timings[("restricted", shape[-1])] = row
        emit(**row)
    for dtype in (f32, bf16):
        flat = torch.zeros((1, 8, 8, 4), device="cuda", dtype=dtype)
        got = upsample_argmax(flat, (16, 16))
        check(bool((got == 0).all()), "kernels", f"all-equal {dtype} logits must give label 0")
    emit(phase="kernels", kernel="upsample_argmax", case="all-equal", ok=True)
    return timings


# K1's source with one part taken out or changed (k1_parts), as K3_PARTS.
# (A variant that leaves the labels unchanged by the classes lets the
# compiler drop the class loop: each keeps the index live.)
K1_ONE_CLASS = ("  for (int k = 1; k < C; ++k) {\n", "  for (int k = 1; k < 1; ++k) {\n")
K1_NO_STORES = ("  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {\n",
                "  for (int i = threadIdx.x; i < 0; i += blockDim.x) {\n")
K1_PARTS = {
    "one class (launch, staging, label stores)": [K1_ONE_CLASS],
    "one class, no label stores (launch and staging)": [K1_ONE_CLASS, K1_NO_STORES],
    "no label stores": [K1_NO_STORES],
    "no staging (compute on what shared memory holds)": [
        ("      if (bytes) bulk_load(", "      if (bytes && false) bulk_load("),
        ("      mbar_expect_tx(&bars[k], bytes);\n", "      mbar_expect_tx(&bars[k], 0);\n")],
    "empty (launch only)": [(
        "  const int band = static_cast<int>(blockIdx.x % g.nbands);\n",
        "  if (g.C > 0) return;\n  const int band = static_cast<int>(blockIdx.x % g.nbands);\n")],
    "fifth column in every warp": [(
        "    if (__any_sync(__activemask(), run.y > kCols)) {\n", "    if (true) {\n")],
    "W blend of one product (fl(wa ha))": [(
        "      const float v = blend(wca[j], ha[r], wcb[j], hb[r]);\n",
        "      const float v = __fmul_rn(wca[j], ha[r]);\n")],
    "max and class packed in 64 bits, one predicated mad.wide.u32": [
        ("__device__ __forceinline__ void take(float v, int k, float& best, int& arg) {\n"
         "  if (v > best) {  // strict: the first maximum wins\n    best = v;\n    arg = k;\n  }\n",
         "__device__ __forceinline__ void take(float v, unsigned long long kk,\n"
         "                                     unsigned long long& best) {\n"
         '  asm("{\\n.reg .pred p;\\n.reg .b32 lo, hi;\\nmov.b64 {lo, hi}, %0;\\n"\n'
         '      "setp.gt.f32 p, %1, lo;\\n@p mad.wide.u32 %0, %2, 1, %3;\\n}\\n"\n'
         '      : "+l"(best) : "f"(v), "r"(__float_as_uint(v)), "l"(kk));\n'),
        ("    float (&best)[kRows][kCols + 1], int (&arg)[kRows][kCols + 1]) {\n",
         "    unsigned long long (&best)[kRows][kCols + 1]) {\n"),
        ("  const float va1 = widen(a1 + k), vb1 = widen(b1 + k);\n",
         "  const float va1 = widen(a1 + k), vb1 = widen(b1 + k);\n"
         "  const unsigned long long kk = static_cast<unsigned long long>(k) << 32;\n"),
        ("        best[r][j] = v;\n        arg[r][j] = 0;\n",
         "        best[r][j] = __float_as_uint(v);\n"),
        ("        take(v, k, best[r][j], arg[r][j]);\n", "        take(v, kk, best[r][j]);\n"),
        ("  float best[kRows][kCols + 1];\n"
         "  tile_class<true, kFifth>(a0, b0, a1, b1, 0, wra, wrb, wca, wcb, best, arg);\n",
         "  unsigned long long best[kRows][kCols + 1] = {};\n"
         "  tile_class<true, kFifth>(a0, b0, a1, b1, 0, wra, wrb, wca, wcb, best);\n"),
        ("    tile_class<false, kFifth>(a0, b0, a1, b1, k, wra, wrb, wca, wcb, best, arg);\n  }\n",
         "    tile_class<false, kFifth>(a0, b0, a1, b1, k, wra, wrb, wca, wcb, best);\n  }\n"
         "#pragma unroll\n  for (int r = 0; r < kRows; ++r) {\n#pragma unroll\n"
         "    for (int j = 0; j <= kCols; ++j) arg[r][j] = static_cast<int>(best[r][j] >> 32);\n"
         "  }\n")],
}


def k1_parts():
    """What holds K1 back, on one card: K1 against copies of its source
    with one part taken out or changed (K1_PARTS), each built like the
    kernel and called through its C entry point on the plan's tables,
    timed in turns (forward, then reverse) at (4,129,129,21) and
    (16,129,129,21) -> 513^2, f32 and bf16; beside them a device copy of
    the f32 logits and a fill of the labels.  Prints one line."""
    import ctypes

    from zs3_tpu_torch.ops import eval_kernels as ek

    phase = "k1 parts"
    out_dir = os.path.join(SCRATCH, "k1_parts")
    libs = {}
    for name, so in build_variants(phase, [("kernel", [])] + list(K1_PARTS.items()), out_dir,
                                   "upsample_argmax"):
        lib = ctypes.CDLL(so)
        fn = lib.zs3_upsample_argmax
        fn.argtypes, fn.restype = ek._LIB._functions["zs3_upsample_argmax"]
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for bsz, dtype in ((4, torch.float32), (4, torch.bfloat16), (16, torch.float32)):
        shape, size = (bsz, 129, 129, 21), (513, 513)
        logits = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        layout, ints, floats = ek.card_plan(shape, size, True, dtype, torch.cuda.current_device())
        ngroups, nruns = len(layout["rows"].starts), len(layout["cols"].starts)
        out = torch.empty((bsz, *size), dtype=torch.int32, device="cuda")
        times = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                lib = libs[name]

                def call():
                    rc = lib.zs3_upsample_argmax(
                        logits.data_ptr(), int(dtype == torch.bfloat16), bsz, *shape[1:], *size,
                        ints.data_ptr(), ngroups, layout["groups_per_band"], floats.data_ptr(),
                        ints.data_ptr() + 16 * ngroups, nruns, floats.data_ptr() + 8 * size[0],
                        layout["threads"], layout["off_src"], layout["off_lab"],
                        layout["smem_bytes"], out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    check(rc == 0, phase, f"{name}: launch failed ({rc})")

                t = time_ms(call, what=name)
                times[name] = min(t, times.get(name, t))
        if dtype == torch.float32:
            copy = torch.empty_like(logits)
            times["copy of the logits"] = time_ms(lambda: copy.copy_(logits), what="copy")
            times["fill of the labels"] = time_ms(lambda: out.fill_(1), what="fill")
        result[f"{bsz} {str(dtype).split('.')[-1]}"] = times
    shutil.rmtree(out_dir, ignore_errors=True)
    emit(phase=phase, shape="(B,129,129,21)->513^2", best_of_2_ms=result)
    return result


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


def k4_tile_ms(lib, feats, w, b, tc):
    """K4's time at tile width tc (a launch the kernel takes, with the grid
    of its occupancy there; `plan` picks one of them), after checking that
    it writes the same bits as the launch `plan` picks."""
    from zs3_tpu_torch.ops import tail_kernels

    bsz, hi, wi, c = feats.shape
    k = w.shape[1]
    is_bf16 = int(feats.dtype == torch.bfloat16)
    size = (4 * (hi - 1) + 1, 4 * (wi - 1) + 1)
    items = bsz * (hi - 1) // 8 * max(1, -(-(wi - 1) // tc))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = min(items, sms * tail_kernels.resident_ctas(0, is_bf16, c, k, tc))
    out = torch.empty((bsz, *size, k), dtype=feats.dtype, device="cuda")

    def launch():
        rc = lib.zs3_classify_resize(
            feats.data_ptr(), is_bf16, bsz, hi, wi, c, w.data_ptr(), w.stride(0), w.stride(1),
            b.data_ptr(), k, tc, grid, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(rc == 0, "tail kernels", f"K4 at tile {tc}: {lib.zs3_cuda_error_string(rc)}")

    launch()
    want = tail_kernels.classify_resize(feats, w, b, size)
    check(torch.equal(out, want), "tail kernels", f"K4 at tile {tc} differs from plan's launch")
    return time_ms(launch, what=f"K4 at tile {tc}")


def traffic_ms(feats, size, k):
    """What the card's memory does with K4's traffic: a device-to-device
    copy of half its bytes (each byte read once and written once), a read
    of the features alone (a sum) and a write of the logits alone (a
    fill), as the library runs them."""
    logits = torch.empty((feats.shape[0], *size, k), dtype=feats.dtype, device="cuda")
    half = (feats.numel() + logits.numel()) * feats.element_size() // 2
    src = torch.empty(half, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return {
        "copy_ms": time_ms(lambda: dst.copy_(src), what="copy of K4's bytes"),
        "read_ms": time_ms(lambda: feats.sum(), what="read of K4's features"),
        "write_ms": time_ms(lambda: logits.zero_(), what="write of K4's logits"),
    }


def phase_tail():
    """K4 on the card against its plain version at the serve path's shapes
    (bf16, and f32 with TF32 off), the TTA shapes, the edge shapes of
    tests/test_pallas_tail.py, a C that is not a multiple of 4 or 8; its
    refusals; each launch's layout (route, tile, CTAs, shared memory, the
    latter equal to plan's); and its times beside the bound, the plain
    version and F.interpolate(F.conv2d(...)), with its host ms a call and,
    at the main path, what a copy, a read and a write of its bytes take."""
    import torch.nn.functional as F

    from zs3_tpu_torch.ops import tail_kernels
    from zs3_tpu_torch.ops.tail_kernels import classify_resize, classify_resize_reference

    lib = tail_kernels._LIB.get()
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ((1, 129, 129, 256, 21), bf16, True),   # one request
        ((8, 129, 129, 256, 21), bf16, True),   # serve batch 8, the main path
        ((1, 129, 129, 256, 21), f32, False),
        ((8, 129, 129, 256, 21), f32, True),
        ((4, 97, 97, 256, 21), bf16, True),     # TTA scale 0.75 (385x385 input)
        ((4, 161, 161, 256, 21), bf16, True),   # TTA scale 1.25 (641x641 input)
        ((2, 17, 17, 16, 5), f32, False),       # crop-65 geometry, odd class count
        ((1, 9, 9, 8, 21), f32, False),         # one band, clamped last row
        ((3, 17, 17, 32, 128), f32, False),     # K = 128
        ((2, 17, 23, 30, 21), f32, False),      # C = 30, W != H, ragged column tile
        ((2, 17, 17, 16, 7), bf16, False),      # tests/test_pallas_tail.py's bf16 case
        ((2, 17, 23, 30, 21), bf16, False),     # bf16 features TMA cannot describe
    ]
    timings = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for shape, dtype, timed in cases:
            feats, w, b = tail_inputs(gen, *shape, dtype)
            layout = tail_kernels.card_plan(shape[:4], shape[4], dtype, 0)
            c_smem = lib.zs3_classify_resize_smem(int(dtype == bf16), shape[3], shape[4],
                                                  layout["tile_cols"])
            check(c_smem == layout["smem_bytes"], "tail kernels",
                  f"{shape}: plan says {layout['smem_bytes']} bytes, the kernel {c_smem}")
            row = dict(phase="tail kernels", kernel="classify_resize", shape=list(shape),
                       dtype=str(dtype).split(".")[-1],
                       **check_k4(feats, w, b, f"{shape} {dtype}"),
                       **{f: layout[f] for f in ("route", "tile_cols", "items", "grid",
                                                 "ctas_per_sm", "smem_bytes")})
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
                    host_ms=host_ms(lambda: classify_resize(feats, w, b, size)),
                )
                row["tile_ms"] = {tc: k4_tile_ms(lib, feats, w, b, tc)
                                  for tc in tail_kernels.TILE_COLS}
                if shape[0] == SERVE_BATCH and dtype == bf16:
                    row.update(traffic_ms(feats, size, shape[4]))
                timings[(shape[0], shape[1], row["dtype"])] = row
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
        "shared memory": (ValueError, lambda: classify_resize(
            torch.zeros((1, 17, 17, 2048), dtype=bf16, device="cuda"),
            torch.zeros((2048, 128), device="cuda"), torch.zeros(128, device="cuda"),
            (65, 65))),
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


K4_BARS = [  # (shape, dtype) of K4's bars: the main path, one request, TTA, f32
    ((8, 129, 129, 256, 21), "bfloat16"), ((1, 129, 129, 256, 21), "bfloat16"),
    ((4, 97, 97, 256, 21), "bfloat16"), ((4, 161, 161, 256, 21), "bfloat16"),
    ((8, 129, 129, 256, 21), "float32"),
]
K4_TIMES = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from zs3_tpu_torch.ops.tail_kernels import classify_resize
gen = torch.Generator(device="cuda").manual_seed(3)
out = []
for shape, dtype in json.loads(sys.argv[1]):
    feats, w, b = c.tail_inputs(gen, *shape, getattr(torch, dtype))
    size = (4 * (shape[1] - 1) + 1, 4 * (shape[2] - 1) + 1)
    out.append(c.time_ms(lambda: classify_resize(feats, w, b, size), what=str(shape)))
print(json.dumps(out))
"""


K3_SHAPES = [[21, b, b, 256] for b in MMD_BUDGETS]  # the step's budgets, dx only
K2_TIMES = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from zs3_tpu_torch.ops import mmd_kernels as mk
from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS as sig
gen = torch.Generator(device="cuda").manual_seed(2)
out = []
for shape in json.loads(sys.argv[1]):
    x, y, wx, wy = c.mmd_inputs(gen, *shape, (10, 14))
    out.append(c.time_ms(lambda: mk.kernel_sum(x, y, wx, wy, sig),
                         reps=20 if shape[1] <= 512 else 3, what=str(shape)))
print(json.dumps(out))
"""
K3_TIMES = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from zs3_tpu_torch.ops import mmd_kernels as mk
from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS as sig
gen = torch.Generator(device="cuda").manual_seed(2)
out = []
for shape in json.loads(sys.argv[1]):
    x, y, wx, wy = c.mmd_inputs(gen, *shape, (10, 14))
    out.append(c.time_ms(lambda: mk.kernel_sum_grad(x, y, wx, wy, sig, with_dwx=False),
                         reps=20 if shape[1] <= 512 else 3, what=str(shape)))
print(json.dumps(out))
"""


def against(other_root: str, script: str, cases, phase: str):
    """A kernel of this checkout against the same kernel of another (a
    parent commit unpacked at `other_root`), on one card: each checkout
    times its own kernel at `cases` in a process of its own, in turns
    (other, this, this, other).  Prints one line: both checkouts' times,
    the best of each, the ratios."""
    here = os.path.dirname(os.path.abspath(__file__))
    times = {"other": [], "this": []}
    order = ["other", "this", "this", "other"]
    for name in order:
        root = other_root if name == "other" else here
        proc = subprocess.run([sys.executable, "-c", script, json.dumps(cases)], cwd=root,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, phase, f"{name}: {proc.stderr[-2000:]}")
        times[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    best = {name: [min(t) for t in zip(*runs)] for name, runs in times.items()}
    emit(phase=phase, other=os.path.relpath(other_root, here), cases=cases,
         order=order, runs=times, best_ms=best,
         speedup=[o / t for o, t in zip(best["other"], best["this"])])
    return best


def k4_against(other_root: str):
    """K4 of this checkout against another checkout's at K4_BARS, in turns."""
    return against(other_root, K4_TIMES, K4_BARS, "k4 against")


def k2_against(other_root: str):
    """K2 of this checkout against another checkout's at the step's three
    budgets (K3_SHAPES), x against y, in turns."""
    return against(other_root, K2_TIMES, K3_SHAPES, "k2 against")


def k3_against(other_root: str):
    """K3 (dx only) of this checkout against another checkout's at the
    step's three budgets (K3_SHAPES), in turns."""
    return against(other_root, K3_TIMES, K3_SHAPES, "k3 against")


# K3's source with one part taken out or changed, to time what each part
# costs (k3_parts): the substitutions apply to csrc/mmd_kernel_sum.cu.
K3_PARTS = {
    "x.y^T only (no C.y)": [(
        "    cy_tile<NTD>(acc, red, red + kTile * kRedPitch, yt, dp);\n", "")],
    "C.y only (no x.y^T)": [(
        "    dot_tile_3xtf32(dot, xs, yt, dp);\n",
        "    for (int a = 0; a < 8; ++a) dot[a / 4][a % 4] = 0.f;\n")],
    "one TF32 product (hi.hi)": [(
        "  mma_tf32(d, al, bh0, bh1);\n  mma_tf32(d, ah, bl0, bl1);\n", "")],
    "split by cvt.rna.tf32.f32": [(
        "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n",
        "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(v));\n"
        "  return r;\n")],
}


# K2's source with one part taken out or changed (k2_parts), as K3_PARTS.
K2_PARTS = {
    "no exponentials": [(
        "        if (e < sig.count) k += expf(d2 * sig.coef[e]);\n",
        "        if (e < sig.count) k += d2 * sig.coef[e];\n")],
    "no x.y^T": [(
        "    dot_tile_3xtf32(xy, xs, yt, dp);\n",
        "    for (int e = 0; e < 8; ++e) xy[e / 4][e % 4] = 0.f;\n")],
    "no x.y^T, no exponentials (the feed, norms and barriers)": [
        ("    dot_tile_3xtf32(xy, xs, yt, dp);\n",
         "    for (int e = 0; e < 8; ++e) xy[e / 4][e % 4] = 0.f;\n"),
        ("        if (e < sig.count) k += expf(d2 * sig.coef[e]);\n",
         "        if (e < sig.count) k += d2 * sig.coef[e];\n")],
    "one TF32 product (hi.hi)": K3_PARTS["one TF32 product (hi.hi)"],
    "split by truncation (hi = v & ~0x1fff, lo = v - hi as it is)": [(
        "  hi = tf32(v);\n  lo = tf32(v - __uint_as_float(hi));\n",
        "  hi = __float_as_uint(v) & 0xffffe000u;\n"
        "  lo = __float_as_uint(v - __uint_as_float(hi));\n")],
}


# The mma.sync TF32 ceiling K3's products run against: each warp issues
# `iters` rounds of 8 independent m16n8k8 products from registers.
MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void __launch_bounds__(256) mma_probe(float* out, int iters) {
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  const uint32_t b0 = 3 * threadIdx.x, b1 = 5 * threadIdx.x;
  float d[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int zs3_mma_probe(float* out, int blocks, int iters, void* stream) {
  mma_probe<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_source(phase: str, name: str, text: str, out_dir: str) -> str:
    """nvcc of one source text into out_dir/name.so, as cuda_build builds
    the kernels; the library's path."""
    from zs3_tpu_torch.ops import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    check(proc.returncode == 0, phase, f"{name}: {proc.stderr[-2000:]}")
    return so


def build_variants(phase: str, parts, out_dir: str, source: str = "mmd_kernel_sum"):
    """[(name, library)]: csrc/<source>.cu with each part's substitutions
    made, one nvcc per variant, all at once."""
    from zs3_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / f"{source}.cu").read_text()

    def build(item):
        i, (name, subs) = item
        text = src
        for old, new in subs:
            check(old in text, phase, f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        return name, build_source(phase, f"part{i}", text, out_dir)

    with ThreadPoolExecutor(len(parts)) as pool:
        return list(pool.map(build, enumerate(parts)))


def k3_parts():
    """What holds K3 back, on one card: K3 against copies of its source
    with one part taken out or changed (K3_PARTS), each built like the
    kernel and called through its C entry point, timed in turns (forward,
    then reverse) at (21,128,128,256) and (21,2048,2048,256), dx only;
    the kernel at each cluster size at (21,128,128,256); a device copy of
    the bytes K3 must move there (x and y read, dx written); and the
    mma.sync TF32 rate of MMA_PROBE, four CTAs an SM.  Prints one line."""
    import ctypes

    from zs3_tpu_torch.ops import mmd_kernels as mk
    from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS as sig

    phase = "k3 parts"
    out_dir = os.path.join(SCRATCH, "k3_parts")
    parts = [("kernel", [])] + list(K3_PARTS.items())
    with ThreadPoolExecutor(2) as pool:  # the probe beside the variants' nvccs
        probe = pool.submit(build_source, phase, "mma_probe", MMA_PROBE, out_dir)
        built = build_variants(phase, parts, out_dir)
        probe_so = probe.result()
    lib = ctypes.CDLL(probe_so)
    lib.zs3_mma_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    blocks, iters = 4 * torch.cuda.get_device_properties(0).multi_processor_count, 2048
    sink = torch.empty(blocks * 256, device="cuda")
    probe_ms = time_ms(lambda: lib.zs3_mma_probe(sink.data_ptr(), blocks, iters,
                                                 torch.cuda.current_stream().cuda_stream),
                       reps=5, what="mma probe")
    mma_tflops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8 / probe_ms / 1e9
    libs = {}
    for name, so in built:
        lib = ctypes.CDLL(so)
        fn = lib.zs3_mmd_kernel_sum_grad
        fn.argtypes, fn.restype = mk._LIB._functions["zs3_mmd_kernel_sum_grad"]
        libs[name] = lib
    sigmas = (ctypes.c_float * len(sig))(*sig)
    gen = torch.Generator(device="cuda").manual_seed(2)
    result = {}
    for shape in ([21, 128, 128, 256], [21, 2048, 2048, 256]):
        c, n, m, d = shape
        x, y, wx, wy = mmd_inputs(gen, c, n, m, d, (10, 14))
        dx = torch.empty_like(x)
        plan = mk.grad_plan(c, n, m, d)
        runs = [(name, plan["cluster"]) for name in libs]
        if n <= 128:
            runs += [("kernel", cl) for cl in (1, 2, 4) if cl != plan["cluster"]]
        times = {}
        for order in (runs, runs[::-1]):
            for name, cl in order:
                lib = libs[name]

                def call():
                    rc = lib.zs3_mmd_kernel_sum_grad(
                        x.data_ptr(), y.data_ptr(), wx.data_ptr(), wy.data_ptr(), c, n, m, d,
                        sigmas, len(sig), dx.data_ptr(), None, cl,
                        torch.cuda.current_stream().cuda_stream)
                    check(rc == 0, phase, f"{name}, cluster {cl}: launch failed ({rc})")

                key = name if cl == plan["cluster"] else f"{name}, cluster {cl}"
                t = time_ms(call, reps=20 if n <= 128 else 3, what=key)
                times[key] = min(t, times.get(key, t))
        if n <= 128:
            src_t, dst_t = torch.cat([x, y, x], 1), torch.empty_like(torch.cat([x, y, x], 1))
            times["copy of K3's bytes"] = time_ms(lambda: dst_t.copy_(src_t), what="copy")
        result[str(shape)] = times
    shutil.rmtree(out_dir, ignore_errors=True)
    emit(phase=phase, cluster_default="grad_plan", best_of_2_ms=result,
         mma_sync_tf32_tflops=mma_tflops)
    return result


def k2_parts():
    """What holds K2 back, on one card: K2 against copies of its source
    with one part taken out or changed (K2_PARTS), each built like the
    kernel and called through its C entry point, timed in turns (forward,
    then reverse) at (21,128,128,256) and (21,2048,2048,256), x against y;
    at (21,128,128,256) also the kernel at other splits, the symmetric
    call on x against itself, and a device copy of the bytes K2 must read
    there (x and y); beside each time, the largest relative error of the
    variant's sums against the plain version.  Prints one line."""
    import ctypes

    from zs3_tpu_torch.ops import mmd_kernels as mk
    from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS as sig

    phase = "k2 parts"
    out_dir = os.path.join(SCRATCH, "k2_parts")
    libs = {}
    for name, so in build_variants(phase, [("kernel", [])] + list(K2_PARTS.items()), out_dir):
        lib = ctypes.CDLL(so)
        fn = lib.zs3_mmd_kernel_sum
        fn.argtypes, fn.restype = mk._LIB._functions["zs3_mmd_kernel_sum"]
        libs[name] = lib
    sigmas = (ctypes.c_float * len(sig))(*sig)
    gen = torch.Generator(device="cuda").manual_seed(2)
    result, rel_errors = {}, {}
    for shape in ([21, 128, 128, 256], [21, 2048, 2048, 256]):
        c, n, m, d = shape
        x, y, wx, wy = mmd_inputs(gen, c, n, m, d, (10, 14))
        out = torch.empty(c, device="cuda")
        plan = mk.sum_plan(c, n, m, d)
        runs = [(name, plan["split"], False) for name in libs]
        if n <= 128:
            runs += [("kernel", k, False) for k in (4, 12, 16) if k != plan["split"]]
            runs += [("kernel", mk.sum_plan(c, n, m, d, True)["split"], True)]
        tickets = torch.zeros(c, dtype=torch.int32, device="cuda")
        partials = torch.empty(c * max(k for _, k, _ in runs), device="cuda")
        want = {sym: mk.kernel_sum_reference(x, x if sym else y, wx, wx if sym else wy, sig)
                for sym in (False, True)}
        times, errors = {}, {}
        for order in (runs, runs[::-1]):
            for name, k, sym in order:
                lib = libs[name]
                a, wa = (x, wx) if sym else (y, wy)

                def call():
                    rc = lib.zs3_mmd_kernel_sum(
                        x.data_ptr(), a.data_ptr(), wx.data_ptr(), wa.data_ptr(), c, n, m, d,
                        sigmas, len(sig), k, int(sym), tickets.data_ptr(), partials.data_ptr(),
                        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                    check(rc == 0, phase, f"{name}, split {k}: launch failed ({rc})")

                key = name if k == plan["split"] and not sym else f"{name}, split {k}"
                key += ", symmetric (x is y)" if sym else ""
                t = time_ms(call, reps=20 if n <= 128 else 3, what=key)
                times[key] = min(t, times.get(key, t))
                errors[key] = float(((out - want[sym]).abs()
                                      / want[sym].abs().clamp(min=1e-30)).max())
        if n <= 128:
            src_t = torch.cat([x, y], 1)
            dst_t = torch.empty_like(src_t)
            times["copy of K2's bytes"] = time_ms(lambda: dst_t.copy_(src_t), what="copy")
        result[str(shape)] = times
        rel_errors[str(shape)] = errors
    shutil.rmtree(out_dir, ignore_errors=True)
    emit(phase=phase, split_default="sum_plan", best_of_2_ms=result, max_rel_err=rel_errors)
    return result


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


def library_block(params, dtype):
    """The yardstick's weights: the folded weights as OIHW conv kernels and
    biases, cast to `dtype` once."""
    w1, b1, w2, b2, w3, b3 = params
    kernels = (w1.t()[:, :, None, None], w2.permute(3, 2, 0, 1), w3.t()[:, :, None, None])
    return [t.to(dtype).contiguous() for t in (*kernels, b1, b2, b3)]


def unfused_block(x_nchw, lib, d):
    """The block as three cuDNN convolutions with the folded weights of
    `library_block` (the library yardstick), NCHW channels_last in and
    out."""
    import torch.nn.functional as F

    k1, k2, k3, b1, b2, b3 = lib
    y = torch.relu(F.conv2d(x_nchw, k1, b1))
    y = torch.relu(F.conv2d(y, k2, b2, padding=d, dilation=d))
    return torch.relu(F.conv2d(y, k3, b3) + x_nchw)


K5_EDGES = (  # (shape, planes, dilation): small and ragged cases against the plain version
    ((1, 33, 33, 1024), 256, 1),  # B = 1
    ((2, 7, 9, 256), 64, 1),  # a 7 x 9 image: ragged M tiles and rows
    ((2, 7, 9, 512), 128, 2),
    ((1, 5, 5, 2048), 512, 8),  # every tap but the centre leaves the image
)


def k5_random_block(gen, c, p):
    """Folded-block weights at the scale of a trained trunk's (std 1/sqrt(fan-in))."""
    mk = lambda *s, fan: torch.randn(s, device="cuda", generator=gen) / fan ** 0.5
    return (mk(c, p, fan=c), 0.1 * mk(p, fan=1), mk(3, 3, p, p, fan=9 * p), 0.1 * mk(p, fan=1),
            mk(p, c, fan=p), 0.1 * mk(c, fan=1))


def phase_k5_edges():
    """K5 against its plain version on small and ragged shapes (K5_EDGES),
    bf16 within 4 ulps of the pixel's largest |output| and f32 (TF32 off)
    within 1e-5 of the largest |output|; then bf16 widths off 64 must be
    refused before any launch."""
    from zs3_tpu_torch.ops import bottleneck as plain
    from zs3_tpu_torch.ops import bottleneck_kernels as k5

    phase = "bottleneck edges"
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            for shape, p, d in K5_EDGES:
                params = k5_random_block(gen, shape[-1], p)
                x = torch.randn(shape, device="cuda", generator=gen)
                xb = x.bfloat16()
                got = k5.fused_bottleneck(xb, *params, dilation=d).float()
                want = plain.fused_bottleneck(xb, *params, dilation=d).float()
                ulps = float(((got - want).abs()
                              / bf16_ulp(want.abs().amax(-1, keepdim=True))).max())
                got32 = k5.fused_bottleneck(x, *params, dilation=d)
                want32 = plain.fused_bottleneck(x, *params, dilation=d)
                scale = float(want32.abs().max())
                err32 = float((got32 - want32).abs().max())
                torch.cuda.synchronize()
                check(ulps <= 4, phase, f"{shape} P={p} d={d} bf16: {ulps} ulps off the plain")
                check(err32 <= 1e-5 * scale, phase,
                      f"{shape} P={p} d={d} f32: {err32} off the plain (max |out| {scale})")
                rows.append({"shape": list(shape), "planes": p, "dilation": d,
                             "bf16_plain_ulps": ulps, "f32_plain_abs": err32,
                             "f32_max_abs_out": scale})
    finally:
        torch.backends.cudnn.allow_tf32 = True
    refused = []
    before = k5.fused_bottleneck.launches
    for c, p in ((96, 64), (256, 48)):
        x = torch.randn((1, 9, 9, c), device="cuda", generator=gen).bfloat16()
        try:
            with torch.inference_mode():
                k5.fused_bottleneck(x, *k5_random_block(gen, c, p), dilation=1)
        except ValueError as e:
            refused.append(f"C={c} P={p}: {e}")
        else:
            fail(phase, f"bf16 C={c} P={p} was not refused")
    check(k5.fused_bottleneck.launches == before, phase, "a refused call counted a launch")
    emit(phase=phase, check="small and ragged shapes, bf16 and f32", blocks=rows,
         bounds={"bf16_plain_ulps": 4, "f32_plain": 1e-5}, refused=refused)


def phase_bottleneck(model=None, images=None):
    """K5 on a trunk's identity blocks (layerN[1:] of R101: 29 blocks) in
    eval mode, on the activations that enter them at eval batch 4 and
    513x513.  Each block against the plain version on the same input (bf16:
    within 4 bf16 ulps of the pixel's largest |output|; f32 with TF32 off:
    within 1e-5 of the largest |output|) and against the trunk's own block
    (cuDNN convs, BN, ReLU; bf16 within 2^-4 of the pixel's largest
    |output|, f32 within 1e-4 of the block's), then the 29-launch pass of
    the fused stages with the counts from 0, then times: one block of each
    stage shape (layer4 at d = 4 and d = 8) and the whole 29-block pass.
    K5 is timed on weights packed once (`pack_block`) and the cuDNN
    yardstick on weights cast to bf16 once (`library_block`), so neither
    time holds a per-call cast; beside each device time, the host's own
    time for one call (`host_ms`: what the host pays to queue it)."""
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

    # Times per stage shape: the stage's first identity block, and
    # layer4's second (d = 8) as its own row.
    timed = [(layer, layer, 1) for layer, _, _ in K5_STAGES] + [("layer4.d8", "layer4", 2)]
    shapes = {layer: (shape, planes) for layer, shape, planes in K5_STAGES}
    with torch.inference_mode():
        for name, layer, i in timed:
            block = getattr(backbone, layer)[i]
            params = plain.fold_bottleneck(block)
            d = block.conv2.dilation[0]
            x_nchw = inputs[(layer, i)]
            x = x_nchw.permute(0, 2, 3, 1)
            shape, planes = shapes[layer]
            packed = k5.pack_block(params, x.dtype)
            lib = library_block(params, x.dtype)
            row = {"shape": list(shape), "planes": planes, "dilation": d, "dtype": "bfloat16",
                   "plan": k5.plan(shape, planes, d, x.dtype, *k5.resident_ctas(0))}
            row.update(zip(("bound_ms", "bound_by"), k5_bound(*shape, planes, x.dtype)))
            row.update(
                kernel_ms=time_ms(lambda: k5.fused_bottleneck(x, packed, dilation=d),
                                  what=f"K5 {name}"),
                plain_ms=time_ms(lambda: plain.fused_bottleneck(x, *params, dilation=d),
                                 reps=5, what=f"K5 plain {name}"),
                library_ms=time_ms(lambda: unfused_block(x_nchw, lib, d),
                                   what=f"K5 library {name}"),
            )
            row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
            row["kernel_host_ms"] = host_ms(lambda: k5.fused_bottleneck(x, packed, dilation=d))
            row["library_host_ms"] = host_ms(lambda: unfused_block(x_nchw, lib, d))
            timings[name] = row
            emit(phase=phase, stage=name, **row)

        # The whole pass: 29 launches over the four stages against the same
        # 29 blocks as cuDNN convolutions, each stage from its first input.
        stages = []
        for layer, shape, planes in K5_STAGES:
            blocks = list(getattr(backbone, layer))[1:]
            folded = [plain.fold_bottleneck(b) for b in blocks]
            stages.append((inputs[(layer, 1)], [b.conv2.dilation[0] for b in blocks],
                           [k5.pack_block(f, model.compute_dtype) for f in folded],
                           [library_block(f, model.compute_dtype) for f in folded]))

        def k5_pass():
            for x_nchw, dils, packed, _ in stages:
                k5.fused_stage(x_nchw.permute(0, 2, 3, 1), packed, dils)

        def library_pass():
            for x_nchw, dils, _, libs in stages:
                y = x_nchw
                for lib, d in zip(libs, dils):
                    y = unfused_block(y, lib, d)

        bound = sum(k5_bound(*shape, planes, model.compute_dtype)[0] * (len(
            getattr(backbone, layer)) - 1) for layer, shape, planes in K5_STAGES)
        # One pass a timed call: five of cuDNN's would queue some 1,000
        # kernels, past what the launch queue holds ahead of the sleep.
        whole = {"blocks": 29, "kernel_ms": time_ms(k5_pass, reps=1, what="K5 whole pass"),
                 "library_ms": time_ms(library_pass, reps=1, what="K5 library whole pass"),
                 "kernel_host_ms": host_ms(k5_pass), "library_host_ms": host_ms(library_pass),
                 "bound_ms": bound}
        timings["whole_pass"] = whole
        emit(phase=phase, stage="whole pass", **whole)
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

    # Eval images/s over device batches: 3 windows of 100 batches (host
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
    MEASURED["eval"] = {"images_per_sec": images_per_sec,
                        "device_ms_per_image": device_ms_per_image}
    # The model's bf16 logits reach K1 as they are: no cast kernel between
    # the classifier and K1.
    before = kernels_before(lambda: step(model, batches[0]), "upsample_argmax")
    check(bool(before) and "copy" not in before[-1].lower(), "profile",
          f"a copy kernel runs right before K1: {before}")
    emit(phase="profile", check="no cast launch before K1", kernels_before_k1=before, ok=True)

    # One batch with TF32 off: K1 against the plain version on the same logits.
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            first = batches[0]["image"]
            logits = model.classify(model.forward_features(first)).contiguous()
            size = tuple(first.shape[1:3])
            ties = {}
            for name, x in (("model", logits), ("float32", logits.float())):
                got = eval_kernels.upsample_argmax(x, size)
                want = eval_kernels.upsample_argmax_reference(x, size)
                ties[name], _ = compare_labels(got, want, x, size, "slice",
                                               f"tf32-off batch, {name} logits")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    emit(phase="slice", check="tf32-off batch, K1 vs plain", logits_dtype=str(logits.dtype),
         near_ties=ties, pixels=got.numel(), ok=True)
    return launches


def kernels_before(fn, name: str, n: int = 3):
    """The names of the `n` device kernels that ran right before the first
    whose name holds `name`, in one traced fn() (after one untraced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    names = [e.name for e in kernels]
    first = next((i for i, k in enumerate(names) if name in k), None)
    return [] if first is None else [k[:120] for k in names[max(0, first - n):first]]


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
    MEASURED["serve"] = {"requests_per_sec": 64 / wall,
                         "latency_p50_ms": 1e3 * percentile(latencies, 50),
                         "latency_p99_ms": 1e3 * percentile(latencies, 99)}
    emit(phase=phase, command="python -m zs3_tpu_torch.cli " + " ".join(SERVE_ARGS),
         requests=64, client_threads=16, setup_seconds_with_warmup=setup_s,
         requests_per_sec=64 / wall, requests_per_sec_windows=window_rates,
         latency_p50_ms=1e3 * percentile(latencies, 50),
         latency_p99_ms=1e3 * percentile(latencies, 99),
         sliding_ms=[1e3 * r[2] for r in sliding], batch_groups=batcher.groups,
         batch_sizes=sizes, sliding_windows_per_image=windows, launches=launches,
         fused_vs_standard=agree)

    # Predictor.predict_batch images/s on 8 letterboxed images, standard
    # tail and fused tail in turns (off, on, on, off), 3 windows of 5 calls.
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


def k3_design_bound(c, n, m, d, s):
    """(least time in ms, what bounds it) for K3 (dx only) in its own
    arithmetic: the two products (2D each per pair) as three TF32 products
    each at the TF32 tensor-core rate, the rest of a pair (5S + 8: d2, the
    exponentials, C, K, the row sums) at the f32 rate beside them, and
    mmd_bounds's bytes; the largest of the three."""
    pairs = c * n * m
    times = {
        "bytes": 4 * c * (n * d + m * d + n + m + n * d) / HBM_BYTES_PER_S,
        "tensor operations": pairs * 3 * 4 * d / TF32_FLOPS_PER_S,
        "operations": pairs * (5 * s + 8) / F32_FLOPS_PER_S,
    }
    by = max(times, key=times.get)
    return 1e3 * times[by], by


SFU_EXP_PER_SM_CLOCK = 16  # H100: MUFU ex2 results an SM gives each clock


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi's clocks.max.sm), in Hz."""
    if not hasattr(sm_clock_hz, "hz"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        sm_clock_hz.hz = 1e6 * float(smi)
    return sm_clock_hz.hz


def k2_design_bound(c, n, m, d, s):
    """(least time in ms, what bounds it) for K2 in its own arithmetic: the
    x.y^T product (2D per pair) as three TF32 products at the TF32
    tensor-core rate, the S exponentials a pair on the SFU (16 an SM a
    clock, at the card's highest SM clock), the rest of a pair (d2, the
    scales and sums, the weights: 2S + 6) at the f32 rate, and
    mmd_bounds's bytes; the largest of the four."""
    pairs = c * n * m
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {
        "bytes": 4 * c * (n * d + m * d + n + m + 1) / HBM_BYTES_PER_S,
        "tensor operations": pairs * 3 * 2 * d / TF32_FLOPS_PER_S,
        "exponentials": pairs * s / (SFU_EXP_PER_SM_CLOCK * sms * sm_clock_hz()),
        "operations": pairs * (2 * s + 6) / F32_FLOPS_PER_S,
    }
    by = max(times, key=times.get)
    return 1e3 * times[by], by


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
    sym = {}
    if x is y and wx is wy:  # K2 over the tile pairs a <= b, as KernelSum calls it
        half = mk.kernel_sum(x, y, wx, wy, sig, symmetric=True)
        half2 = mk.kernel_sum(x, y, wx, wy, sig, symmetric=True)
        torch.cuda.synchronize()
        check(bool(((half - want).abs() <= 1e-4 * want.abs()).all()), phase,
              f"{what}: symmetric K2 {half.tolist()[:4]} vs plain {want.tolist()[:4]}")
        check(torch.equal(half, half2), phase, f"{what}: a second symmetric call gave other bits")
        sym = {"k2_symmetric_max_abs_err": float((half - want).abs().max()),
               "k2_symmetric_max_rel_err":
                   float(((half - want).abs() / want.abs().clamp(min=1e-30)).max())}
    return {
        **sym,
        "k2_max_abs_err": float((got - want).abs().max()),
        "k2_max_rel_err": float(((got - want).abs() / want.abs().clamp(min=1e-30)).max()),
        "k3_dx_max_abs_err": float(err_dx.max()),
        "k3_dx_outside_plain_tol": int((err_dx > plain_tol).sum()),
        "k3_dwx_max_abs_err": float((dwx - want_dwx).abs().max()),
    }


def phase_mmd(timed: bool = True):
    """K2 and K3 on the card against their plain versions (f32, TF32
    off), K2's symmetric call where x is y, K2's and K3's plans against
    the library's, the batched loss and its gradient on KernelSum against
    the plain oracle with autograd, and (when `timed`) times at budgets
    128, 512 and 2048."""
    from zs3_tpu_torch.ops import mmd_kernels as mk
    from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS as sig
    from zs3_tpu_torch.ops.mmd import batched_mmd_loss

    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default: f32 products
    lib = mk._LIB.get()
    plans = {}
    for d in (16, 30, 64, 256, 512):
        check(lib.zs3_mmd_grad_smem(d) == mk.grad_smem_bytes(d), "mmd kernels",
              f"K3 shared memory at D={d}: kernel {lib.zs3_mmd_grad_smem(d)}, "
              f"plan {mk.grad_smem_bytes(d)}")
        # sum_plan's shared memory and CTAs an SM against the kernel's own.
        plan = mk.sum_plan(21, 128, 128, d)
        plans[d] = {"plan_smem_bytes": plan["smem_bytes"],
                    "kernel_smem_bytes": lib.zs3_mmd_sum_smem(d),
                    "plan_ctas_per_sm": plan["ctas_per_sm"],
                    "occupancy_ctas_per_sm": lib.zs3_mmd_sum_ctas_per_sm(d)}
        check(plans[d]["plan_smem_bytes"] == plans[d]["kernel_smem_bytes"]
              and plans[d]["plan_ctas_per_sm"] == plans[d]["occupancy_ctas_per_sm"],
              "mmd kernels", f"K2 at D={d}: plan against kernel {plans[d]}")
    emit(phase="mmd kernels", case="K2's sum_plan against the kernel", by_d=plans)
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
    x, _, wx, _ = mmd_inputs(gen, 21, 128, 128, 256, (10, 14, 3))
    errors["main path, x is y"] = check_k2_k3(x, x, wx, wx, "main path, x is y")
    emit(phase="mmd kernels", case="main path, x is y (the fake-fake and real-real sums)",
         shape=[21, 128, 128, 256], **errors["main path, x is y"])

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
    if not timed:
        return errors, {}

    timings = {}
    for budget in MMD_BUDGETS:
        x, y, wx, wy = mmd_inputs(gen, 21, budget, budget, 256, (10, 14))
        fake = x.clone().requires_grad_(True)
        fm = torch.ones_like(wx)
        bounds = mmd_bounds(21, budget, budget, 256, len(sig))
        plan = mk.grad_plan(21, budget, budget, 256)
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
        row["K2"]["design_bound_ms"], row["K2"]["design_bound_by"] = k2_design_bound(
            21, budget, budget, 256, len(sig))
        row["K2"]["host_ms"] = host_ms(lambda: mk.kernel_sum(x, y, wx, wy, sig))
        k2_plan = mk.sum_plan(21, budget, budget, 256)
        row["K2"]["plan"] = {k: k2_plan[k] for k in ("split", "ctas", "pairs_per_cta",
                                                     "smem_bytes")}
        row["K2"]["plan"]["ctas_per_sm"] = lib.zs3_mmd_sum_ctas_per_sm(256)
        # x against itself, as the fake-fake and real-real sums: over the
        # tile pairs a <= b (as KernelSum calls it), and over every pair.
        row["K2"]["x_is_y"] = {
            "symmetric_ms": time_ms(lambda: mk.kernel_sum(x, x, wx, wx, sig, symmetric=True),
                                    reps=reps, what=f"K2 symmetric {budget}"),
            "every_pair_ms": time_ms(lambda: mk.kernel_sum(x, x, wx, wx, sig),
                                     reps=reps, what=f"K2 x is y {budget}"),
            "symmetric_plan": {k: v for k, v in mk.sum_plan(21, budget, budget, 256, True).items()
                               if k in ("split", "ctas", "pairs_per_cta")},
        }
        row["K3"]["design_bound_ms"], row["K3"]["design_bound_by"] = k3_design_bound(
            21, budget, budget, 256, len(sig))
        row["K3"]["host_ms"] = host_ms(
            lambda: mk.kernel_sum_grad(x, y, wx, wy, sig, with_dwx=False))
        row["K3"]["plan"] = {k: plan[k] for k in ("ctas", "cluster", "smem_bytes")}
        row["K3"]["plan"]["ctas_per_sm"] = lib.zs3_mmd_grad_ctas_per_sm(256)
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


MMD_KERNEL_NAMES = ("kernel_sum_3xtf32", "kernel_sum_grad_3xtf32")


def mmd_kernel_ms(prof) -> float:
    """Device ms of K2's and K3's kernels in a profile_device summary;
    fails unless each name of MMD_KERNEL_NAMES matched a kernel (a renamed
    kernel would drop out of the sum)."""
    names = [e["name"] for e in prof["kernels"]]
    missing = [k for k in MMD_KERNEL_NAMES if not any(k in n for n in names)]
    check(not missing, "zs3 profile", f"no profiled kernel named {missing}")
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

    time_zs3_step(trainer, phase, "zs3 profile")
    return launches


def time_zs3_step(trainer, phase: str, profile_phase: str):
    """On a trainer `cli.run` returned (ZS3, ZS5 or graph-context): its
    step's rate over device batches, and its device time, whole and by
    stage (the graph branch a stage of its own)."""
    from zs3_tpu_torch.train.seen import device_batch
    from zs3_tpu_torch.utils.profiling import profile_device

    # Steps/s over device batches: 3 windows of 50 steps (host clock,
    # each ending in a synchronize), the host's own ms per step, and the
    # host syncs in one step (none, or host_ms would include device time).
    host_batches = [b for _, b in zip(range(ZS3_STEPS), trainer.train_loader)]
    batches = [device_batch(b, torch.device("cuda")) for b in host_batches]
    turn = itertools.cycle(batches)
    step_index = itertools.count(trainer.global_step)

    def one_step():
        trainer.step(next(turn), step=next(step_index))

    def one_pass():
        for batch in batches:
            trainer.step(batch, step=next(step_index))

    before = _params(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_per_sec, window_rates = rate_windows(one_step, calls=50)
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
    check(prof["device_busy_ms"] > 0, profile_phase, "the profiler saw no device time")
    step_ms = prof["device_busy_ms"] / (2 * len(batches))
    mmd_ms = mmd_kernel_ms(prof)
    step = trainer.step
    first = batches[0]
    feats, labels = step.features(first)
    u, noise1, noise2 = step.draw(labels.shape[0], 0)
    real, real_mask, pix_idx = step.sample(feats, labels, u, return_indices=True)
    grid = labels.shape[0] // first["label"].shape[0]
    context = step.context(first["label"], pix_idx, real_mask, grid) if step.graph_context else None
    stages = {
        "trunk": lambda: step.features(first),
        "draws": lambda: step.draw(labels.shape[0], 0),
        "sampling": lambda: step.sample(feats, labels, u, return_indices=step.graph_context),
    }
    if step.graph_context:  # adjacency, neighbour lists and their gathers
        stages["graph"] = lambda: step.context(first["label"], pix_idx, real_mask, grid)
    stages["generator_update"] = lambda: step.generator_update(real, real_mask, noise1, context)
    stages["classifier_update"] = lambda: step.classifier_update(real, real_mask, noise2, context)
    split, graph_kernels = {}, None
    for name, fn in stages.items():
        p = profile_device(fn, steps=4)
        split[name] = p["device_busy_ms"] / 4
        if name == "generator_update":
            split["of_which_k2_k3"] = mmd_kernel_ms(p) / 4
        if name == "graph":
            graph_kernels = p["kernels"][:8]
    prof["kernels"], prof["ops"] = prof["kernels"][:15], prof["ops"][:15]
    if graph_kernels:
        prof["graph_kernels"] = graph_kernels
    MEASURED[profile_phase] = {"steps_per_sec": steps_per_sec, "device_ms_per_step": step_ms,
                               "trunk_device_ms": split["trunk"]}
    emit(phase=profile_phase, steps_per_pass=len(batches), device_ms_per_step=step_ms,
         k2_k3_device_ms_per_step=mmd_ms / (2 * len(batches)),
         host_ms_per_step=host_ms_per_step, stage_device_ms=split,
         idle_share_untraced=1.0 - step_ms * steps_per_sec / 1e3, **prof)


def step_mmd_inputs(trainer):
    """(fake, real, fake_mask, real_mask) of the trainer's generator MMD on
    its first train batch: the inputs its step hands K2 and K3."""
    from zs3_tpu_torch.train.gmmn import mmd_training_masks
    from zs3_tpu_torch.train.seen import device_batch, preprocess_on_device

    step = trainer.step
    batch = device_batch(next(iter(trainer.train_loader)), torch.device("cuda"))
    if step.device_preprocess:
        batch = preprocess_on_device(batch, step.seed, 0)
    feats, labels = step.features(batch)
    u, noise1, _ = step.draw(labels.shape[0], 0)
    real, real_mask, pix_idx = step.sample(feats, labels, u, return_indices=True)
    context = None
    if step.graph_context:
        grid = labels.shape[0] // batch["label"].shape[0]
        context = step.context(batch["label"], pix_idx, real_mask, grid)
    with torch.no_grad():
        fake = step.generate(noise1, context).contiguous()
    fake_mask, mmd_real_mask = mmd_training_masks(real_mask, step.seen_mask, step.self_training)
    return fake, real.contiguous(), fake_mask.contiguous(), mmd_real_mask.contiguous()


def phase_graph():
    """`cli train-gmmn --graph-context` at full width: the launches of
    phase_zs3, a GraphContextGMMN trained, K2/K3 against their plain
    versions on the step's own inputs, then the step timed and split by
    stage."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.models.gmmn import GraphContextGMMN

    phase = "graph slice"
    reset_counts()
    t0 = time.time()
    result, trainer = cli.run(GRAPH_ARGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    eval_batches = len(trainer.val_loader)
    want = {"K1": eval_batches, "K2": 3 * ZS3_STEPS, "K3": 2 * ZS3_STEPS, "K4": 0, "K5": 0}
    check(launches == want, phase,
          f"launches {launches} for {ZS3_STEPS} steps and {eval_batches} eval batches")
    check(isinstance(trainer.generator, GraphContextGMMN) and trainer.step.graph_context, phase,
          f"the generator is a {type(trainer.generator).__name__}")
    check(all(is_finite(v) for k, v in result.items() if k != "epoch"), phase,
          f"non-finite results {result}")
    check(result["mmd"] > 0, phase, f"mmd {result['mmd']} is not positive")
    check({"seen_miou", "unseen_miou", "harmonic_miou"} <= result.keys(), phase,
          "seen/unseen/harmonic mIoU missing")
    emit(phase=phase, command="python -m zs3_tpu_torch.cli " + " ".join(GRAPH_ARGS),
         result=result, launches=launches, steps=ZS3_STEPS,
         eval_batches=eval_batches, wall_seconds_with_setup=wall)
    errors = check_k2_k3(*step_mmd_inputs(trainer), "graph step")
    emit(phase=phase, check="K2/K3 on the graph step's inputs against their plain versions",
         **errors, ok=True)
    time_zs3_step(trainer, phase, "graph profile")
    return launches


REFERENCE_ARGS = ["train-gmmn", "--dataset", "synthetic", "--backbone", "resnet50",
                  "--crop-size", "65", "--base-size", "65", "--batch-size", "8",
                  "--compute-dtype", "float32", "--unseen-split", "2"]


def reference_config(graph: bool = False, self_training: bool = False):
    """The reference phases' config (ResNet-50 at 65x65, f32); ZS5's as
    ZS5Trainer makes it (a weak-label dir keeps the unseen images)."""
    from zs3_tpu_torch import cli

    argv = [*REFERENCE_ARGS, *(["--graph-context"] if graph else [])]
    cfg = cli.build_config(cli.make_parser().parse_args(argv))
    if self_training:
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, weak_label_dir=os.path.join(SCRATCH, "weak")),
            gmmn=dataclasses.replace(cfg.gmmn, self_training=True))
    return cfg


def phase_zs3_reference(phase: str = "zs3 reference", graph: bool = False,
                        self_training: bool = False):
    """One ZS3 step (graph-conditioned, or ZS5's) on the card against the
    same step on the CPU: same weights, batch and draws; ResNet-50 at
    65x65, f32, TF32 off.  mmd and cls_ce to rtol 1e-4, gradients to rtol
    1e-3 with an atol of 1e-4 of the tensor's largest entry, updated
    params to 1e-6 where |g| > 1e-3 max|g| (Adam's first step is +-lr,
    whatever |g|)."""
    import copy

    from zs3_tpu_torch.data.loader import make_train_loader
    from zs3_tpu_torch.data.synthetic import synthetic_class_embeddings
    from zs3_tpu_torch.models.gmmn import build_gmmn, init_gmmn
    from zs3_tpu_torch.train.gmmn import ZS3Step, extract_classifier
    from zs3_tpu_torch.train.seen import build_eval_model, device_batch

    cfg = reference_config(graph, self_training)
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
    draws = cpu_step.draw(labels.shape[0], 0)
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
    check(gpu_step.graph_context == graph and gpu_step.self_training == self_training, phase,
          "the step is not the asked variant")
    emit(phase=phase, mmd=float(got["mmd"]), cpu_mmd=float(want["mmd"]),
         cls_ce=float(got["cls_ce"]), cpu_cls_ce=float(want["cls_ce"]),
         grad_max_err_over_max_grad=worst,
         unseen_pixels_in_batch=int(sum((batch["label"] == c).sum()
                                        for c in cfg.data.unseen_classes)), ok=True)


def phase_graph_reference():
    phase_zs3_reference("graph reference", graph=True)


def phase_zs5_reference():
    """The ZS5 step on the card against the CPU (phase_zs3_reference), then
    the pseudo-labels of the same seeded network on both: the same PNGs,
    labels that differ only at near-ties of the CPU's restricted logits."""
    import numpy as np
    from PIL import Image

    from zs3_tpu_torch.data.loader import make_train_loader
    from zs3_tpu_torch.data.transforms import normalize
    from zs3_tpu_torch.train.seen import build_eval_model
    from zs3_tpu_torch.train.self_training import _gt_view, generate_pseudo_labels

    phase = "zs5 reference"
    phase_zs3_reference(phase, self_training=True)
    cfg = reference_config(self_training=True)
    loader, n = make_train_loader(cfg.data)
    base = _gt_view(loader.dataset)
    unseen = list(cfg.data.unseen_classes)
    size = cfg.data.crop_size
    dirs = {dev: os.path.join(SCRATCH, f"pseudo_{dev}") for dev in ("cpu", "cuda")}
    models = {dev: build_eval_model(cfg, dev) for dev in dirs}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        written = {dev: generate_pseudo_labels(models[dev], base, unseen, dirs[dev], size=size)
                   for dev in dirs}
    finally:
        torch.backends.cudnn.allow_tf32 = True
    names = sorted(os.listdir(dirs["cpu"]))
    check(written["cpu"] == written["cuda"] == len(names) > 0
          and names == sorted(os.listdir(dirs["cuda"])), phase, f"PNGs written: {written}")
    by_name = {base.names[i]: i for i in range(len(base))}
    differ = ties_total = 0
    for name in names:
        sample = base[by_name[name[:-4]]]
        got = torch.from_numpy(np.asarray(Image.open(os.path.join(dirs["cuda"], name))))
        want = torch.from_numpy(np.asarray(Image.open(os.path.join(dirs["cpu"], name))))
        gt = np.asarray(sample["label"])
        allowed = torch.ones(n, dtype=torch.bool)
        allowed[unseen] = False
        allowed[np.intersect1d(np.unique(gt), unseen).tolist()] = True
        image = torch.from_numpy(normalize(sample)["image"])[None]  # square: no letterbox
        with torch.inference_mode():
            cpu_model = models["cpu"]
            logits = cpu_model.classify(cpu_model.forward_features(image)).float()
            logits = torch.where(allowed, logits, torch.finfo(torch.float32).min)
        unlabelled = torch.from_numpy(np.isin(gt, unseen))
        diff = (got != want) & unlabelled
        ties = near_ties(logits, (size, size))[0]
        check(bool((got == want)[~unlabelled].all()), phase, f"{name}: labelled pixels differ")
        check(not bool((diff & ~ties).any()), phase,
              f"{name}: {int((diff & ~ties).sum())} labels differ outside near-ties")
        differ += int(diff.sum())
        ties_total += int((ties & unlabelled).sum())
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    emit(phase=phase, check="pseudo-labels, card against CPU", images=len(names),
         pixels_differing=differ, near_tie_pixels=ties_total, ok=True)


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
    trainer it ran, its steps/s over 3 windows of 10 steps on batches on
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

    # Steps/s over batches on the card: 3 windows of 10 steps (host clock,
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

    MEASURED["seen"] = {"steps_per_sec": steps_per_sec, "device_ms_per_step": step_ms}
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
    <seen checkpoint>`; both checkpoints reload to bit-equal tensors.  Then
    `train-zs5 --resume <seen checkpoint>` (phase_zs5); returns its
    launches and K1's numbers on its pseudo-label pass."""
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
    MEASURED["gmmn_checkpoint"] = gmmn_ckpt  # phase_export exports its classifier
    gmmn = Saver.restore(gmmn_ckpt)
    same(gmmn["gen"], trainer.generator.state_dict(), "gmmn checkpoint: generator")
    same(gmmn["cls"], {k: v.detach() for k, v in trainer.step.cls.items()},
         "gmmn checkpoint: classifier")
    # The draws of step 1, and of step 2 as the uninterrupted run takes it,
    # for one batch's pixels at the feature grid.
    pixels = 8 * 129 * 129
    first_draws = trainer.step.draw(pixels, 0)
    second_draws = trainer.step.draw(pixels, trainer.global_step)
    del trainer
    trainer, _ = stage("evaluate-gmmn", ["evaluate-gmmn", *common, "--gmmn-resume", gmmn_ckpt])
    same(gmmn["gen"], trainer.generator.state_dict(), "evaluate-gmmn's generator")
    check(trainer.global_step == gmmn["step"] == 1, phase, "evaluate-gmmn's step")
    resumed_draws = trainer.step.draw(pixels, trainer.global_step)
    check(all(torch.equal(a, b) for a, b in zip(resumed_draws, second_draws)), phase,
          "the resumed run's next draws are not the uninterrupted run's second")
    check(not any(torch.equal(a, b) for a, b in zip(resumed_draws, first_draws)), phase,
          "the resumed run draws step 1's scores or noise again")
    stages["evaluate-gmmn"]["resumed_draws_are_step_2s"] = True
    del first_draws, second_draws, resumed_draws
    del trainer
    trainer, _ = stage("evaluate", ["evaluate", *common])
    same(Saver.restore(seen_ckpt)["model"], trainer.model.state_dict(), "evaluate's model")
    check(trainer.step == SEEN_STEPS, phase, f"evaluate resumed at step {trainer.step}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase=phase, seen_checkpoint=os.path.relpath(seen_ckpt), stages=stages, ok=True)
    return phase_zs5(seen_ckpt)


def zs5_args(seen_ckpt):
    return ["train-zs5", *FULL_WIDTH, "--batch-size", "8", "--eval-batch-size", "4",
            "--unseen-split", "2", "--epochs", "1", "--steps-per-epoch", str(ZS3_STEPS),
            *CKPT_ARGS, "--resume", seen_ckpt]


def tagged_images(dataset, unseen):
    """Indices of the images whose ground truth holds an unseen class."""
    import numpy as np

    return [i for i in range(len(dataset))
            if np.isin(np.asarray(dataset[i]["label"]), unseen).any()]


def phase_zs5(seen_ckpt):
    """`cli train-zs5 --resume <seen checkpoint>` at full width: the
    pseudo-label pass (K1 once per tagged image, on f32 logits restricted
    with finfo(float32).min), 4 ZS5 steps (K2 3 and K3 2 each) and one
    validation (K1 once per eval batch).  Then the PNGs and their labels
    checked, K1 and K2/K3 against their plain versions on the path's own
    inputs, the pseudo-label pass timed, and the step timed and split."""
    import numpy as np
    import torch.nn.functional as F
    from PIL import Image

    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data.transforms import normalize
    from zs3_tpu_torch.ops.eval_kernels import upsample_argmax, upsample_argmax_reference
    from zs3_tpu_torch.train.self_training import (
        _gt_view, generate_pseudo_labels, make_pseudo_label_step,
    )
    from zs3_tpu_torch.utils.profiling import profile_device

    phase = "zs5 slice"
    argv = zs5_args(seen_ckpt)
    reset_counts()
    t0 = time.time()
    result, trainer = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    unseen = list(trainer.unseen)
    base = _gt_view(trainer.train_loader.dataset)
    tagged = tagged_images(base, unseen)
    eval_batches = len(trainer.val_loader)
    want = {"K1": len(tagged) + eval_batches, "K2": 3 * ZS3_STEPS, "K3": 2 * ZS3_STEPS,
            "K4": 0, "K5": 0}
    check(launches == want, phase, f"launches {launches}, want {want} ({len(tagged)} tagged "
                                   f"images, {eval_batches} eval batches)")
    check(trainer.cfg.gmmn.self_training and trainer.global_step == ZS3_STEPS, phase,
          "not a self-training run of the asked steps")
    check(all(is_finite(v) for k, v in result.items() if k != "epoch"), phase,
          f"non-finite results {result}")
    check({"seen_miou", "unseen_miou", "harmonic_miou"} <= result.keys(), phase,
          "seen/unseen/harmonic mIoU missing")
    pngs = sorted(os.listdir(trainer.pseudo_dir))
    check(pngs == sorted(base.names[i] + ".png" for i in tagged), phase,
          f"{len(pngs)} PNGs for {len(tagged)} tagged images")
    unseen_px = 0
    for i in tagged:
        sample = base[i]
        gt = np.asarray(sample["label"])
        pseudo = np.asarray(Image.open(os.path.join(trainer.pseudo_dir, sample["name"] + ".png")))
        tags = np.intersect1d(np.unique(gt), unseen)
        labelled = ~np.isin(gt, unseen)
        check(pseudo.shape == gt.shape and np.array_equal(pseudo[labelled], gt[labelled]),
              phase, f"{sample['name']}: labelled pixels changed")
        seen_classes = [c for c in range(trainer.num_classes) if c not in unseen]
        ok = np.isin(pseudo, [*seen_classes, *tags.tolist(), 255])
        check(bool(ok.all()), phase, f"{sample['name']}: a label that is neither a seen class, "
                                     "a tag of the image nor ignore")
        unseen_px += int(np.isin(pseudo, tags).sum())
    emit(phase=phase, command="python -m zs3_tpu_torch.cli " + " ".join(argv), result=result,
         launches=launches, tagged_images=len(tagged), pseudo_label_pngs=len(pngs),
         pixels_pseudo_labelled_unseen=unseen_px, steps=ZS3_STEPS, eval_batches=eval_batches,
         wall_seconds_with_setup=wall)

    # K1 on a tagged image's restricted f32 logits, as the pass made them.
    model = trainer.model
    sample = base[tagged[0]]
    image = torch.from_numpy(normalize(sample)["image"])  # square: no letterbox
    allowed = torch.ones(trainer.num_classes, dtype=torch.bool)
    allowed[unseen] = False
    allowed[np.intersect1d(np.unique(np.asarray(sample["label"])), unseen).tolist()] = True
    allowed = allowed.cuda()
    with torch.inference_mode():
        logits = model.classify(model.forward_features(image[None].cuda())).float()
        logits = torch.where(allowed, logits, torch.finfo(torch.float32).min).contiguous()
    size = tuple(image.shape[:2])
    got = upsample_argmax(logits, size)
    ref = upsample_argmax_reference(logits, size)
    torch.cuda.synchronize()
    ties, err = compare_labels(got, ref, logits, size, phase, "pseudo-label K1")
    check(bool(allowed[got.long()].all()), phase, "K1 gave a class that is not allowed")
    nchw = logits.permute(0, 3, 1, 2)
    bound_ms, bound_by = k1_bound(*logits.shape, *size)
    k1 = dict(shape=list(logits.shape), size=list(size), near_ties=ties, max_abs_err=err,
              kernel_ms=time_ms(lambda: upsample_argmax(logits, size), what="zs5 K1"),
              plain_ms=time_ms(lambda: upsample_argmax_reference(logits, size), what="zs5 K1"),
              library_ms=time_ms(lambda: F.interpolate(
                  nchw, size=size, mode="bilinear", align_corners=True).argmax(1),
                  what="zs5 K1"),
              bound_ms=bound_ms, bound_by=bound_by)
    emit(phase=phase, check="K1 on the pseudo-label pass's restricted logits", **k1, ok=True)
    errors = check_k2_k3(*step_mmd_inputs(trainer), "zs5 step")
    emit(phase=phase, check="K2/K3 on the ZS5 step's inputs against their plain versions",
         **errors, ok=True)

    # The pseudo-label pass again (with the classifier the steps trained),
    # timed: images/s on the host clock, PNG writing included; and one
    # image's device time under the profiler.
    out_dir = os.path.join(SCRATCH, "pseudo_again")
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = generate_pseudo_labels(model, base, unseen, out_dir, size=trainer.cfg.data.crop_size)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    again = sorted(os.listdir(out_dir))
    check(again == pngs, phase, "the pass again wrote other files")
    shutil.rmtree(out_dir, ignore_errors=True)
    pseudo_step = make_pseudo_label_step(0.0)
    one = image[None].cuda()
    prof = profile_device(lambda: pseudo_step(model, one, allowed), steps=4)
    emit(phase="zs5 pseudo-label profile", pseudo_label_images_per_sec=sorted(rates)[1],
         pseudo_label_images_per_sec_passes=rates, pseudo_label_images=n,
         pseudo_label_device_ms_per_image=prof["device_busy_ms"] / 4,
         pseudo_label_idle_share=prof.get("idle_share"),
         pseudo_label_kernels=prof["kernels"][:8])
    time_zs3_step(trainer, phase, "zs5 profile")
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, k1


DATA_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_data")
DATA_STEPS = 2  # train steps of each data path
DATA_EPOCHS = 2  # epochs of the VOC+SBD train loader timed, each alone
DATA_FED_STEPS = 6  # seen steps timed in a window fed by the loader (2 before it)


def data_args(command, dataset, split, *extra):
    """`command` at full width on the fabricated trees of DATA_ROOT."""
    width = [a for a in FULL_WIDTH if a not in ("--dataset", "synthetic")]
    return [command, *width, "--dataset", dataset, "--data-root", DATA_ROOT,
            "--unseen-split", str(split), "--batch-size", "8", "--eval-batch-size", "4",
            *CKPT_ARGS, *extra]


def data_trees(phase):
    """Fabricate the VOC2012 (48 train, 16 val; BASELINE config 3's 10
    unseen classes), SBD (32) and Pascal-Context (24 train, 8 val; split 4)
    trees in VOC's four sizes; write the Context tree's detail-API JSON and
    rebuild its labels with `prepare-context`; build the VOC and Context
    registries with `build-embeddings` from a fabricated 300-d word2vec
    binary.  Returns the registries' paths."""
    import numpy as np
    from PIL import Image

    from zs3_tpu_torch import cli
    from zs3_tpu_torch.core.config import context_unseen_split, voc_unseen_split
    from zs3_tpu_torch.data import fabricate
    from zs3_tpu_torch.data.classes import CONTEXT_CLASSES, VOC_CLASSES

    shutil.rmtree(DATA_ROOT, ignore_errors=True)
    t0 = time.time()
    voc = fabricate.fabricate_voc_tree(DATA_ROOT, 48, 16, unseen_classes=voc_unseen_split(10))
    sbd = fabricate.fabricate_sbd_tree(DATA_ROOT, 32, unseen_classes=voc_unseen_split(10))
    ctx = fabricate.fabricate_context_tree(DATA_ROOT, 24, 8,
                                           unseen_classes=context_unseen_split(4))
    fabricate_s = time.time() - t0

    # prepare-context: the detail JSON of the Context tree, its labels and
    # split lists removed, then rebuilt from the JSON; they must come back.
    base = os.path.join(DATA_ROOT, "VOC2010")
    label_dir = os.path.join(base, "SegmentationClassContext")
    want = {n: np.asarray(Image.open(os.path.join(label_dir, n))) for n in os.listdir(label_dir)}
    detail = os.path.join(DATA_ROOT, "trainval_merged.json")
    made = fabricate.fabricate_context_detail_json(DATA_ROOT, detail)
    shutil.rmtree(label_dir)
    shutil.rmtree(os.path.join(base, "ImageSets"))
    t0 = time.time()
    stats, _ = cli.run(["prepare-context", detail, "--data-root", DATA_ROOT])
    prepare_s = time.time() - t0
    got = sorted(os.listdir(label_dir))
    check(got == sorted(want) and all(
        np.array_equal(np.asarray(Image.open(os.path.join(label_dir, n))), want[n])
        for n in got), phase, "prepare-context did not rebuild the Context tree's labels")
    check(stats["images"] == 32 and stats["train"] == 24 and stats["val"] == 8
          and stats["matched_classes"] == 59, phase, f"prepare-context: {stats}")

    vectors = fabricate.fabricate_word_vectors(os.path.join(DATA_ROOT, "w2v.bin"),
                                               VOC_CLASSES + CONTEXT_CLASSES, dim=300)
    registries, reports = {}, {}
    for dataset, names in (("pascal", VOC_CLASSES), ("context", CONTEXT_CLASSES)):
        registries[dataset] = os.path.join(DATA_ROOT, f"{dataset}_w2v.npy")
        reports[dataset], _ = cli.run(["build-embeddings", vectors, "--output",
                                       registries[dataset], "--dataset", dataset])
        emb = np.load(registries[dataset])
        check(emb.shape == (len(names), 300)
              and np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5), phase,
              f"build-embeddings {dataset}: {emb.shape}")
    emit(phase=phase, step="trees", voc=voc, sbd=sbd, context=ctx, fabricate_seconds=fabricate_s,
         detail_json=made, prepare_context=stats, prepare_context_seconds=prepare_s,
         build_embeddings={k: {f: v[f] for f in ("classes", "dim", "norm_min", "norm_max")}
                           for k, v in reports.items()}, ok=True)
    return registries


def loader_numbers(phase, cfg):
    """The train loader's images/s (batch 8, 513² crops from the
    fabricated JPEGs, pinned batches; each of DATA_EPOCHS epochs of
    VOC+SBD timed from its first request to its last batch, the median
    epoch's rate) at 4 workers and os.cpu_count(), host-normalized and
    with device_preprocess; and the host-to-device ms of one batch, uint8
    from pinned memory against f32 from pageable memory (CUDA events,
    median of 10)."""
    import numpy as np

    from zs3_tpu_torch.data.loader import make_train_loader

    rates = {}
    for workers in (4, os.cpu_count()):
        for preprocess in (False, True):
            data = dataclasses.replace(cfg.data, num_workers=workers,
                                       device_preprocess=preprocess)
            loader, _ = make_train_loader(data, pin_memory=True)
            epochs = []
            for epoch in range(DATA_EPOCHS):
                loader.set_epoch(epoch)
                t0 = time.perf_counter()
                n = 0
                for batch in loader:
                    n += batch["image"].shape[0]
                epochs.append(n / (time.perf_counter() - t0))
            check(batch["image"].is_pinned() and batch["image"].dtype == (
                torch.uint8 if preprocess else torch.float32), phase,
                f"loader batch {batch['image'].dtype}, pinned {batch['image'].is_pinned()}")
            key = f"{workers}_workers_{'device_preprocess' if preprocess else 'host_normalized'}"
            rates[key] = {"images_per_sec": sorted(epochs)[len(epochs) // 2],
                          "images_per_epoch": n, "epochs_images_per_sec": epochs}
    shape = (8, 513, 513, 3)
    pinned = torch.from_numpy(np.zeros(shape, np.uint8)).pin_memory()
    pageable = torch.from_numpy(np.zeros(shape, np.float32))

    def h2d_ms(x):
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            x.to("cuda", non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[5]

    h2d = {"uint8_pinned_ms": h2d_ms(pinned), "uint8_pinned_bytes": pinned.numel(),
           "f32_pageable_ms": h2d_ms(pageable), "f32_pageable_bytes": 4 * pageable.numel()}
    emit(phase=phase, step="loader", batch=8, crop=513, cpu_count=os.cpu_count(),
         loader=rates, host_to_device=h2d)
    return rates, h2d


def seen_fed_and_bypassed(phase, trainer, modes, fed_steps=DATA_FED_STEPS, bypass=None):
    """The seen step (train batch 8, 513²) on the trainer `train-seen`
    ran, fed by each of `modes` ({name: (loader, step)}): steps/s fed by
    the loader (pinned batches copied as they come; in each of 3 rounds,
    for each mode in turn, a fresh epoch, 2 steps to fill the queue, then
    `fed_steps` steps timed on the host clock to a synchronize; the
    median round) beside steps/s on its batches already on the card (3
    windows of 10), the device ms per step (profiler, 3 steps) and each
    rate's idle share.  Modes that share one step can share `bypass`, the
    mode whose batches the card-side numbers are taken on."""
    from zs3_tpu_torch.train.seen import device_batch
    from zs3_tpu_torch.utils.profiling import profile_device

    cuda = torch.device("cuda")
    fed = {name: [] for name in modes}
    for round_ in range(3):
        for name, (loader, step) in modes.items():
            loader.set_epoch(round_)
            feed = iter(loader)
            fed_step = lambda: step(trainer.model, trainer.optimizer,
                                    device_batch(next(feed), cuda))
            for _ in range(2):
                fed_step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(fed_steps):
                fed_step()
            torch.cuda.synchronize()
            fed[name].append(fed_steps / (time.perf_counter() - t0))
            feed.close()
    out, card_side = {}, {}
    for name, (loader, step) in modes.items():
        if bypass is not None and name != bypass:
            continue
        on_card = [device_batch(b, cuda) for _, b in zip(range(4), loader)]
        turn = itertools.cycle(on_card)
        bypass_step = lambda: step(trainer.model, trainer.optimizer, next(turn))
        bypassed, windows = rate_windows(bypass_step, calls=10, windows=3)
        prof = profile_device(bypass_step, steps=3)
        card_side[name] = (bypassed, windows, prof["device_busy_ms"] / 3,
                           str(on_card[0]["image"].dtype).split(".")[-1])
    for name in modes:
        bypassed, windows, device_ms, dtype = card_side[bypass or name]
        rate = sorted(fed[name])[1]
        out[name] = {
            "fed_steps_per_sec": rate, "fed_rounds": fed[name],
            "bypassed_steps_per_sec": bypassed, "bypassed_windows": windows,
            "device_ms_per_step": device_ms,
            "fed_idle_share": 1.0 - device_ms * rate / 1e3,
            "bypassed_idle_share": 1.0 - device_ms * bypassed / 1e3,
            "image_dtype": dtype,
        }
        check(is_finite(rate) and is_finite(bypassed) and device_ms > 0, phase,
              f"seen step rates {out[name]}")
    emit(phase=phase, step="seen step fed by the loader against bypassing it", batch=8,
         fed_steps=fed_steps, num_workers=trainer.cfg.data.num_workers, **out)
    return out


def phase_data():
    """The data layer and the real-data paths at full width (R101, os16,
    513², bf16) on fabricated trees: `train-seen` on VOC2012+SBD at BASELINE
    config 3's split (10 unseen) with device_preprocess (a --config), then
    from its checkpoint `train-gmmn` (device_preprocess too, the VOC
    registry), `evaluate-gmmn` and `evaluate`; `train-seen` on Context at
    split 4 (a 59-class trunk, --no-val), then from it `train-zs5` and
    `train-gmmn --graph-context` (configs 4 and 5) with the Context
    registry.  Each path with the counts from 0 and the launches it must
    make; K2/K3 against their plain versions at the Context steps' inputs
    (C = 59, after the VOC step's C = 21 in this process), and timed
    there; the loader's numbers and the seen step fed by it.  The trees
    stay for phase_tfdata, with the Context trunk's checkpoint (returned)."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data.loader import make_train_loader
    from zs3_tpu_torch.ops import mmd_kernels as mk
    from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS as sig
    from zs3_tpu_torch.train.seen import make_train_step
    from zs3_tpu_torch.train.self_training import _gt_view
    from zs3_tpu_torch.utils.saver import Saver

    phase = "data"
    t_phase = time.time()
    registries = data_trees(phase)
    dp_config = os.path.join(DATA_ROOT, "device_preprocess.json")
    with open(dp_config, "w") as f:
        json.dump({"data": {"device_preprocess": True}}, f)
    steps = ["--epochs", "1", "--steps-per-epoch", str(DATA_STEPS)]
    paths, launches = {}, {}

    def run(name, argv, want):
        """cli.run(argv) with the counts from 0; want(trainer) is the
        launches it must make."""
        reset_counts()
        t0 = time.time()
        result, trainer = cli.run(argv)
        torch.cuda.synchronize()
        launches[name] = read_counts()
        expected = want(trainer)
        check(launches[name] == expected, phase,
              f"{name}: launches {launches[name]}, want {expected}")
        check(all(is_finite(v) for k, v in result.items() if k != "epoch"), phase,
              f"{name}: non-finite results {result}")
        paths[name] = {"command": "python -m zs3_tpu_torch.cli " + " ".join(argv),
                       "result": result, "launches": launches[name],
                       "wall_seconds_with_setup": time.time() - t0}
        emit(phase=phase, path=name, **paths[name])
        return result, trainer

    def evals(trainer, k2=0, k3=0, k1_extra=0):
        return {"K1": len(trainer.val_loader) + k1_extra, "K2": k2, "K3": k3, "K4": 0, "K5": 0}

    voc = ["--use-sbd"]
    _, seen = run("train-seen pascal", data_args(
        "train-seen", "pascal", 10, *voc, *steps, "--config", dp_config), evals)
    check(seen.cfg.data.device_preprocess and seen.step == DATA_STEPS
          and len(seen.val_loader.dataset) == 16, phase, "train-seen pascal: not the asked run")
    seen_ckpt = Saver.latest_checkpoint(seen.saver.directory)
    loader_rates, h2d = loader_numbers(phase, seen.cfg)
    modes = {}
    for preprocess in (False, True):
        data = dataclasses.replace(seen.cfg.data, device_preprocess=preprocess)
        modes["device_preprocess" if preprocess else "host_normalized"] = (
            make_train_loader(data, pin_memory=True)[0],
            make_train_step(seen.loss_fn, seen.cfg.optim.loss_at, seen.cfg.train.grad_accum,
                            seen.cfg.train.seed, preprocess))
    fed = seen_fed_and_bypassed(phase, seen, modes)
    del modes
    del seen
    gc.collect()
    torch.cuda.empty_cache()

    emb = ["--embedding-path", registries["pascal"]]
    _, trainer = run("train-gmmn pascal", data_args(
        "train-gmmn", "pascal", 10, *voc, *steps, *emb, "--resume", seen_ckpt,
        "--config", dp_config), lambda t: evals(t, 3 * DATA_STEPS, 2 * DATA_STEPS))
    check(trainer.step.device_preprocess and trainer.embeddings.shape == (21, 300), phase,
          "train-gmmn pascal: not the asked run")
    gmmn_ckpt = Saver.latest_checkpoint(trainer.saver.directory)
    del trainer
    run("evaluate-gmmn pascal", data_args("evaluate-gmmn", "pascal", 10, *emb, "--resume",
                                          seen_ckpt, "--gmmn-resume", gmmn_ckpt), evals)
    run("evaluate pascal", data_args("evaluate", "pascal", 10, "--resume", seen_ckpt), evals)
    gc.collect()
    torch.cuda.empty_cache()

    _, seen = run("train-seen context", data_args(
        "train-seen", "context", 4, *steps, "--no-val"),
        lambda t: {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0})
    check(seen.num_classes == 59, phase, f"a {seen.num_classes}-class Context trunk")
    ctx_ckpt = Saver.latest_checkpoint(seen.saver.directory)
    del seen
    gc.collect()
    torch.cuda.empty_cache()
    emb = ["--embedding-path", registries["context"]]

    def zs5_want(t):  # K1 once per tagged train image too
        tagged = tagged_images(_gt_view(t.train_loader.dataset), list(t.unseen))
        return evals(t, 3 * DATA_STEPS, 2 * DATA_STEPS, k1_extra=len(tagged))

    _, zs5 = run("train-zs5 context", data_args(
        "train-zs5", "context", 4, *steps, *emb, "--resume", ctx_ckpt), zs5_want)
    check(zs5.num_classes == 59 and len(os.listdir(zs5.pseudo_dir)) > 0, phase,
          "train-zs5 context: no pseudo-labels")
    errors = {"train-zs5 context": check_k2_k3(*step_mmd_inputs(zs5), "zs5 context step")}
    del zs5
    gc.collect()
    torch.cuda.empty_cache()
    _, graph = run("train-gmmn --graph-context context", data_args(
        "train-gmmn", "context", 4, *steps, *emb, "--resume", ctx_ckpt, "--graph-context"),
        lambda t: evals(t, 3 * DATA_STEPS, 2 * DATA_STEPS))
    inputs = step_mmd_inputs(graph)
    errors["train-gmmn --graph-context context"] = check_k2_k3(*inputs, "graph context step")
    emit(phase=phase, check="K2/K3 at the Context steps' inputs against their plain versions",
         shape=list(inputs[0].shape), **errors, ok=True)

    # K2 and K3 timed at the Context step's shape, as the step calls them.
    x, y, wx, wy = inputs
    c, n, d = x.shape
    m = y.shape[1]
    bounds = mmd_bounds(c, n, m, d, len(sig))
    c59 = {"shape": [c, n, m, d]}
    for name, kernel, plain in (
        ("K2", lambda: mk.kernel_sum(x, y, wx, wy, sig),
         lambda: mk.kernel_sum_reference(x, y, wx, wy, sig)),
        ("K3", lambda: mk.kernel_sum_grad(x, y, wx, wy, sig, with_dwx=False),
         lambda: mk.kernel_sum_grad_reference(x, y, wx, wy, sig, with_dwx=False)),
    ):
        c59[name] = {"kernel_ms": time_ms(kernel, what=f"{name} C={c}"),
                     "plain_ms": time_ms(plain, what=f"{name} plain C={c}"),
                     "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                     "library_ms": None}
    c59["K2"]["plan"] = {k: v for k, v in mk.sum_plan(c, n, m, d).items()
                         if k in ("split", "ctas", "pairs_per_cta")}
    c59["K3"]["plan"] = {k: v for k, v in mk.grad_plan(c, n, m, d).items()
                         if k in ("ctas", "cluster")}
    emit(phase=phase, check="K2/K3 timed at the Context step's shape", **c59)
    del graph, inputs, x, y, wx, wy
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase=phase, seconds=time.time() - t_phase, ok=True)
    return {"launches": launches, "errors": errors, "c59": c59, "loader": loader_rates,
            "host_to_device": h2d, "seen_fed": fed, "context_checkpoint": ctx_ckpt}


TFDATA_WORKERS = 4  # the stream's worker processes on the paths (--config)
TFDATA_EPOCHS = 2  # epochs timed per loader


def first_batches(loader, epoch, n=2):
    """The first n batches of `epoch`, as numpy arrays."""
    import numpy as np

    loader.set_epoch(epoch)
    feed = iter(loader)
    batches = [{k: np.asarray(v) for k, v in next(feed).items()} for _ in range(n)]
    feed.close()
    return batches


def same_bytes(a, b):
    return all(x[k].tobytes() == y[k].tobytes() for x, y in zip(a, b, strict=True) for k in x)


def epoch_rates(loader):
    """images/s of `loader` (pinned batches) in each of TFDATA_EPOCHS
    epochs, timed from the first request to the last batch; the rate is
    the last epoch's (a new stream's first epoch starts its workers and
    first touches its ring)."""
    rates = []
    for epoch in range(TFDATA_EPOCHS):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            n += batch["image"].shape[0]
        rates.append(n / (time.perf_counter() - t0))
    return {"images_per_sec": rates[-1], "epochs_images_per_sec": rates,
            "images_per_epoch": n, "pinned": bool(batch["image"].is_pinned())}


def phase_tfdata(ctx_ckpt):
    """input_pipeline="tfdata" (data/tfdata.py: zs3_tpu's tf.data stream
    without TensorFlow) at full width (R101, os16, 513², bf16, batch 8)
    on the data phase's trees, through a --config that sets it with
    TFDATA_WORKERS workers: `train-seen` on VOC2012 (split 2, no SBD, 2
    steps and its validation: K1 4 times) with --compilation-cache in a
    fresh directory, which must then hold K1's library; `train-zs5` on
    Context from the data phase's 59-class trunk (`ctx_ckpt`; K1 once a
    tagged image and a val batch, K2 3 and K3 2 a step), its batches read
    through the stream with the weak labels; `evaluate` with the same
    directory after that, which runs no nvcc (K1's library keeps its
    mtime).  On the host: the first two batches at 0 and 4 workers
    byte-equal, epoch 1 repeatable and not epoch 0; the stream's images/s
    at 4 and 8 workers beside the python loader's; the seen step fed by
    each against batches on the card.  Removes the trees."""
    from pathlib import Path

    from zs3_tpu_torch.data.loader import make_train_loader
    from zs3_tpu_torch.data.tfdata import TFDataLoader, _file_lists
    from zs3_tpu_torch.ops import cuda_build, eval_kernels
    from zs3_tpu_torch.train.seen import make_train_step
    from zs3_tpu_torch.train.self_training import _gt_view
    from zs3_tpu_torch.utils.saver import Saver

    phase = "tfdata"
    t_phase = time.time()
    config = os.path.join(DATA_ROOT, "tfdata.json")
    with open(config, "w") as f:
        json.dump({"data": {"input_pipeline": "tfdata", "num_workers": TFDATA_WORKERS}}, f)
    cache = os.path.join(DATA_ROOT, "compilation_cache")
    check(not os.path.exists(cache), phase, f"{cache} is not fresh")
    k1_library = cuda_build.library_path("upsample_argmax", Path(cache).resolve())
    steps = ["--epochs", "1", "--steps-per-epoch", str(DATA_STEPS)]
    stream = ["--config", config]
    paths = {}

    def run(name, argv, want):
        result, obj, launches, _, wall = run_path(phase, argv, want)
        check(all(is_finite(v) for k, v in result.items() if k != "epoch"), phase,
              f"{name}: non-finite results {result}")
        check(isinstance(obj.train_loader, TFDataLoader), phase,
              f"{name}: train batches from {type(obj.train_loader).__name__}")
        paths[name] = {"command": "python -m zs3_tpu_torch.cli " + " ".join(argv),
                       "result": result, "launches": launches,
                       "wall_seconds_with_setup": wall}
        emit(phase=phase, path=name, **paths[name])
        return obj

    evals = lambda t: {"K1": len(t.val_loader)}
    seen = run("train-seen pascal", data_args(
        "train-seen", "pascal", 2, *steps, *stream, "--compilation-cache", cache), evals)
    check(seen.step == DATA_STEPS and len(seen.val_loader.dataset) == 16
          and seen.cfg.data.num_workers == TFDATA_WORKERS and k1_library.exists(), phase,
          f"train-seen pascal: not the asked run, or no K1 library in {cache}")
    k1_mtime = k1_library.stat().st_mtime_ns
    seen_ckpt = Saver.latest_checkpoint(seen.saver.directory)

    # The stream on the host: workers, epochs, rates beside the python loader's.
    stream_loader = seen.train_loader
    inline = TFDataLoader(stream_loader.dataset, dataclasses.replace(seen.cfg.data,
                                                                     num_workers=0))
    check(same_bytes(first_batches(inline, 0), first_batches(stream_loader, 0)), phase,
          f"the first two batches differ between 0 and {TFDATA_WORKERS} workers")
    again = first_batches(stream_loader, 1)
    check(same_bytes(again, first_batches(stream_loader, 1))
          and not same_bytes(again, first_batches(stream_loader, 0)), phase,
          "epoch 1 does not repeat, or equals epoch 0")
    emit(phase=phase, check="first two batches at 0 and 4 workers, epochs 0 and 1",
         equal_bytes=True, epoch_1_repeats=True, epoch_0_differs=True)
    # Rates and the fed step over longer epochs: the 45 names three times,
    # 16 batches (the stream keeps 2 x workers batches in flight).
    repeated = copy.copy(stream_loader.dataset)
    repeated.names = repeated.names * 3
    stream_loader.dataset = repeated
    python_data = dataclasses.replace(seen.cfg.data, input_pipeline="python")
    loaders = {"tfdata_4_workers": stream_loader}
    for name, workers, data in (("python_4_workers", 4, python_data),
                                ("tfdata_8_workers", 8, seen.cfg.data),
                                ("python_8_workers", 8, python_data)):
        loaders[name] = make_train_loader(dataclasses.replace(data, num_workers=workers),
                                          pin_memory=True)[0]
        loaders[name].dataset = repeated
    rates = {name: epoch_rates(loader) for name, loader in loaders.items()}
    loaders["tfdata_8_workers"].close()
    emit(phase=phase, step="loader", batch=8, crop=513, cpu_count=os.cpu_count(),
         images_per_epoch=len(repeated), loader=rates)
    step = make_train_step(seen.loss_fn, seen.cfg.optim.loss_at, seen.cfg.train.grad_accum,
                           seen.cfg.train.seed)
    python_loader = loaders["python_4_workers"]
    fed = seen_fed_and_bypassed(phase, seen, {"tfdata": (stream_loader, step),
                                              "python": (python_loader, step)},
                                fed_steps=len(stream_loader) - 2, bypass="tfdata")
    stream_loader.close()
    del seen, stream_loader, inline, python_loader, step, loaders
    gc.collect()
    torch.cuda.empty_cache()

    emb = ["--embedding-path", os.path.join(DATA_ROOT, "context_w2v.npy")]

    tagged = {}

    def zs5_want(t):  # K1 once per tagged train image too, K2 3 and K3 2 a step
        ds = _gt_view(t.train_loader.dataset)
        tagged["names"] = [ds.names[i] for i in tagged_images(ds, list(t.unseen))]
        return {"K1": len(tagged["names"]) + len(t.val_loader), "K2": 3 * DATA_STEPS,
                "K3": 2 * DATA_STEPS}

    zs5 = run("train-zs5 context", data_args(
        "train-zs5", "context", 4, *steps, *emb, *stream, "--resume", ctx_ckpt), zs5_want)
    ds = zs5.train_loader.dataset
    labels = dict(zip(ds.names, _file_lists(ds)[1]))
    weak = [labels[n] for n in tagged["names"]
            if os.path.dirname(labels[n]) == zs5.pseudo_dir]
    check(zs5.num_classes == 59 and len(weak) == len(tagged["names"]) > 0, phase,
          f"train-zs5 context: {len(weak)} of {len(tagged['names'])} tagged images read "
          "their pseudo-labels through the stream")
    emit(phase=phase, check="train-zs5 reads its pseudo-labels through the stream",
         weak_labels=len(weak))
    zs5.train_loader.close()
    del zs5
    gc.collect()
    torch.cuda.empty_cache()

    result, trainer, launches, _, wall = run_path(phase, data_args(
        "evaluate", "pascal", 2, "--resume", seen_ckpt, "--compilation-cache", cache), evals)
    check(k1_library.stat().st_mtime_ns == k1_mtime
          and eval_kernels._LIB._dir == Path(cache).resolve(), phase,
          "evaluate with the same --compilation-cache rebuilt K1, or loaded it elsewhere")
    emit(phase=phase, path="evaluate pascal, same --compilation-cache", result=result,
         launches=launches, wall_seconds_with_setup=wall, k1_library=str(k1_library),
         k1_mtime_unchanged=True)
    del trainer
    cuda_build.set_build_dir(None)
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(DATA_ROOT, ignore_errors=True)
    seconds = time.time() - t_phase
    check(seconds <= 90, phase, f"the phase took {seconds:.1f} s, over its 90")
    emit(phase=phase, seconds=seconds, ok=True)
    return {"launches": {n: p["launches"] for n, p in paths.items()}, "loader": rates,
            "seen_fed": fed}


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


def int8_forms(model):
    """{form: conv} of the int8 path: the first conv of each distinct
    geometry (kernel, stride, dilation), the ASPP's image-pool 1x1 on a
    1x1 map (M = B rows) and the decoder's 3x3 on 304 channels."""
    from zs3_tpu_torch import quant

    forms = {}
    for path, conv in quant.eligible_convs(model):
        k, s, d = conv.kernel_size[0], conv.stride[0], conv.dilation[0]
        label = {"global_pool.conv": "image pool 1x1 (M = B)",
                 "fuse1.conv": "decoder 3x3"}.get(path, f"{k}x{k} stride {s} dilation {d}")
        forms.setdefault(label, conv)
    return forms


def check_int8_forms(model, scales, images, phase):
    """Each conv form's inputs from one int8 forward of `images`: the
    quantized operands equal the CPU's (true f32 divisions), the route's
    int32 sums (im2col + torch._int_mm) equal the plain float64 conv's,
    and int8_conv's dequantized output equals the plain sums' bit for bit."""
    from zs3_tpu_torch import quant

    forms = int8_forms(model)
    captured = {}
    hooks = [conv.register_forward_pre_hook(
        lambda module, args, label=label: captured.__setitem__(label, args[0]))
        for label, conv in forms.items()]
    try:
        with torch.inference_mode(), quant.quantized(scales):
            model.forward_features(images)
    finally:
        for hook in hooks:
            hook.remove()
    rows = []
    with torch.inference_mode():
        for label, conv in forms.items():
            t0 = time.time()
            x, absmax = captured[label], scales[conv.quant_path]
            geometry = (conv.stride, conv.padding, conv.dilation)
            xq, wq, s_act, s_w = quant.quantize_operands(x, conv.weight, absmax)
            cpu = quant.quantize_operands(x.cpu(), conv.weight.cpu(), absmax)
            check(torch.equal(xq.cpu(), cpu[0]) and torch.equal(wq.cpu(), cpu[1]), phase,
                  f"{label}: the card's int8 operands differ from the CPU's")
            route = quant.int8_conv_route(xq, wq, *geometry)
            plain = quant.int8_conv_plain(xq, wq, *geometry)
            check(torch.equal(route, plain), phase,
                  f"{label}: route sums differ from the plain conv's by "
                  f"{int((route.long() - plain.long()).abs().max())}")
            got = quant.int8_conv(x, conv.weight, absmax, *geometry, conv.compute_dtype)
            want = quant.dequantize(plain, s_act, s_w, conv.compute_dtype)
            check(torch.equal(got, want), phase, f"{label}: dequantized outputs differ")
            b, c, h, w = x.shape
            rows.append({"form": label, "conv": conv.quant_path, "input": [b, c, h, w],
                         "gemm_mkn": [route.numel() // wq.shape[0], wq[0].numel(), wq.shape[0]],
                         "exact": True, "check_seconds": time.time() - t0})
    return rows


def int8_route_ms(conv, absmax, x):
    """The int8 route on one conv's shape: quantize, im2col, the GEMM alone,
    the whole int8_conv, against cuDNN's bf16 conv (library) and the port's
    bf16 path, with the bound of the int8 work and the route's peak memory.
    CUDA events over 10 calls, median of 3."""
    import torch.nn.functional as F

    from zs3_tpu_torch import quant

    geometry = (conv.stride, conv.padding, conv.dilation)
    w = conv.weight
    with torch.inference_mode():
        xq, wq, _, _ = quant.quantize_operands(x, w, absmax)
        cols, _ = quant.im2col(xq, conv.kernel_size, *geometry)
        wmat = wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1).t()
        wb = w.to(torch.bfloat16)
        m, k, n = cols.shape[0], cols.shape[1], wq.shape[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        quant.int8_conv(x, w, absmax, *geometry, torch.bfloat16)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        label = conv.quant_path
        out = {
            "conv": label, "input": list(x.shape), "gemm_mkn": [m, k, n],
            "quantize_ms": time_ms(lambda: quant.quantize_operands(x, w, absmax),
                                   reps=10, rounds=3, what=f"{label} quantize"),
            "im2col_ms": time_ms(lambda: quant.im2col(xq, conv.kernel_size, *geometry),
                                 reps=10, rounds=3, what=f"{label} im2col"),
            "gemm_ms": time_ms(lambda: torch._int_mm(cols, wmat), reps=10, rounds=3, what=f"{label} _int_mm"),
            "ms": time_ms(lambda: quant.int8_conv(x, w, absmax, *geometry, torch.bfloat16),
                          reps=10, rounds=3, what=f"{label} int8_conv"),
            "library_ms": time_ms(lambda: F.conv2d(x, wb, None, *geometry),
                                  reps=10, rounds=3, what=f"{label} cuDNN bf16"),
            "port_bf16_ms": time_ms(lambda: conv(x), reps=10, rounds=3, what=f"{label} port bf16"),
            "peak_mib": peak / 2**20,
        }
    ops = 2.0 * m * k * n
    conv_bytes = x.numel() * x.element_size() + w.numel() * 4 + m * n * 2
    gemm_bytes = m * k + k * n + 4 * m * n
    out["bound_ms"] = 1e3 * max(ops / INT8_OPS_PER_S, conv_bytes / HBM_BYTES_PER_S)
    out["bound_by"] = "operations" if ops / INT8_OPS_PER_S > conv_bytes / HBM_BYTES_PER_S \
        else "bytes"
    out["gemm_bound_ms"] = 1e3 * max(ops / INT8_OPS_PER_S, gemm_bytes / HBM_BYTES_PER_S)
    out["bf16_bound_ms"] = 1e3 * max(ops / BF16_FLOPS_PER_S, conv_bytes / HBM_BYTES_PER_S)
    return out


def phase_int8():
    """int8 PTQ, QAT and --int8-features at full width (R101, os16, 513²,
    bf16), each path through its entry point with the counts set to 0
    just before: `evaluate --int8` (K1 once per eval batch, int8_conv
    112 times per forward), the route held against its plain version for
    every conv form on the inputs that path gives, absmax and 99.99%
    calibration, int8 and bf16 eval in turns, `serve --int8 --calib-images
    --int8-percentile 99.99 --fused-tail --serve-batch 8` (K4 once per
    batched forward), `train-seen --qat` (3 steps) and `train-gmmn
    --int8-features` (2 steps and a validation: K2 3 and K3 2 a step);
    then the route's time on three shapes against cuDNN's bf16 conv.
    K4 runs in the calibration forwards too (float, fused tail)."""
    import numpy as np

    from zs3_tpu_torch import cli, quant
    from zs3_tpu_torch.data.transforms import letterbox_image
    from zs3_tpu_torch.ops.eval_kernels import predict_labels
    from zs3_tpu_torch.serve import InferenceServer
    from zs3_tpu_torch.train.seen import device_batch, make_eval_step, select_eval_step
    from zs3_tpu_torch.utils.profiling import profile_device

    phase = "int8"
    t_phase = time.time()
    cuda = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()

    # evaluate --int8: calibration on the first 2 val batches, then every
    # eval batch int8, K1 on its logits.
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    result, trainer = cli.run(INT8_ARGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, int8_launches = read_counts(), quant.int8_conv.launches
    scales = trainer.int8_scales()
    eval_batches = len(trainer.val_loader)
    check(len(scales) == INT8_CONVS, phase, f"{len(scales)} quantized convs, not {INT8_CONVS}")
    check(launches == {"K1": eval_batches, "K2": 0, "K3": 0, "K4": 0, "K5": 0}, phase,
          f"launches {launches} for {eval_batches} eval batches")
    check(int8_launches == INT8_CONVS * eval_batches, phase,
          f"int8_conv launched {int8_launches} times for {eval_batches} eval batches")
    check(all(is_finite(v) for v in result.values()), phase, f"non-finite metrics {result}")
    emit(phase="int8 evaluate", at_seconds=time.time() - t_phase, command="python -m zs3_tpu_torch.cli " + " ".join(INT8_ARGS),
         metrics=result, launches=launches, int8_conv_launches=int8_launches,
         quantized_convs=len(scales), eval_batches=eval_batches,
         wall_seconds_with_setup=wall, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    model, n = trainer.model, trainer.num_classes
    batches = [device_batch(b, cuda) for b in trainer.val_loader]
    emit(phase="int8 route", at_seconds=time.time() - t_phase, forms=check_int8_forms(model, scales, batches[0]["image"], phase),
         ok=True)

    # Calibration on 2 eval batches: absmax (the path's) and percentile 99.99,
    # whose decoder input holds more than 2^24 values.
    images = [b["image"] for b in batches[:2]]
    t0 = time.perf_counter()
    absmax = quant.calibrate(model, images)
    absmax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pct = quant.calibrate(model, images, percentile=99.99)
    pct_s = time.perf_counter() - t0
    rel = max(abs(absmax[k] - scales[k]) / scales[k] for k in scales)
    check(set(absmax) == set(pct) == set(scales) and rel <= 1e-3, phase,
          f"calibration again: {len(absmax)} convs, largest relative change {rel}")
    check(all(0 < pct[k] <= absmax[k] for k in pct), phase, "a percentile above its absmax")
    decoder_in = images[0].shape[0] * 304 * 129 * 129
    emit(phase="int8 calibration", at_seconds=time.time() - t_phase, batches=2, absmax_seconds=absmax_s,
         percentile_seconds=pct_s, quantized_convs=len(pct), largest_input_values=decoder_in,
         over_2_24=decoder_in > 2**24, absmax_again_max_rel_change=rel,
         percentile_over_absmax_median=float(np.median([pct[k] / absmax[k] for k in pct])))

    # Eval images/s, int8 and bf16 in turns (bf16, int8, int8, bf16) over the
    # same device batches: 3 windows of one pass; device ms per image.
    train_cfg = dataclasses.replace(trainer.cfg.train, int8_eval=True)
    steps = {"bf16": make_eval_step(n, 255),
             "int8": select_eval_step(n, 255, train_cfg, scales)}
    per_pass = sum(int(b["image"].shape[0]) for b in batches)
    rates = {}
    for turn, name in enumerate(("bf16", "int8", "int8", "bf16")):
        one_pass = lambda step=steps[name]: [step(model, b) for b in batches]
        median, spread = rate_windows(one_pass, calls=1)
        rates[f"{turn}_{name}"] = {"images_per_sec": per_pass * median,
                                   "windows": [per_pass * r for r in spread]}
    device = {}
    for name, step in steps.items():
        prof = profile_device(lambda step=step: [step(model, b) for b in batches], steps=1)
        device[name] = prof["device_busy_ms"] / per_pass
    agree = total = 0
    with torch.inference_mode():
        for b in batches:
            size = tuple(b["image"].shape[1:3])
            want = predict_labels(model.classify(model.forward_features(b["image"])), size)
            with quant.quantized(scales):
                got = predict_labels(model.classify(model.forward_features(b["image"])), size)
            agree += int((got == want).sum())
            total += got.numel()
    int8_rate = rates["1_int8"]["images_per_sec"]
    bf16_rate = rates["0_bf16"]["images_per_sec"]
    emit(phase="int8 eval", at_seconds=time.time() - t_phase, eval_batch=int(batches[0]["image"].shape[0]), turns=rates,
         device_ms_per_image=device, idle_share_untraced={
             "int8": 1.0 - device["int8"] * int8_rate / 1e3,
             "bf16": 1.0 - device["bf16"] * bf16_rate / 1e3},
         int8_over_bf16_images_per_sec=int8_rate / bf16_rate,
         label_agreement_int8_vs_bf16=agree / total, pixels=total,
         slice_bf16=MEASURED.get("eval"))
    del trainer, steps, batches, images
    gc.collect()
    torch.cuda.empty_cache()

    # serve --int8: calibrated at start-up on 8 PNG files (99.99th
    # percentile), then 64 POSTs from 16 clients.
    calib_dir = os.path.join(SCRATCH, "calib")
    os.makedirs(calib_dir, exist_ok=True)
    calib = []
    for i, img in enumerate(voc_like_images(6, 8)):
        calib.append(os.path.join(calib_dir, f"calib{i}.png"))
        with open(calib[-1], "wb") as f:
            f.write(png_bytes(img))
    serve_args = [*SERVE_ARGS, "--int8", "--int8-percentile", "99.99", "--calib-images", *calib]
    args = cli.make_parser().parse_args(serve_args)
    cfg = cli.build_config(args)
    images = voc_like_images(4, 64)
    bodies = [png_bytes(img) for img in images]
    reset_counts()
    t0 = time.time()
    server = InferenceServer(cfg, port=args.port, serve_batch=args.serve_batch,
                             device=args.device, int8_calib_images=args.calib_images
                             ).start(warmup=True)
    try:
        setup_s = time.time() - t0
        batcher, service = server.service.batcher, server.service
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            results = list(pool.map(lambda body: post(server.port, body), bodies))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches, int8_launches = read_counts(), quant.int8_conv.launches
    finally:
        server.stop()
    shutil.rmtree(calib_dir, ignore_errors=True)
    for (status, pred, _), img in zip(results, images):
        check(status == 200 and pred.shape == img.shape[:2] and int(pred.max()) < n, phase,
              f"int8 serve answer {status} {getattr(pred, 'shape', pred)}")
    check(service.int8_convs == service.info()["int8_convs"] == INT8_CONVS, phase,
          f"serve quantized {service.int8_convs} convs")
    calib_batches = -(-len(calib) // SERVE_BATCH)  # Predictor.quantize's calib_batch is 8
    check(launches["K4"] == batcher.groups + calib_batches and launches["K1"] == 0, phase,
          f"launches {launches} for {batcher.groups} batched forwards and "
          f"{calib_batches} calibration batch")
    check(int8_launches == INT8_CONVS * batcher.groups, phase,
          f"int8_conv launched {int8_launches} times for {batcher.groups} forwards")
    latencies = [r[2] for r in results]
    predictor = service.predictor
    frames = [letterbox_image(img, cfg.data.crop_size)[0] for img in images[:8]]
    int8_scales = predictor._scales
    turns, device = {}, {}
    for turn, name in enumerate(("bf16", "int8", "int8", "bf16")):
        predictor._scales = int8_scales if name == "int8" else None
        median, spread = rate_windows(lambda: predictor.predict_batch(frames), calls=2)
        turns[f"{turn}_{name}"] = {"images_per_sec": 8 * median,
                                   "windows": [8 * r for r in spread]}
        if turn < 2:
            prof = profile_device(lambda: predictor.predict_batch(frames), steps=2)
            device[name] = prof["device_busy_ms"] / 2
    predictor._scales = int8_scales
    emit(phase="int8 serve", at_seconds=time.time() - t_phase, command="python -m zs3_tpu_torch.cli " + " ".join(
             [a if a not in calib else os.path.relpath(a) for a in serve_args]),
         requests=64, client_threads=16, setup_seconds_with_calibration=setup_s,
         requests_per_sec=64 / wall, latency_p50_ms=1e3 * percentile(latencies, 50),
         latency_p99_ms=1e3 * percentile(latencies, 99), batch_groups=batcher.groups,
         launches=launches, int8_conv_launches=int8_launches, int8_convs=service.int8_convs,
         predict_batch=turns, device_ms_per_batch=device, idle_share_untraced={
             name: 1.0 - device[name] * turns[f"{i}_{name}"]["images_per_sec"] / 8 / 1e3
             for i, name in enumerate(("bf16", "int8"))},
         serve_bf16=MEASURED.get("serve"))
    del server, service, predictor, batcher
    gc.collect()
    torch.cuda.empty_cache()

    # train-seen --qat: 3 steps at batch 8 on fake-quantized operands.
    reset_counts()
    t0 = time.time()
    result, trainer = cli.run(QAT_ARGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, int8_launches = read_counts(), quant.int8_conv.launches
    check(trainer.cfg.train.qat and trainer.step == QAT_STEPS, phase,
          f"train-seen --qat took {trainer.step} steps")
    check(is_finite(result["train_loss"]), phase, f"QAT loss {result['train_loss']}")
    check(all(v == 0 for v in launches.values()) and int8_launches == 0, phase,
          f"QAT (fake-quant, no validation) launched {launches}, int8 {int8_launches}")
    host_batches = [b for _, b in zip(range(QAT_STEPS), trainer.train_loader)]
    batches = itertools.cycle([device_batch(b, cuda) for b in host_batches])
    one_step = lambda: trainer.train_step(trainer.model, trainer.optimizer, next(batches))
    losses = [float(one_step()["loss"]) for _ in range(QAT_STEPS)]
    check(all(is_finite(v) for v in losses), phase, f"non-finite QAT losses {losses}")
    steps_per_sec, spread = rate_windows(one_step, calls=QAT_STEPS, windows=3)
    prof = profile_device(one_step, steps=2)
    step_ms = prof["device_busy_ms"] / 2
    emit(phase="int8 qat", at_seconds=time.time() - t_phase, command="python -m zs3_tpu_torch.cli " + " ".join(QAT_ARGS),
         result=result, launches=launches, steps=QAT_STEPS, losses=losses,
         wall_seconds_with_setup=wall, steps_per_sec=steps_per_sec,
         steps_per_sec_windows=spread, device_ms_per_step=step_ms,
         idle_share_untraced=1.0 - step_ms * steps_per_sec / 1e3,
         seen_bf16=MEASURED.get("seen"), kernels=prof["kernels"][:8])
    del trainer, batches, one_step
    gc.collect()
    torch.cuda.empty_cache()

    # train-gmmn --int8-features: 2 steps on int8 trunk features, then an
    # int8 validation.
    reset_counts()
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random trunk's warning
        result, trainer = cli.run(INT8_ZS3_ARGS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, int8_launches = read_counts(), quant.int8_conv.launches
    eval_batches = len(trainer.val_loader)
    want = {"K1": eval_batches, "K2": 3 * INT8_ZS3_STEPS, "K3": 2 * INT8_ZS3_STEPS,
            "K4": 0, "K5": 0}
    check(launches == want, phase, f"int8-features launches {launches}, expected {want}")
    check(int8_launches == INT8_CONVS * (INT8_ZS3_STEPS + eval_batches), phase,
          f"int8_conv launched {int8_launches} times")
    check(all(is_finite(v) for k, v in result.items() if k != "epoch") and result["mmd"] > 0,
          phase, f"int8-features results {result}")
    host_batches = [b for _, b in zip(range(INT8_ZS3_STEPS), trainer.train_loader)]
    batches = [device_batch(b, cuda) for b in host_batches]
    turn = itertools.cycle(batches)
    index = itertools.count(trainer.global_step)
    one_step = lambda: trainer.step(next(turn), step=next(index))
    steps_per_sec, spread = rate_windows(one_step, calls=5)
    prof = profile_device(one_step, steps=2)
    trunk = profile_device(lambda: trainer.step.features(batches[0]), steps=2)
    step_ms, trunk_ms = prof["device_busy_ms"] / 2, trunk["device_busy_ms"] / 2
    emit(phase="int8 zs3", at_seconds=time.time() - t_phase, command="python -m zs3_tpu_torch.cli " + " ".join(INT8_ZS3_ARGS),
         result=result, launches=launches, int8_conv_launches=int8_launches,
         steps=INT8_ZS3_STEPS, eval_batches=eval_batches, wall_seconds_with_setup=wall,
         steps_per_sec=steps_per_sec, steps_per_sec_windows=spread,
         device_ms_per_step=step_ms, trunk_device_ms=trunk_ms,
         idle_share_untraced=1.0 - step_ms * steps_per_sec / 1e3,
         zs3_bf16=MEASURED.get("zs3 profile"))

    # The route on three shapes at batch 8 against cuDNN's bf16 conv.
    model = trainer.model
    gen = torch.Generator(device="cuda").manual_seed(8)
    shapes = (("backbone.layer3.1.conv1", (8, 1024, 33, 33)),
              ("aspp3.conv", (8, 2048, 33, 33)), ("fuse1.conv", (8, 304, 129, 129)))
    convs = dict(model.named_modules())
    scales = trainer.trunk_int8_scales()
    route = []
    for path, shape in shapes:
        x = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        route.append(int8_route_ms(convs[path], scales[path], x))
    emit(phase="int8 route", at_seconds=time.time() - t_phase, step="int8 route against cuDNN bf16, batch 8", shapes=route)
    emit(phase=phase, seconds=time.time() - t_phase, ok=True)


# The backbones phase: Xception-65 and MobileNetV2 at os16, DRN-D-54 (os8
# by nature), each at full width (513x513, bf16, full depth, 21 classes,
# unseen split 2) through every path.
BACKBONES = (("xception", 16), ("mobilenet", 16), ("drn", 8))
BB_SEEN_STEPS = 2
BB_ZS3_STEPS = 2
BB_BATCH = 8


def bb_args(backbone: str, output_stride: int):
    """(flags every subcommand takes, checkpoint flags) of one backbone."""
    common = ["--dataset", "synthetic", "--backbone", backbone, "--out-stride",
              str(output_stride), "--crop-size", "513", "--base-size", "513",
              "--compute-dtype", "bfloat16", "--unseen-split", "2", "--seed", "0",
              "--eval-batch-size", "4", "--device", "cuda"]
    return common, ["--checkpoint-dir", CKPT_DIR, "--checkname", f"bb-{backbone}"]


def run_path(phase: str, argv, want):
    """cli.run(argv) with the launch counts set to 0 just before and read
    just after; `want(obj)` gives the counts the path must launch.
    Returns (result, the object it ran, launches, int8 launches, seconds)."""
    from zs3_tpu_torch import cli, quant

    reset_counts()
    t0 = time.time()
    result, obj = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, int8 = read_counts(), quant.int8_conv.launches
    expected = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, **want(obj)}
    check(launches == expected, phase, f"{argv[0]}: launches {launches}, expected {expected}")
    return result, obj, launches, int8, wall


def depthwise_shapes(model, x):
    """The distinct grouped convs one eval forward of `model` runs on x:
    (C, H, W, stride, dilation) of their inputs."""
    from zs3_tpu_torch.models.layers import Conv

    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.setdefault(
            (m.in_channels, *args[0].shape[2:], m.stride[0], m.dilation[0]), None))
        for m in model.modules() if isinstance(m, Conv) and m.groups > 1]
    try:
        with torch.inference_mode():
            model.forward_features(x)
    finally:
        for h in hooks:
            h.remove()
    return sorted(seen)


def conv_layouts_ms(x, w, stride, padding, dilation, groups, phase, what):
    """One bf16 conv in channels_last and in contiguous_format (device ms,
    CUDA events), its least time from its bytes (input, weight and output
    once each over HBM), and the slower layout's ratio to each."""
    import torch.nn.functional as F

    out = {}
    for layout, fmt in (("channels_last", torch.channels_last),
                        ("contiguous", torch.contiguous_format)):
        xl = x.contiguous(memory_format=fmt)
        out[f"{layout}_ms"] = time_ms(
            lambda: F.conv2d(xl, w, None, stride, padding, dilation, groups), reps=10,
            rounds=3, what=f"{phase} {what} {layout}")
    y = F.conv2d(x, w, None, stride, padding, dilation, groups)
    moved = (x.numel() + w.numel() + y.numel()) * x.element_size()
    out["bytes_bound_ms"] = 1e3 * moved / HBM_BYTES_PER_S
    out["cl_over_contiguous"] = out["channels_last_ms"] / out["contiguous_ms"]
    out["cl_over_bound"] = out["channels_last_ms"] / out["bytes_bound_ms"]
    return out


def depthwise_routes_ms(c, h, w, d, phase):
    """A dilated depthwise 3x3 conv ("same", stride 1) at batch 8 in bf16,
    forward and forward + backward: cuDNN on the channels_last input, cuDNN
    on a contiguous_format copy (converted back), and space-to-batch
    (models/layers.py, the route Conv takes for it).  Space-to-batch is
    also held against cuDNN's conv in f32 with TF32 off."""
    import torch.nn.functional as F

    from zs3_tpu_torch.models.layers import conv2d_space_to_batch

    gen = torch.Generator(device="cuda").manual_seed(5)
    x32 = torch.randn((BB_BATCH, c, h, w), device="cuda", generator=gen)
    x32 = x32.contiguous(memory_format=torch.channels_last)
    w32 = torch.randn((c, 1, 3, 3), device="cuda", generator=gen)
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = F.conv2d(x32, w32, None, 1, d, d, c)
        err = float((conv2d_space_to_batch(x32, w32, None, d, c) - want).abs().max())
    finally:
        torch.backends.cudnn.allow_tf32 = True
    check(err <= 1e-5 * float(want.abs().max()), phase,
          f"depthwise {c}@{h} d{d}: space-to-batch off cuDNN's conv by {err}")
    x, wt = x32.bfloat16(), w32.bfloat16()
    routes = {
        "cudnn_channels_last": lambda a: F.conv2d(a, wt, None, 1, d, d, c),
        "cudnn_contiguous": lambda a: F.conv2d(a.contiguous(), wt, None, 1, d, d, c)
        .contiguous(memory_format=torch.channels_last),
        "space_to_batch": lambda a: conv2d_space_to_batch(a, wt, None, d, c),
    }
    out = {"max_abs_err_f32": err}
    g = torch.randn_like(x)
    xg = x.detach().requires_grad_()
    for name, fn in routes.items():
        out[f"{name}_ms"] = time_ms(lambda: fn(x), reps=10, rounds=3, what=f"{name} fwd")
        out[f"{name}_fwd_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(fn(xg), xg, g), reps=10, rounds=3,
            what=f"{name} fwd+bwd")
    return out


def backbone_cpu_check(backbone, output_stride, phase):
    """The backbone's DeepLab in f32 at 65x65 (seeded weights, random BN
    statistics), TF32 off, on the card against the port on the CPU: the
    backbone's two maps and the logits within 1e-3 of their largest
    value (a wrong grouped or dilated cuDNN path is off by its size)."""
    import copy

    from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
    from zs3_tpu_torch.models.layers import BatchNorm

    gen = torch.Generator().manual_seed(11)
    model = init_deeplab(DeepLab(backbone=backbone, output_stride=output_stride,
                                 num_classes=21, dropout=False), 0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
    model.eval()
    card = copy.deepcopy(model).to("cuda", memory_format=torch.channels_last)
    x = torch.randn((2, 65, 65, 3), generator=gen)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = (*model.backbone(x), model(x))
            got = (*card.backbone(x.cuda()), card(x.cuda()))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    errors = {}
    for name, a, b in zip(("high", "low", "logits"), got, want):
        err = float((a.float().cpu() - b).abs().max())
        scale = float(b.abs().max())
        check(err <= 1e-3 * scale, phase, f"f32 65x65 {name}: card off the CPU by {err} "
                                          f"(largest value {scale})")
        errors[name] = {"max_abs_err": err, "max_abs": scale}
    return errors


def phase_backbone(backbone: str, output_stride: int):
    """One backbone through every path at full width: `evaluate` (K1 on
    each eval batch, held against its plain version), `train-seen` (3 steps
    at batch 8, a checkpoint), from it `train-gmmn` (2 steps, K2/K3 held
    against their plain versions on the step's inputs) and `evaluate-gmmn`,
    `serve --fused-tail --serve-batch 8` (8 requests, K4's logits against
    the standard tail), `profile --mode fwd` and `--mode train`,
    `convert-weights` of the trained backbone's keys, the f32 card-vs-CPU
    forward; with `int8`, `evaluate --int8` too.  Returns the launches per
    path."""
    import numpy as np

    from zs3_tpu_torch.data.transforms import letterbox_image
    from zs3_tpu_torch.ops import eval_kernels
    from zs3_tpu_torch.serve import InferenceServer
    from zs3_tpu_torch.train.seen import device_batch, make_eval_step
    from zs3_tpu_torch.utils.profiling import profile_device
    from zs3_tpu_torch.utils.saver import Saver

    phase = f"backbones {backbone}"
    common, ckpt = bb_args(backbone, output_stride)
    launches, numbers = {}, {}
    cuda = torch.device("cuda")

    # evaluate: one K1 launch per eval batch.
    result, trainer, launches["evaluate"], _, wall = run_path(
        phase, ["evaluate", *common, *ckpt], lambda t: {"K1": len(t.val_loader)})
    check(all(is_finite(v) for v in result.values()), phase, f"evaluate gave {result}")
    model, num_classes = trainer.model, trainer.num_classes
    batches = [device_batch(b, cuda) for b in trainer.val_loader]
    with torch.inference_mode():
        first = batches[0]["image"]
        logits = model.classify(model.forward_features(first)).contiguous()
        size = tuple(first.shape[1:3])
        got = eval_kernels.upsample_argmax(logits, size)
        want = eval_kernels.upsample_argmax_reference(logits, size)
    ties, _ = compare_labels(got, want, logits, size, phase, "K1 on the model's bf16 logits")
    step = make_eval_step(num_classes, 255)

    def one_pass():
        for batch in batches:
            step(model, batch)

    per_pass = sum(int(b["image"].shape[0]) for b in batches)
    passes_per_sec, _ = rate_windows(one_pass, calls=2, windows=2)
    prof = profile_device(one_pass, steps=1)
    numbers["eval"] = {"images_per_sec": per_pass * passes_per_sec,
                       "device_ms_per_image": prof["device_busy_ms"] / per_pass,
                       "k1_near_ties": ties, "metrics": result, "wall_seconds": wall}
    shapes = depthwise_shapes(model, torch.randn((BB_BATCH, 513, 513, 3), device=cuda))
    del trainer, model, batches
    gc.collect()
    torch.cuda.empty_cache()

    # train-seen: 3 steps at batch 8, no validation, the final state saved.
    seen_argv = ["train-seen", *common, *ckpt, "--batch-size", str(BB_BATCH), "--epochs", "1",
                 "--steps-per-epoch", str(BB_SEEN_STEPS), "--no-val"]
    result, trainer, launches["train_seen"], _, wall = run_path(phase, seen_argv, lambda t: {})
    check(trainer.step == BB_SEEN_STEPS and is_finite(result["train_loss"]), phase,
          f"train-seen: {trainer.step} steps, {result}")
    seen_ckpt = Saver.latest_checkpoint(trainer.saver.directory)
    check(seen_ckpt is not None, phase, "train-seen wrote no checkpoint")
    batch = device_batch(next(iter(trainer.train_loader)), cuda)

    def seen_step():
        trainer.train_step(trainer.model, trainer.optimizer, batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_per_sec, _ = rate_windows(seen_step, calls=4, windows=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_device(seen_step, steps=2)
    numbers["seen"] = {"steps_per_sec": steps_per_sec,
                       "device_ms_per_step": prof["device_busy_ms"] / 2,
                       "peak_mem_gib": peak, "train_loss": result["train_loss"],
                       "wall_seconds": wall}
    backbone_state = {k: v.detach().cpu() for k, v in trainer.model.backbone.state_dict().items()}
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()

    # train-gmmn from that checkpoint, then evaluate-gmmn from its own.
    zs3_argv = ["train-gmmn", *common, *ckpt, "--resume", seen_ckpt, "--batch-size",
                str(BB_BATCH), "--epochs", "1", "--steps-per-epoch", str(BB_ZS3_STEPS), "--no-val"]
    result, trainer, launches["train_gmmn"], _, wall = run_path(
        phase, zs3_argv, lambda t: {"K2": 3 * BB_ZS3_STEPS, "K3": 2 * BB_ZS3_STEPS})
    check(result["mmd"] > 0 and is_finite(result["mmd"]), phase, f"train-gmmn gave {result}")
    mmd_errors = check_k2_k3(*step_mmd_inputs(trainer), f"{backbone} step")
    zs3_batch = device_batch(next(iter(trainer.train_loader)), cuda)
    counter = itertools.count(trainer.global_step)
    prof = profile_device(lambda: trainer.step(zs3_batch, step=next(counter)), steps=2)
    numbers["zs3"] = {"device_ms_per_step": prof["device_busy_ms"] / 2, "mmd": result["mmd"],
                      "k2_k3_errors": mmd_errors, "wall_seconds": wall}
    gmmn_ckpt = Saver.latest_checkpoint(trainer.saver.directory)
    del trainer, zs3_batch
    gc.collect()
    torch.cuda.empty_cache()
    result, _, launches["evaluate_gmmn"], _, _ = run_path(
        phase, ["evaluate-gmmn", *common, *ckpt, "--resume", seen_ckpt, "--gmmn-resume",
                gmmn_ckpt], lambda t: {"K1": len(t.val_loader)})
    check({"seen_miou", "unseen_miou", "harmonic_miou"} <= result.keys(), phase,
          f"evaluate-gmmn gave {result}")
    numbers["evaluate_gmmn"] = result

    # serve: 8 concurrent requests on the trained model, K4 once per
    # batched forward (the warmup's too).
    from zs3_tpu_torch import cli

    serve_argv = ["serve", *common, "--resume", seen_ckpt, "--fused-tail", "--serve-batch",
                  str(SERVE_BATCH), "--port", "0"]
    cfg = cli.build_config(cli.make_parser().parse_args(serve_argv))
    images = voc_like_images(6, SERVE_BATCH)
    reset_counts()
    server = InferenceServer(cfg, port=0, serve_batch=SERVE_BATCH, device="cuda").start(
        warmup=True)
    try:
        with ThreadPoolExecutor(SERVE_BATCH) as pool:
            answers = list(pool.map(lambda img: post(server.port, png_bytes(img)), images))
        torch.cuda.synchronize()
        launches["serve"] = read_counts()
        groups = server.service.batcher.groups
    finally:
        server.stop()
    for (status, pred, _), img in zip(answers, images):
        check(status == 200 and pred.shape == img.shape[:2], phase, f"serve answered {status}")
    check(launches["serve"] == {"K1": 0, "K2": 0, "K3": 0, "K4": groups, "K5": 0}, phase,
          f"serve launched {launches['serve']} for {groups} batched forwards")
    predictor = server.service.predictor
    canvases = np.stack([letterbox_image(img, 513)[0] for img in images])
    agree = fused_vs_standard(predictor, canvases, phase)
    frames = list(canvases)
    batch_rate, _ = rate_windows(lambda: predictor.predict_batch(frames), calls=2, windows=2)
    numbers["serve"] = {"fused_vs_standard": agree, "batch_groups": groups,
                        "predict_batch_images_per_sec": SERVE_BATCH * batch_rate}
    del server, predictor
    gc.collect()
    torch.cuda.empty_cache()

    # profile --mode fwd (with a trace and the device time by kernel) and
    # --mode train.
    for mode in ("fwd", "train"):
        trace = []
        if mode == "fwd":
            trace = ["--trace-dir", os.path.join(CKPT_DIR, f"{backbone}-trace")]
        result, _, launches[f"profile_{mode}"], _, _ = run_path(
            phase, ["profile", *common, *ckpt, "--mode", mode, "--steps", "2",
                    "--batch-size", str(BB_BATCH), *trace], lambda t: {})
        check(result["mode"] == mode and result["mean_step_ms"] > 0, phase,
              f"profile --mode {mode} gave {result}")
        if trace:
            attribution = result.pop("device_attribution_per_step")
            check(attribution["device_busy_ms"] > 0
                  and os.path.getsize(os.path.join(trace[1], "trace.json")) > 0, phase,
                  f"profile --trace-dir gave {attribution}")
            result["device_busy_ms_per_step"] = attribution["device_busy_ms"]
            result["top_kernels"] = attribution["kernels"][:3]
        numbers[f"profile_{mode}"] = result
        gc.collect()
        torch.cuda.empty_cache()

    # convert-weights of the trained backbone's keys (the upstream names).
    pth = os.path.join(CKPT_DIR, f"{backbone}-upstream.pth")
    out = os.path.join(CKPT_DIR, f"{backbone}-init.pt")
    torch.save(backbone_state, pth)
    result, _, launches["convert_weights"], _, _ = run_path(
        phase, ["convert-weights", pth, "--output", out, *common, *ckpt], lambda t: {})
    saved = Saver.restore(out)["model"]
    check(all(torch.equal(saved[f"backbone.{k}"], v) for k, v in backbone_state.items()),
          phase, "convert-weights changed a backbone tensor")
    numbers["convert_weights"] = {"keys": len(backbone_state), "result": result}

    numbers["f32_65x65_card_vs_cpu"] = backbone_cpu_check(backbone, output_stride, phase)

    if backbone == "mobilenet":  # evaluate --int8: the depthwise convs stay float
        result, trainer, launches["evaluate_int8"], int8, _ = run_path(
            phase, ["evaluate", *common, *ckpt, "--int8"], lambda t: {"K1": len(t.val_loader)})
        scales = trainer._int8_scales
        grouped = [n for n, m in trainer.model.named_modules() if getattr(m, "groups", 1) > 1]
        eval_batches = len(trainer.val_loader)
        check(grouped and not set(grouped) & set(scales), phase, "a depthwise conv quantized")
        check(int8 == eval_batches * len(scales), phase,
              f"{int8} int8 launches for {eval_batches} batches of {len(scales)} int8 convs")
        numbers["evaluate_int8"] = {"metrics": result, "int8_convs": len(scales),
                                    "float_depthwise_convs": len(grouped),
                                    "int8_conv_launches": int8}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    # The depthwise convs of this backbone at 513x513, batch 8, bf16, in
    # both layouts; DRN's 7x7 stem and its os8 ASPP through space-to-batch.
    timings = {}
    for c, h, w, s, d in shapes:
        x = torch.randn((BB_BATCH, c, h, w), device=cuda, dtype=torch.bfloat16)
        wt = torch.randn((c, 1, 3, 3), device=cuda, dtype=torch.bfloat16)
        timings[f"dw {c}x{h}x{w} s{s} d{d}"] = conv_layouts_ms(x, wt, s, d, d, c, phase,
                                                               f"depthwise {c}@{h} d{d}")
        if d > 1:  # the routes of a dilated depthwise conv
            timings[f"dw {c}x{h}x{w} s{s} d{d}"]["routes"] = depthwise_routes_ms(c, h, w, d,
                                                                                 phase)
    if backbone == "drn":
        x = torch.randn((BB_BATCH, 3, 513, 513), device=cuda, dtype=torch.bfloat16)
        wt = torch.randn((16, 3, 7, 7), device=cuda, dtype=torch.bfloat16)
        timings["stem 7x7 3->16 @513"] = conv_layouts_ms(x, wt, 1, 3, 1, 1, phase, "stem")
        timings["aspp os8"] = drn_aspp_check(phase)
    del shapes
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase=phase, launches=launches, **numbers, conv_timings=timings)
    return launches


def drn_aspp_check(phase):
    """DRN's os8 ASPP branches (3x3, 512 -> 256, d = 12, 24, 36 on the
    65x65 grid at batch 8) through space-to-batch: f32 with TF32 off
    against F.conv2d on the card, then both timed in bf16."""
    import torch.nn.functional as F

    from zs3_tpu_torch.models.layers import conv2d_space_to_batch

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((BB_BATCH, 512, 65, 65), device="cuda", generator=gen)
    x = x.contiguous(memory_format=torch.channels_last)
    out = {}
    torch.backends.cudnn.allow_tf32 = False
    try:
        for d in (12, 24, 36):
            w = torch.randn((256, 512, 3, 3), device="cuda", generator=gen) / 48
            got = conv2d_space_to_batch(x, w, None, d)
            want = F.conv2d(x, w, None, 1, d, d)
            err = float((got - want).abs().max())
            check(err <= 1e-4 * float(want.abs().max()), phase,
                  f"space-to-batch d={d} off cuDNN's conv by {err}")
            xb, wb = x.bfloat16(), w.bfloat16().contiguous(memory_format=torch.channels_last)
            out[f"d{d}"] = {
                "max_abs_err_f32": err,
                "space_to_batch_ms": time_ms(lambda: conv2d_space_to_batch(xb, wb, None, d),
                                             reps=5, rounds=3, what=f"s2b d{d}"),
                "cudnn_ms": time_ms(lambda: F.conv2d(xb, wb, None, 1, d, d), reps=5, rounds=3,
                                    what=f"cudnn d{d}"),
            }
    finally:
        torch.backends.cudnn.allow_tf32 = True
    return out


EXPORT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "chip_smoke_export")
EXPORT_BATCH = 8
# Run in a process whose sys.path holds no checkout: torch.export alone.
LOAD_ALONE = r"""
import json, sys, numpy as np, torch
module = torch.export.load(sys.argv[1]).module()
with torch.no_grad():
    labels = module(torch.from_numpy(np.load(sys.argv[2])).cuda())
np.save(sys.argv[3], labels.cpu().numpy())
print(json.dumps({"imported": sorted(m for m in sys.modules if m.split(".")[0] in (
    "zs3_tpu_torch", "zs3_tpu", "jax")), "device": str(labels.device),
    "dtype": str(labels.dtype), "shape": list(labels.shape)}))
"""


@contextlib.contextmanager
def counting_space_to_batch(counts: dict):
    """Count the calls of models/layers.py's space-to-batch conv (a trace
    calls it once per conv it routes), dense and grouped apart, and those
    of a spatially sharded conv's window of rows (H padding 0) apart."""
    from zs3_tpu_torch.models import layers

    orig = layers.conv2d_space_to_batch

    def counted(x, weight, bias, dilation, groups=1, pad_h=None):
        key = ("grouped" if groups > 1 else "dense") + ("_windowed" if pad_h == 0 else "")
        counts[key] = counts.get(key, 0) + 1
        return orig(x, weight, bias, dilation, groups, pad_h)

    layers.conv2d_space_to_batch = counted
    try:
        yield counts
    finally:
        layers.conv2d_space_to_batch = orig


def export_cli(phase, argv, what):
    """cli.run(["export", *argv]) with the counts from 0: (its result, the
    wall seconds, the space-to-batch convs its trace routed).  An export
    launches no kernel: K1 and K4 are not in the artifact."""
    from zs3_tpu_torch import cli

    routes = {}
    reset_counts()
    t0 = time.time()
    with counting_space_to_batch(routes):
        result, _ = cli.run(["export", *argv])
    seconds = time.time() - t0
    launches = read_counts()
    check(not any(launches.values()), phase, f"{what}: the export launched {launches}")
    check(result["bytes"] == os.path.getsize(result["artifact"])
          and os.path.exists(result["artifact"] + ".json"), phase, f"{what}: {result}")
    return result, seconds, routes


def spliced_predictor(cfg, gmmn_ckpt):
    """The eager Predictor of cfg (standard tail) with the retrained
    classifier of `gmmn_ckpt` spliced in, as evaluate-gmmn serves it."""
    from zs3_tpu_torch.export import restore_retrained_classifier
    from zs3_tpu_torch.train.gmmn import splice_classifier
    from zs3_tpu_torch.train.predict import Predictor

    predictor = Predictor(cfg, device="cuda")
    cls = restore_retrained_classifier(gmmn_ckpt, cfg.model.num_classes)
    splice_classifier(predictor.model, {k: v.cuda() for k, v in cls.items()})
    return predictor


def source_logits(predictor, canvases, scales=None):
    """(B, 129, 129, C) f32 logits of the feature grid (before the
    upsample), under int8 `scales` when given: what near-ties are judged on."""
    from zs3_tpu_torch import quant
    from zs3_tpu_torch.data.transforms import batched_normalize_device

    model = predictor.model
    x = batched_normalize_device(torch.from_numpy(canvases).cuda())
    with torch.inference_mode(), (quant.quantized(scales) if scales
                                  else contextlib.nullcontext()):
        return model.classify(model.forward_features(x)).float()


def phase_export(seen_ckpt, gmmn_ckpt):
    """`cli export` of the chained phase's checkpoints at full width
    (R101, os16, 513x513, bf16, 21 classes, split 2), through torch.export:

      * `--export-batch 8 --emit labels --resume <seen> --gmmn-resume
        <gmmn>`: a process without the port on its path loads the artifact
        (torch.export alone) and labels 8 letterboxed VOC-sized canvases,
        equal to the eager Predictor's with the classifier spliced
        (standard tail) outside near-ties (top-2 gap within 8 bf16 ulps of
        the taps' scale); the artifact's device ms (profiler, kernels
        only) against that forward's;
      * `--emit logits` at batch 1 within 8 bf16 ulps of the eager logits;
      * `--int8 --calib-images` (8 PNGs): labels equal to
        Predictor.quantize's eager int8 ones outside near-ties;
      * `serve --artifact` answering 16 POSTs, its PNGs equal to a
        checkpoint server's (the classifier spliced) outside near-ties;
      * the refusals (`--fused-tail`, two platforms, `serve --artifact
        --serve-batch 8`), each raising out of `cli.main` with its message;
      * MobileNetV2 (dilated depthwise convs through space-to-batch).
    The trace's counts of space-to-batch convs and int8 convs are counts
    of the Python that torch.export ran, not launches."""
    import numpy as np
    from PIL import Image

    from zs3_tpu_torch import cli, quant
    from zs3_tpu_torch.data.transforms import (batched_normalize_device, letterbox_image,
                                               unletterbox_pred)
    from zs3_tpu_torch.export import restore_retrained_classifier
    from zs3_tpu_torch.serve import InferenceServer
    from zs3_tpu_torch.train.gmmn import splice_classifier
    from zs3_tpu_torch.train.predict import Predictor
    from zs3_tpu_torch.utils.profiling import profile_device

    phase = "export"
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    art = lambda name: os.path.join(EXPORT_DIR, name)
    common = [*FULL_WIDTH, "--unseen-split", "2", "--resume", seen_ckpt]
    cfg = cli.build_config(cli.make_parser().parse_args(["export", *common, "--output", "x"]))
    size = (cfg.data.crop_size, cfg.data.crop_size)
    images = voc_like_images(7, EXPORT_BATCH)
    canvases = np.stack([letterbox_image(img, cfg.data.crop_size)[0] for img in images])
    out = {}

    # Labels at batch 8, the zero-shot classifier spliced.
    labels, seconds, routes = export_cli(phase, [
        *common, "--gmmn-resume", gmmn_ckpt, "--output", art("r101_labels_b8.pt2"),
        "--export-batch", str(EXPORT_BATCH), "--emit", "labels"], "labels")
    check(labels["zero_shot_classifier"] and labels["platforms"] == ["cuda"]
          and labels["batch_size"] == EXPORT_BATCH and not labels["int8"], phase, str(labels))
    check(routes.get("dense", 0) == 2, phase,
          f"the ASPP's d = 12 and 18 convs traced as space-to-batch: {routes}")
    np.save(art("canvases.npy"), canvases)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", LOAD_ALONE, labels["artifact"],
                           art("canvases.npy"), art("labels.npy")], cwd=EXPORT_DIR, env=env,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, phase, f"loading alone: {proc.stderr[-3000:]}")
    alone = json.loads(proc.stdout.strip().splitlines()[-1])
    check(alone["imported"] == [] and alone["dtype"] == "torch.int32", phase, str(alone))
    got = torch.from_numpy(np.load(art("labels.npy"))).cuda()
    predictor = spliced_predictor(cfg, gmmn_ckpt)
    want = predictor._logits(canvases).argmax(-1).to(torch.int32)
    src = source_logits(predictor, canvases)
    tol = 8 * bf16_ulp(tap_max(src, size))
    ties, _ = compare_labels(got, want, src, size, phase, "the artifact against the Predictor",
                             tol)
    out["labels_b8"] = {
        "export_wall_seconds": seconds, "artifact_bytes": labels["bytes"],
        "space_to_batch_convs_traced": routes, "load_alone": alone,
        "load_alone_wall_seconds_with_start": time.time() - t0,
        "pixels": got.numel(), "near_ties": ties, "labels_differ": int((got != want).sum())}

    # Device ms of a batch of 8: the artifact against the eager forward it
    # was traced from (normalize, trunk, portable resize, argmax), in turns.
    module = torch.export.load(labels["artifact"]).module()
    x = torch.from_numpy(canvases).cuda()
    model = predictor.model

    def eager():
        return model(batched_normalize_device(x)).float().argmax(-1).to(torch.int32)

    turns, walls = {}, {}
    with torch.inference_mode():
        for name, fn in (("eager", eager), ("artifact", lambda: module(x))):
            prof = profile_device(fn, steps=3)
            check(prof["device_busy_ms"] > 0, phase, "the profiler saw no device time")
            turns.setdefault(name, []).append(prof["device_busy_ms"] / 3)
            walls.setdefault(name, []).append(prof["wall_ms"] / 3)
        out["labels_b8"]["device_ms"] = turns
        out["labels_b8"]["wall_ms_traced"] = walls
        out["labels_b8"]["artifact_over_eager"] = (sum(turns["artifact"])
                                                   / sum(turns["eager"]))
    del module

    # Logits at batch 1.
    logits, seconds, _ = export_cli(phase, [
        *common, "--gmmn-resume", gmmn_ckpt, "--output", art("r101_logits_b1.pt2"),
        "--export-batch", "1", "--emit", "logits"], "logits")
    module = torch.export.load(logits["artifact"]).module()
    with torch.inference_mode():
        got_logits = module(x[:1])
    want_logits = predictor._logits(canvases[:1])
    diff = (got_logits - want_logits).abs()
    ulps = 8 * bf16_ulp(tap_max(src[:1], size))[..., None]
    check(got_logits.dtype == torch.float32 and bool((diff <= ulps).all()), phase,
          f"logits artifact off the eager logits by {float(diff.max())}")
    out["logits_b1"] = {"export_wall_seconds": seconds, "artifact_bytes": logits["bytes"],
                        "max_abs_diff": float(diff.max()),
                        "max_abs_logit": float(want_logits.abs().max())}
    del module

    # serve --artifact against a checkpoint server, 16 POSTs each.
    bodies = [png_bytes(img) for img in images[:8] + voc_like_images(9, 8)]
    argv = ["serve", *common, "--artifact", labels["artifact"], "--port", "0"]
    args = cli.make_parser().parse_args(argv)
    servers = {
        "artifact": InferenceServer(cli.build_config(args), port=0, artifact=args.artifact,
                                    device=args.device),
        "checkpoint": InferenceServer(cfg, port=0, device="cuda"),
    }
    cls = restore_retrained_classifier(gmmn_ckpt, cfg.model.num_classes)
    splice_classifier(servers["checkpoint"].service.predictor.model,
                      {k: v.cuda() for k, v in cls.items()})
    answers, served = {}, {}
    for name, server in servers.items():
        server.start(warmup=True)
        try:
            t0 = time.perf_counter()
            answers[name] = [post(server.port, body) for body in bodies]
            served[name] = {"seconds": time.perf_counter() - t0,
                            "info": server.service.info()}
        finally:
            server.stop()
    check(served["artifact"]["info"]["source"] == "artifact", phase, str(served))
    differ = ties_total = 0
    for body, a, c in zip(bodies, answers["artifact"], answers["checkpoint"]):
        check(a[0] == 200 and c[0] == 200, phase, f"serve answers {a[0]} {c[0]}")
        image = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
        canvas, content = letterbox_image(image, cfg.data.crop_size)
        s = source_logits(predictor, canvas[None])
        tie = near_ties(s, size, 8 * bf16_ulp(tap_max(s, size)))[0].cpu().numpy()
        tie = unletterbox_pred(tie.astype(np.uint8), content, image.shape[:2]) > 0
        bad = int(((a[1] != c[1]) & ~tie).sum())
        check(bad == 0, phase, f"serve --artifact: {bad} pixels differ outside near-ties")
        differ += int((a[1] != c[1]).sum())
        ties_total += int(tie.sum())
    out["serve_artifact"] = {"requests": len(bodies), "labels_differ": differ,
                             "near_ties": ties_total,
                             "artifact_requests_per_sec": len(bodies) / served["artifact"][
                                 "seconds"],
                             "checkpoint_requests_per_sec": len(bodies) / served[
                                 "checkpoint"]["seconds"]}
    del servers

    # int8 at batch 8, calibrated on 8 PNGs.
    calib = voc_like_images(8, 8)
    pngs = []
    for i, img in enumerate(calib):
        pngs.append(art(f"calib{i}.png"))
        Image.fromarray(img).save(pngs[-1])
    int8, seconds, _ = export_cli(phase, [
        *common, "--gmmn-resume", gmmn_ckpt, "--output", art("r101_int8_b8.pt2"),
        "--export-batch", str(EXPORT_BATCH), "--int8", "--calib-images", *pngs], "int8")
    int8_traced = quant.int8_conv.launches  # export_cli counted from 0: trace-time calls
    check(int8["int8"] and int8_traced == INT8_CONVS, phase,
          f"int8 artifact: {int8_traced} int8 convs traced, want {INT8_CONVS}")
    module = torch.export.load(int8["artifact"]).module()
    with torch.inference_mode():
        got8 = module(x)
    eager8 = predictor  # from here on int8: served and compared above in float
    eager8.quantize([np.asarray(Image.open(p).convert("RGB")) for p in pngs])
    want8 = eager8._logits(canvases).argmax(-1).to(torch.int32)
    src8 = source_logits(eager8, canvases, eager8._scales)
    ties8, _ = compare_labels(got8, want8, src8, size, phase,
                              "the int8 artifact against the int8 Predictor",
                              8 * bf16_ulp(tap_max(src8, size)))
    out["int8_b8"] = {"export_wall_seconds": seconds, "artifact_bytes": int8["bytes"],
                      "int8_convs_traced": int8_traced, "near_ties": ties8,
                      "labels_differ": int((got8 != want8).sum()),
                      "int8_matches_float_labels": float((got8 == want).float().mean())}
    del module

    # The refusals: each raises out of cli.main, so `python -m
    # zs3_tpu_torch.cli` exits 1 with its message.
    refusals = {
        "export --fused-tail": (["export", *FULL_WIDTH, "--allow-random", "--fused-tail",
                                 "--output", art("no.pt2")], "fused-tail"),
        "export --platforms cuda,cpu": (["export", *FULL_WIDTH, "--allow-random",
                                         "--platforms", "cuda,cpu", "--output",
                                         art("no.pt2")], "one device"),
        "serve --artifact --serve-batch 8": (["serve", *FULL_WIDTH, "--artifact",
                                              labels["artifact"], "--serve-batch", "8",
                                              "--port", "0"], "fixed baked-in batch"),
    }
    out["refusals"] = {}
    for name, (argv, message) in refusals.items():
        try:
            cli.main(argv)
            raised = "nothing"
        except ValueError as e:
            raised = str(e)
        check(message in raised, phase, f"{name}: raised {raised[:300]}")
        out["refusals"][name] = raised
    check(not os.path.exists(art("no.pt2")), phase, "a refused export wrote an artifact")

    # MobileNetV2: its dilated depthwise convs trace as grouped space-to-batch.
    mb_args = [*FULL_WIDTH, "--backbone", "mobilenet", "--allow-random"]
    mb, seconds, mb_routes = export_cli(phase, [*mb_args, "--output", art("mobilenet_b1.pt2"),
                                                "--emit", "logits"], "mobilenet")
    check(mb_routes.get("grouped", 0) > 0, phase, f"MobileNetV2 routes {mb_routes}")
    mb_cfg = cli.build_config(cli.make_parser().parse_args(["export", *mb_args, "--output",
                                                            "x"]))
    mb_eager = Predictor(mb_cfg, device="cuda")
    module = torch.export.load(mb["artifact"]).module()
    with torch.inference_mode():
        mb_got = module(x[:1])
    mb_want = mb_eager._logits(canvases[:1])
    mb_src = source_logits(mb_eager, canvases[:1])
    mb_diff = (mb_got - mb_want).abs()
    check(bool((mb_diff <= 8 * bf16_ulp(tap_max(mb_src, size))[..., None]).all()), phase,
          f"MobileNetV2 artifact off the eager logits by {float(mb_diff.max())}")
    out["mobilenet_b1"] = {"export_wall_seconds": seconds, "artifact_bytes": mb["bytes"],
                           "space_to_batch_convs_traced": mb_routes,
                           "max_abs_diff": float(mb_diff.max())}
    del module, mb_eager, predictor
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase=phase, command="python -m zs3_tpu_torch.cli export " + " ".join(common),
         **out, ok=True)
    return out


DP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_dp")
DP_RANKS = 2
DP_STEPS = 2
# Two ranks against one on the same global batch, by compute dtype: the
# first step's loss (the forward: data, masks, global BN statistics),
# relative; the whole model's change over the steps (`rel_err`), relative.
# bf16: one bf16 ulp of the loss; the change over 2 steps within 10%: a
# rounding-level change of one rank's BN arithmetic alone moved it 7.5%
# (f32, 65x65, PERF.md section 6), and rounding grows with each step.  f32
# (TF32 off) takes one step: its change within 1e-2 (one rank against
# itself, cuDNN's weight-gradient sums being nondeterministic, 1.2e-3 after
# two steps; an f32 step against f64, 1.4e-3 on the CPU).
DP_TOLERANCE = {"bf16": {"first_loss": 2.0 ** -8, "step": 1e-1},
                "f32": {"first_loss": 1e-5, "step": 1e-2}}
F32_SIZE = ["--crop-size", "65", "--base-size", "65", "--compute-dtype", "float32"]


def dp_stages(seen_ckpt, world: int) -> dict:
    """name -> the `cli` argv of each data-parallel stage, for `world`
    ranks (the one-rank run also takes `evaluate_b2`: the forwards of
    batch 2 that each of two ranks runs on an eval batch of 4)."""
    def run_dir(name):
        return ["--checkpoint-dir", os.path.join(DP_DIR, f"{name}_{world}"),
                "--checkname", "dp"]

    steps = ["--epochs", "1", "--steps-per-epoch", str(DP_STEPS), "--no-val"]
    seen = ["train-seen", *FULL_WIDTH, "--batch-size", "8", "--unseen-split", "2", *steps]
    seen_f32 = [*seen, *F32_SIZE, "--steps-per-epoch", "1"]
    stages = {
        "seen_bf16": [*seen, *run_dir("seen_bf16")],
        "seen_f32": [*seen_f32, *run_dir("seen_f32")],
        "gmmn": ["train-gmmn", *FULL_WIDTH, "--batch-size", "8", "--unseen-split", "2",
                 *steps, "--resume", seen_ckpt, *run_dir("gmmn")],
        "evaluate": ["evaluate", *FULL_WIDTH, "--eval-batch-size", "4", "--unseen-split", "2",
                     "--resume", seen_ckpt, *run_dir("evaluate")],
    }
    if world == 1:
        stages["evaluate_b2"] = [*stages["evaluate"], "--eval-batch-size", "2"]
        # The same run again: how far one rank is from itself (cuDNN's f32
        # weight gradients are not deterministic; its bf16 ones were).
        stages["seen_f32_repeat"] = [*seen_f32, *run_dir("seen_f32_repeat")]
    return stages


def tensor_digest(tensors: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def timed_steps(record: list, collectives: list):
    """Time every seen and ZS3 step (synchronized before and after) into
    `record` as (ms, collective ms inside it, the seen step's loss or
    None); `collectives` [ms, calls] is what the all-reduce wrapper of
    dp_rank adds up."""
    from zs3_tpu_torch.train import gmmn, seen

    orig_make, orig_call = seen.make_train_step, gmmn.ZS3Step.__call__

    def timed(fn):
        def step(*args, **kwargs):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), collectives[0]
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            loss = float(out["loss"]) if "loss" in out else None
            record.append((1e3 * (time.perf_counter() - t0), collectives[0] - c0, loss))
            return out
        return step

    seen.make_train_step = lambda *a, **kw: timed(orig_make(*a, **kw))
    gmmn.ZS3Step.__call__ = timed(gmmn.ZS3Step.body)
    try:
        yield
    finally:
        seen.make_train_step, gmmn.ZS3Step.__call__ = orig_make, orig_call


def run_dp_stage(name: str, argv, collectives: list) -> dict:
    """cli.run(argv) with the counts from 0 (f32 stages with TF32 off):
    its result, launches, steps' ms and collective ms, peak memory, and
    what the comparisons read (the trained tensors, or the confusion)."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.train.seen import select_eval_step, sum_confusion

    f32 = "f32" in name
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if f32:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    steps = []
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        with timed_steps(steps, collectives):
            result, trainer = cli.run(argv)
        torch.cuda.synchronize()
        out = {"result": result, "launches": read_counts(), "wall_seconds": time.time() - t0,
               "step_ms": [s[0] for s in steps], "collective_ms": [s[1] for s in steps],
               "losses": [s[2] for s in steps],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if name.startswith("seen"):
            state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
            out.update(state=state, digest=tensor_digest(state))
        elif name == "gmmn":
            state = {**{f"gen.{k}": v.detach().cpu()
                        for k, v in trainer.generator.state_dict().items()},
                     **{f"cls.{k}": v.detach().cpu() for k, v in trainer.step.cls.items()}}
            out.update(state=state, digest=tensor_digest(state))
        else:
            cfg = trainer.cfg
            step = select_eval_step(trainer.num_classes, cfg.data.ignore_index, cfg.train)
            out["confusion"] = sum_confusion(
                lambda b: step(trainer.model, b), trainer.val_loader, trainer.num_classes,
                trainer.device, cfg.data.ignore_index, trainer.mesh).cpu()
        del trainer
        return out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def dp_rank(rank: int, world: int, port: int, seen_ckpt: str):
    """One rank of phase_data_parallel: joins a gloo group on the one card
    (CUDA tensors; NCCL refuses two ranks on one device), times every
    all-reduce (synchronized before and after), runs the stages and writes
    what they gave to DP_DIR/rank<r>.pt (rank 1: digests and the small
    tensors only)."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    collectives = [0.0, 0]
    orig = dist.all_reduce

    def all_reduce(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = orig(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        collectives[0] += 1e3 * (time.perf_counter() - t0)
        collectives[1] += 1
        return work

    dist.all_reduce = all_reduce
    out = {}
    for name, argv in dp_stages(seen_ckpt, world).items():
        out[name] = run_dp_stage(name, argv, collectives)
        if rank and name.startswith("seen"):
            del out[name]["state"]  # rank 0's tensors are compared; rank 1's digest
    out["all_reduce_calls"] = collectives[1]
    torch.save(out, os.path.join(DP_DIR, f"rank{rank}.pt"))
    dist.destroy_process_group()


def rel_err(a: dict, b: dict, start: dict = None) -> dict:
    """How far a is from b over their floating tensors, relative to b's
    change from `start` (to b without `start`): the whole model's
    ||a - b|| / ||b - start|| ("global"), and the worst tensor's
    max|a - b| / max|b - start| with its name."""
    worst, num, den = (0.0, ""), 0.0, 0.0
    for k in b:
        if b[k].is_floating_point():
            diff = a[k].double() - b[k].double()
            ref = b[k].double() if start is None else b[k].double() - start[k].double()
            num += float(diff.square().sum())
            den += float(ref.square().sum())
            worst = max(worst, (float(diff.abs().max()) / max(float(ref.abs().max()), 1e-30),
                                k))
    return {"global": (num / max(den, 1e-300)) ** 0.5, "worst_tensor": worst[0],
            "worst_tensor_name": worst[1]}


def phase_data_parallel(seen_ckpt):
    """Two ranks over gloo on the one card (CUDA tensors), each a process
    running cli.run as torchrun's ranks would (dp_rank), against the
    one-rank run of the same stages in this process:

      * `train-seen` at full width, global batch 8 (4 a rank), 2 steps,
        and in f32 with TF32 off at 65x65, 1 step: the ranks end
        bit-equal; the first step's loss, and the whole model's change
        over the steps (parameters and BN statistics, `rel_err`), within
        DP_TOLERANCE of the one-rank run's; beside the f32 ones, one rank
        against itself (the same run again);
      * `train-gmmn --resume <seen>` 2 steps: K2 6 and K3 4 launches on
        each rank, the generator and classifier bit-equal on the ranks,
        within 1e-2 (`rel_err`, whole model) of the one-rank run's;
      * `evaluate --resume <seen>` (eval batch 4): K1 once per eval batch
        on each rank; the confusion equal to the one-rank confusion of
        forwards of the ranks' size (eval batch 2), and how far from the
        one-rank eval batch 4.
    Each rank's peak memory, its step times and the share of the step in
    all-reduces (synchronized around each call, so they serialize with
    the compute: gloo's host copies wait for it anyway).  Two ranks share
    one card: these times are no scaling figure."""
    import socket

    phase = "data parallel"
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    procs = []
    for r in range(DP_RANKS):
        log = open(os.path.join(DP_DIR, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke as c; c.dp_rank({r}, {DP_RANKS}, {port}, {seen_ckpt!r})"],
            cwd=here, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for proc, _ in procs:
            proc.wait(timeout=900)
    finally:
        for proc, log in procs:
            proc.kill()
            log.close()
    ranks_wall = time.time() - t0
    for r, (proc, _) in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(DP_DIR, f"rank{r}.log")) as f:
                fail(phase, f"rank {r} exited {proc.returncode}: {f.read()[-3000:]}")
    ranks = [torch.load(os.path.join(DP_DIR, f"rank{r}.pt"), weights_only=True)
             for r in range(DP_RANKS)]
    one = {}
    for name, argv in dp_stages(seen_ckpt, 1).items():
        one[name] = run_dp_stage(name, argv, [0.0, 0])
    report = {"ranks_wall_seconds_with_start": ranks_wall,
              "all_reduce_calls": [r["all_reduce_calls"] for r in ranks]}

    def steps_of(stage):
        return {"one_rank_step_ms": one[stage]["step_ms"],
                "rank_step_ms": [r[stage]["step_ms"] for r in ranks],
                "rank_collective_ms": [r[stage]["collective_ms"] for r in ranks],
                "collective_share_last_step": [r[stage]["collective_ms"][-1]
                                               / r[stage]["step_ms"][-1] for r in ranks],
                "rank_peak_mem_gib": [r[stage]["peak_mem_gib"] for r in ranks],
                "one_rank_peak_mem_gib": one[stage]["peak_mem_gib"]}

    from zs3_tpu_torch import cli
    from zs3_tpu_torch.models.deeplab import build_deeplab, init_deeplab

    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)

    for stage, tol in (("seen_bf16", DP_TOLERANCE["bf16"]), ("seen_f32", DP_TOLERANCE["f32"])):
        cfg = cli.build_config(cli.make_parser().parse_args(dp_stages(seen_ckpt, 1)[stage]))
        start = init_deeplab(build_deeplab(cfg.model), cfg.train.seed).state_dict()
        a, b = ranks[0][stage], ranks[1][stage]
        expect(a["digest"] == b["digest"]
               and a["result"]["train_loss"] == b["result"]["train_loss"],
               f"{stage}: the ranks' models or losses differ")
        loss, want = a["result"]["train_loss"], one[stage]["result"]["train_loss"]
        err = rel_err(a["state"], one[stage]["state"], start)
        first = abs(a["losses"][0] - one[stage]["losses"][0]) / abs(one[stage]["losses"][0])
        report[stage] = {
            "losses": a["losses"], "one_rank_losses": one[stage]["losses"],
            "first_loss_rel_err": first, "train_loss": loss, "one_rank_train_loss": want,
            "loss_rel_err": abs(loss - want) / abs(want), "step_rel_err": err,
            "tolerance": tol, "launches": [r[stage]["launches"] for r in ranks],
            **steps_of(stage)}
        expect(first <= tol["first_loss"] and err["global"] <= tol["step"],
               f"{stage}: two ranks against one beyond {tol}")
        again = one.get(stage + "_repeat")
        if again:
            report[stage]["one_rank_repeat"] = {
                "loss_rel_err": abs(again["result"]["train_loss"] - want) / abs(want),
                "step_rel_err": rel_err(again["state"], one[stage]["state"], start)}
    a, b = ranks[0]["gmmn"], ranks[1]["gmmn"]
    expect(a["digest"] == b["digest"], "train-gmmn: the ranks' generators differ")
    for r in ranks:
        expect(r["gmmn"]["launches"] == {"K1": 0, "K2": 3 * DP_STEPS, "K3": 2 * DP_STEPS,
                                         "K4": 0, "K5": 0},
               f"train-gmmn launches {r['gmmn']['launches']}")
    err = rel_err(a["state"], one["gmmn"]["state"])
    report["gmmn"] = {"result": a["result"], "one_rank_result": one["gmmn"]["result"],
                      "rel_err": err,
                      "exact": tensor_digest(one["gmmn"]["state"]) == a["digest"],
                      "launches": [r["gmmn"]["launches"] for r in ranks], **steps_of("gmmn")}
    expect(err["global"] <= 1e-2, "train-gmmn: two ranks against one beyond 1e-2")
    conf = [r["evaluate"]["confusion"] for r in ranks]
    for r in ranks:
        expect(r["evaluate"]["launches"]["K1"] == one["evaluate"]["launches"]["K1"],
               f"evaluate launches {r['evaluate']['launches']} against one rank's "
               f"{one['evaluate']['launches']}")
    same_b2 = torch.equal(conf[0], conf[1]) and torch.equal(conf[0],
                                                            one["evaluate_b2"]["confusion"])
    expect(same_b2, "evaluate: the two-rank confusion is not the one-rank one at batch 2")
    report["evaluate"] = {
        "result": ranks[0]["evaluate"]["result"],
        "k1_launches_per_rank": [r["evaluate"]["launches"]["K1"] for r in ranks],
        "one_rank_k1_launches": one["evaluate"]["launches"]["K1"],
        "confusion_equals_one_rank_batch_2": same_b2,
        "confusion_cells_differing_from_one_rank_batch_4": int(
            (conf[0] != one["evaluate"]["confusion"]).sum()),
        "pixels_moved_against_batch_4": int((conf[0] - one["evaluate"]["confusion"]).abs().sum()
                                            // 2)}
    if failures:
        emit(phase=phase, **report, ok=False)
        fail(phase, "; ".join(failures))
    shutil.rmtree(DP_DIR, ignore_errors=True)
    emit(phase=phase, ranks=DP_RANKS, backend="gloo, CUDA tensors, one card", **report,
         ok=True)
    return {"gmmn": ranks[0]["gmmn"]["launches"], "evaluate": ranks[0]["evaluate"]["launches"],
            "seen": ranks[0]["seen_bf16"]["launches"]}


SP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_spatial")
SP_SEED = 3
SP_EVAL = {"bf16": (2049, "bfloat16"), "f32": (513, "float32")}  # case -> (H = W, dtype)
SP_EVAL_RANKS = 3  # 2049 = 3 * 683 and 4 * (513 - 1) + 1: K4's geometry on the gathered os4
SP_TRAIN = {"bf16": (1024, "bfloat16", 2), "f32": (128, "float32", 1)}  # case -> (H, dtype, steps)
SP_TRAIN_RANKS = 2  # data 1 x space 2
SP_BATCH = 2  # the train cases' global batch
SP_F32_LOGITS = 1e-4  # sharded against one rank, of max |logit| (tests/test_spatial.py: 2e-4)
# bf16: cuDNN picks other algorithms for a rank's window of rows than for
# the whole image, so the sharded trunk rounds otherwise (1.5% of max |logit|
# off the one-rank bf16 forward at 2049x2049, run 1 of PR 17).  Both bf16
# forwards are held against the one-rank f32 forward (TF32 off) of the same
# weights: the sharded one's largest logit error at most SP_BF16_NOISE times
# the one-rank bf16 forward's own, and the labels the one-rank bf16 ones
# outside near-ties, a tie where the one-rank top-2 gap is within
# SP_BF16_NOISE times that own error.
SP_BF16_NOISE = 2.0


def sp_state() -> dict:
    """The seeded R101 weights of the spatial phase (made once a process:
    the seeded init of 60 M parameters takes seconds on the host)."""
    from zs3_tpu_torch.core.config import ModelConfig
    from zs3_tpu_torch.models.deeplab import build_deeplab, init_deeplab

    if "spatial_state" not in MEASURED:
        model = init_deeplab(build_deeplab(ModelConfig(backbone="resnet101")), SP_SEED)
        MEASURED["spatial_state"] = model.state_dict()
    return MEASURED["spatial_state"]


def sp_model(dtype: str, fused_tail: bool = False, dropout: bool = False):
    """R101 os16 (multigrid), 21 classes, seeded (sp_state), on the card."""
    from zs3_tpu_torch.core.config import ModelConfig
    from zs3_tpu_torch.models.deeplab import build_deeplab

    cfg = ModelConfig(backbone="resnet101", num_classes=21, compute_dtype=dtype,
                      fused_tail=fused_tail, dropout=dropout)
    with torch.device("meta"):  # no host init: the weights are sp_state's
        model = build_deeplab(cfg)
    model = model.to_empty(device="cuda")
    model.load_state_dict(sp_state())
    return model.to(memory_format=torch.channels_last)


def sp_images(hw: int, n: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(SP_SEED + hw)
    return torch.randn((n, hw, hw, 3), generator=gen).cuda()


def sp_batch(hw: int) -> dict:
    gen = torch.Generator().manual_seed(SP_SEED + 7 * hw)
    labels = torch.randint(0, 21, (SP_BATCH, hw, hw), generator=gen, dtype=torch.int32)
    labels[torch.rand(labels.shape, generator=gen) < 0.1] = 255
    return {"image": sp_images(hw, SP_BATCH), "label": labels.cuda()}


@contextlib.contextmanager
def tf32_off(dtype: str):
    """TF32 off for f32 (the parity setting), as it was for bf16."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if dtype == "float32":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def sp_eval(forward, x):
    """One measured eval forward: (f32 logits on the host, K4 launches,
    windowed space-to-batch convs, peak GiB, wall ms of 2 forwards after it,
    the profiler's device busy ms and idle share of one)."""
    from zs3_tpu_torch.utils.profiling import profile_device

    forward(x)  # plans, cuDNN's choices
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    routes = {}
    with counting_space_to_batch(routes):
        logits = forward(x)
        torch.cuda.synchronize()
    launches = read_counts()["K4"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    for _ in range(2):
        forward(x)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / 2
    prof = profile_device(lambda: forward(x), steps=1)
    return {"logits": logits.float().cpu(), "k4": launches, "routes": routes,
            "peak_mem_gib": peak, "wall_ms": wall_ms, "device_busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"]}


def sp_train(step, model, optimizer, batch, steps: int):
    """`steps` train steps: (losses, each step's wall ms, state on the host)."""
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(model, optimizer, batch)["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return losses, step_ms, state


def spatial_rank(rank: int, world: int, port: int):
    """One rank of phase_spatial: joins a gloo group on the one card (CUDA
    tensors), times every all-reduce (synchronized before and after), and
    runs, on SP_EVAL_RANKS ranks, the sharded eval forwards of SP_EVAL
    (bf16 with and without the fused tail, f32 with it) and, on
    SP_TRAIN_RANKS, the sharded train steps of SP_TRAIN; writes what they
    gave to SP_DIR/rank<r>_<world>.pt."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zs3_tpu_torch.core.config import Config, ModelConfig
    from zs3_tpu_torch.core.mesh import make_mesh
    from zs3_tpu_torch.parallel import spatial
    from zs3_tpu_torch.train.state import SegOptimizer
    from zs3_tpu_torch.utils.losses import build_seg_loss

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    collectives = [0.0, 0]
    orig = dist.all_reduce

    def all_reduce(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = orig(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        collectives[0] += 1e3 * (time.perf_counter() - t0)
        collectives[1] += 1
        return work

    dist.all_reduce = all_reduce
    mesh = make_mesh((("space", world),))
    block = spatial.spatial_batch_sharding(mesh, data_axis=None)
    out = {}
    if world == SP_EVAL_RANKS:
        for case, (hw, dtype) in SP_EVAL.items():
            x = block.take(sp_images(hw))
            variants = ("fused", "portable") if case == "bf16" else ("fused",)
            model = sp_model(dtype, fused_tail=True).eval()
            with tf32_off(dtype):
                for variant in variants:
                    model.fused_tail = variant == "fused"
                    forward = spatial.spatially_sharded_forward(model, mesh, data_axis=None)
                    c0 = list(collectives)
                    out[f"{case}_{variant}"] = sp_eval(forward, x)
                    out[f"{case}_{variant}"]["all_reduces"] = collectives[1] - c0[1]
            del model
            torch.cuda.empty_cache()
    else:
        for case, (hw, dtype, steps) in SP_TRAIN.items():
            batch = {k: block.take(v) for k, v in sp_batch(hw).items()}
            with tf32_off(dtype):
                model = sp_model(dtype, dropout=True)
                cfg = Config(model=ModelConfig(backbone="resnet101", compute_dtype=dtype))
                optimizer = SegOptimizer(model, cfg, steps)
                step = spatial.spatially_sharded_train_step(
                    build_seg_loss("ce", 255, mesh=mesh), mesh)
                torch.cuda.reset_peak_memory_stats()
                c0 = list(collectives)
                losses, step_ms, state = sp_train(step, model, optimizer, batch, steps)
                out[case] = {"losses": losses, "step_ms": step_ms,
                             "collective_ms": collectives[0] - c0[0],
                             "all_reduces": collectives[1] - c0[1],
                             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                             "digest": tensor_digest(state)}
                if rank == 0:
                    out[case]["state"] = state
            del model, optimizer
            torch.cuda.empty_cache()
    torch.save(out, os.path.join(SP_DIR, f"rank{rank}_{world}.pt"))
    dist.destroy_process_group()


def run_ranks(phase: str, world: int, target: str, log_dir: str, timeout: float = 600):
    """`world` processes `chip_smoke.<target>(rank, world, port)` on a
    free port, each logging to log_dir/rank<r>_<world>.log; fails the
    phase unless each exits 0.  Returns the wall seconds, start included."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    procs = []
    for r in range(world):
        log = open(os.path.join(log_dir, f"rank{r}_{world}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke as c; c.{target}({r}, {world}, {port})"],
            cwd=here, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for proc, _ in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc, log in procs:
            proc.kill()
            log.close()
    for r, (proc, _) in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(log_dir, f"rank{r}_{world}.log")) as f:
                fail(phase, f"rank {r} of {world} exited {proc.returncode}: {f.read()[-3000:]}")
    return time.time() - t0


def phase_spatial():
    """Spatial sharding (zs3_tpu_torch/parallel/spatial.py): ranks over
    gloo on the one card (CUDA tensors), each a process (spatial_rank),
    against one rank in this process, at full width (R101, os16,
    multigrid, 21 classes, seeded weights):

      (a) the bf16 eval forward at 2049x2049 on ("space", 3) with the
          fused tail: K4 once on each rank, on the os4 features gathered
          whole (1, 513, 513, 256); its logits and labels against the
          one-rank bf16 forward's, both against the one-rank f32 forward
          (SP_BF16_NOISE); the same without the fused tail; each rank's
          peak memory, wall and device ms beside one rank's;
      (b) the same forward in f32 (TF32 off) at 513x513 (uneven splits:
          257 -> 129 -> 65 -> 33 rows over 3): logits within SP_F32_LOGITS
          of max |logit| of one rank's;
      (c) spatially_sharded_train_step on ("space", 2) (data 1), global
          batch 2, dropout on: bf16 at 1024x1024 for 2 steps, f32 (TF32 off)
          at 128x128 for 1: the ranks end bit-equal; the first loss and
          the model's change (`rel_err`) within DP_TOLERANCE of one rank's.
    Every dilated conv of the sharded forwards runs a window of rows, and
    those of dilation >= 11 (the ASPP's 12 and 18) through space-to-batch,
    never cuDNN's direct kernel (the route counts).  Ranks share one card:
    their times are no scaling figure.  Returns each eval rank's K4
    launches on (a)'s fused forward."""
    from zs3_tpu_torch.core.config import Config, ModelConfig
    from zs3_tpu_torch.train.seen import make_train_step
    from zs3_tpu_torch.train.state import SegOptimizer
    from zs3_tpu_torch.utils.losses import build_seg_loss

    phase = "spatial"
    shutil.rmtree(SP_DIR, ignore_errors=True)
    os.makedirs(SP_DIR)
    gc.collect()
    torch.cuda.empty_cache()
    wall = {w: run_ranks(phase, w, "spatial_rank", SP_DIR)
            for w in (SP_EVAL_RANKS, SP_TRAIN_RANKS)}
    evals = [torch.load(os.path.join(SP_DIR, f"rank{r}_{SP_EVAL_RANKS}.pt"), weights_only=True)
             for r in range(SP_EVAL_RANKS)]
    trains = [torch.load(os.path.join(SP_DIR, f"rank{r}_{SP_TRAIN_RANKS}.pt"),
                         weights_only=True) for r in range(SP_TRAIN_RANKS)]
    report = {"ranks_wall_seconds_with_start": wall}
    failures = []

    def expect(cond, message):
        if not cond:
            failures.append(message)

    def per_rank(key, field):
        return [r[key][field] for r in evals]

    for case, (hw, dtype) in SP_EVAL.items():
        x = sp_images(hw)
        model = sp_model(dtype, fused_tail=True).eval()
        for variant in (("fused", "portable") if case == "bf16" else ("fused",)):
            key = f"{case}_{variant}"
            model.fused_tail = variant == "fused"
            with tf32_off(dtype):
                one = sp_eval(torch.inference_mode()(model), x)
            got = torch.cat([r[key]["logits"] for r in evals], 1)
            want = one["logits"]
            scale = float(want.abs().max())
            err = float((got - want).abs().max()) / scale
            k4 = per_rank(key, "k4")
            windowed = per_rank(key, "routes")
            expect(k4 == [int(variant == "fused")] * SP_EVAL_RANKS
                   and one["k4"] == int(variant == "fused"),
                   f"{key}: K4 launches {k4} a rank, one rank {one['k4']}")
            expect(all(r.get("dense_windowed") == 2 and set(r) == {"dense_windowed"}
                       for r in windowed),
                   f"{key}: space-to-batch routes {windowed}, not the ASPP's two windows")
            entry = {"shape": [1, hw, hw, 21], "dtype": dtype,
                     "max_abs_err_rel_to_max_logit": err, "max_abs_logit": scale,
                     "k4_launches_per_rank": k4, "one_rank_k4_launches": one["k4"],
                     "space_to_batch_routes_per_rank": windowed,
                     "one_rank_space_to_batch_routes": one["routes"],
                     "all_reduces_per_rank": per_rank(key, "all_reduces"),
                     **{f"rank_{f}": per_rank(key, f) for f in (
                         "peak_mem_gib", "wall_ms", "device_busy_ms", "idle_share")},
                     **{f"one_rank_{f}": one[f] for f in (
                         "peak_mem_gib", "wall_ms", "device_busy_ms", "idle_share")}}
            if dtype == "float32":
                expect(err <= SP_F32_LOGITS, f"{key}: logits {err} of max |logit| off")
            else:
                f32 = sp_model("float32", fused_tail=variant == "fused").eval()
                with tf32_off("float32"), torch.inference_mode():
                    truth = f32(x).float().cpu()
                del f32
                own = float((want - truth).abs().max())
                sharded = float((got - truth).abs().max())
                expect(sharded <= SP_BF16_NOISE * own,
                       f"{key}: the sharded bf16 logits {sharded} off f32, the one-rank "
                       f"bf16 {own}: beyond {SP_BF16_NOISE}x")
                ties = near_ties(want, (hw, hw), SP_BF16_NOISE * own)
                flips = got.argmax(-1) != want.argmax(-1)
                bad = int((flips & ~ties).sum())
                entry.update(one_rank_bf16_max_err_to_f32=own,
                             sharded_bf16_max_err_to_f32=sharded,
                             near_tie_gap=SP_BF16_NOISE * own, near_ties=int(ties.sum()),
                             labels_differing=int(flips.sum()),
                             labels_differing_outside_ties=bad)
                expect(bad == 0, f"{key}: {bad} labels differ outside near-ties")
                del truth
            report[key] = entry
            del got, want, one
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for case, (hw, dtype, steps) in SP_TRAIN.items():
        tol = DP_TOLERANCE["bf16" if dtype == "bfloat16" else "f32"]
        with tf32_off(dtype):
            start = sp_state()
            model = sp_model(dtype, dropout=True)
            cfg = Config(model=ModelConfig(backbone="resnet101", compute_dtype=dtype))
            optimizer = SegOptimizer(model, cfg, steps)
            step = make_train_step(build_seg_loss("ce", 255))
            torch.cuda.reset_peak_memory_stats()
            losses, step_ms, state = sp_train(step, model, optimizer, sp_batch(hw), steps)
            peak = torch.cuda.max_memory_allocated() / 2**30
            del model, optimizer
            gc.collect()
            torch.cuda.empty_cache()
        a, b = trains[0][case], trains[1][case]
        expect(a["digest"] == b["digest"] and a["losses"] == b["losses"],
               f"train {case}: the ranks' models or losses differ")
        first = abs(a["losses"][0] - losses[0]) / abs(losses[0])
        err = rel_err(a["state"], state, start)
        expect(first <= tol["first_loss"] and err["global"] <= tol["step"],
               f"train {case}: two ranks against one beyond {tol}: first loss {first}, {err}")
        report[f"train_{case}"] = {
            "shape": [SP_BATCH, hw, hw, 3], "dtype": dtype, "steps": steps,
            "losses": a["losses"], "one_rank_losses": losses, "first_loss_rel_err": first,
            "step_rel_err": err, "tolerance": tol,
            "rank_step_ms": [r[case]["step_ms"] for r in trains], "one_rank_step_ms": step_ms,
            "rank_collective_ms": [r[case]["collective_ms"] for r in trains],
            "all_reduces_per_rank": [r[case]["all_reduces"] for r in trains],
            "rank_peak_mem_gib": [r[case]["peak_mem_gib"] for r in trains],
            "one_rank_peak_mem_gib": peak}
    if failures:
        emit(phase=phase, **report, ok=False)
        fail(phase, "; ".join(failures))
    shutil.rmtree(SP_DIR, ignore_errors=True)
    emit(phase=phase, backend="gloo, CUDA tensors, one card", **report, ok=True)
    return report["bf16_fused"]["k4_launches_per_rank"]


REHEARSAL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "chip_smoke_rehearsal")
REHEARSAL_BUDGET_S = 300
# Stages of the rehearsal that run K1 (single-scale eval steps, the ZS5
# pseudo-label pass) and K2/K3 (generator steps).  evaluate-gmmn runs
# ms+flip TTA, whose argmax of averaged probabilities is not K1's.
REHEARSAL_K1 = ("train-seen", "train-gmmn", "train-zs5", "evaluate", "evaluate-int8",
                "qat-finetune+int8", "zero-shot-synthetic", "noop-train-seen-lr0")
REHEARSAL_K2_K3 = ("train-gmmn", "train-zs5", "zero-shot-synthetic")


def rehearsal_kernels(workdir: str) -> dict:
    """K1, K2 and K3 on the inputs the rehearsal's synthetic stage gives
    them, from the seen trunk it trained: K1 on the ZS3 eval step's f32
    logits of the first validation batch, and on one image's logits
    restricted as the ZS5 pseudo-label pass makes them; K2 and K3 on the
    first ZS3 step (the generator at its seeded init, the first batch and
    draws).  Each against its plain version, K2/K3 then timed at those
    shapes beside their bounds.  Returns K1's and check_k2_k3's errors,
    the MMD shape, and a "K2" and a "K3" row."""
    import numpy as np

    from zs3_tpu_torch import release_rehearsal as rr
    from zs3_tpu_torch.ops import mmd_kernels as mk
    from zs3_tpu_torch.ops.eval_kernels import upsample_argmax, upsample_argmax_reference
    from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS as sig
    from zs3_tpu_torch.train.gmmn import GMMNTrainer, splice_classifier
    from zs3_tpu_torch.train.seen import device_batch

    phase = "rehearsal"
    run_dir = os.path.join(workdir, "run")
    cfg = rr.synthetic_config(run_dir, 1)
    trunk = rr.best_or_latest(cfg.train.checkpoint_dir, "synthetic", cfg.train.checkname)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, resume=trunk, checkpoint_dir=os.path.join(SCRATCH, "rehearsal_kernels")))
    trainer = GMMNTrainer(cfg, device="cuda")
    model = splice_classifier(trainer.model, trainer.step.cls)
    images = device_batch(next(iter(trainer.val_loader)), torch.device("cuda"))["image"]
    size = tuple(images.shape[1:3])
    with torch.inference_mode():
        logits = model.classify(model.forward_features(images)).float()
    allowed = torch.ones(trainer.num_classes, dtype=torch.bool, device="cuda")
    allowed[list(trainer.unseen)] = False
    allowed[trainer.unseen[0]] = True  # an image tagged with one unseen class
    restricted = torch.where(allowed, logits[:1], torch.finfo(torch.float32).min).contiguous()
    k1 = {}
    for what, x in (("eval", logits), ("pseudo-label", restricted)):
        got = upsample_argmax(x, size)
        want = upsample_argmax_reference(x, size)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == torch.int32, phase,
              f"K1 {what}: got {tuple(got.shape)} {got.dtype}")
        ties, err = compare_labels(got, want, x, size, phase, f"K1 on the synthetic {what} logits")
        if what == "pseudo-label":
            check(bool(allowed[got.long()].all()), phase, f"K1 {what}: a class not allowed won")
        k1[what] = {"shape": list(x.shape), "size": list(size), "near_ties": ties,
                    "max_abs_err": err, "classes": int(np.unique(got.cpu()).size)}

    fake, real, fake_mask, real_mask = step_mmd_inputs(trainer)
    errors = check_k2_k3(fake, real, fake_mask, real_mask, "rehearsal synthetic ZS3 step")
    c, n, d = fake.shape
    m = real.shape[1]
    bounds = mmd_bounds(c, n, m, d, len(sig))
    rows = {"K1": k1, "shape": [c, n, m, d], **errors}
    for name, kernel, plain in (
        ("K2", lambda: mk.kernel_sum(fake, real, fake_mask, real_mask, sig),
         lambda: mk.kernel_sum_reference(fake, real, fake_mask, real_mask, sig)),
        ("K3", lambda: mk.kernel_sum_grad(fake, real, fake_mask, real_mask, sig,
                                          with_dwx=False),
         lambda: mk.kernel_sum_grad_reference(fake, real, fake_mask, real_mask, sig,
                                              with_dwx=False)),
    ):
        rows[name] = {"kernel_ms": time_ms(kernel, what=f"{name} rehearsal"),
                      "plain_ms": time_ms(plain, what=f"{name} plain rehearsal"),
                      "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                      "library_ms": None}
    rows["K2"]["plan"] = {k: v for k, v in mk.sum_plan(c, n, m, d).items()
                          if k in ("split", "ctas", "pairs_per_cta")}
    rows["K3"]["plan"] = {k: v for k, v in mk.grad_plan(c, n, m, d).items()
                          if k in ("ctas", "cluster")}
    del trainer, model
    shutil.rmtree(os.path.join(SCRATCH, "rehearsal_kernels"), ignore_errors=True)
    return rows


def phase_rehearsal():
    """The release rehearsal (zs3_tpu_torch/release_rehearsal.py) at its
    card defaults: R101 at 513², batch 4, bf16, 2 steps a stage, 25
    train-seen steps, TTA scales 0.75,1.0, the synthetic zero-shot stage at
    acceptance depth, and the no-op runs; every stage through cli.run, every
    bar of the card asserted and each above its no-op run, within
    REHEARSAL_BUDGET_S.  Then each stage's K1/K2/K3 launches, and K1, K2
    and K3 on the synthetic stage's own inputs against their plain
    versions.  Returns {"stages": {stage: launches}, "kernels":
    rehearsal_kernels' rows}."""
    from zs3_tpu_torch import release_rehearsal as rr

    phase = "rehearsal"
    shutil.rmtree(REHEARSAL_DIR, ignore_errors=True)
    reset_counts()
    t0 = time.time()
    summary = rr.rehearse(REHEARSAL_DIR, noop=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    per_stage = summary["stage_launches"]
    for stage, seconds in summary["stage_seconds"].items():
        emit(phase=phase, stage=stage, seconds=seconds, launches=per_stage[stage])
    metrics, bars = summary["metrics"], summary["bars"]
    noop = {key: metrics[n] for n, keys in rr.NOOPS.items() for key in keys if n in metrics}
    emit(phase=phase, bars=bars, measured={k: metrics[k] for k in bars}, noop=noop,
         int8_miou_delta=metrics["int8_miou_delta"], metrics=metrics)
    check(set(bars) == set(rr.SEEN_BARS["cuda"]) | set(rr.ZERO_SHOT_BARS["cuda"])
          and set(noop) == {k for keys in rr.NOOPS.values() for k in keys}, phase,
          f"bars {sorted(bars)} or no-op values {sorted(noop)} missing")
    check(wall <= REHEARSAL_BUDGET_S, phase,
          f"the rehearsal took {wall:.1f} s, over its budget of {REHEARSAL_BUDGET_S} s")
    totals = {k: sum(n[k] for n in per_stage.values()) for k in ("K1", "K2", "K3")}
    check(launches == {**totals, "K4": 0, "K5": 0}, phase,
          f"launches {launches} against the stages' {totals}")
    for stage, counts in per_stage.items():
        check((counts["K1"] > 0) == (stage in REHEARSAL_K1), phase,
              f"{stage}: K1 launches {counts['K1']}")
        check((counts["K2"] > 0) == (counts["K3"] > 0) == (stage in REHEARSAL_K2_K3)
              and 2 * counts["K2"] == 3 * counts["K3"], phase,
              f"{stage}: K2/K3 launches {counts['K2']}/{counts['K3']}")
    steps = summary["steps_per_stage"]
    check(per_stage["train-gmmn"]["K2"] == 3 * steps, phase,
          f"train-gmmn: K2 {per_stage['train-gmmn']['K2']} for {steps} steps")
    check(summary["artifact_platforms"] == ["cuda"] and summary["backend"] == "cuda", phase,
          f"ran on {summary['backend']}, exported for {summary['artifact_platforms']}")
    kernels = rehearsal_kernels(REHEARSAL_DIR)
    emit(phase=phase, check="K1, K2 and K3 on the synthetic stage's inputs against their "
         "plain versions, and K2/K3's times there", **kernels, ok=True)
    emit(phase=phase, wall_seconds=wall, budget_seconds=REHEARSAL_BUDGET_S,
         total_seconds=summary["total_seconds"], tf32=summary["tf32"],
         device_name=summary["device_name"], launches=launches, ok=True)
    shutil.rmtree(REHEARSAL_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"stages": per_stage, "kernels": kernels}


def phase_export_and_data_parallel_alone():
    """phase_export and phase_data_parallel on checkpoints of their own:
    `train-seen` and then `train-gmmn` at full width, one step each."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.utils.saver import Saver

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    one = ["--epochs", "1", "--steps-per-epoch", "1", "--no-val", *CKPT_ARGS]
    _, seen = cli.run(["train-seen", *FULL_WIDTH, "--batch-size", "8", "--unseen-split", "2",
                       *one])
    seen_ckpt = Saver.latest_checkpoint(seen.saver.directory)
    del seen
    _, gmmn = cli.run(["train-gmmn", *FULL_WIDTH, "--batch-size", "8", "--unseen-split", "2",
                       "--resume", seen_ckpt, *one])
    gmmn_ckpt = Saver.latest_checkpoint(gmmn.saver.directory)
    del gmmn
    gc.collect()
    torch.cuda.empty_cache()
    phase_export(seen_ckpt, gmmn_ckpt)
    phase_data_parallel(seen_ckpt)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)


def phase_backbones():
    """phase_backbone for each of BACKBONES; returns {backbone: launches}."""
    out = {}
    for backbone, output_stride in BACKBONES:
        out[backbone] = phase_backbone(backbone, output_stride)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import zs3_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from zs3_tpu_torch.train.seen import build_eval_model, device_batch

    seconds, clock = {}, [time.time()]

    def lap(name):
        """Wall seconds since the last lap, as the timeline's `name`."""
        now = time.time()
        seconds[name] = now - clock[0]
        clock[0] = now

    phase_env()
    phase_build()
    lap("env, build")
    timings = phase_kernels()
    mmd_errors, mmd_timings = phase_mmd()
    tail_timings = phase_tail()
    phase_k5_edges()
    phase_dilated()
    lap("kernels, mmd kernels, tail kernels, bottleneck edges, dilated")
    launches = phase_slice()
    zs3_launches = phase_zs3()
    graph_launches = phase_graph()
    lap("slice, zs3, graph")
    serve_launches = phase_serve()
    infer_launches = phase_infer()
    tta_launches = phase_tta()
    lap("serve, infer, tta")
    seen_launches, seen, seen_ckpt = phase_seen()
    images = device_batch(next(iter(seen.val_loader)), torch.device("cuda"))["image"]
    trunk_cfg = seen.cfg.replace(train=dataclasses.replace(seen.cfg.train, resume=seen_ckpt))
    del seen
    gc.collect()
    torch.cuda.empty_cache()
    lap("seen")
    zs5_launches, zs5_k1 = phase_chained(seen_ckpt)
    lap("chained, zs5")
    phase_export(seen_ckpt, MEASURED["gmmn_checkpoint"])
    lap("export")
    dp_launches = phase_data_parallel(seen_ckpt)
    lap("data parallel")
    sp_launches = phase_spatial()
    lap("spatial")
    # K5 on the trunk train-seen trained and wrote, reloaded from its checkpoint.
    k5_launches, k5_errors, k5_timings = phase_bottleneck(build_eval_model(trunk_cfg, "cuda"),
                                                          images)
    del images
    gc.collect()
    torch.cuda.empty_cache()
    lap("bottleneck")
    data = phase_data()
    gc.collect()
    torch.cuda.empty_cache()
    lap("data")
    tfdata = phase_tfdata(data["context_checkpoint"])
    lap("tfdata")
    phase_int8()
    lap("int8")
    bb_launches = phase_backbones()
    lap("backbones")
    rehearsal = phase_rehearsal()
    lap("rehearsal")
    phase_reference()
    phase_zs3_reference()
    phase_graph_reference()
    phase_zs5_reference()
    phase_serve_reference()
    phase_seen_reference()
    lap("references")
    emit(phase="timeline", seconds=seconds, total_seconds=sum(seconds.values()))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    b4 = timings[(4, 21, "float32")]
    data_launches = lambda k: {path: n[k] for path, n in data["launches"].items()}
    tfdata_launches = lambda k: {path: n[k] for path, n in tfdata["launches"].items()}

    def rehearsal_counts(k):  # {stage: launches}, the rehearsal's stages that launched k
        return {stage: n[k] for stage, n in rehearsal["stages"].items() if n[k]}

    def bb_counts(k):  # {backbone: {path: launches}}, the paths that launched k
        return {b: {path: n[k] for path, n in paths.items() if n[k]}
                for b, paths in bb_launches.items()}
    k1_fields = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "host_ms")
    k4 = tail_timings[(SERVE_BATCH, 129, "bfloat16")]
    k4_fields = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
    main_err, main_t = mmd_errors["main path"], mmd_timings[128]

    def mmd_row(name, key, source_line, err, c59_err):
        t = main_t[key]
        return {
            "name": name,
            "route": "cuda",
            "source": "zs3_tpu_torch/csrc/mmd_kernel_sum.cu",
            "replaces": f"zs3_tpu/ops/pallas_mmd.py:{source_line}",
            "launches": zs3_launches[key],
            "launches_train_zs5": zs5_launches[key],
            "launches_graph": graph_launches[key],
            "launches_data": data_launches(key),
            "launches_tfdata": tfdata_launches(key),
            "launches_backbones": bb_counts(key),
            "launches_data_parallel_per_rank": {"train-gmmn": dp_launches["gmmn"][key]},
            "launches_rehearsal": rehearsal_counts(key),
            "max_abs_err": err,
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": main_t["shape"],
            **{k: v for k, v in t.items() if k not in ("kernel_ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms")},
            "budgets": {b: mmd_timings[b][key] for b in MMD_BUDGETS},
            "c59": {**data["c59"][key], "shape": data["c59"]["shape"], "max_abs_err": {
                path: e[c59_err] for path, e in data["errors"].items()}},
            "rehearsal_synthetic": {**rehearsal["kernels"][key],
                                    "shape": rehearsal["kernels"]["shape"],
                                    "max_abs_err": rehearsal["kernels"][c59_err]},
        }

    print(json.dumps({"kernels": [{
        "name": "upsample_argmax",
        "route": "cuda",
        "source": "zs3_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "zs3_tpu/ops/pallas_eval.py:30",
        "launches": launches,
        "launches_train_gmmn": zs3_launches["K1"],
        "launches_train_zs5": zs5_launches["K1"],
        "launches_graph": graph_launches["K1"],
        "zs5_pseudo_label": zs5_k1,
        "launches_data": data_launches("K1"),
        "launches_tfdata": tfdata_launches("K1"),
        "launches_backbones": bb_counts("K1"),
        "launches_data_parallel_per_rank": {"evaluate": dp_launches["evaluate"]["K1"]},
        "launches_rehearsal": rehearsal_counts("K1"),
        "rehearsal_synthetic": rehearsal["kernels"]["K1"],
        "max_abs_err": b4["max_abs_err"],
        "ms": b4["kernel_ms"],
        "plain_ms": b4["plain_ms"],
        "bound_ms": b4["bound_ms"],
        "bound_by": b4["bound_by"],
        "library_ms": b4["library_ms"],
        "shape": b4["shape"],
        "host_ms": b4["host_ms"],
        **{f: b4[f] for f in ("band_rows", "ctas", "threads", "smem_bytes")},
        "b16": {f: timings[(16, 21, "float32")][f] for f in k1_fields},
        "bf16": {f: timings[(4, 21, "bfloat16")][f] for f in k1_fields + ("max_abs_err",)},
        "b16_bf16": {f: timings[(16, 21, "bfloat16")][f] for f in k1_fields},
        "c59": {f"b4_{d}": {f: timings[(4, 59, d)][f] for f in k1_fields + ("max_abs_err",)}
                for d in ("float32", "bfloat16")},
        "c59_restricted_b1": {f: timings[("restricted", 59)][f] for f in (
            "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")},
        "rehearsal_synthetic_shapes": {  # (8,13,13,10)->49², (1,13,13,10) restricted
            "b8": {f: timings[(8, 10, "float32")][f] for f in k1_fields + ("max_abs_err",)},
            "restricted_b1": {f: timings[("restricted", 10)][f] for f in (
                "kernel_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}},
    },
        mmd_row("mmd_kernel_sum", "K2", 54, main_err["k2_max_abs_err"], "k2_max_abs_err"),
        mmd_row("mmd_kernel_sum_grad", "K3", 79, main_err["k3_dx_max_abs_err"],
                "k3_dx_max_abs_err"),
        {
            "name": "classify_resize",
            "route": "cuda",
            "source": "zs3_tpu_torch/csrc/classify_resize.cu",
            "replaces": "zs3_tpu/ops/pallas_tail.py:95",
            "launches": serve_launches["K4"],
            "launches_infer": {m: v["launches"]["K4"] for m, v in infer_launches.items()},
            "launches_tta": tta_launches["K4"],
            "launches_backbones": bb_counts("K4"),
            "launches_spatial_per_rank": sp_launches,
            "max_abs_err": k4["max_abs_err"],
            "max_err_in_tap_ulps": k4["max_err_in_tap_ulps"],
            "ms": k4["kernel_ms"],
            "plain_ms": k4["plain_ms"],
            "bound_ms": k4["bound_ms"],
            "bound_by": k4["bound_by"],
            "library_ms": k4["library_ms"],
            "shape": k4["shape"],
            "dtype": "bfloat16",
            "host_ms": k4["host_ms"],
            **{f: k4[f] for f in ("tile_cols", "grid", "ctas_per_sm", "smem_bytes", "copy_ms",
                                  "read_ms", "write_ms")},
            "b1": {f: tail_timings[(1, 129, "bfloat16")][f] for f in k4_fields},
            "b8_f32": {f: tail_timings[(SERVE_BATCH, 129, "float32")][f] for f in k4_fields},
            "tta": {f"{n}x{n}": {f: tail_timings[(4, n, "bfloat16")][f] for f in k4_fields}
                    for n in (97, 161)},
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
            "whole_pass": k5_timings.pop("whole_pass"),
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
