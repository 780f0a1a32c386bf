"""Release rehearsal of the port: the paper's configuration end to end,
through the CLI, on a fabricated VOC(+SBD) tree, with bars that a
deliberately broken run fails.

  21-class VOC2012 + SBD trees (fabricated, real size variety)
  torchvision-shaped ResNet .pth  -> convert-weights
  word2vec-style embedding .npy   -> --embedding-path
  train-seen   (unseen filter, SBD union, poly LR, --ft init)
  train-gmmn   (--unseen-split 2, --int8-features, harmonic-best ckpt)
  train-zs5    (pseudo-labels, then the weak-label retrain)
  evaluate, evaluate --int8                       (the int8 protocol)
  train-seen --qat + evaluate --int8              (QAT fine-tune -> int8)
  evaluate-gmmn --eval-scales ... --eval-flip     (TTA)
  zero-shot-synthetic  (seen, ZS3 and ZS5 transfer on the synthetic
                        split: the fabricated tree's random embeddings
                        cannot show transfer)
  export --resume ... --gmmn-resume ...           (zero-shot artifact)
  serve        (HTTP, letterbox geometry, a non-square request)

On the card (the default) it runs R101 at 513², bf16, 25 train-seen
steps and the synthetic stage at acceptance depth with the card's bars;
with --device cpu, f32, `--steps` train-seen steps and the synthetic
stage at smoke depth, without the depth-gated bars:

  python -m zs3_tpu_torch.release_rehearsal --workdir /tmp/rehearsal
  python -m zs3_tpu_torch.release_rehearsal --device cpu --backbone resnet50 \\
      --crop-size 65 --batch-size 2

`rehearse(noop=True)` (chip_smoke.py's rehearsal phase) adds the
deliberately broken runs each bar must fail (train-seen at LR 0, the
synthetic ZS3 leg with a generator LR of 0) and asserts every bar above
them; `--measure 3` runs that three times without asserting any bar, to
set the bars, and measures the QAT fine-tune at the full LR beside the
rehearsal's 0.1x.  Prints one JSON summary line; exit 0 = every stage
green and every bar held.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import http.client
import io
import json
import math
import os
import shutil
import sys
import time
from typing import Dict, Optional

import numpy as np
from PIL import Image

# The rehearsal's bars, the port's own, per device type.  Each was set at
# about 60% of the lowest of three fixed-seed runs of the port on that
# device (`python -m zs3_tpu_torch.release_rehearsal --measure 3`),
# and sits above the value of the deliberately broken run it must fail
# (NOOPS).  zs3_tpu's bars were measured on a TPU and on JAX's random
# streams: they set no target here.  The card's numbers are from one
# NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi's name and power limit).
#
# Seen floor and QAT, after `seen_steps` >= 25 train-seen steps.
#   cuda: R101, 513², batch 4, bf16, 28 steps (7 epochs of the fabricated
#         tree's 4 batches): evaluate 0.09637 in all three runs (the stage
#         is deterministic on the card), the LR-0 no-op 0.01088; QAT at
#         0.1x LR then int8 0.1185, the LR-0 level 0.01088.  QAT at the
#         full LR (0.007, the seen stage's own) gives 0.1128: it does not
#         damage this trunk, so it is measured and reported, not a no-op.
#   cpu:  none.  At R50, 65², batch 2, f32, 32 steps (4 epochs of 8), the
#         trunk predicts a near-constant class: 0.04214 (all background)
#         at 1 and 2 threads, 0.00174 at 8, the LR-0 no-op 0.00752; at 65²
#         the fabricated tree's tints do not separate a trained trunk from
#         an untrained one, and no bar can.
SEEN_BARS: Dict[str, Dict[str, float]] = {
    "cuda": {"evaluate_miou": 0.058, "qat_int8_miou": 0.071},
}
# Zero-shot transfer on the synthetic split at acceptance depth (20/45/30
# epochs, `synthetic_config`, f32), the generator-LR-0 no-op beside it.
#   cuda: under cudnn_deterministic, with cuDNN's TF32 on (torch's
#         default), the three runs at one seed gave the same values: seen
#         0.4767; ZS3 unseen 0.2062, no-op 0.0; ZS3 harmonic 0.2718, no-op
#         0.0; ZS5 unseen 0.2289; ZS5 harmonic 0.2856.  With cuDNN's
#         default algorithms nine runs spread over ZS3 unseen 0.0452-0.1818
#         (seen 0.4483-0.5447, ZS5 unseen 0.1046-0.2441).
#   cpu:  a run repeats itself bit for bit at one thread count, and its
#         reductions' order moves with the count: the three runs at 1, 2
#         and 8 intra-op threads (OMP_NUM_THREADS; the slow tests run at
#         1): seen 0.4674, 0.4608, 0.5182; ZS3 unseen 0.1307, 0.0661,
#         0.3232, no-op 0.0; ZS3 harmonic 0.2010, 0.1141, 0.3724, no-op
#         0.0; ZS5 unseen 0.1740, 0.2981, 0.4927; ZS5 harmonic 0.2418,
#         0.3499, 0.4639.
ZERO_SHOT_BARS: Dict[str, Dict[str, float]] = {
    "cuda": {"synthetic_seen_miou": 0.28, "synthetic_zs3_unseen_miou": 0.12,
             "synthetic_zs3_harmonic_miou": 0.16, "synthetic_zs5_unseen_miou": 0.13,
             "synthetic_zs5_harmonic_miou": 0.17},
    "cpu": {"synthetic_seen_miou": 0.28, "synthetic_zs3_unseen_miou": 0.040,
            "synthetic_zs3_harmonic_miou": 0.068, "synthetic_zs5_unseen_miou": 0.10,
            "synthetic_zs5_harmonic_miou": 0.145},
}
# int8 runs the same checkpoint through the same protocol as float, so
# the delta is an invariant whatever the device.
INT8_MIOU_DELTA = 0.05
# zs3_tpu's acceptance rules for the synthetic chain
# (tests/test_zero_shot_acceptance.py), at acceptance depth: no unseen
# transfer before the generator, seen classes kept by every retrain, the
# int8 protocol keeping the transfer, and ZS5 improving on a ZS3 below the
# frozen trunk's unseen ceiling and holding one at it.
UNSEEN_BEFORE_GENERATOR = 0.02
RETRAINED_SEEN_MIOU = 0.30
ZS5_CEILING = 0.15
ZS5_GAIN = 0.02
ZS5_LOSS = 0.03
# The no-op runs of `rehearse(noop=True)`, and the bars each must fail: train-seen at
# LR 0 (weights at the converted init, only BN statistics move) is the
# untrained level that the seen floor and the QAT fine-tune must stay
# above; the ZS3 leg with a generator LR of 0 is zero transfer.
NOOPS = {
    "noop_evaluate_miou": ("evaluate_miou", "qat_int8_miou"),
    "noop_synthetic_zs3_unseen_miou": ("synthetic_zs3_unseen_miou",),
    "noop_synthetic_zs3_harmonic_miou": ("synthetic_zs3_harmonic_miou",),
}
QAT_LR = 0.0007  # 0.1x the base LR, the rehearsal's QAT fine-tune
FULL_LR = 0.007  # the base LR: the QAT fine-tune that --measure runs beside it


def run_cli(argv):
    """Run a port CLI command in-process (zs3_tpu_torch.cli.run); print its
    JSON line as the CLI would, and return its result (the metric dict
    of evaluate and evaluate-gmmn)."""
    from zs3_tpu_torch.cli import run

    result, _ = run(argv)
    print(json.dumps(result), flush=True)
    return result


def require(cond: bool, message: str) -> None:
    """Raise AssertionError(message) unless cond (a bar or a stage's check;
    unlike `assert`, it holds under python -O)."""
    if not cond:
        raise AssertionError(message)


def best_or_latest(run_dir: str, dataset: str, checkname: str) -> str:
    from zs3_tpu_torch.utils.saver import Saver

    exp = Saver.latest_experiment(run_dir, dataset, checkname)
    if exp is None:
        raise RuntimeError(f"no experiment under {run_dir}/{dataset}/{checkname}")
    ckpt = Saver.best_checkpoint(exp) or Saver.latest_checkpoint(exp)
    if ckpt is None:
        raise RuntimeError(f"no checkpoint in {exp}")
    return ckpt


def synthetic_config(run_dir: str, epochs: int, gmmn_lr: float = 1e-3):
    """The synthetic zero-shot split of zs3_tpu's acceptance test: R50 at
    49², 10 classes, unseen (3, 5), f32, class tints a linear function of
    the embeddings (so embedding -> feature transfer is well-posed)."""
    from zs3_tpu_torch.core.config import (
        Config, DataConfig, GMMNConfig, ModelConfig, OptimConfig, TrainConfig)

    return Config(
        model=ModelConfig(backbone="resnet50", num_classes=10, compute_dtype="float32",
                          dropout=False),
        gmmn=GMMNConfig(embed_dim=8, noise_dim=8, hidden_dim=128, pixels_per_class=64),
        data=DataConfig(dataset="synthetic", crop_size=49, base_size=49, batch_size=8,
                        eval_batch_size=8, unseen_classes=(3, 5), synthetic_classes=10,
                        synthetic_items=32, synthetic_embed_dim=8,
                        synthetic_tint_weight=1.0),
        optim=OptimConfig(lr=0.02, gmmn_lr=gmmn_lr, classifier_lr=1e-2),
        train=TrainConfig(epochs=epochs, eval_interval=10**9,
                          checkpoint_dir=os.path.join(run_dir, "synthetic_zs"),
                          keep_checkpoints=1),
    )


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms (no autotuning) for the block, the
    caller's settings after it.  With its default algorithms the card's
    synthetic stage differed from run to run at one seed (some f32 conv
    gradients are summed in no fixed order, and train-mode BN over a 4x4
    grid amplifies the rounding); with these its runs repeat bit for bit,
    so its bars stand on one value."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def synthetic_zs3(cfg, trunk: str, epochs: int, device: str):
    """The ZS3 leg from the seen trunk checkpoint `trunk`: the generator
    and the classifier retrained for `epochs` epochs; (the GMMNTrainer,
    its validation)."""
    from zs3_tpu_torch.train.gmmn import GMMNTrainer

    gcfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=epochs, resume=trunk))
    trainer = GMMNTrainer(gcfg, device=device)
    for e in range(epochs):
        trainer.train_epoch(e)
    return trainer, trainer.validate(epochs - 1)


@cudnn_deterministic()
def synthetic_zero_shot(run_dir: str, epochs: tuple, device: str = "cuda",
                        noop: bool = False) -> dict:
    """Measured zero-shot transfer on the synthetic split
    (`synthetic_config`), under `cudnn_deterministic`: seen training, the
    ZS3 leg, its int8 validation, then ZS5 warm-started from the ZS3
    generator and classifier.

    The fabricated VOC tree cannot show transfer: its embedding .npy is
    random vectors unlinked to class appearance, so unseen mIoU is
    structurally 0 there.  Returns {seen_miou, seen_unseen_miou,
    zs3_unseen_miou, zs3_harmonic_miou, zs3_seen_miou,
    zs3_int8_unseen_miou, zs3_int8_seen_miou}, with zs5_unseen_miou,
    zs5_harmonic_miou and zs5_seen_miou when epochs[2] > 0, and with
    `noop` the ZS3 leg again at a generator LR of 0 (noop_zs3_*)."""
    from zs3_tpu_torch.train.gmmn import GMMNTrainer
    from zs3_tpu_torch.train.seen import SeenTrainer
    from zs3_tpu_torch.train.self_training import ZS5Trainer
    from zs3_tpu_torch.utils.saver import Saver

    e_seen, e_gmmn, e_zs5 = epochs
    cfg = synthetic_config(run_dir, e_seen)
    seen = SeenTrainer(cfg, device=device)
    for e in range(e_seen):
        seen.train_epoch(e)
    seen_report = seen.validate(e_seen - 1)
    trunk = Saver.latest_checkpoint(seen.saver.directory)
    del seen

    t, zs3_report = synthetic_zs3(cfg, trunk, e_gmmn, device)
    # The int8 PTQ protocol on the same zero-shot model: a trainer whose
    # validation calibrates and runs the trunk int8.
    qcfg = t.cfg.replace(train=dataclasses.replace(t.cfg.train, int8_eval=True))
    tq = GMMNTrainer(qcfg, device=device)
    tq.load_checkpoint(t.checkpoint_payload())
    int8_report = tq.validate(e_gmmn - 1)
    del tq

    out = {
        "seen_miou": round(seen_report["seen_miou"], 4),
        "seen_unseen_miou": round(seen_report["unseen_miou"], 4),
        "zs3_unseen_miou": round(zs3_report["unseen_miou"], 4),
        "zs3_harmonic_miou": round(zs3_report["harmonic_miou"], 4),
        "zs3_seen_miou": round(zs3_report["seen_miou"], 4),
        "zs3_int8_unseen_miou": round(int8_report["unseen_miou"], 4),
        "zs3_int8_seen_miou": round(int8_report["seen_miou"], 4),
    }
    if e_zs5 > 0:
        z5cfg = t.cfg.replace(train=dataclasses.replace(
            t.cfg.train, epochs=e_zs5, checkpoint_dir=os.path.join(run_dir, "synthetic_zs5")))
        t5 = ZS5Trainer(z5cfg, device=device)
        t5.load_checkpoint(t.checkpoint_payload())  # warm start: generator, classifier, Adam
        require(t5.pseudo_label() > 0, "ZS5 wrote no pseudo-label")
        for e in range(e_zs5):
            t5.train_epoch(e)
        zs5_report = t5.validate(e_zs5 - 1)
        out["zs5_unseen_miou"] = round(zs5_report["unseen_miou"], 4)
        out["zs5_harmonic_miou"] = round(zs5_report["harmonic_miou"], 4)
        out["zs5_seen_miou"] = round(zs5_report["seen_miou"], 4)
        del t5
    del t
    if noop:
        _, noop_report = synthetic_zs3(synthetic_config(run_dir, e_seen, gmmn_lr=0.0), trunk,
                                       e_gmmn, device)
        out["noop_zs3_unseen_miou"] = round(noop_report["unseen_miou"], 4)
        out["noop_zs3_harmonic_miou"] = round(noop_report["harmonic_miou"], 4)
    return out


def rehearsal_bars(*, seen_steps: int, zero_shot: str, device: str) -> Dict[str, float]:
    """{metric: bar} of the depth-gated bars that hold for this run: the
    seen floor and QAT after >= 25 train-seen steps (the card's only), the
    transfer bars at the synthetic stage's acceptance depth ("full")."""
    bars: Dict[str, float] = {}
    if seen_steps >= 25:
        bars.update(SEEN_BARS.get(device, {}))
    if zero_shot == "full":
        bars.update(ZERO_SHOT_BARS[device])
    return bars


def assert_rehearsal_bars(metrics: dict, *, seen_steps: int, zero_shot: str,
                          device: str) -> None:
    """Bars with teeth: every one fails on a deliberately broken run (an
    LR-0 seen trainer, a QAT fine-tune that falls to the untrained level,
    a generator that never learns, zero unseen transfer, a diverging int8
    protocol).  Where `metrics` holds a no-op run's value (NOOPS), the bar
    must sit above it.  Pure dict logic, so the failure modes are pinned
    by a quick test; raises AssertionError."""
    for k, v in metrics.items():
        require(math.isfinite(v), f"non-finite rehearsal metric {k}={v}")
        require(k == "int8_miou_delta" or v >= 0.0, f"negative rehearsal metric {k}={v}")
    require(abs(metrics["int8_miou_delta"]) <= INT8_MIOU_DELTA,
            f"int8 protocol diverged from float: delta {metrics['int8_miou_delta']} "
            f"(float {metrics['evaluate_miou']}, int8 {metrics['evaluate_int8_miou']})")
    bars = rehearsal_bars(seen_steps=seen_steps, zero_shot=zero_shot, device=device)
    for noop, keys in NOOPS.items():
        for key in keys:
            if noop in metrics and key in bars:
                require(bars[key] > metrics[noop], f"bar {key} > {bars[key]} does not fail "
                                                   f"its no-op run ({noop}={metrics[noop]})")
    if "evaluate_miou" in bars:
        require(metrics["evaluate_miou"] > bars["evaluate_miou"],
                f"train-seen learned nothing: evaluate_miou {metrics['evaluate_miou']} is "
                f"at the LR=0 no-op level (bar {bars['evaluate_miou']})")
        if "qat_int8_miou" in metrics:
            require(metrics["qat_int8_miou"] > bars["qat_int8_miou"],
                    f"QAT fine-tune damaged the trained model: qat_int8_miou "
                    f"{metrics['qat_int8_miou']} (bar {bars['qat_int8_miou']})")
    if zero_shot == "full":
        assert_zero_shot_transfer(metrics, device)


def assert_zero_shot_transfer(metrics: dict, device: str) -> None:
    """The synthetic stage's bars at acceptance depth (ZERO_SHOT_BARS of
    `device`) and zs3_tpu's acceptance rules (tests/test_zero_shot_
    acceptance.py), on its `synthetic_*` metrics; raises AssertionError."""
    synthetic = {m: v for m, v in metrics.items() if m.startswith("synthetic_")}
    for k, bar in ZERO_SHOT_BARS[device].items():
        require(metrics[k] > bar, f"zero-shot transfer below bar: {k}={metrics[k]} <= {bar} "
                                  f"(all synthetic metrics: {synthetic})")
    require(metrics["synthetic_seen_unseen_miou"] < UNSEEN_BEFORE_GENERATOR,
            f"unseen classes transfer before the generator: {synthetic}")
    for k in ("synthetic_zs3_seen_miou", "synthetic_zs5_seen_miou"):
        require(metrics[k] > RETRAINED_SEEN_MIOU,
                f"classifier retrain destroyed seen classes: {k} <= {RETRAINED_SEEN_MIOU} "
                f"({synthetic})")
    zs3 = metrics["synthetic_zs3_unseen_miou"]
    require(metrics["synthetic_zs3_int8_unseen_miou"] > 0.8 * zs3 - 0.01,
            f"int8 eval lost the zero-shot transfer: {synthetic}")
    require(abs(metrics["synthetic_zs3_int8_seen_miou"] - metrics["synthetic_zs3_seen_miou"])
            < 0.05, f"int8 eval shifted seen mIoU: {synthetic}")
    zs5 = metrics["synthetic_zs5_unseen_miou"]
    if zs3 < ZS5_CEILING:  # ZS3 below the frozen trunk's ceiling: ZS5 must improve on it
        require(zs5 > zs3 + ZS5_GAIN, f"ZS5 did not improve unseen mIoU: {synthetic}")
    else:  # ZS3 at the ceiling: ZS5 must hold it
        require(zs5 > zs3 - ZS5_LOSS, f"ZS5 degraded unseen mIoU: {synthetic}")


def train_batches(argv) -> int:
    """Batches in one epoch of the train loader a CLI command builds."""
    from zs3_tpu_torch.cli import build_config, make_parser
    from zs3_tpu_torch.data.loader import make_train_loader

    return len(make_train_loader(build_config(make_parser().parse_args(argv)).data)[0])


def kernel_launches() -> Dict[str, int]:
    """The launch counts of K1 (upsample+argmax), K2 and K3 (the MMD
    kernel sums and their gradient); they stay 0 on the CPU."""
    from zs3_tpu_torch.ops import eval_kernels, mmd_kernels

    return {"K1": eval_kernels.upsample_argmax.launches,
            "K2": mmd_kernels.kernel_sum.launches,
            "K3": mmd_kernels.kernel_sum_grad.launches}


def rehearse(
    workdir: str,
    crop_size: int = 513,
    batch_size: int = 4,
    steps: int = 2,
    backbone: str = "resnet101",
    eval_scales: str = "0.75,1.0",
    compute_dtype: Optional[str] = None,
    seen_steps: Optional[int] = None,
    zero_shot: str = "auto",
    device: str = "cuda",
    noop: bool = False,
    check_bars: bool = True,
) -> dict:
    """The chain, stage by stage; returns the summary (raises on a failed
    stage or bar).  seen_steps: steps of the train-seen stage alone (None =
    25 on the card, so the seen floor has teeth; `steps` on the CPU).
    zero_shot: "full" runs the synthetic stage at acceptance depth
    (20/45/30 epochs) and asserts its bars, "smoke" (the CPU's default)
    the same chain at 2/3/2 epochs without them, "off" skips it.  `noop`
    adds the no-op runs and asserts every bar above them; without
    `check_bars` nothing is asserted of the metrics, and with `noop` the
    QAT fine-tune at the full LR runs too (to measure bars)."""
    import torch

    from zs3_tpu_torch.cli import build_config, make_parser
    from zs3_tpu_torch.core.device import resolve_device
    from zs3_tpu_torch.data.classes import VOC_CLASSES
    from zs3_tpu_torch.data.fabricate import (
        fabricate_embedding_npy, fabricate_sbd_tree, fabricate_torchvision_resnet_pth,
        fabricate_voc_tree)
    from zs3_tpu_torch.serve import InferenceServer

    dev = resolve_device(device).type
    on_card = dev == "cuda"
    if compute_dtype is None:
        compute_dtype = "bfloat16" if on_card else "float32"
    if seen_steps is None:
        seen_steps = 25 if on_card else steps
    if zero_shot == "auto":
        zero_shot = "full" if on_card else "smoke"
    os.makedirs(workdir, exist_ok=True)
    data_root = os.path.join(workdir, "data")
    run_dir = os.path.join(workdir, "run")
    timings: dict = {}
    launches: dict = {}
    t_all = time.time()

    @contextlib.contextmanager
    def stage(name):
        print(f"[rehearsal] {name} ...", file=sys.stderr, flush=True)
        before = kernel_launches()
        t0 = time.time()
        yield
        if on_card:
            torch.cuda.synchronize()
        timings[name] = round(time.time() - t0, 1)
        launches[name] = {k: n - before[k] for k, n in kernel_launches().items()}

    with stage("fabricate"):
        voc_stats = fabricate_voc_tree(data_root, n_train=12, n_val=4)
        fabricate_sbd_tree(data_root, n=8)
        pth = fabricate_torchvision_resnet_pth(
            os.path.join(workdir, "resnet.pth"),
            depth={"resnet101": 101, "resnet50": 50}[backbone])
        emb = fabricate_embedding_npy(os.path.join(workdir, "w2v_voc.npy"), VOC_CLASSES,
                                      dim=300)

    model_args = [
        "--dataset", "pascal", "--data-root", data_root, "--use-sbd",
        "--backbone", backbone, "--out-stride", "16",
        "--crop-size", str(crop_size), "--base-size", str(crop_size),
        "--batch-size", str(batch_size), "--unseen-split", "2",
        "--compute-dtype", compute_dtype, "--seed", "0", "--device", dev,
    ]
    common = [*model_args, "--checkpoint-dir", run_dir, "--checkname", "rehearsal"]
    # The flags of the training commands; the GMMN commands' embeddings.
    sched = ["--epochs", "1", "--steps-per-epoch", str(steps)]
    gmmn = [*sched, "--embedding-path", emb]

    with stage("convert-weights"):
        conv_ckpt = os.path.join(workdir, "pretrained_ckpt")
        run_cli(["convert-weights", pth, "--output", conv_ckpt, "--force", *common])

    # The train-seen schedule: seen_steps steps (rounded up to whole
    # epochs) with one validation at the end.  An epoch is one pass over
    # the fabricated train set (4 batches of 4 at the defaults), and a
    # trainer stops an epoch there whatever --steps-per-epoch asks, so 25
    # steps take 7 epochs of 4: one epoch of "25" would be 4 steps.
    per_epoch = min(seen_steps, train_batches(["train-seen", *common]))
    epochs = -(-seen_steps // per_epoch)
    seen_sched = ["--epochs", str(epochs), "--steps-per-epoch", str(per_epoch),
                  "--eval-interval", str(epochs)]

    with stage("train-seen"):
        # Deeper than the other stages: the fabricated tints are learnable,
        # so 25 steps buy a seen mIoU that the floor can gate (a 2-step
        # checkpoint evaluates at noise level, and any floor is vacuous).
        run_cli(["train-seen", "--resume", conv_ckpt, "--ft", *common, *seen_sched])
        seen_ckpt = best_or_latest(run_dir, "pascal", "rehearsal")

    with stage("train-gmmn"):
        # --int8-features: the frozen trunk's features come from int8
        # convs inside the step (the stage's dominant cost).
        run_cli(["train-gmmn", "--resume", seen_ckpt, "--int8-features", *common, *gmmn])
        gmmn_ckpt = best_or_latest(run_dir, "pascal", "rehearsal-gmmn")

    with stage("train-zs5"):
        run_cli(["train-zs5", "--resume", seen_ckpt, "--gmmn-resume", gmmn_ckpt, *common,
                 *gmmn])
        zs5_ckpt = best_or_latest(run_dir, "pascal", "rehearsal-zs5")

    metrics: dict = {}

    with stage("evaluate"):
        m_float = run_cli(["evaluate", "--resume", seen_ckpt, *common])
        metrics["evaluate_miou"] = m_float["miou"]

    with stage("evaluate-int8"):
        # The int8 deployment path through the same protocol: calibrated
        # on the first val batches, validated with s8 x s8 convs.
        m_int8 = run_cli(["evaluate", "--int8", "--resume", seen_ckpt, *common])
        metrics["evaluate_int8_miou"] = m_int8["miou"]
        metrics["int8_miou_delta"] = round(m_float["miou"] - m_int8["miou"], 4)

    def qat_int8_miou(lr: float, checkname: str) -> float:
        """QAT fine-tune of the trained checkpoint at `lr`, then the int8
        protocol on the QAT checkpoint."""
        run_cli(["train-seen", "--qat", "--resume", seen_ckpt, "--ft", "--lr", str(lr),
                 *common, *sched, "--checkname", checkname])
        qat_ckpt = best_or_latest(run_dir, "pascal", checkname)
        return run_cli(["evaluate", "--int8", "--resume", qat_ckpt, *common])["miou"]

    with stage("qat-finetune+int8"):
        # Quantization-aware fine-tune of the trunk (fake-quant convs,
        # straight-through gradients), then the int8 protocol on its
        # checkpoint, at 0.1x the base LR as zs3_tpu's: there the full LR's
        # fresh-momentum steps damaged its 4-step trunk (noop=True measures
        # the full LR on this one).
        metrics["qat_int8_miou"] = qat_int8_miou(QAT_LR, "rehearsal-qat")

    with stage("evaluate-gmmn+tta"):
        m_gmmn = run_cli(["evaluate-gmmn", "--resume", seen_ckpt, "--gmmn-resume", zs5_ckpt,
                          "--eval-scales", eval_scales, "--eval-flip", *common,
                          "--embedding-path", emb])
        for key in ("miou", "seen_miou", "unseen_miou", "harmonic_miou"):
            if m_gmmn.get(key) is not None:
                metrics[f"gmmn_tta_{key}"] = m_gmmn[key]

    if zero_shot != "off":
        with stage("zero-shot-synthetic"):
            zs_epochs = (20, 45, 30) if zero_shot == "full" else (2, 3, 2)
            zs = synthetic_zero_shot(run_dir, zs_epochs, dev, noop=noop)
            metrics.update({(f"noop_synthetic_{k[5:]}" if k.startswith("noop_")
                             else f"synthetic_{k}"): v for k, v in zs.items()})

    if noop:
        with stage("noop-train-seen-lr0"):
            # The no-op learner: weights stay at the converted init, only
            # BN statistics move.
            run_cli(["train-seen", "--resume", conv_ckpt, "--ft", "--lr", "0", *common,
                     *seen_sched, "--checkname", "rehearsal-lr0"])
            lr0_ckpt = best_or_latest(run_dir, "pascal", "rehearsal-lr0")
            metrics["noop_evaluate_miou"] = run_cli(
                ["evaluate", "--resume", lr0_ckpt, *common])["miou"]
        if not check_bars:  # measured beside the bars; no bar reads it
            with stage("qat-full-lr+int8"):
                metrics["qat_full_lr_int8_miou"] = qat_int8_miou(FULL_LR, "rehearsal-qat-full")

    bars = rehearsal_bars(seen_steps=seen_steps, zero_shot=zero_shot, device=dev)
    if check_bars:
        assert_rehearsal_bars(metrics, seen_steps=seen_steps, zero_shot=zero_shot,
                              device=dev)

    with stage("export"):
        artifact = os.path.join(workdir, "zs3_model.pt2")
        run_cli(["export", "--output", artifact, "--resume", seen_ckpt,
                 "--gmmn-resume", gmmn_ckpt, *common])
        with open(artifact + ".json") as f:
            manifest = json.load(f)
        require(manifest["zero_shot_classifier"] is True, f"manifest {manifest}")

    with stage("serve"):
        # Serve the seen checkpoint over HTTP and segment a non-square
        # image (the letterbox geometry end to end).
        cfg = build_config(make_parser().parse_args(
            ["serve", *model_args, "--resume", seen_ckpt]))
        srv = InferenceServer(cfg, port=0, device=dev).start(warmup=True)
        try:
            img = Image.fromarray(
                np.random.default_rng(0).integers(0, 255, (375, 500, 3)).astype(np.uint8))
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
            conn.request("POST", "/predict", body=buf.getvalue())
            resp = conn.getresponse()
            require(resp.status == 200, f"POST /predict: HTTP {resp.status}")
            pred = np.asarray(Image.open(io.BytesIO(resp.read())))
            require(pred.shape == (375, 500), f"a 375x500 request gave {pred.shape}")
            require(pred.max() < 21, f"label {pred.max()} of 21 classes")
            conn.close()
        finally:
            srv.stop()

    return {
        "ok": True,
        "backbone": backbone,
        "crop_size": crop_size,
        "batch_size": batch_size,
        "steps_per_stage": steps,
        "seen_steps": epochs * per_epoch,
        "zero_shot_mode": zero_shot,
        "backend": dev,
        "device_name": torch.cuda.get_device_name(0) if on_card else "cpu",
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
        "voc": voc_stats,
        "artifact_platforms": manifest["platforms"],
        "metrics": metrics,
        "bars": bars,
        "stage_seconds": timings,
        "stage_launches": launches,
        "total_seconds": round(time.time() - t_all, 1),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default="rehearsal")
    p.add_argument("--crop-size", type=int, default=513)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--backbone", default="resnet101", choices=["resnet101", "resnet50"])
    p.add_argument("--eval-scales", default="0.75,1.0")
    p.add_argument("--compute-dtype", default=None, choices=[None, "bfloat16", "float32"])
    p.add_argument("--seen-steps", type=int, default=None,
                   help="train-seen steps (default: 25 on the card, --steps on the CPU)")
    p.add_argument("--zero-shot", default="auto", choices=["auto", "full", "smoke", "off"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--measure", type=int, default=0, metavar="N",
                   help="the runs that set the bars: N rehearsals with the no-op runs and "
                        "no bar asserted, each in a workdir of its own (run_I, removed once "
                        "summarised, all but the last)")
    args = p.parse_args(argv)
    for i in range(max(args.measure, 1)):
        workdir = os.path.join(args.workdir, f"run_{i}") if args.measure else args.workdir
        summary = rehearse(
            workdir, crop_size=args.crop_size, batch_size=args.batch_size, steps=args.steps,
            backbone=args.backbone, eval_scales=args.eval_scales,
            compute_dtype=args.compute_dtype, seen_steps=args.seen_steps,
            zero_shot=args.zero_shot, device=args.device, noop=bool(args.measure),
            check_bars=not args.measure)
        print(json.dumps(summary), flush=True)
        if i + 1 < args.measure:
            shutil.rmtree(workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
