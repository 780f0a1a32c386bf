"""Supervised seen-class training and evaluation (port of zs3_tpu.train.seen).

`make_train_step` mirrors zs3_tpu's: the model forward in train mode,
the loss at full resolution (`loss_at="full"`) or at the feature grid
(`"feature"`: forward_features -> classify, labels resized nearest to
the logits' grid), and with `grad_accum = N` N contiguous microbatches
whose gradients are summed and divided by N, whose losses are averaged
and whose BN statistics update one microbatch after the other; then one
SGD update (train/state.py).  Dropout draws from a torch.Generator
seeded from (train.seed, step), so a resumed run repeats an
uninterrupted one.

`make_eval_step` mirrors zs3_tpu's too: features -> classify at the
feature grid -> predict_labels (kernel K1 on the GPU, which reads the
model's bf16 or f32 logits as they are; the plain version, in f32, on
the CPU) -> confusion matrix, so the full-resolution logits never reach
device memory.  With `train.eval_scales != (1.0,)`
or `train.eval_flip`, `select_eval_step` gives the ms+flip TTA step
(metrics/tta.py) instead.

`SeenTrainer` drives training, validation and checkpoints (Saver) as
zs3_tpu's does; `evaluate` is `SeenTrainer(cfg).validate(epoch=0)`, the
`cli evaluate` path, and writes a checkpoint as zs3_tpu's does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from zs3_tpu_torch.core.config import Config, TrainConfig
from zs3_tpu_torch.core.device import resolve_device
from zs3_tpu_torch.data.loader import make_data_loader
from zs3_tpu_torch.data.transforms import batched_normalize_device, batched_random_flip_device
from zs3_tpu_torch.metrics.evaluator import Evaluator
from zs3_tpu_torch.metrics.tta import make_tta_eval_step
from zs3_tpu_torch.models.deeplab import DeepLab, build_deeplab, init_deeplab
from zs3_tpu_torch.models.layers import set_dropout_generator
from zs3_tpu_torch.ops.confusion import confusion_matrix
from zs3_tpu_torch.ops.eval_kernels import predict_labels
from zs3_tpu_torch.ops.resize import resize_nearest
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils.logging import MetricLogger
from zs3_tpu_torch.utils.losses import build_seg_loss, compute_dataset_class_weights
from zs3_tpu_torch.utils.saver import Saver

Batch = Dict[str, torch.Tensor]


FLIP_STREAM = 1  # step_generator's stream of the device_preprocess flip masks


def step_generator(seed: int, step: int, device: torch.device,
                   stream: int = 0) -> torch.Generator:
    """The generator of step `step`'s random draws (the seen step's
    dropout masks, the ZS3 step's scores and noise): a function of
    (seed, step) alone, as zs3_tpu's `fold_in(rng, step)`.  Another
    `stream` (FLIP_STREAM: the flips of device_preprocess) is a stream of
    its own, so turning it on shifts no draw of stream 0."""
    spawn_key = (stream,) if stream else ()
    state = np.random.SeedSequence((seed, step), spawn_key=spawn_key).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def preprocess_on_device(batch: Batch, seed: int, step: int) -> Batch:
    """A device_preprocess batch (uint8 NHWC images, int32 labels) made
    ready for the step where it lies: images normalized, then each sample
    mirrored with probability 1/2 from step_generator(seed, step,
    FLIP_STREAM) (zs3_tpu's batched_normalize_device and
    batched_random_flip_device)."""
    images = batched_normalize_device(batch["image"])
    gen = step_generator(seed, step, images.device, FLIP_STREAM)
    images, labels = batched_random_flip_device(images, batch["label"], gen)
    return {**batch, "image": images, "label": labels}


def make_train_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    loss_at: str = "full",
    grad_accum: int = 1,
    seed: int = 0,
    device_preprocess: bool = False,
    qat: bool = False,
) -> Callable[[DeepLab, SegOptimizer, Batch], Dict[str, torch.Tensor]]:
    """train_step(model, optimizer, batch) -> {"loss": mean loss}: one
    optimizer update of `model` on the batch (the effective batch when
    grad_accum > 1).  The gradients stay in the parameters' .grad.  With
    `device_preprocess` the batch's images are uint8, normalized and
    flipped in the step (preprocess_on_device)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if loss_at not in ("full", "feature"):
        raise ValueError(f"loss_at must be 'full' or 'feature', got {loss_at!r}")
    if qat:
        raise NotImplementedError("train.qat (quantization-aware training) is not ported "
                                  "yet: see ROADMAP Queue 1, Quantization")

    def micro_loss(model: DeepLab, images: torch.Tensor, labels: torch.Tensor):
        if loss_at == "feature":
            # The loss at the os4 grid: the full-resolution logits never exist.
            logits = model.classify(model.forward_features(images))
            return loss_fn(logits.float(), resize_nearest(labels, tuple(logits.shape[1:3])))
        return loss_fn(model(images), labels)

    def train_step(model: DeepLab, optimizer: SegOptimizer, batch: Batch):
        if device_preprocess:
            batch = preprocess_on_device(batch, seed, optimizer.step)
        images, labels = batch["image"], batch["label"]
        if images.shape[0] % grad_accum:
            raise ValueError(f"batch size {images.shape[0]} is not divisible by grad_accum "
                             f"{grad_accum}")
        model.train()
        set_dropout_generator(model, step_generator(seed, optimizer.step, images.device))
        optimizer.zero_grad()
        loss_sum = None
        for mb_images, mb_labels in zip(images.chunk(grad_accum), labels.chunk(grad_accum)):
            loss = micro_loss(model, mb_images, mb_labels)
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        if grad_accum > 1:
            torch._foreach_div_([p.grad for p in model.parameters() if p.grad is not None],
                                grad_accum)
        optimizer.apply()
        return {"loss": loss_sum / grad_accum}

    return train_step


def make_eval_step(
    num_classes: int, ignore_index: int = 255
) -> Callable[[DeepLab, Batch], torch.Tensor]:
    @torch.inference_mode()
    def eval_step(model: DeepLab, batch: Batch) -> torch.Tensor:
        images = batch["image"]
        feats = model.forward_features(images)
        logits = model.classify(feats)
        pred = predict_labels(logits, tuple(images.shape[1:3]))
        return confusion_matrix(batch["label"], pred, num_classes, ignore_index)

    return eval_step


def select_eval_step(
    num_classes: int, ignore_index: int, train_cfg: TrainConfig
) -> Callable[[DeepLab, Batch], torch.Tensor]:
    """The eval step `train_cfg` asks for: ms+flip TTA when eval_scales or
    eval_flip depart from single-scale, else the K1 eval step.  int8
    evaluation is refused, not run in float."""
    if train_cfg.int8_eval:
        raise NotImplementedError(
            "train.int8_eval (int8 PTQ evaluation) is not ported yet: "
            "see ROADMAP Queue 1, Quantization"
        )
    if tuple(train_cfg.eval_scales) != (1.0,) or train_cfg.eval_flip:
        return make_tta_eval_step(
            num_classes, ignore_index, train_cfg.eval_scales, train_cfg.eval_flip
        )
    return make_eval_step(num_classes, ignore_index)


def device_batch(batch: Mapping[str, Any], device: torch.device) -> Batch:
    """A host batch (numpy arrays, or the loader's pinned tensors) ->
    tensors on `device` in their own dtypes (images f32, or uint8 with
    device_preprocess; labels int32).  From pinned memory the copies are
    asynchronous."""
    return {
        "image": torch.as_tensor(batch["image"]).to(device, non_blocking=True),
        "label": torch.as_tensor(batch["label"]).to(device, non_blocking=True),
    }


def validate(
    model: DeepLab,
    val_loader,
    num_classes: int,
    data_cfg,
    device: Union[str, torch.device] = "cuda",
    train_cfg: TrainConfig = TrainConfig(),
) -> Dict[str, float]:
    """Run the eval step `train_cfg` selects over `val_loader`; returns the
    MetricReport dict (with seen/unseen/harmonic mIoU when unseen classes
    are set)."""
    device = resolve_device(device)
    evaluator = Evaluator(num_classes, data_cfg.ignore_index, data_cfg.unseen_classes)
    eval_step = select_eval_step(num_classes, data_cfg.ignore_index, train_cfg)
    model.eval()
    for batch in val_loader:
        evaluator.add_confusion(eval_step(model, device_batch(batch, device)))
    return evaluator.compute().as_dict()


def model_state_dict(payload: Mapping[str, Any]) -> Mapping[str, torch.Tensor]:
    """The DeepLab weights of a checkpoint: a Saver checkpoint's "model",
    or a bare state_dict (its "state_dict" entry when it has one)."""
    if "model" in payload:
        return payload["model"]
    return payload.get("state_dict", payload)


def build_eval_model(
    cfg: Config, device: Union[str, torch.device] = "cuda"
) -> DeepLab:
    """DeepLab for cfg.model on `device` in eval mode: seeded random init
    from cfg.train.seed, or the weights at cfg.train.resume (a `train-seen`
    checkpoint or a bare `.pt` state_dict in the port's naming)."""
    device = resolve_device(device)
    model = build_deeplab(cfg.model)
    if cfg.train.resume:
        model.load_state_dict(model_state_dict(Saver.restore(cfg.train.resume)))
    else:
        init_deeplab(model, cfg.train.seed)
    return model.to(device=device, memory_format=torch.channels_last).eval()


class SeenTrainer:
    """Step 1 of the pipeline: DeepLabv3+ on the seen classes, with
    validation, checkpoints and metric logs (zs3_tpu.train.seen.SeenTrainer)."""

    def __init__(self, cfg: Config, device: Union[str, torch.device] = "cuda",
                 saver: Optional[Saver] = None):
        device = resolve_device(device)
        select_eval_step(1, cfg.data.ignore_index, cfg.train)  # refuses before any work
        self.train_loader, self.val_loader, num_classes = make_data_loader(
            cfg.data, pin_memory=device.type == "cuda")
        if cfg.model.num_classes != num_classes:
            cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=num_classes))
        self.cfg = cfg
        self.device = device
        self.num_classes = num_classes
        class_weights = None
        if cfg.optim.use_balanced_weights:
            # Keyed by everything that changes the filtered train set.
            split_tag = "-".join(str(c) for c in cfg.data.unseen_classes) or "none"
            variant = ("_sbd" if cfg.data.use_sbd else "") + (
                "_weak" if cfg.data.weak_label_dir else "")
            cache = os.path.join(
                cfg.train.checkpoint_dir,
                f"{cfg.data.dataset}_u{split_tag}{variant}_class_hist.npy")
            class_weights = compute_dataset_class_weights(
                self.train_loader.dataset, num_classes, cfg.data.ignore_index,
                cache_path=cache).to(device)
        self.loss_fn = build_seg_loss(cfg.optim.loss_type, cfg.data.ignore_index,
                                      class_weights)
        self.train_step = make_train_step(  # refuses qat
            self.loss_fn, cfg.optim.loss_at, cfg.train.grad_accum, cfg.train.seed,
            cfg.data.device_preprocess, cfg.train.qat,
        )
        model = init_deeplab(build_deeplab(cfg.model), cfg.train.seed)
        self.model = model.to(device=device, memory_format=torch.channels_last)
        self.steps_per_epoch = cfg.train.steps_per_epoch or len(self.train_loader)
        self.optimizer = SegOptimizer(self.model, cfg, self.steps_per_epoch * cfg.train.epochs)
        self.best_metric = 0.0
        if cfg.train.resume:
            payload = Saver.restore(cfg.train.resume)
            self.model.load_state_dict(model_state_dict(payload))
            # --ft: weights only, a fresh optimizer, step and schedule.
            if not cfg.train.finetune:
                if "optimizer" in payload:
                    self.optimizer.load_state_dict(payload["optimizer"])
                # Carry the best-so-far across a resume, so a validation
                # after a crash cannot point 'best' at a worse model.
                self.best_metric = float(
                    Saver.read_meta(cfg.train.resume).get("best_metric", 0.0))
        self.saver = saver or Saver(cfg.train.checkpoint_dir, cfg.data.dataset,
                                    cfg.train.checkname, cfg, keep=cfg.train.keep_checkpoints)
        self.logger = MetricLogger(self.saver.directory, tensorboard=cfg.train.tensorboard)
        self.history = []

    @property
    def step(self) -> int:
        return self.optimizer.step

    def checkpoint_payload(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        losses = []
        t0 = time.time()
        for i, batch in enumerate(self.train_loader):
            if i >= self.steps_per_epoch:
                break
            out = self.train_step(self.model, self.optimizer, device_batch(batch, self.device))
            losses.append(out["loss"])
            if self.cfg.train.log_every and (i + 1) % self.cfg.train.log_every == 0:
                self.logger.log(self.step, {"loss": float(out["loss"])}, prefix="train_step")
        loss = float(torch.stack(losses).mean()) if losses else float("nan")
        stats = {"epoch": epoch, "train_loss": loss, "epoch_seconds": time.time() - t0}
        self.logger.log(self.step, stats, prefix="train")
        self.history.append(stats)
        return stats

    def validate(self, epoch: int) -> Dict[str, float]:
        """Metrics over the val set; writes a checkpoint, `best` when the
        mIoU improved."""
        report = validate(self.model, self.val_loader, self.num_classes, self.cfg.data,
                          self.device, self.cfg.train)
        if self.cfg.train.tensorboard:
            self._log_panels(next(iter(self.val_loader)))
        self.logger.log(self.step, report, prefix="val")
        metric = report["miou"]
        is_best = metric > self.best_metric
        if is_best:
            self.best_metric = metric
        self.saver.save_checkpoint(self.checkpoint_payload(), self.step, self.best_metric,
                                   is_best=is_best, extra={"epoch": epoch, **report})
        return report

    def _log_panels(self, batch):
        """Input, ground-truth and prediction colour panels of the first
        val image (TensorBoard only)."""
        from zs3_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
        from zs3_tpu_torch.utils.viz import decode_segmap

        with torch.inference_mode():
            images = torch.as_tensor(batch["image"][:1]).to(self.device)
            pred = self.model(images).argmax(-1)[0].cpu().numpy()
        img = np.asarray(batch["image"][0])
        img = np.clip((img * IMAGENET_STD + IMAGENET_MEAN) * 255, 0, 255).astype(np.uint8)
        self.logger.log_images(self.step, {
            "val/input": img,
            "val/ground_truth": decode_segmap(np.asarray(batch["label"][0]), self.num_classes),
            "val/prediction": decode_segmap(pred, self.num_classes),
        })

    def fit(self) -> Dict[str, float]:
        last_report: Dict[str, float] = {}
        stats: Dict[str, float] = {}
        validated = False
        for epoch in range(self.cfg.train.epochs):
            stats = self.train_epoch(epoch)
            # eval_interval <= 0 means never validate (like --no-val).
            validated = (self.cfg.train.eval_interval > 0
                         and (epoch + 1) % self.cfg.train.eval_interval == 0)
            if validated:
                last_report = self.validate(epoch)
        if self.cfg.train.epochs and not validated:
            # --no-val, or epochs after the last validation: checkpoints
            # are otherwise written by validate() alone.
            self.saver.save_checkpoint(self.checkpoint_payload(), self.step, self.best_metric,
                                       is_best=False, extra={"epoch": self.cfg.train.epochs - 1})
        return {**stats, **last_report}


def evaluate(cfg: Config, device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """`cli evaluate`: validate the (seeded or resumed) model once, which
    writes a checkpoint, as zs3_tpu's does."""
    return SeenTrainer(cfg, device).validate(epoch=0)
