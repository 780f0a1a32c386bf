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
(metrics/tta.py) instead.  With `train.int8_eval` the step runs under
quant.quantized(scales), calibrated once on the first 2 val batches
(`calibrate_on_val`); with `train.qat` the train step's convs run on
fake-quantized operands (quant.qat()).

`SeenTrainer` drives training, validation and checkpoints (Saver) as
zs3_tpu's does; `evaluate` is `SeenTrainer(cfg).validate(epoch=0)`, the
`cli evaluate` path, and writes a checkpoint as zs3_tpu's does.

Over the ranks of a process group (core/mesh.py) each rank trains on its
rows of the global batch, with BN statistics, loss and gradients of the
global batch and the masks one rank would draw, so N ranks take one
rank's step; validation pads, shards and sums the confusion; rank 0
alone writes checkpoints and logs.  Under a `space` mesh axis the
trainers hold each data block whole on every space rank, as zs3_tpu's
do; parallel/spatial.py's train step splits H over them instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from zs3_tpu_torch import quant
from zs3_tpu_torch.core.config import Config, TrainConfig
from zs3_tpu_torch.core.device import resolve_device
from zs3_tpu_torch.core.mesh import Mesh, all_reduce_, all_reduce_grads_, mesh_from_config
from zs3_tpu_torch.data.loader import make_data_loader
from zs3_tpu_torch.data.transforms import batched_normalize_device, batched_random_flip_device
from zs3_tpu_torch.metrics.evaluator import Evaluator
from zs3_tpu_torch.metrics.tta import make_tta_eval_step
from zs3_tpu_torch.models.deeplab import DeepLab, build_deeplab, init_deeplab
from zs3_tpu_torch.models.layers import set_dropout_generator
from zs3_tpu_torch.ops.confusion import confusion_matrix
from zs3_tpu_torch.ops.eval_kernels import predict_labels
from zs3_tpu_torch.ops.resize import resize_nearest
from zs3_tpu_torch.parallel import spatial
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils.logging import MetricLogger
from zs3_tpu_torch.utils.losses import build_seg_loss, compute_dataset_class_weights
from zs3_tpu_torch.utils.profiling import span
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


def preprocess_on_device(batch: Batch, seed: int, step: int,
                         shard: Tuple[int, int] = (0, 1)) -> Batch:
    """A device_preprocess batch (uint8 NHWC images, int32 labels) made
    ready for the step where it lies: images normalized, then each sample
    mirrored with probability 1/2 from step_generator(seed, step,
    FLIP_STREAM) (zs3_tpu's batched_normalize_device and
    batched_random_flip_device).  As rank r of `shard` (rank, ranks) the
    batch is rank r's rows, flipped by those rows of the global mask."""
    images = batched_normalize_device(batch["image"])
    gen = step_generator(seed, step, images.device, FLIP_STREAM)
    images, labels = batched_random_flip_device(images, batch["label"], gen, shard)
    return {**batch, "image": images, "label": labels}


def shard_of(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(batch shard, batch shards) of `mesh`: its data index and size, the
    same on the space ranks of one data index; (0, 1) without one."""
    return (0, 1) if mesh is None else (mesh.data_index, mesh.data_size)


def forward_for_loss(model: DeepLab, images: torch.Tensor, labels: torch.Tensor,
                     loss_at: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, labels) the seen loss compares: at full resolution
    ("full"), or at the os4 grid ("feature": forward_features -> classify,
    labels resized nearest to the logits' grid; the full-resolution logits
    never exist)."""
    if loss_at == "feature":
        logits = model.classify(model.forward_features(images))
        return logits.float(), resize_nearest(labels, tuple(logits.shape[1:3]))
    return model(images), labels


def make_train_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    loss_at: str = "full",
    grad_accum: int = 1,
    seed: int = 0,
    device_preprocess: bool = False,
    qat: bool = False,
    mesh: Optional[Mesh] = None,
) -> Callable[[DeepLab, SegOptimizer, Batch], Dict[str, torch.Tensor]]:
    """train_step(model, optimizer, batch) -> {"loss": mean loss}: one
    optimizer update of `model` on the batch (the effective batch when
    grad_accum > 1).  The gradients stay in the parameters' .grad.  With
    `device_preprocess` the batch's images are uint8, normalized and
    flipped in the step (preprocess_on_device).  With `qat` the forwards
    and backwards run under quant.qat() (zs3_tpu's QAT train step).

    Over a `mesh` of several ranks the batch is this rank's rows, and
    `loss_fn` must be the mesh's (build_seg_loss(..., mesh=mesh): each
    rank's share of the global mean).  The microbatches are each rank's
    rows cut in grad_accum, as zs3_tpu's mesh step cuts them (microbatch
    k is every rank's k-th sub-chunk), the gradients are summed over the
    ranks once, after the last microbatch, and the loss returned is the
    global batch's.  A mesh with a `space` axis of several ranks that are
    not replicas (make_mesh's; parallel/spatial.py's train step) takes
    this rank's rows of H too: each microbatch's forward runs under the
    spatial sharding of its plan.

    Each call is a span `zs3.train.step` (utils/profiling.py::span) over
    `zs3.train.prepare` (preprocessing, train mode, the dropout generator,
    zero_grad), each microbatch's `zs3.train.forward` (forward and loss)
    and `zs3.train.backward`, and `zs3.train.optimizer`; the gradient
    all-reduce and the grad_accum divide are the step's own time."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if loss_at not in ("full", "feature"):
        raise ValueError(f"loss_at must be 'full' or 'feature', got {loss_at!r}")
    planner = None
    if mesh is not None and mesh.space_size > 1 and not mesh.space_replicas:
        planner = spatial.Planner(mesh)

    def micro_loss(model: DeepLab, images: torch.Tensor, labels: torch.Tensor):
        def forward(x, y):
            return forward_for_loss(model, x, y, loss_at)

        if planner is None:
            return loss_fn(*forward(images, labels))
        with planner.sharded(forward, model, images, labels):
            return loss_fn(*forward(images, labels))

    shard = shard_of(mesh)

    def train_step(model: DeepLab, optimizer: SegOptimizer, batch: Batch):
        with span("zs3.train.step"):
            with span("zs3.train.prepare"):
                if device_preprocess:
                    batch = preprocess_on_device(batch, seed, optimizer.step, shard)
                images, labels = batch["image"], batch["label"]
                if images.shape[0] % grad_accum:
                    where = f" on each of {shard[1]} ranks" if shard[1] > 1 else ""
                    raise ValueError(f"batch size {images.shape[0]}{where} is not divisible "
                                     f"by grad_accum {grad_accum}")
                model.train()
                set_dropout_generator(model, step_generator(seed, optimizer.step,
                                                            images.device), shard)
                optimizer.zero_grad()
            loss_sum = None
            with quant.qat() if qat else contextlib.nullcontext():
                for mb_images, mb_labels in zip(images.chunk(grad_accum),
                                                labels.chunk(grad_accum)):
                    with span("zs3.train.forward"):
                        loss = micro_loss(model, mb_images, mb_labels)
                    with span("zs3.train.backward"):
                        loss.backward()
                    loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            if mesh is not None:
                loss_sum = all_reduce_grads_(model.parameters(), mesh, extra=loss_sum)
            if grad_accum > 1:
                torch._foreach_div_([p.grad for p in model.parameters() if p.grad is not None],
                                    grad_accum)
            with span("zs3.train.optimizer"):
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
    num_classes: int, ignore_index: int, train_cfg: TrainConfig,
    scales: Optional[quant.Scales] = None,
) -> Callable[[DeepLab, Batch], torch.Tensor]:
    """The eval step `train_cfg` asks for: ms+flip TTA when eval_scales or
    eval_flip depart from single-scale, else the K1 eval step; run under
    quant.quantized(scales) when int8 scales are given.  int8_eval needs
    them: it never runs in float."""
    if train_cfg.int8_eval and scales is None:
        raise ValueError("train.int8_eval: pass the calibrated int8 scales "
                         "(calibrate_on_val)")
    if tuple(train_cfg.eval_scales) != (1.0,) or train_cfg.eval_flip:
        step = make_tta_eval_step(
            num_classes, ignore_index, train_cfg.eval_scales, train_cfg.eval_flip
        )
    else:
        step = make_eval_step(num_classes, ignore_index)
    return quant.under(scales, step)


def device_batch(batch: Mapping[str, Any], device: torch.device) -> Batch:
    """A host batch (numpy arrays, or the loader's pinned tensors) ->
    tensors on `device` in their own dtypes (images f32, or uint8 with
    device_preprocess; labels int32).  From pinned memory the copies are
    asynchronous."""
    return {
        "image": torch.as_tensor(batch["image"]).to(device, non_blocking=True),
        "label": torch.as_tensor(batch["label"]).to(device, non_blocking=True),
    }


def calibrate_on_val(
    model: DeepLab, val_loader, device: torch.device, percentile: Optional[float] = None,
    forward: Optional[Callable] = None,
) -> quant.Scales:
    """int8 scales of `model` (in eval mode) from the first 2 val batches,
    as zs3_tpu's trainers calibrate (quant.calibrate_from_batches)."""
    images = (device_batch(b, device)["image"] for b in val_loader)
    return quant.calibrate_from_batches(model.eval(), images, forward=forward,
                                        percentile=percentile)


def sum_confusion(eval_fn: Callable[[Batch], torch.Tensor], val_loader, num_classes: int,
                  device: torch.device, ignore_index: int,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The (C, C) int64 confusion of `eval_fn` over `val_loader`; over a
    `mesh`, of each rank's rows of every batch padded with inert rows,
    summed over the ranks."""
    from zs3_tpu_torch.core import mesh as mesh_lib

    mesh = mesh or Mesh({"data": 1})
    total = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    for batch in val_loader:
        total += eval_fn(mesh_lib.device_batch(batch, mesh, ignore_index, device, eval=True))
    return all_reduce_(total, mesh)


def validate(
    model: DeepLab,
    val_loader,
    num_classes: int,
    data_cfg,
    device: Union[str, torch.device] = "cuda",
    train_cfg: TrainConfig = TrainConfig(),
    scales: Optional[quant.Scales] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, float]:
    """Run the eval step `train_cfg` selects over `val_loader`; returns the
    MetricReport dict (with seen/unseen/harmonic mIoU when unseen classes
    are set).  int8_eval without `scales` calibrates on the val set.  Over
    a `mesh` the ranks split every batch (sum_confusion)."""
    device = resolve_device(device)
    if train_cfg.int8_eval and scales is None:
        scales = calibrate_on_val(model, val_loader, device, train_cfg.int8_percentile)
    evaluator = Evaluator(num_classes, data_cfg.ignore_index, data_cfg.unseen_classes)
    eval_step = select_eval_step(num_classes, data_cfg.ignore_index, train_cfg, scales)
    model.eval()
    evaluator.add_confusion(sum_confusion(lambda b: eval_step(model, b), val_loader,
                                          num_classes, device, data_cfg.ignore_index, mesh))
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
    validation, checkpoints and metric logs (zs3_tpu.train.seen.SeenTrainer).
    Over the ranks of a process group each rank loads and trains on its
    rows (core/mesh.py); rank 0 alone has a saver and a logger."""

    def __init__(self, cfg: Config, device: Union[str, torch.device] = "cuda",
                 saver: Optional[Saver] = None):
        device = resolve_device(device)
        self.mesh = mesh_from_config(cfg)
        self.train_loader, self.val_loader, num_classes = make_data_loader(
            cfg.data, pin_memory=device.type == "cuda", shard=shard_of(self.mesh))
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
                                      class_weights, mesh=self.mesh)
        self.train_step = make_train_step(
            self.loss_fn, cfg.optim.loss_at, cfg.train.grad_accum, cfg.train.seed,
            cfg.data.device_preprocess, cfg.train.qat, mesh=self.mesh,
        )
        model = init_deeplab(build_deeplab(cfg.model), cfg.train.seed)
        self.model = model.to(device=device, memory_format=torch.channels_last)
        self.steps_per_epoch = cfg.train.steps_per_epoch or len(self.train_loader)
        self.optimizer = SegOptimizer(self.model, cfg, self.steps_per_epoch * cfg.train.epochs)
        self.best_metric = 0.0
        self._int8_scales: Optional[quant.Scales] = None
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
        self.saver: Optional[Saver] = None
        self.logger: Optional[MetricLogger] = None
        if self.mesh.is_writer:
            self.saver = saver or Saver(cfg.train.checkpoint_dir, cfg.data.dataset,
                                        cfg.train.checkname, cfg,
                                        keep=cfg.train.keep_checkpoints)
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
            if (self.logger and self.cfg.train.log_every
                    and (i + 1) % self.cfg.train.log_every == 0):
                self.logger.log(self.step, {"loss": float(out["loss"])}, prefix="train_step")
        loss = float(torch.stack(losses).mean()) if losses else float("nan")
        stats = {"epoch": epoch, "train_loss": loss, "epoch_seconds": time.time() - t0}
        if self.logger:
            self.logger.log(self.step, stats, prefix="train")
        self.history.append(stats)
        return stats

    def int8_scales(self) -> Optional[quant.Scales]:
        """With train.int8_eval, the scales of the first validation's model
        (first 2 val batches), kept for the trainer's lifetime as zs3_tpu
        keeps them; else None."""
        if self.cfg.train.int8_eval and self._int8_scales is None:
            self._int8_scales = calibrate_on_val(self.model, self.val_loader, self.device,
                                                 self.cfg.train.int8_percentile)
        return self._int8_scales

    def validate(self, epoch: int) -> Dict[str, float]:
        """Metrics over the val set; writes a checkpoint, `best` when the
        mIoU improved.  Under int8_eval the panels show the int8 model too."""
        scales = self.int8_scales()
        report = validate(self.model, self.val_loader, self.num_classes, self.cfg.data,
                          self.device, self.cfg.train, scales, self.mesh)
        metric = report["miou"]
        is_best = metric > self.best_metric
        if is_best:
            self.best_metric = metric
        if self.mesh.is_writer:
            if self.cfg.train.tensorboard:
                quant.under(scales, self._log_panels)(next(iter(self.val_loader)))
            self.logger.log(self.step, report, prefix="val")
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
        if self.cfg.train.epochs and not validated and self.mesh.is_writer:
            # --no-val, or epochs after the last validation: checkpoints
            # are otherwise written by validate() alone.
            self.saver.save_checkpoint(self.checkpoint_payload(), self.step, self.best_metric,
                                       is_best=False, extra={"epoch": self.cfg.train.epochs - 1})
        return {**stats, **last_report}


def evaluate(cfg: Config, device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """`cli evaluate`: validate the (seeded or resumed) model once, which
    writes a checkpoint, as zs3_tpu's does."""
    return SeenTrainer(cfg, device).validate(epoch=0)
