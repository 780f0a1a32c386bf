"""Seen-class evaluation (the eval side of zs3_tpu.train.seen).

`make_eval_step` mirrors zs3_tpu's: features -> classify at the feature
grid -> f32 logits -> predict_labels (kernel K1 on the GPU, the plain
version on the CPU) -> confusion matrix, so the full-resolution logits
never reach device memory.  With `train.eval_scales != (1.0,)` or
`train.eval_flip`, `select_eval_step` gives the ms+flip TTA step
(metrics/tta.py) instead, as zs3_tpu's SeenTrainer does.  `validate`
drives an Evaluator over the val loader; `evaluate` is the `cli
evaluate` path end to end.  Training, int8 evaluation and the
checkpoint write that zs3_tpu's validate does come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Union

import numpy as np
import torch

from zs3_tpu_torch.core.config import Config, DataConfig, TrainConfig
from zs3_tpu_torch.core.device import resolve_device
from zs3_tpu_torch.data.loader import make_val_loader
from zs3_tpu_torch.metrics.evaluator import Evaluator
from zs3_tpu_torch.metrics.tta import make_tta_eval_step
from zs3_tpu_torch.models.deeplab import DeepLab, build_deeplab, init_deeplab
from zs3_tpu_torch.ops.confusion import confusion_matrix
from zs3_tpu_torch.ops.eval_kernels import predict_labels


def make_eval_step(
    num_classes: int, ignore_index: int = 255
) -> Callable[[DeepLab, Dict[str, torch.Tensor]], torch.Tensor]:
    @torch.inference_mode()
    def eval_step(model: DeepLab, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        images = batch["image"]
        feats = model.forward_features(images)
        logits = model.classify(feats)
        pred = predict_labels(logits.float(), tuple(images.shape[1:3]))
        return confusion_matrix(batch["label"], pred, num_classes, ignore_index)

    return eval_step


def select_eval_step(
    num_classes: int, ignore_index: int, train_cfg: TrainConfig
) -> Callable[[DeepLab, Dict[str, torch.Tensor]], torch.Tensor]:
    """The eval step `train_cfg` asks for: ms+flip TTA when eval_scales or
    eval_flip depart from single-scale, else the K1 eval step.  int8
    evaluation is refused, not run in float."""
    if train_cfg.int8_eval:
        raise NotImplementedError(
            "train.int8_eval (int8 PTQ evaluation) is not ported yet: "
            "ROADMAP Queue 1 item 10"
        )
    if tuple(train_cfg.eval_scales) != (1.0,) or train_cfg.eval_flip:
        return make_tta_eval_step(
            num_classes, ignore_index, train_cfg.eval_scales, train_cfg.eval_flip
        )
    return make_eval_step(num_classes, ignore_index)


def device_batch(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on `device` (images f32 NHWC, labels int32)."""
    return {
        "image": torch.from_numpy(batch["image"]).to(device, non_blocking=True),
        "label": torch.from_numpy(batch["label"]).to(device, non_blocking=True),
    }


def validate(
    model: DeepLab,
    val_loader,
    num_classes: int,
    data_cfg: DataConfig,
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


def build_eval_model(
    cfg: Config, device: Union[str, torch.device] = "cuda"
) -> DeepLab:
    """DeepLab for cfg.model on `device` in eval mode: seeded random init
    from cfg.train.seed, or the `.pt` state_dict (the port's naming) at
    cfg.train.resume."""
    device = resolve_device(device)
    model = build_deeplab(cfg.model)
    if cfg.train.resume:
        state = torch.load(cfg.train.resume, map_location="cpu", weights_only=True)
        model.load_state_dict(state.get("state_dict", state))
    else:
        init_deeplab(model, cfg.train.seed)
    return model.to(device=device, memory_format=torch.channels_last).eval()


def evaluate(cfg: Config, device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """`cli evaluate`: validate the (seeded or resumed) model once."""
    device = resolve_device(device)
    select_eval_step(1, cfg.data.ignore_index, cfg.train)  # refuses before any work
    val_loader, num_classes = make_val_loader(cfg.data)
    if cfg.model.num_classes != num_classes:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=num_classes))
    model = build_eval_model(cfg, device)
    return validate(model, val_loader, num_classes, cfg.data, device, cfg.train)
