"""Seen-class evaluation (the eval side of zs3_tpu.train.seen).

`make_eval_step` mirrors zs3_tpu's: features -> classify at the feature
grid -> f32 logits -> predict_labels (kernel K1 on the GPU, the plain
version on the CPU) -> confusion matrix, so the full-resolution logits
never reach device memory.  `validate` drives an Evaluator over the val
loader; `evaluate` is the `cli evaluate` path end to end.  Training, and
the checkpoint write that zs3_tpu's validate does, come with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Union

import numpy as np
import torch

from zs3_tpu_torch.core.config import Config, DataConfig
from zs3_tpu_torch.core.device import resolve_device
from zs3_tpu_torch.data.loader import make_val_loader
from zs3_tpu_torch.metrics.evaluator import Evaluator
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
) -> Dict[str, float]:
    """Run the eval step over `val_loader`; returns the MetricReport dict
    (with seen/unseen/harmonic mIoU when unseen classes are set)."""
    device = resolve_device(device)
    evaluator = Evaluator(num_classes, data_cfg.ignore_index, data_cfg.unseen_classes)
    eval_step = make_eval_step(num_classes, data_cfg.ignore_index)
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
    val_loader, num_classes = make_val_loader(cfg.data)
    if cfg.model.num_classes != num_classes:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=num_classes))
    model = build_eval_model(cfg, device)
    return validate(model, val_loader, num_classes, cfg.data, device)
