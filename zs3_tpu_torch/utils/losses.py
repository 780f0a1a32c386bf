"""Segmentation losses (port of zs3_tpu.utils.losses).

Cross-entropy and focal loss over (..., C) logits and (...) integer
labels: the mean over valid pixels (not 255, not >= C, not < 0), with
optional per-class weights normalised by the sum of the weights, as
torch's NLLLoss(weight=...) and zs3_tpu do.  The log-softmax runs in
f32, or in the logits' dtype when that is wider.  Balanced class weights are
1 / ln(1.02 + f_c) of the train set's label histogram, cached as .npy.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _nll_and_weight(logits, labels, ignore_index, class_weights):
    """Per-pixel negative log-likelihood and its validity (x class) weight."""
    num_classes = logits.shape[-1]
    labels = labels.long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    w = valid.float()
    if class_weights is not None:
        w = w * class_weights.to(device=logits.device, dtype=torch.float32)[safe]
    return nll, w


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = 255,
    class_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE over non-ignored pixels. logits (..., C), labels (...)."""
    nll, w = _nll_and_weight(logits, labels, ignore_index, class_weights)
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = 255,
    gamma: float = 2.0,
    alpha: float = 0.5,
    class_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """alpha * (1 - exp(-CE))^gamma * CE per valid pixel, averaged."""
    nll, w = _nll_and_weight(logits, labels, ignore_index, class_weights)
    fl = alpha * (1.0 - torch.exp(-nll)) ** gamma * nll
    return (fl * w).sum() / w.sum().clamp(min=1.0)


def build_seg_loss(
    mode: str = "ce",
    ignore_index: int = 255,
    class_weights: Optional[torch.Tensor] = None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    if mode == "ce":
        return lambda logits, labels: cross_entropy_loss(
            logits, labels, ignore_index, class_weights
        )
    if mode == "focal":
        return lambda logits, labels: focal_loss(
            logits, labels, ignore_index, class_weights=class_weights
        )
    raise ValueError(f"unknown loss mode {mode!r}")


def calculate_class_weights(histogram, smooth: float = 1.02) -> torch.Tensor:
    """1 / ln(smooth + f_c) of the normalised label histogram (f32)."""
    hist = torch.as_tensor(np.asarray(histogram), dtype=torch.float32)
    freq = hist / hist.sum().clamp(min=1.0)
    return 1.0 / torch.log(smooth + freq)


def compute_dataset_class_weights(
    dataset,
    num_classes: int,
    ignore_index: int = 255,
    cache_path: Optional[str] = None,
) -> torch.Tensor:
    """One pass over the dataset's label maps -> balanced class weights;
    the int64 histogram is cached at `cache_path` (.npy) when given."""
    if cache_path is not None and os.path.exists(cache_path):
        hist = np.load(cache_path)
    else:
        hist = np.zeros((num_classes,), np.int64)
        for i in range(len(dataset)):
            label = np.asarray(dataset[i]["label"]).ravel()
            valid = (label != ignore_index) & (label < num_classes)
            hist += np.bincount(label[valid], minlength=num_classes)
        if cache_path is not None:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            np.save(cache_path, hist)
    return calculate_class_weights(hist)
