"""Test-time augmentation evaluation: multi-scale + horizontal flip
(port of zs3_tpu.metrics.tta).

The reference validates single-scale only (SURVEY.md §3.5); the DeepLab
lineage's ms+flip mode averages softmax probabilities over scaled and
mirrored inputs.  Opt-in through `TrainConfig.eval_scales` /
`eval_flip`.  Each view is one forward of the model, so with
`fused_tail` every view whose geometry `supported()` admits runs kernel
K4; the probabilities, the argmax and the confusion stay on the device.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from zs3_tpu_torch.ops.confusion import confusion_matrix
from zs3_tpu_torch.ops.resize import resize_bilinear


def tta_probs(
    model: torch.nn.Module,
    images: torch.Tensor,
    scales: Sequence[float] = (1.0,),
    flip: bool = False,
) -> torch.Tensor:
    """(B, H, W, C) mean softmax probabilities over the TTA ensemble.

    model(images) returns logits at the INPUT resolution of `images`
    (the DeepLab forward upsamples internally), as zs3_tpu's forward_fn.
    """
    h, w = images.shape[1:3]
    probs = None
    for scale in scales:
        if scale == 1.0:
            xs = images
        else:
            hs = max(int(round(h * scale)), 1)
            ws = max(int(round(w * scale)), 1)
            xs = resize_bilinear(images, (hs, ws))
        views = [xs]
        if flip:
            views.append(torch.flip(xs, dims=(2,)))
        for i, view in enumerate(views):
            logits = model(view).float()
            if i == 1:
                logits = torch.flip(logits, dims=(2,))
            if tuple(logits.shape[1:3]) != (h, w):
                logits = resize_bilinear(logits, (h, w))
            p = torch.softmax(logits, dim=-1)
            probs = p if probs is None else probs + p
    n_views = len(scales) * (2 if flip else 1)
    return probs / n_views


def make_tta_eval_step(
    num_classes: int,
    ignore_index: int,
    scales: Sequence[float] = (1.0,),
    flip: bool = False,
):
    """step(model, batch) -> (C, C) confusion matrix under TTA (the
    signature of train/seen.py's make_eval_step)."""
    scales = tuple(scales)

    @torch.inference_mode()
    def step(model: torch.nn.Module, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        probs = tta_probs(model, batch["image"], scales, flip)
        pred = probs.argmax(dim=-1).to(torch.int32)  # first maximum, as jnp.argmax
        return confusion_matrix(batch["label"], pred, num_classes, ignore_index)

    return step
