"""On-device confusion matrix (port of zs3_tpu.ops.confusion).

Counted in int64 with one ``bincount`` over ``gt * C + pred``, which is
exact at any pixel count.  (zs3_tpu accumulates f32 one-hot products,
exact only while a cell stays below 2**24 pixels.)
"""

from __future__ import annotations

import torch


def confusion_matrix(
    gt: torch.Tensor,
    pred: torch.Tensor,
    num_classes: int,
    ignore_index: int = 255,
) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts; rows = ground truth.

    Pixels whose gt equals ignore_index (or falls outside
    [0, num_classes)) are dropped; predictions are clipped into range.
    """
    if gt.shape != pred.shape:
        raise ValueError(
            f"confusion_matrix: gt {tuple(gt.shape)} and pred {tuple(pred.shape)} differ"
        )
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long().clamp(0, num_classes - 1)
    valid = (gt != ignore_index) & (gt >= 0) & (gt < num_classes)
    flat = gt[valid] * num_classes + pred[valid]
    counts = torch.bincount(flat, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)
