"""Per-class pixel sampling at a fixed budget (port of zs3_tpu.ops.sampling).

Every class gets `budget` slots; selection is a top-k over uniform
scores masked to the class's pixels, and a validity mask records which
slots hold a real pixel, so classes with fewer pixels (or none) need no
dynamic shapes.  The random draw is split from the selection: the tests
hand both packages the same scores.
"""

from __future__ import annotations

from typing import Tuple

import torch

from zs3_tpu_torch.ops.resize import resize_nearest

SCORE_MIN = 1e-6  # scores are strictly positive, non-members get -1


def draw_scores(
    num_classes: int, num_pixels: int, generator: torch.Generator,
    device: torch.device,
) -> torch.Tensor:
    """(C, N) f32 scores ~ U[1e-6, 1), the draw sample_class_pixels takes."""
    u = torch.rand((num_classes, num_pixels), generator=generator, device=device)
    return SCORE_MIN + (1.0 - SCORE_MIN) * u


def sample_class_pixels(
    feats: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
    budget: int,
    scores: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to `budget` pixels of every class, without replacement.

    feats (N, D), labels (N,) int class ids (255 or out of range =
    ignore), scores (C, N) from `draw_scores`.  Returns gathered
    (C, budget, D) and mask (C, budget), 1 where slot j holds a real pixel
    of class c (zeroed features elsewhere).  Which pixel an empty slot
    gathered depends on how top-k orders ties; the mask zeroes it.
    """
    if feats.ndim != 2 or labels.ndim != 1 or feats.shape[0] != labels.shape[0]:
        raise ValueError(
            f"sample_class_pixels expects feats (N, D) and labels (N,); "
            f"got {tuple(feats.shape)} and {tuple(labels.shape)}"
        )
    if tuple(scores.shape) != (num_classes, labels.shape[0]):
        raise ValueError(
            f"scores must be ({num_classes}, {labels.shape[0]}), got {tuple(scores.shape)}"
        )
    classes = torch.arange(num_classes, device=labels.device, dtype=labels.dtype)
    member = labels[None, :] == classes[:, None]
    masked = torch.where(member, scores, -1.0)
    vals, idx = torch.topk(masked, budget, dim=1)
    mask = (vals > 0.0).float()
    return feats[idx] * mask[..., None], mask


def downsample_labels(labels: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour downsample of (B, H, W) labels to the feature grid."""
    return resize_nearest(labels, size)
