"""Per-class pixel sampling at a fixed budget (port of zs3_tpu.ops.sampling).

Every class gets `budget` slots; selection is a top-k over uniform
scores masked to the class's pixels, and a validity mask records which
slots hold a real pixel, so classes with fewer pixels (or none) need no
dynamic shapes.  The random draw is split from the selection: the tests
hand both packages the same scores.

The graph-context generator's spatial-context priors come from here too:
`class_adjacency` counts 4-neighbour pixel pairs between classes, and
`neighbor_lists_from_adjacency` keeps each class's most frequent
neighbours, ties to the lower class id as `jax.lax.top_k` breaks them.
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
    return_indices: bool = False,
):
    """Up to `budget` pixels of every class, without replacement.

    feats (N, D), labels (N,) int class ids (255 or out of range =
    ignore), scores (C, N) from `draw_scores`.  Returns gathered
    (C, budget, D) and mask (C, budget), 1 where slot j holds a real pixel
    of class c (zeroed features elsewhere); with `return_indices` also the
    flat pixel indices (C, budget), from which the graph branch reads each
    pixel's image.  Which pixel an empty slot gathered depends on how
    top-k orders ties; the mask zeroes it.
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
    gathered = feats[idx] * mask[..., None]
    if return_indices:
        return gathered, mask, idx
    return gathered, mask


def downsample_labels(labels: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour downsample of (B, H, W) labels to the feature grid."""
    return resize_nearest(labels, size)


SPARE_BINS = 1024  # where the pairs that count nothing go, by position


def _pair_counts(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, C, C) int64 counts of the vertical and horizontal 4-neighbour
    pairs of two different classes (upper or left pixel's class, lower or
    right pixel's class) of each image.

    Counted by `index_add_` into a fixed-size table, so no host sync and
    no data-dependent shape.  The pairs that count nothing, a label
    outside [0, C) or one class on both sides (the diagonal, which the
    adjacency leaves at 0), are most of an image; they go to SPARE_BINS
    spare bins picked by position, so their atomics do not all wait on
    one address."""
    b, c = labels.shape[0], num_classes
    labels = labels.long()
    image = torch.arange(b, device=labels.device)[:, None, None] * (c * c)
    table = b * c * c
    counts = torch.zeros(table + SPARE_BINS, dtype=torch.int64, device=labels.device)
    for first, second in ((labels[:, :-1], labels[:, 1:]), (labels[:, :, :-1], labels[:, :, 1:])):
        counted = (first != second) & (first >= 0) & (first < c) & (second >= 0) & (second < c)
        spare = torch.arange(first.numel(), device=labels.device).view(first.shape)
        key = torch.where(counted, image + first * c + second, table + (spare & (SPARE_BINS - 1)))
        one = torch.ones((), dtype=torch.int64, device=labels.device).expand(key.numel())
        counts.index_add_(0, key.reshape(-1), one)
    return counts[:table].view(b, c, c)


def per_image_adjacency(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, C, C) f32 adjacency counts of (B, H, W) labels, one graph per
    image (the spatial-context priors are per scene); zero diagonal."""
    pairs = _pair_counts(labels, num_classes)
    # Exact in f32: an image has at most 2*H*W pairs, < 2**24 at 513x513.
    return (pairs + pairs.transpose(1, 2)).float()


def class_adjacency(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) f32 adjacency counts over a batch of (B, H, W) labels:
    adj[a, b] = the 4-neighbour pixel pairs where class a touches class b
    (symmetric, zero diagonal; labels outside [0, C), such as 255, count
    nothing).  No pair crosses images, so it is the per-image graphs' sum."""
    return per_image_adjacency(labels, num_classes).sum(0)


def top_k_lower_first(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, equal
    entries in ascending index order, as `jax.lax.top_k` returns them
    (`torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def neighbor_lists_from_adjacency(
    adj: torch.Tensor, max_neighbors: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each class's `max_neighbors` most frequent neighbours: ids (..., C,
    K) int32 and validity (..., C, K) f32 (1 where the count is positive).
    A tie at the K-th place goes to the lower class id."""
    vals, idx = top_k_lower_first(adj, max_neighbors)
    return idx.to(torch.int32), (vals > 0).float()
