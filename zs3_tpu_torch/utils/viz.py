"""Label -> color visualization (a copy of zs3_tpu.utils.viz's palettes).

The VOC color palette of the reference (zs3/dataloaders/utils.py
get_pascal_labels), a seeded palette past 21 classes, `decode_segmap`
for the colorized PNGs of `infer` and `serve`, its batched form
`decode_seg_map_sequence`, and `encode_segmap` back from VOC colors.
"""

from __future__ import annotations

import numpy as np


def get_pascal_labels() -> np.ndarray:
    """(21, 3) uint8 VOC palette (the standard bit-interleaved map)."""
    palette = np.zeros((21, 3), np.uint8)
    for i in range(21):
        c = i
        r = g = b = 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        palette[i] = (r, g, b)
    return palette


def _generic_palette(n: int) -> np.ndarray:
    rng = np.random.default_rng(12345)
    pal = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    pal[: min(n, 21)] = get_pascal_labels()[: min(n, 21)]
    return pal


def decode_segmap(label: np.ndarray, num_classes: int = 21) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) uint8 RGB; ignore/out-of-range black."""
    palette = _generic_palette(num_classes)
    label = np.asarray(label)
    safe = np.clip(label, 0, num_classes - 1)
    rgb = palette[safe]
    rgb[(label < 0) | (label >= num_classes)] = 0
    return rgb


def decode_seg_map_sequence(labels: np.ndarray, num_classes: int = 21) -> np.ndarray:
    """(N, H, W) -> (N, H, W, 3)."""
    return np.stack([decode_segmap(l, num_classes) for l in labels])


def encode_segmap(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) VOC-palette RGB -> (H, W) int labels (255 if unmatched)."""
    palette = get_pascal_labels()
    h, w, _ = rgb.shape
    out = np.full((h, w), 255, np.uint8)
    flat = rgb.reshape(-1, 3)
    for i, color in enumerate(palette):
        out.reshape(-1)[np.all(flat == color, axis=1)] = i
    return out
