"""Label -> color visualization (a copy of zs3_tpu.utils.viz's palettes).

The VOC color palette of the reference (zs3/dataloaders/utils.py
get_pascal_labels), a seeded palette past 21 classes, and
`decode_segmap` for the colorized PNGs of `infer` and `serve`.
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
