"""Per-sample eval preprocessing (the eval side of zs3_tpu.data.transforms).

The reference's val composition: FixScaleCrop -> Normalize (ImageNet
mean/std), on {'image', 'label'} sample dicts of numpy arrays, with PIL
doing the resampling exactly as zs3_tpu does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

Sample = Dict[str, np.ndarray]


def _to_pil(image: np.ndarray, label: np.ndarray) -> Tuple[Image.Image, Image.Image]:
    img = Image.fromarray(image.astype(np.uint8))
    lbl = Image.fromarray(label.astype(np.uint8), mode="L")
    return img, lbl


def _from_pil(img: Image.Image, lbl: Image.Image) -> Sample:
    return {
        "image": np.asarray(img, dtype=np.uint8),
        "label": np.asarray(lbl, dtype=np.uint8),
    }


def fix_scale_crop(sample: Sample, crop_size: int = 513) -> Sample:
    """Center crop after scaling short side to crop_size (val transform)."""
    img, lbl = _to_pil(sample["image"], sample["label"])
    w, h = img.size
    if w > h:
        oh = crop_size
        ow = int(1.0 * w * oh / h)
    else:
        ow = crop_size
        oh = int(1.0 * h * ow / w)
    img = img.resize((ow, oh), Image.BILINEAR)
    lbl = lbl.resize((ow, oh), Image.NEAREST)
    w, h = img.size
    x1 = int(round((w - crop_size) / 2.0))
    y1 = int(round((h - crop_size) / 2.0))
    img = img.crop((x1, y1, x1 + crop_size, y1 + crop_size))
    lbl = lbl.crop((x1, y1, x1 + crop_size, y1 + crop_size))
    return _from_pil(img, lbl)


def normalize(sample: Sample) -> Dict[str, np.ndarray]:
    """uint8 HWC -> float32 HWC normalized; label -> int32."""
    img = sample["image"].astype(np.float32) / 255.0
    img = (img - IMAGENET_MEAN) / IMAGENET_STD
    return {"image": img, "label": sample["label"].astype(np.int32)}


def eval_transform(sample: Sample, crop_size: int = 513) -> Dict[str, np.ndarray]:
    """The reference val-time composition: FixScaleCrop -> Normalize."""
    return normalize(fix_scale_crop(sample, crop_size))
