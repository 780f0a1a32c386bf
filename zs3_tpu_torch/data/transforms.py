"""Per-sample preprocessing (a copy of zs3_tpu.data.transforms' host side).

The reference's compositions on {'image', 'label'} sample dicts of numpy
arrays, with PIL doing the resampling exactly as zs3_tpu does: train is
HFlip -> RandomScaleCrop -> GaussianBlur -> Normalize, val is
FixScaleCrop -> Normalize (ImageNet mean/std).  Random transforms take an
explicit np.random.Generator, so a sample's augmentation is a function of
its seed, as in zs3_tpu.  The inference geometry (`letterbox_image`,
`unletterbox_pred`) is copied too.

Device-side preprocessing (`data.device_preprocess`) splits the train
composition: `train_transform_spatial` does the shape-changing half on
the host and ships uint8 crops; the step normalizes them where they lie
(`batched_normalize_device`, also the server's) and flips each sample
where a mask says (`batched_flip_device`), the mask drawn from a torch
generator the step seeds (`batched_random_flip_device`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from PIL import Image, ImageFilter

from zs3_tpu_torch.core.device import device_constant_cache

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


def random_horizontal_flip(sample: Sample, rng: np.random.Generator) -> Sample:
    if rng.random() < 0.5:
        return {
            "image": np.ascontiguousarray(sample["image"][:, ::-1]),
            "label": np.ascontiguousarray(sample["label"][:, ::-1]),
        }
    return sample


def random_gaussian_blur(sample: Sample, rng: np.random.Generator) -> Sample:
    if rng.random() < 0.5:
        img, lbl = _to_pil(sample["image"], sample["label"])
        img = img.filter(ImageFilter.GaussianBlur(radius=rng.random()))
        return _from_pil(img, lbl)
    return sample


def random_scale_crop(
    sample: Sample,
    rng: np.random.Generator,
    base_size: int = 513,
    crop_size: int = 513,
    fill: int = 255,
) -> Sample:
    """Random scale in [0.5, 2.0]x base_size short side, pad, random crop."""
    img, lbl = _to_pil(sample["image"], sample["label"])
    short_size = int(rng.integers(int(base_size * 0.5), int(base_size * 2.0) + 1))
    w, h = img.size
    if h > w:
        ow = short_size
        oh = int(1.0 * h * ow / w)
    else:
        oh = short_size
        ow = int(1.0 * w * oh / h)
    img = img.resize((ow, oh), Image.BILINEAR)
    lbl = lbl.resize((ow, oh), Image.NEAREST)
    if short_size < crop_size:
        padh = max(crop_size - oh, 0)
        padw = max(crop_size - ow, 0)
        img_np = np.asarray(img)
        lbl_np = np.asarray(lbl)
        img_np = np.pad(img_np, ((0, padh), (0, padw), (0, 0)), constant_values=0)
        lbl_np = np.pad(lbl_np, ((0, padh), (0, padw)), constant_values=fill)
        img, lbl = _to_pil(img_np, lbl_np)
    w, h = img.size
    x1 = int(rng.integers(0, max(w - crop_size, 0) + 1))
    y1 = int(rng.integers(0, max(h - crop_size, 0) + 1))
    img = img.crop((x1, y1, x1 + crop_size, y1 + crop_size))
    lbl = lbl.crop((x1, y1, x1 + crop_size, y1 + crop_size))
    return _from_pil(img, lbl)


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


def train_transform(
    sample: Sample,
    rng: np.random.Generator,
    base_size: int = 513,
    crop_size: int = 513,
    fill: int = 255,
) -> Dict[str, np.ndarray]:
    """The reference train-time composition (pascal.py transform_tr):
    HFlip -> RandomScaleCrop -> GaussianBlur -> Normalize."""
    sample = random_horizontal_flip(sample, rng)
    sample = random_scale_crop(sample, rng, base_size, crop_size, fill)
    sample = random_gaussian_blur(sample, rng)
    return normalize(sample)


def train_transform_spatial(
    sample: Sample,
    rng: np.random.Generator,
    base_size: int = 513,
    crop_size: int = 513,
    fill: int = 255,
) -> Dict[str, np.ndarray]:
    """Host half of the device-preprocess split: the shape-changing ops
    only (scale/crop/blur), image uint8 (4x less host->device traffic),
    labels int32; normalize and flip run in the train step (the flip
    commutes with the other augmentations in distribution)."""
    sample = random_scale_crop(sample, rng, base_size, crop_size, fill)
    sample = random_gaussian_blur(sample, rng)
    return {
        "image": sample["image"].astype(np.uint8),
        "label": sample["label"].astype(np.int32),
    }


def letterbox_image(image: np.ndarray, size: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Aspect-preserving resize onto a (size, size) canvas.

    Scales the LONG side to `size` (so nothing is cropped, unlike
    fix_scale_crop) and pads the short side — top-left anchored — with
    ImageNet-mean pixels, which normalize to exactly zero.  Returns
    (uint8 canvas, (content_h, content_w)); crop the prediction to the
    content extent and resize back to undo (see unletterbox_pred).
    """
    h, w = image.shape[:2]
    scale = size / float(max(h, w))
    ch = max(1, min(size, int(round(h * scale))))
    cw = max(1, min(size, int(round(w * scale))))
    resized = np.asarray(
        Image.fromarray(image.astype(np.uint8)).resize((cw, ch), Image.BILINEAR),
        dtype=np.uint8,
    )
    canvas = np.empty((size, size, 3), np.uint8)
    canvas[:] = np.round(IMAGENET_MEAN * 255.0).astype(np.uint8)
    canvas[:ch, :cw] = resized
    return canvas, (ch, cw)


def unletterbox_pred(
    pred: np.ndarray, content_hw: Tuple[int, int], out_hw: Tuple[int, int]
) -> np.ndarray:
    """Undo letterbox_image on a (size, size) label map: crop the valid
    content region and NEAREST-resize to the native resolution."""
    ch, cw = content_hw
    h, w = out_hw
    return np.asarray(
        Image.fromarray(pred[:ch, :cw].astype(np.uint8), mode="L").resize(
            (w, h), Image.NEAREST
        )
    ).astype(np.int32)


@device_constant_cache(maxsize=8)
def _mean_std(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """IMAGENET_MEAN/STD on `device`, uploaded once (outside inference mode;
    anew under a trace, device_constant_cache)."""
    with torch.inference_mode(False):
        return (torch.from_numpy(IMAGENET_MEAN).to(device),
                torch.from_numpy(IMAGENET_STD).to(device))


def batched_normalize_device(images: torch.Tensor) -> torch.Tensor:
    """uint8/float NHWC on any device -> normalized float32 NHWC there."""
    img = images.to(torch.float32) / 255.0
    mean, std = _mean_std(img.device)
    return (img - mean) / std


def batched_flip_device(
    images: torch.Tensor, labels: torch.Tensor, flip: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirror sample i of images (NHWC) and labels (NHW) horizontally
    where flip[i] (bool (N,)) is set, where they lie."""
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    labels = torch.where(flip[:, None, None], labels.flip(2), labels)
    return images, labels


def batched_random_flip_device(
    images: torch.Tensor, labels: torch.Tensor, generator: torch.Generator,
    shard: Tuple[int, int] = (0, 1),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """batched_flip_device with each sample flipped with probability 1/2,
    the mask drawn from `generator` (on the images' device).  As rank r of
    `shard` (rank, ranks) the mask of the global batch is drawn and rank
    r's rows kept."""
    rank, ranks = shard
    n = images.shape[0]
    flip = torch.rand(n * ranks, generator=generator, device=images.device) < 0.5
    return batched_flip_device(images, labels, flip[rank * n:(rank + 1) * n])
