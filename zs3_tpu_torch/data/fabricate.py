"""Fabricated on-disk dataset trees and artifacts (a copy of the dataset
half of zs3_tpu.data.fabricate, plus the detail-API JSON and word-vector
files that `prepare-context` and `build-embeddings` read).

Real VOC2012, SBD and Pascal-Context trees cannot be downloaded here, so
these write structurally exact stand-ins: 21-class VOC(+SBD) trees,
59-class Context trees, a word2vec-style registry `.npy`, and a
torchvision-named ResNet `.pth` with random weights (what the model zoo's
would look like to `convert-weights`).  For the same arguments and seed,
`fabricate_voc_tree`, `fabricate_sbd_tree`, `fabricate_context_tree`,
`fabricate_embedding_npy` and `fabricate_torchvision_resnet_state` give
what zs3_tpu's give, byte for byte (a `.mat` file's header carries its
creation time).

Labels are structured (per-class tinted rectangles over noise, a 2-pixel
ignore border) rather than uniform noise, so losses move and evaluation
is non-degenerate; image sizes mirror real VOC variety (500x375-ish,
both orientations).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Sequence, Tuple

import numpy as np
from PIL import Image

from zs3_tpu_torch.data.classes import CONTEXT_CLASSES, NUM_CONTEXT_CLASSES

# Real-VOC-like size variety: both orientations, non-square.
_DEFAULT_SIZES = ((375, 500), (500, 375), (442, 500), (333, 500))


def _class_tint(cls: int, num_classes: int = 21) -> np.ndarray:
    """Deterministic RGB tint per class (bright, well-separated)."""
    rng = np.random.default_rng(1000 + cls)
    return rng.integers(40, 255, size=3).astype(np.uint8)


def _fabricate_sample(
    rng: np.random.Generator,
    size: Tuple[int, int],
    classes: Sequence[int],
    ignore_index: int = 255,
) -> Tuple[np.ndarray, np.ndarray]:
    """(image uint8 HWC, label uint8 HW) with one tinted rectangle per
    class over background noise and a 2px ignore border."""
    h, w = size
    image = rng.integers(0, 80, (h, w, 3)).astype(np.uint8)
    label = np.zeros((h, w), np.uint8)
    for cls in classes:
        rh = int(rng.integers(h // 6, h // 2))
        rw = int(rng.integers(w // 6, w // 2))
        y0 = int(rng.integers(0, h - rh))
        x0 = int(rng.integers(0, w - rw))
        label[y0 : y0 + rh, x0 : x0 + rw] = cls
        tint = _class_tint(cls)
        noise = rng.integers(-30, 30, (rh, rw, 3))
        image[y0 : y0 + rh, x0 : x0 + rw] = np.clip(
            tint[None, None].astype(np.int32) + noise, 0, 255
        ).astype(np.uint8)
    label[:2, :] = ignore_index
    label[:, :2] = ignore_index
    return image, label


def fabricate_voc_tree(
    root: str,
    n_train: int = 12,
    n_val: int = 4,
    seed: int = 0,
    num_classes: int = 21,
    unseen_classes: Sequence[int] = (10, 14),
    unseen_every: int = 3,
    sizes: Sequence[Tuple[int, int]] = _DEFAULT_SIZES,
) -> Dict[str, int]:
    """Write a minimal-but-exact VOC2012 layout under `root`.

    Every `unseen_every`-th train image (and every val image) contains
    an unseen class, so the train-time unseen filter, the val-time
    seen/unseen mIoU split, and the ZS5 image-level tag sets all
    engage.  Returns counts.
    """
    base = os.path.join(root, "VOC2012")
    for d in ("JPEGImages", "SegmentationClass"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    sets = os.path.join(base, "ImageSets", "Segmentation")
    os.makedirs(sets, exist_ok=True)
    rng = np.random.default_rng(seed)
    seen = [c for c in range(1, num_classes) if c not in set(unseen_classes)]
    splits = {"train": n_train, "val": n_val}
    names: Dict[str, list] = {}
    with_unseen = 0
    for split, count in splits.items():
        names[split] = []
        for i in range(count):
            name = f"2008_{'0' if split == 'train' else '9'}{i:05d}"
            names[split].append(name)
            size = sizes[(i + (split == "val")) % len(sizes)]
            classes = list(rng.choice(seen, size=3, replace=False))
            if split == "val" or i % unseen_every == 0:
                classes.append(int(unseen_classes[i % len(unseen_classes)]))
                with_unseen += split == "train"
            image, label = _fabricate_sample(rng, size, classes)
            Image.fromarray(image).save(os.path.join(base, "JPEGImages", name + ".jpg"))
            Image.fromarray(label).save(os.path.join(base, "SegmentationClass", name + ".png"))
        with open(os.path.join(sets, split + ".txt"), "w") as f:
            f.write("\n".join(names[split]) + "\n")
    return {"train": n_train, "val": n_val, "train_with_unseen": with_unseen}


def fabricate_sbd_tree(
    root: str,
    n: int = 8,
    seed: int = 1,
    num_classes: int = 21,
    unseen_classes: Sequence[int] = (10, 14),
    sizes: Sequence[Tuple[int, int]] = _DEFAULT_SIZES,
) -> Dict[str, int]:
    """Write a benchmark_RELEASE/dataset SBD layout (.mat labels)."""
    from scipy import io as sio

    base = os.path.join(root, "benchmark_RELEASE", "dataset")
    os.makedirs(os.path.join(base, "img"), exist_ok=True)
    os.makedirs(os.path.join(base, "cls"), exist_ok=True)
    rng = np.random.default_rng(seed)
    seen = [c for c in range(1, num_classes) if c not in set(unseen_classes)]
    names = [f"2009_{i:06d}" for i in range(n)]
    for i, name in enumerate(names):
        size = sizes[i % len(sizes)]
        classes = list(rng.choice(seen, size=2, replace=False))
        image, label = _fabricate_sample(rng, size, classes)
        Image.fromarray(image).save(os.path.join(base, "img", name + ".jpg"))
        sio.savemat(os.path.join(base, "cls", name + ".mat"), {"GTcls": {"Segmentation": label}})
    for split in ("train", "val"):
        with open(os.path.join(base, split + ".txt"), "w") as f:
            f.write("\n".join(names if split == "train" else []) + "\n")
    return {"train": n}


def fabricate_context_tree(
    root: str,
    n_train: int = 12,
    n_val: int = 4,
    seed: int = 2,
    unseen_classes: Sequence[int] = (19, 33),  # cow, motorbike
    unseen_every: int = 3,
    sizes: Sequence[Tuple[int, int]] = _DEFAULT_SIZES,
) -> Dict[str, int]:
    """Write the Pascal-Context layout (VOC2010 + 59-class label PNGs,
    what `cli prepare-context` produces from the detail JSON)."""
    base = os.path.join(root, "VOC2010")
    os.makedirs(os.path.join(base, "JPEGImages"), exist_ok=True)
    os.makedirs(os.path.join(base, "SegmentationClassContext"), exist_ok=True)
    sets = os.path.join(base, "ImageSets", "SegmentationContext")
    os.makedirs(sets, exist_ok=True)
    rng = np.random.default_rng(seed)
    seen = [c for c in range(1, NUM_CONTEXT_CLASSES) if c not in set(unseen_classes)]
    with_unseen = 0
    for split, count in (("train", n_train), ("val", n_val)):
        names = []
        for i in range(count):
            name = f"2010_{'0' if split == 'train' else '9'}{i:05d}"
            names.append(name)
            size = sizes[(i + (split == "val")) % len(sizes)]
            classes = list(rng.choice(seen, size=3, replace=False))
            if split == "val" or i % unseen_every == 0:
                classes.append(int(unseen_classes[i % len(unseen_classes)]))
                with_unseen += split == "train"
            image, label = _fabricate_sample(rng, size, classes)
            Image.fromarray(image).save(os.path.join(base, "JPEGImages", name + ".jpg"))
            Image.fromarray(label).save(
                os.path.join(base, "SegmentationClassContext", name + ".png")
            )
        with open(os.path.join(sets, split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return {"train": n_train, "val": n_val, "train_with_unseen": with_unseen}


_RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def fabricate_torchvision_resnet_state(
    depth: int = 101, seed: int = 0
) -> Dict[str, np.ndarray]:
    """A torchvision-named ResNet state_dict (numpy values) with exactly
    the real checkpoint's keys and shapes, random weights: conv1, bn1
    (num_batches_tracked included), layerL.B.{conv,bn}{1,2,3}, block 0's
    downsample.{0,1}, and the fc head (which the converter must skip)."""
    if depth not in _RESNET_BLOCKS:
        raise ValueError(f"depth must be one of {sorted(_RESNET_BLOCKS)}")
    rng = np.random.default_rng(seed)

    def conv(out_ch, in_ch, k):
        fan_in = in_ch * k * k
        return (rng.standard_normal((out_ch, in_ch, k, k)) *
                (2.0 / fan_in) ** 0.5).astype(np.float32)

    def bn(prefix, ch, sd):
        sd[prefix + ".weight"] = (1.0 + 0.05 * rng.standard_normal(ch)).astype(np.float32)
        sd[prefix + ".bias"] = (0.05 * rng.standard_normal(ch)).astype(np.float32)
        sd[prefix + ".running_mean"] = (0.05 * rng.standard_normal(ch)).astype(np.float32)
        sd[prefix + ".running_var"] = (1.0 + 0.05 * rng.random(ch)).astype(np.float32)
        sd[prefix + ".num_batches_tracked"] = np.asarray(100, np.int64)

    sd: Dict[str, np.ndarray] = {}
    sd["conv1.weight"] = conv(64, 3, 7)
    bn("bn1", 64, sd)
    inplanes = 64
    for li, blocks in enumerate(_RESNET_BLOCKS[depth], start=1):
        planes = 64 * 2 ** (li - 1)
        for b in range(blocks):
            p = f"layer{li}.{b}"
            sd[p + ".conv1.weight"] = conv(planes, inplanes, 1)
            bn(p + ".bn1", planes, sd)
            sd[p + ".conv2.weight"] = conv(planes, planes, 3)
            bn(p + ".bn2", planes, sd)
            sd[p + ".conv3.weight"] = conv(planes * 4, planes, 1)
            bn(p + ".bn3", planes * 4, sd)
            if b == 0:
                sd[p + ".downsample.0.weight"] = conv(planes * 4, inplanes, 1)
                bn(p + ".downsample.1", planes * 4, sd)
            inplanes = planes * 4
    sd["fc.weight"] = (0.01 * rng.standard_normal((1000, 2048))).astype(np.float32)
    sd["fc.bias"] = np.zeros((1000,), np.float32)
    return sd


def fabricate_torchvision_resnet_pth(path: str, depth: int = 101, seed: int = 0) -> str:
    """torch.save a fabricated torchvision-shaped ResNet .pth."""
    import torch

    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in fabricate_torchvision_resnet_state(depth, seed).items()}
    torch.save(sd, path)
    return path


def fabricate_embedding_npy(
    path: str,
    class_names: Sequence[str],
    dim: int = 300,
    seed: int = 0,
) -> str:
    """A word2vec-registry-style (num_classes, dim) float32 .npy, unit
    norm rows, deterministic in (names, seed)."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((len(class_names), dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    np.save(path, emb)
    return path


def _mask_rle(mask: np.ndarray) -> Dict:
    """COCO compressed RLE of a bool (h, w) mask: runs over the mask in
    column-major order, the first one background (the inverse of
    context_prepare.rle_to_mask)."""
    from zs3_tpu_torch.data.context_prepare import encode_rle_string

    flat = mask.T.reshape(-1).astype(np.int8)
    edges = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1, [flat.size]])
    counts = np.diff(edges).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"counts": encode_rle_string(counts), "size": list(mask.shape)}


def fabricate_context_detail_json(root: str, path: str) -> Dict[str, int]:
    """Write the detail-API annotation JSON (`trainval_merged.json`'s
    layout) of the Context tree under `root`: one image record per name of
    its split lists, the 59 classes and one rare category as categories,
    and one RLE segment per class present in each label PNG.
    `prepare-context` on it writes that tree's label PNGs again (pixels
    of no segment, the ignore border, read as 255)."""
    base = os.path.join(root, "VOC2010")
    categories = [{"category_id": 100 + i, "name": n} for i, n in enumerate(CONTEXT_CLASSES)]
    categories.append({"category_id": 999, "name": "ashtray"})  # not among the 59
    images, annos = [], []
    for phase in ("train", "val"):
        with open(os.path.join(base, "ImageSets", "SegmentationContext", phase + ".txt")) as f:
            names = [line.strip() for line in f if line.strip()]
        for name in names:
            label = np.asarray(
                Image.open(os.path.join(base, "SegmentationClassContext", name + ".png")))
            image_id = len(images) + 1
            images.append({"image_id": image_id, "file_name": name + ".jpg",
                           "height": int(label.shape[0]), "width": int(label.shape[1]),
                           "phase": phase})
            for cls in np.unique(label):
                if cls != 255:
                    annos.append({"image_id": image_id, "category_id": 100 + int(cls),
                                  "segmentation": _mask_rle(label == cls)})
    with open(path, "w") as f:
        json.dump({"images": images, "categories": categories,
                   "annos_segmentation": annos}, f)
    return {"images": len(images), "segments": len(annos)}


def fabricate_word_vectors(
    path: str,
    class_names: Sequence[str],
    dim: int = 300,
    seed: int = 0,
    binary: bool = True,
) -> str:
    """A word-vector file holding every token `build-embeddings` looks up
    for `class_names` (a class's own name, or the words of its alias in
    embedding_build.DEFAULT_ALIASES): word2vec's C binary format when
    `binary` ("N dim" header, then token, space, dim little-endian f32
    and a newline), else word2vec text.  Vectors are seeded."""
    from zs3_tpu_torch.data.embedding_build import DEFAULT_ALIASES

    tokens = sorted({t for n in class_names
                     for t in DEFAULT_ALIASES.get(n.lower(), n).split(" ")})
    vectors = np.random.default_rng(seed).standard_normal((len(tokens), dim)).astype("<f4")
    mode = "wb" if binary else "w"
    with open(path, mode) as f:
        header = f"{len(tokens)} {dim}\n"
        f.write(header.encode() if binary else header)
        for token, vec in zip(tokens, vectors):
            if binary:
                f.write(token.encode() + b" " + struct.pack(f"<{dim}f", *vec) + b"\n")
            else:
                f.write(token + " " + " ".join(repr(float(v)) for v in vec) + "\n")
    return path
