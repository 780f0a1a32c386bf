"""Synthetic segmentation dataset for tests, smoke runs, and benches.

A copy of zs3_tpu.data.synthetic, so the port's synthetic images and
labels are the JAX package's, pixel for pixel.

No dataset ships with this image (no network), so every pipeline must be
exercisable without VOC on disk.  This generates deterministic
random-blob scenes: each image contains a background plus a few
axis-aligned class rectangles; labels match exactly.  The generator is
seeded per index, so dataset[i] is stable across processes.

Zero-shot hook: each class's appearance (its RGB tint) is a LINEAR
function of the same deterministic class embedding the trainers load
(zs3_tpu.data.embeddings.load_class_embeddings with names "class_<i>").
Appearance being predictable from the embedding is what makes
embedding->feature transfer to unseen classes possible at all, so this
dataset supports an end-to-end acceptance test of the ZS3 chain
(reference de-facto validation: seen/unseen/harmonic mIoU tables,
SURVEY.md §6) without VOC on disk.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from zs3_tpu_torch.data.embeddings import _fallback_embedding


def synthetic_class_embeddings(num_classes: int, dim: int = 32) -> np.ndarray:
    """(num_classes, dim) unit-norm class embeddings whose first three
    coordinates encode a WELL-SEPARATED RGB tint (golden-angle hue walk,
    so no two classes collapse to similar colors by hash luck); the
    remaining coordinates are deterministic per-class noise the
    generator must learn to ignore.

    Shared by the dataset (appearance) and GMMNTrainer (conditioning):
    the embedding->appearance map is linear by construction, which is
    the property that makes zero-shot transfer possible and testable."""
    if dim < 3:
        raise ValueError(f"synthetic embeddings need dim >= 3, got {dim}")
    import colorsys

    emb = np.zeros((num_classes, dim), np.float32)
    for c in range(num_classes):
        hue = (c * 0.61803398875) % 1.0
        r, g, b = colorsys.hsv_to_rgb(hue, 0.85, 0.9)
        emb[c, :3] = (np.array([r, g, b]) - 0.5) * 2.0  # [-1, 1]
        if dim > 3:
            noise = _fallback_embedding(f"class_{c}", dim - 3)
            emb[c, 3:] = 0.3 * noise
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(norms, 1e-8)


def synthetic_class_tints(num_classes: int, embedding_dim: int = 32) -> np.ndarray:
    """(num_classes, 3) uint8 tints, exactly linear in the embeddings:
    tint = clip(128 + 150 * emb[:, :3]).  Row norms are ~1 with color
    coords dominating (see synthetic_class_embeddings), so coords span
    roughly [-0.8, 0.8] and clipping is rare.  Class 0 (background)
    gets no tint (its region stays pure noise)."""
    emb = synthetic_class_embeddings(num_classes, embedding_dim)
    tints = np.clip(128.0 + 150.0 * emb[:, :3], 0, 255)
    return tints.astype(np.uint8)


class SyntheticSegmentation:
    def __init__(
        self,
        num_items: int = 64,
        image_size: Tuple[int, int] = (128, 128),
        num_classes: int = 21,
        max_objects: int = 4,
        seed: int = 0,
        classes: Sequence[int] | None = None,
        embedding_dim: int = 32,
        tint_weight: float = 0.75,
        context_tint: float = 0.0,
    ):
        self.NUM_CLASSES = num_classes
        self.num_items = num_items
        self.image_size = image_size
        self.max_objects = max_objects
        self.seed = seed
        self.classes = tuple(classes) if classes is not None else tuple(
            range(1, num_classes)
        )
        self.embedding_dim = embedding_dim
        self.tint_weight = float(tint_weight)
        # context_tint > 0 makes each visible region's tint depend on the
        # classes it TOUCHES (4-neighbor region adjacency, the same
        # relation ops/sampling.py::class_adjacency measures):
        #   eff_tint[c] = (1-ct)*tint[c] + ct*mean(tint[n] for n in touch(c))
        # Appearance then depends on spatial context, so the paper's
        # graph-context conditioning (neighbor class embeddings) carries
        # real signal a context-blind generator cannot represent — the
        # dataset hook behind the graph-context acceptance evidence.
        self.context_tint = float(context_tint)
        self.tints = synthetic_class_tints(num_classes, embedding_dim)
        self.names = [f"synthetic_{i:05d}" for i in range(num_items)]

    def __len__(self) -> int:
        return self.num_items

    def _touching(self, label: np.ndarray) -> dict:
        """class -> set of classes sharing a 4-neighbor pixel edge."""
        touch: dict = {int(c): set() for c in np.unique(label)}
        for a, b in (
            (label[:, :-1], label[:, 1:]),
            (label[:-1, :], label[1:, :]),
        ):
            diff = a != b
            for x, y in zip(a[diff].ravel().tolist(), b[diff].ravel().tolist()):
                touch[int(x)].add(int(y))
                touch[int(y)].add(int(x))
        return touch

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.image_size
        image = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        label = np.zeros((h, w), dtype=np.uint8)
        n_obj = int(rng.integers(1, self.max_objects + 1))
        tw = self.tint_weight
        rects = []
        for _ in range(n_obj):
            cls = int(rng.choice(self.classes))
            bh = int(rng.integers(h // 8, h // 2))
            bw = int(rng.integers(w // 8, w // 2))
            y0 = int(rng.integers(0, h - bh))
            x0 = int(rng.integers(0, w - bw))
            label[y0 : y0 + bh, x0 : x0 + bw] = cls
            rects.append((cls, y0, x0, bh, bw))
        if self.context_tint > 0.0:
            # Context mode: tint only VISIBLE pixels of each class, with
            # the context-blended tint (needs the final label map).
            ct = self.context_tint
            touch = self._touching(label)
            fimg = image.astype(np.float32)
            for cls in touch:
                if cls == 0:
                    continue
                nbs = sorted(touch[cls])
                nb_tint = (
                    np.mean(self.tints[nbs].astype(np.float32), axis=0)
                    if nbs
                    else self.tints[cls].astype(np.float32)
                )
                tint = (1.0 - ct) * self.tints[cls].astype(np.float32) + ct * nb_tint
                mask = label == cls
                fimg[mask] = (1.0 - tw) * fimg[mask] + tw * tint[None]
            image = fimg.astype(np.uint8)
        else:
            for cls, y0, x0, bh, bw in rects:
                # blend the class tint over the noise so the class is
                # learnable from appearance (and appearance from embedding)
                tint = self.tints[cls].astype(np.float32)
                region = image[y0 : y0 + bh, x0 : x0 + bw].astype(np.float32)
                image[y0 : y0 + bh, x0 : x0 + bw] = (
                    (1.0 - tw) * region + tw * tint[None, None]
                ).astype(np.uint8)
        return {"image": image, "label": label, "name": self.names[idx]}
