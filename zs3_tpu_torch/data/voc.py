"""Pascal-VOC 2012 segmentation dataset (a copy of zs3_tpu.data.voc).

VOC2012 image/label pairs from the standard VOCdevkit layout, with:

  * the zero-shot *train filter*: any train image containing a pixel of
    an unseen class is dropped (so the supervised step never sees them);
  * ZS5Net weak-label hooks: when `weak_label_dir` is set, train labels
    load from a pseudo-label directory instead of ground truth, image by
    image where a PNG of its name exists;
  * lazy per-item decode so startup stays cheap.

Samples are dicts {'image': HWC uint8, 'label': HW uint8, 'name': str}.
Numpy and PIL only.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from zs3_tpu_torch.data.classes import NUM_VOC_CLASSES


class VOCSegmentation:
    NUM_CLASSES = NUM_VOC_CLASSES

    def __init__(
        self,
        root: str,
        split: str = "train",
        unseen_classes: Sequence[int] = (),
        filter_unseen: bool = True,
        weak_label_dir: Optional[str] = None,
        year: str = "2012",
    ):
        base = os.path.join(root, f"VOC{year}")
        self.image_dir = os.path.join(base, "JPEGImages")
        self.label_dir = os.path.join(base, "SegmentationClass")
        self.weak_label_dir = weak_label_dir
        split_file = os.path.join(base, "ImageSets", "Segmentation", f"{split}.txt")
        if not os.path.exists(split_file):
            raise FileNotFoundError(
                f"VOC split list not found: {split_file}\n"
                f"Expected the standard VOCdevkit layout under {root!r}: "
                "VOC2012/{JPEGImages,SegmentationClass,ImageSets/Segmentation}. "
                "Set --data-root to the directory containing VOC2012/."
            )
        with open(split_file) as f:
            names = [line.strip() for line in f if line.strip()]
        self.split = split
        self.unseen_classes = tuple(unseen_classes)
        self.names: List[str] = names
        if split == "train" and filter_unseen and self.unseen_classes:
            self.names = [n for n in names if not self._contains_unseen(n)]

    def _label_path(self, name: str) -> str:
        # Weak (pseudo) labels exist only for images that contained unseen
        # classes; everything else falls back to ground truth.
        if self.weak_label_dir is not None and self.split == "train":
            weak = os.path.join(self.weak_label_dir, name + ".png")
            if os.path.exists(weak):
                return weak
        return os.path.join(self.label_dir, name + ".png")

    def _contains_unseen(self, name: str) -> bool:
        lbl = np.asarray(Image.open(self._label_path(name)))
        return bool(np.isin(np.unique(lbl), self.unseen_classes).any())

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int):
        name = self.names[idx]
        image = np.asarray(
            Image.open(os.path.join(self.image_dir, name + ".jpg")).convert("RGB")
        )
        label = np.asarray(Image.open(self._label_path(name)))
        return {"image": image, "label": label, "name": name}
