"""Pascal-Context dataset, 59-class protocol (a copy of zs3_tpu.data.context).

Reads precomputed 59-class label PNGs over VOC2010 images
(`SegmentationClassContext/`, indices into CONTEXT_CLASSES, 255 =
ignore: what `cli prepare-context` writes from the detail-API JSON),
with the same unseen filter and weak-label hook as VOC.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from zs3_tpu_torch.data.classes import NUM_CONTEXT_CLASSES


class ContextSegmentation:
    NUM_CLASSES = NUM_CONTEXT_CLASSES

    def __init__(
        self,
        root: str,
        split: str = "train",
        unseen_classes: Sequence[int] = (),
        filter_unseen: bool = True,
        weak_label_dir: Optional[str] = None,
    ):
        base = os.path.join(root, "VOC2010")
        self.image_dir = os.path.join(base, "JPEGImages")
        self.label_dir = os.path.join(base, "SegmentationClassContext")
        self.weak_label_dir = weak_label_dir
        split_file = os.path.join(base, "ImageSets", "SegmentationContext", f"{split}.txt")
        if not os.path.exists(split_file):
            raise FileNotFoundError(
                f"Pascal-Context split list not found: {split_file}\n"
                f"Expected under {root!r}: VOC2010/{{JPEGImages,"
                "SegmentationClassContext,ImageSets/SegmentationContext}. "
                "Convert 'detail'-API labels to 59-class PNGs offline first "
                "(cli prepare-context)."
            )
        with open(split_file) as f:
            names = [line.strip() for line in f if line.strip()]
        self.split = split
        self.unseen_classes = tuple(unseen_classes)
        self.names: List[str] = names
        if split == "train" and filter_unseen and self.unseen_classes:
            self.names = [n for n in names if not self._contains_unseen(n)]

    def _label_path(self, name: str) -> str:
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
