"""Berkeley SBD extra annotations and the VOC+SBD union (a copy of
zs3_tpu.data.sbd).

`SBDSegmentation` reads SBD's `.mat` segmentation labels (scipy.io) to
augment the VOC train set; `CombineDBs` concatenates datasets, keeping
the first of any duplicate name and dropping every name of the VOC val
split.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
from PIL import Image
from scipy import io as sio

from zs3_tpu_torch.data.classes import NUM_VOC_CLASSES


class SBDSegmentation:
    NUM_CLASSES = NUM_VOC_CLASSES

    def __init__(
        self,
        root: str,
        split: str = "train",
        unseen_classes: Sequence[int] = (),
        filter_unseen: bool = True,
    ):
        base = os.path.join(root, "benchmark_RELEASE", "dataset")
        if not os.path.isdir(base):
            base = os.path.join(root, "dataset")  # alternate layout
        self.image_dir = os.path.join(base, "img")
        self.label_dir = os.path.join(base, "cls")
        with open(os.path.join(base, f"{split}.txt")) as f:
            names = [line.strip() for line in f if line.strip()]
        self.unseen_classes = tuple(unseen_classes)
        self.names: List[str] = names
        if filter_unseen and self.unseen_classes:
            self.names = [n for n in names if not self._contains_unseen(n)]

    def _load_label(self, name: str) -> np.ndarray:
        mat = sio.loadmat(
            os.path.join(self.label_dir, name + ".mat"),
            mat_dtype=True,
            squeeze_me=True,
            struct_as_record=False,
        )
        return np.asarray(mat["GTcls"].Segmentation, dtype=np.uint8)

    def _contains_unseen(self, name: str) -> bool:
        return bool(np.isin(np.unique(self._load_label(name)), self.unseen_classes).any())

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int):
        name = self.names[idx]
        image = np.asarray(
            Image.open(os.path.join(self.image_dir, name + ".jpg")).convert("RGB")
        )
        return {"image": image, "label": self._load_label(name), "name": name}


class CombineDBs:
    """Concatenate datasets, excluding entries named in `exclude_names`."""

    def __init__(self, datasets, exclude_names: Sequence[str] = ()):
        exclude = set(exclude_names)
        self._items = []
        seen_names = set()
        for ds in datasets:
            for i, name in enumerate(ds.names):
                if name in exclude or name in seen_names:
                    continue
                seen_names.add(name)
                self._items.append((ds, i))
        self.NUM_CLASSES = datasets[0].NUM_CLASSES
        self.names = [ds.names[i] for ds, i in self._items]

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, idx: int):
        ds, i = self._items[idx]
        return ds[i]
