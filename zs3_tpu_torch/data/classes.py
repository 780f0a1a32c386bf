"""Class-name registries (reference: zs3/exp_data.py class lists).

VOC: 21 classes with background at index 0 (the torchvision/VOC
convention the reference inherits).  Pascal-Context: the 59-class
protocol (most-frequent-59); background/everything-else maps to the
ignore index.
"""

from __future__ import annotations

from typing import Sequence, Tuple

VOC_CLASSES: Tuple[str, ...] = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

CONTEXT_CLASSES: Tuple[str, ...] = (
    "aeroplane", "bag", "bed", "bedclothes", "bench", "bicycle", "bird",
    "boat", "book", "bottle", "building", "bus", "cabinet", "car", "cat",
    "ceiling", "chair", "cloth", "computer", "cow", "cup", "curtain", "dog",
    "door", "fence", "floor", "flower", "food", "grass", "ground", "horse",
    "keyboard", "light", "motorbike", "mountain", "mouse", "person", "plate",
    "platform", "pottedplant", "road", "rock", "sheep", "shelves", "sidewalk",
    "sign", "sky", "snow", "sofa", "table", "track", "train", "tree", "truck",
    "tvmonitor", "wall", "water", "window", "wood",
)

NUM_VOC_CLASSES = len(VOC_CLASSES)  # 21
NUM_CONTEXT_CLASSES = len(CONTEXT_CLASSES)  # 59


def seen_classes(num_classes: int, unseen: Sequence[int]) -> Tuple[int, ...]:
    unseen_set = set(unseen)
    return tuple(i for i in range(num_classes) if i not in unseen_set)
