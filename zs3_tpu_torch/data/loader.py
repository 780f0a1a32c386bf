"""Eval batches: dataset -> transformed, collated numpy batches
(the eval side of zs3_tpu.data.loader.make_data_loader).

The val loader walks the dataset in order and yields the last, ragged
batch too, as zs3_tpu's does; images are normalized f32 NHWC, labels
int32.  The train side and the VOC/Context readers come with the
training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Sequence, Tuple

import numpy as np

from zs3_tpu_torch.core.config import DataConfig
from zs3_tpu_torch.data import transforms as T


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {key: np.stack([s[key] for s in samples]) for key in samples[0]}


class EvalLoader:
    """In-order batch iterator over `dataset` with a per-sample transform."""

    def __init__(self, dataset, batch_size: int, transform: Callable):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            samples = []
            for idx in range(start, min(start + self.batch_size, n)):
                sample = self.dataset[idx]
                samples.append(
                    self.transform({"image": sample["image"], "label": sample["label"]})
                )
            yield collate(samples)


def make_val_loader(cfg: DataConfig) -> Tuple[EvalLoader, int]:
    """(val_loader, num_classes) for cfg.dataset."""
    if cfg.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not ported yet; use 'synthetic'"
        )
    from zs3_tpu_torch.data.synthetic import SyntheticSegmentation

    size = (cfg.crop_size, cfg.crop_size)
    val_ds = SyntheticSegmentation(
        max(16, cfg.synthetic_items // 4), size, num_classes=cfg.synthetic_classes,
        seed=2, embedding_dim=cfg.synthetic_embed_dim,
        tint_weight=cfg.synthetic_tint_weight,
        context_tint=cfg.synthetic_context_tint,
    )
    loader = EvalLoader(
        val_ds, cfg.eval_batch_size, lambda s: T.eval_transform(s, cfg.crop_size)
    )
    return loader, val_ds.NUM_CLASSES
