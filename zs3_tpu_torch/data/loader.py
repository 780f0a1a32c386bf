"""Batches: dataset -> transformed, collated numpy batches
(port of zs3_tpu.data.loader.make_data_loader, synthetic data only).

The val loader walks the dataset in order and yields the last, ragged
batch too.  The train loader shuffles with an order that is a function
of (seed, epoch) alone, drops the last ragged batch, and augments each
sample with its own rng seeded by (seed, epoch, index), so its batches
are zs3_tpu's, byte for byte.  Images are normalized f32 NHWC, labels
int32.  The VOC/Context readers come with the training slice.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
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


class TrainLoader:
    """Shuffled batches of `dataset` with a seeded per-sample transform;
    `set_epoch` picks the epoch's order.  Samples of a batch are
    transformed on `num_workers` threads (PIL releases the GIL)."""

    def __init__(self, dataset, batch_size: int, transform: Callable, seed: int = 0,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx

    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self.dataset[int(idx)]
        rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
        return self.transform({"image": sample["image"], "label": sample["label"]}, rng)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        with ThreadPoolExecutor(self.num_workers) as pool:
            for b in range(len(self)):
                chunk = order[b * self.batch_size : (b + 1) * self.batch_size]
                yield collate(list(pool.map(self._load_one, chunk)))


def _require_synthetic(cfg: DataConfig):
    if cfg.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not ported yet; use 'synthetic'"
        )


def make_train_loader(cfg: DataConfig) -> Tuple[TrainLoader, int]:
    """(train_loader, num_classes).  As in the zero-shot protocol, the
    train pool never shows an unseen class (the reference filters images
    that contain one)."""
    _require_synthetic(cfg)
    from zs3_tpu_torch.data.synthetic import SyntheticSegmentation

    n_cls = cfg.synthetic_classes
    unseen = cfg.unseen_classes
    classes = None
    if unseen and cfg.weak_label_dir is None:
        classes = tuple(c for c in range(1, n_cls) if c not in unseen)
    train_ds = SyntheticSegmentation(
        cfg.synthetic_items, (cfg.crop_size, cfg.crop_size), num_classes=n_cls,
        seed=1, classes=classes, embedding_dim=cfg.synthetic_embed_dim,
        tint_weight=cfg.synthetic_tint_weight,
        context_tint=cfg.synthetic_context_tint,
    )
    loader = TrainLoader(
        train_ds, cfg.batch_size,
        lambda s, rng: T.train_transform(s, rng, cfg.base_size, cfg.crop_size,
                                         cfg.ignore_index),
        seed=cfg.shuffle_seed, num_workers=cfg.num_workers,
    )
    return loader, train_ds.NUM_CLASSES


def make_data_loader(cfg: DataConfig) -> Tuple[TrainLoader, EvalLoader, int]:
    """(train_loader, val_loader, num_classes), zs3_tpu's factory contract."""
    train, num_classes = make_train_loader(cfg)
    val, _ = make_val_loader(cfg)
    return train, val, num_classes


def make_val_loader(cfg: DataConfig) -> Tuple[EvalLoader, int]:
    """(val_loader, num_classes) for cfg.dataset."""
    _require_synthetic(cfg)
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
