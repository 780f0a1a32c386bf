"""Batches: dataset -> transformed, collated batches (port of
zs3_tpu.data.loader).

`make_data_loader(cfg)` gives zs3_tpu's (train, val, num_classes) for
`pascal` (VOC2012, with `use_sbd` the VOC+SBD union less the val names),
`context` (Pascal-Context, 59 classes) and `synthetic`.  The train pool
drops every image that shows an unseen class, unless `weak_label_dir`
is set (ZS5 keeps them: their pseudo-labels replace the ground truth).

`DataLoader` is zs3_tpu's: a producer thread maps the per-sample
transform over a batch's indices on `num_workers` threads (PIL releases
the GIL) and puts the collated batch into a queue of `prefetch`
batches, so host decode overlaps device compute.  The epoch order is a
function of (seed, epoch) and each sample's augmentation of (seed,
epoch, index), so its batches are zs3_tpu's byte for byte.  An error in
a worker reaches the consumer as RuntimeError; an abandoned iterator
stops and joins its producer and pool.  With `pin_memory` (the trainers
set it on a CUDA device) a batch is torch tensors in pinned host memory,
so its copies to the card are asynchronous; else numpy arrays.  With
`shard` (rank, ranks) a loader reads and yields only rank's contiguous
rows of each global batch (core/mesh.py's sharding).  Images
are normalized f32 NHWC, or uint8 with `device_preprocess`; labels
int32.  With `input_pipeline="tfdata"` the pascal and context train
loaders are data/tfdata.py's `TFDataLoader` (zs3_tpu's tf.data stream,
without TensorFlow); synthetic data keeps this loader, as in zs3_tpu.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Sequence, Tuple, Union

import numpy as np
import torch

from zs3_tpu_torch.core.config import DataConfig
from zs3_tpu_torch.data import transforms as T

Batch = Dict[str, Union[np.ndarray, torch.Tensor]]


def collate(samples: Sequence[Dict[str, np.ndarray]], pin_memory: bool = False) -> Batch:
    """Stack the samples' arrays key by key: numpy arrays, or torch tensors
    in pinned host memory (stacked in place, no second copy)."""
    out: Batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if pin_memory:
            dtype = torch.from_numpy(vals[0][:0]).dtype
            buf = torch.empty((len(vals), *vals[0].shape), dtype=dtype, pin_memory=True)
            np.stack(vals, out=buf.numpy())
            out[key] = buf
        else:
            out[key] = np.stack(vals)
    return out


class DataLoader:
    """Deterministic shuffling, threaded transform, prefetching iterator."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        transform: Callable,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        transform_needs_rng: bool = True,
        pin_memory: bool = False,
        shard: Tuple[int, int] = (0, 1),
    ):
        if batch_size % shard[1]:
            raise ValueError(f"train batch size {batch_size} must be divisible by the data "
                             f"mesh axis ({shard[1]})")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.transform_needs_rng = transform_needs_rng
        self.pin_memory = pin_memory
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx

    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self.dataset[int(idx)]
        sample = {"image": sample["image"], "label": sample["label"]}
        if self.transform_needs_rng:
            return self.transform(sample, np.random.default_rng((self.seed, self.epoch, int(idx))))
        return self.transform(sample)

    def __iter__(self) -> Iterator[Batch]:
        order = self._order()
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Put unless the consumer went away; False once it has."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # Always ends the queue (with `done` or the error) and never
            # blocks on a consumer that went away: a dataset or transform
            # error must surface in the training loop, not hang it, and an
            # abandoned iterator must not leak this thread and its pool.
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    rank, ranks = self.shard
                    for b in range(n_batches):
                        chunk = order[b * self.batch_size : (b + 1) * self.batch_size]
                        per = len(chunk) // ranks
                        chunk = chunk[rank * per:(rank + 1) * per]
                        samples = list(pool.map(self._load_one, chunk))
                        if stop.is_set() or not put(collate(samples, self.pin_memory)):
                            return
            except BaseException as e:  # handed to the consumer, which raises
                put(e)
            else:
                put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise RuntimeError("DataLoader worker failed while loading a batch") from item
                yield item
        finally:
            # On exhaustion and on close or collection of the generator:
            # unblock a pending put, then reap the thread.
            stop.set()
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.05)


def _datasets(cfg: DataConfig, train: bool):
    """(dataset, num_classes) of cfg.dataset's train or val split."""
    unseen = cfg.unseen_classes
    # ZS5's weak-label mode keeps the unseen-containing train images:
    # their pseudo-labels are the point of self-training.
    filter_unseen = cfg.weak_label_dir is None
    if cfg.dataset == "pascal":
        from zs3_tpu_torch.data.voc import VOCSegmentation

        val = VOCSegmentation(cfg.root, "val", unseen, filter_unseen=False)
        if not train:
            return val, VOCSegmentation.NUM_CLASSES
        ds = VOCSegmentation(cfg.root, "train", unseen, filter_unseen=filter_unseen,
                             weak_label_dir=cfg.weak_label_dir)
        if cfg.use_sbd:
            from zs3_tpu_torch.data.sbd import CombineDBs, SBDSegmentation

            ds = CombineDBs([ds, SBDSegmentation(cfg.root, "train", unseen)],
                            exclude_names=val.names)
        return ds, VOCSegmentation.NUM_CLASSES
    if cfg.dataset == "context":
        from zs3_tpu_torch.data.context import ContextSegmentation

        if not train:
            return (ContextSegmentation(cfg.root, "val", unseen, filter_unseen=False),
                    ContextSegmentation.NUM_CLASSES)
        return (ContextSegmentation(cfg.root, "train", unseen, filter_unseen=filter_unseen,
                                    weak_label_dir=cfg.weak_label_dir),
                ContextSegmentation.NUM_CLASSES)
    if cfg.dataset == "synthetic":
        from zs3_tpu_torch.data.synthetic import SyntheticSegmentation

        n_cls = cfg.synthetic_classes
        classes = None
        if train and unseen and filter_unseen:
            classes = tuple(c for c in range(1, n_cls) if c not in unseen)
        ds = SyntheticSegmentation(
            cfg.synthetic_items if train else max(16, cfg.synthetic_items // 4),
            (cfg.crop_size, cfg.crop_size), num_classes=n_cls, seed=1 if train else 2,
            classes=classes, embedding_dim=cfg.synthetic_embed_dim,
            tint_weight=cfg.synthetic_tint_weight, context_tint=cfg.synthetic_context_tint,
        )
        return ds, ds.NUM_CLASSES
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def make_train_loader(cfg: DataConfig, pin_memory: bool = False,
                      shard: Tuple[int, int] = (0, 1)) -> Tuple[DataLoader, int]:
    """(train_loader, num_classes): shuffled, the last ragged batch
    dropped, augmented by train_transform (train_transform_spatial with
    device_preprocess); rank's rows of each batch with `shard`.  With
    input_pipeline="tfdata", pascal and context take zs3_tpu's tf.data
    stream (`TFDataLoader`), which normalizes on the host: it refuses
    device_preprocess, as zs3_tpu does, and the VOC+SBD union, on which
    zs3_tpu's fails (SBD names no image files, and its labels are .mat)."""
    tfdata = cfg.input_pipeline == "tfdata" and cfg.dataset in ("pascal", "context")
    if tfdata and cfg.device_preprocess:
        # The step would normalize the host-normalized batch again.
        raise ValueError("input_pipeline='tfdata' already normalizes on the host; "
                         "it cannot be combined with device_preprocess=True")
    dataset, num_classes = _datasets(cfg, train=True)
    if tfdata:
        from zs3_tpu_torch.data.tfdata import TFDataLoader

        return TFDataLoader(dataset, cfg, seed=cfg.shuffle_seed, pin_memory=pin_memory,
                            shard=shard), num_classes
    host_tf = T.train_transform_spatial if cfg.device_preprocess else T.train_transform
    loader = DataLoader(
        dataset, cfg.batch_size,
        lambda s, rng: host_tf(s, rng, cfg.base_size, cfg.crop_size, cfg.ignore_index),
        seed=cfg.shuffle_seed, num_workers=cfg.num_workers, pin_memory=pin_memory, shard=shard,
    )
    return loader, num_classes


def make_val_loader(cfg: DataConfig, pin_memory: bool = False) -> Tuple[DataLoader, int]:
    """(val_loader, num_classes): in order, the last ragged batch kept,
    eval_transform (always normalized on the host)."""
    dataset, num_classes = _datasets(cfg, train=False)
    loader = DataLoader(
        dataset, cfg.eval_batch_size, lambda s: T.eval_transform(s, cfg.crop_size),
        shuffle=False, drop_last=False, seed=cfg.shuffle_seed, num_workers=cfg.num_workers,
        transform_needs_rng=False, pin_memory=pin_memory,
    )
    return loader, num_classes


def make_data_loader(
    cfg: DataConfig, pin_memory: bool = False, shard: Tuple[int, int] = (0, 1)
) -> Tuple[DataLoader, DataLoader, int]:
    """(train_loader, val_loader, num_classes), zs3_tpu's factory contract;
    the train loader yields rank's rows with `shard` (the val loader whole
    batches, which the trainers pad and split)."""
    train, num_classes = make_train_loader(cfg, pin_memory, shard)
    val, _ = make_val_loader(cfg, pin_memory)
    return train, val, num_classes
