"""zs3_tpu's tf.data train stream (`input_pipeline="tfdata"`) without
TensorFlow: the port of zs3_tpu.data.tfdata.

zs3_tpu's production train input shuffles the file list, maps a decode
and augmentation over it in parallel (flip, scale, pad, crop, blur,
normalize, every random number from TensorFlow's stateless RNG), and
batches and prefetches, all on the host.  This module computes the same
stream with numpy, PIL and torch; it imports no TensorFlow:

* the epoch order is TensorFlow's `shuffle(n, seed,
  reshuffle_each_iteration=False)` without a global seed
  (`shuffle_order`): a Philox4x32-10 stream seeded by (87654321, seed)
  picks each output from the front of what is left of the buffer;
* an example's six draws are `tf.random.stateless_uniform((),
  seed=(seed, 8 * index + slot))` (`stateless_uniform`): TensorFlow's
  GenerateKey scrambles the seed pair into a Philox key and counter, and
  the first word of the next block becomes an f32 in [0, 1);
* `augment` repeats zs3_tpu's f32 arithmetic step by step: the scaled
  size, TensorFlow's half-pixel bilinear (image) and nearest (label)
  resize, computed only over the crop window, the pad, the crop offsets,
  the 7-tap Gaussian blur and the ImageNet normalization.

Order, draws and labels equal zs3_tpu's bit for bit, and so do images
decoded alike, but where TensorFlow's f32 exp rounds a blur tap
otherwise (about 4% of sigmas; those images move by about 1e-6 in
normalized units).  Two stated divergences (ROADMAP Queue 3): images are
decoded with PIL, whose JPEG pixels lie up to a few levels off
TensorFlow's decoder (lossless images decode alike); labels are read by
index (`np.asarray(Image.open(path))`, as the readers do), where
zs3_tpu's `decode_png(channels=1)` turns a palette PNG into luminance.

`TFDataLoader` keeps zs3_tpu's interface (`set_epoch`, `len`,
`.dataset`; epoch e is the stream of seed + e) and the port's loader
contract (data/loader.py): pinned torch batches with `pin_memory`,
rank's contiguous rows of each batch with `shard`, f32 NHWC images and
int32 labels (numpy arrays unless pinned).  The map runs in
`torch.utils.data.DataLoader` worker processes (`num_workers`, spawned
once and kept across epochs; 0 maps in the calling process).  Batches
keep their order and are byte for byte the same for any number of
workers; an error in a worker is raised in the consumer.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from PIL import Image

from zs3_tpu_torch.core.config import DataConfig
from zs3_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

_MASK32 = np.uint64(0xFFFFFFFF)
_SHIFT32 = np.uint64(32)
_PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_PHILOX_W = (np.uint64(0x9E3779B9), np.uint64(0xBB67AE85))
# GenerateKey's fixed Philox key (tensorflow/core/kernels/stateless_random_ops.cc).
_SCRAMBLE_KEY = (0x3EC8F720, 0x02461E29)
# The partner of an op seed when no global seed is set
# (tensorflow/python/framework/random_seed.py, DEFAULT_GRAPH_SEED).
DEFAULT_GRAPH_SEED = 87654321
_MAXINT32 = 2**31 - 1
SLOTS = 6  # draws an example takes: flip, short side, crop y, crop x, blur gate, sigma


def philox4x32(key: np.ndarray, counter: np.ndarray) -> np.ndarray:
    """Philox4x32-10 (TensorFlow's PhiloxRandom) of each row: key (N, 2)
    and counter (N, 4), 32-bit words held in uint64 -> the (N, 4) block."""
    k0, k1 = key[:, 0].astype(np.uint64), key[:, 1].astype(np.uint64)
    c0, c1, c2, c3 = (counter[:, i].astype(np.uint64) for i in range(4))
    for _ in range(10):
        p0 = _PHILOX_M[0] * c0
        p1 = _PHILOX_M[1] * c2
        c0, c1, c2, c3 = ((p1 >> _SHIFT32) ^ c1 ^ k0, p1 & _MASK32,
                          (p0 >> _SHIFT32) ^ c3 ^ k1, p0 & _MASK32)
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return np.stack([c0, c1, c2, c3], axis=1)


def _words(values) -> Tuple[np.ndarray, np.ndarray]:
    """(low, high) 32-bit words of int64 values, two's complement."""
    u = np.asarray(values, np.int64).astype(np.uint64)
    return u & _MASK32, u >> _SHIFT32


def stateless_uniform(seed0, seed1, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """`tf.random.stateless_uniform((), seed=(seed0, seed1), minval,
    maxval)` in f32, elementwise over the broadcast seeds."""
    s0, s1 = np.broadcast_arrays(np.asarray(seed0, np.int64), np.asarray(seed1, np.int64))
    shape = s0.shape
    lo0, hi0 = _words(s0.ravel())
    lo1, hi1 = _words(s1.ravel())
    key = np.broadcast_to(np.array(_SCRAMBLE_KEY, np.uint64), (lo0.size, 2))
    mix = philox4x32(key, np.stack([lo0, hi0, lo1, hi1], axis=1))
    zero = np.zeros_like(lo0)
    block = philox4x32(mix[:, :2], np.stack([zero, zero, mix[:, 2], mix[:, 3]], axis=1))
    bits = ((block[:, 0] & np.uint64(0x7FFFFF)) | np.uint64(0x3F800000)).astype(np.uint32)
    u = bits.view(np.float32) - np.float32(1.0)
    low, high = np.float32(minval), np.float32(maxval)
    return (u * (high - low) + low).reshape(shape)


def example_draws(seed: int, indices: np.ndarray, base_size: int) -> np.ndarray:
    """(len(indices), SLOTS) f32: slot j of example i is zs3_tpu's
    draw(j), keyed by (seed, 8 * i + j); slot 1 (the short side) lies in
    [int(base / 2), int(2 * base) + 1)."""
    idx = np.asarray(indices, np.int64)[:, None] * 8 + np.arange(SLOTS)
    draws = stateless_uniform(seed, idx)
    draws[:, 1] = stateless_uniform(seed, idx[:, 1], float(int(base_size * 0.5)),
                                    float(int(base_size * 2.0) + 1))
    return draws


def shuffle_order(n: int, seed: int) -> np.ndarray:
    """The order of `tf.data.Dataset.range(n).shuffle(n, seed,
    reshuffle_each_iteration=False)` with no global seed: int64 (n,)."""
    op_seed = seed % _MAXINT32  # random_seed._truncate_seed
    blocks = np.arange(-(-n // 4), dtype=np.uint64)
    lo, hi = _words(op_seed)
    key = np.broadcast_to(np.array([DEFAULT_GRAPH_SEED, 0], np.uint64), (blocks.size, 2))
    counter = np.stack([blocks & _MASK32, blocks >> _SHIFT32,
                        np.full_like(blocks, lo), np.full_like(blocks, hi)], axis=1)
    words = philox4x32(key, counter).reshape(-1)[:n].tolist()
    buffer = list(range(n))
    order = []
    for i, r in enumerate(words):
        j = i + r % (n - i)
        order.append(buffer[j])
        buffer[i], buffer[j] = buffer[j], buffer[i]
    return np.asarray(order, np.int64)


def _bilinear_taps(out_idx: np.ndarray, in_size: int, out_size: int):
    """TensorFlow's half-pixel bilinear weights (resize_bilinear_op.cc,
    compute_interpolation_weights) at the output positions `out_idx`."""
    scale = np.float32(in_size) / np.float32(out_size)
    src = (out_idx.astype(np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    floor = np.floor(src)
    lower = np.maximum(floor.astype(np.int64), 0)
    upper = np.minimum(np.ceil(src).astype(np.int64), in_size - 1)
    return lower, upper, src - floor


def _nearest_taps(out_idx: np.ndarray, in_size: int, out_size: int) -> np.ndarray:
    """TensorFlow's half-pixel nearest source index (resize_nearest_neighbor_op.cc)."""
    scale = np.float32(in_size) / np.float32(out_size)
    src = np.floor((out_idx.astype(np.float32) + np.float32(0.5)) * scale)
    return np.clip(src.astype(np.int64), 0, in_size - 1)


def _resize_window(image: np.ndarray, rows: np.ndarray, cols: np.ndarray, nh: int,
                   nw: int) -> np.ndarray:
    """Rows `rows` and columns `cols` of the uint8 (h, w, 3) image resized
    to (nh, nw) by TensorFlow's bilinear resize, f32, in its order of
    operations (compute_lerp: top and bottom are the column lerps of two
    source rows, so each source row is lerped once)."""
    h, w = image.shape[:2]
    y0, y1, ly = _bilinear_taps(rows, h, nh)
    x0, x1, lx = _bilinear_taps(cols, w, nw)
    used, at = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    src = image[used]
    # a + (b - a) * t, in place.
    left, right = src[:, x0].astype(np.float32), src[:, x1].astype(np.float32)
    right -= left
    right *= lx[None, :, None]
    left += right
    top, bottom = left[at[: rows.size]], left[at[rows.size:]]
    bottom -= top
    bottom *= ly[:, None, None]
    top += bottom
    return top


def blur_kernel(sigma: np.float32) -> np.ndarray:
    """zs3_tpu's 7-tap Gaussian, f32; sigma 0 gives the identity.  The
    exponential is rounded from f64: TensorFlow's f32 exp gives the same
    kernel for about 96% of sigmas, and numpy's f32 exp for about 30%."""
    xs = np.arange(-3.0, 4.0, dtype=np.float32)
    arg = -(xs * xs) / (np.float32(2.0) * sigma * sigma + np.float32(1e-12))
    k = np.exp(arg.astype(np.float64)).astype(np.float32)
    return k / k.sum(dtype=np.float32)


def blur(image: np.ndarray, k: np.ndarray) -> np.ndarray:
    """zs3_tpu's separable blur of an f32 (h, w, 3) image: the 7-tap
    kernel `k` along H, then along W, zero padding ("SAME").  Each output
    adds its seven taps in order, each by a fused multiply-add (torch's
    vectorized `add_(x, alpha=k)`), as TensorFlow's depthwise conv does."""
    x = torch.from_numpy(image)
    for axis in (0, 1):
        out = torch.zeros_like(x)
        n = x.shape[axis]
        for t, weight in enumerate(k.tolist()):
            shift = t - 3
            lo, hi = max(0, -shift), min(n, n - shift)
            out.narrow(axis, lo, hi - lo).add_(x.narrow(axis, lo + shift, hi - lo), alpha=weight)
        x = out
    return x.numpy()


def scaled_size(h: int, w: int, short_draw: np.float32) -> Tuple[int, int]:
    """(nh, nw): the short side scaled to int(short_draw), in f32 as
    TensorFlow computes it (a Python float moves nh or nw by a pixel at
    some sizes)."""
    short = np.float32(int(short_draw))  # f32 -> int32 truncates
    hf, wf = np.float32(h), np.float32(w)
    scale = short / wf if h > w else short / hf
    return int(hf * scale), int(wf * scale)


def augment(image: np.ndarray, label: np.ndarray, draws: np.ndarray, crop: int,
            fill: int, blur_prob: float) -> Dict[str, np.ndarray]:
    """One example through zs3_tpu's map (tfdata.py, load_and_augment),
    given its SLOTS draws: uint8 (h, w, 3) image and (lh, lw) label ->
    {'image': f32 (crop, crop, 3) normalized, 'label': int32 (crop, crop)}."""
    if draws[0] < np.float32(0.5):  # joint horizontal flip
        image, label = image[:, ::-1], label[:, ::-1]
    nh, nw = scaled_size(*image.shape[:2], draws[1])
    ph, pw = max(crop - nh, 0), max(crop - nw, 0)
    oy = int(draws[2] * np.float32(max(nh + ph - crop, 0) + 1))
    ox = int(draws[3] * np.float32(max(nw + pw - crop, 0) + 1))
    # The resize, pad and crop, over the crop window only: rows and columns
    # past (nh, nw) are the pad (0 on the image, fill on the label).
    rows = np.arange(oy, min(oy + crop, nh))
    cols = np.arange(ox, min(ox + crop, nw))
    out = _resize_window(image, rows, cols, nh, nw)
    if out.shape != (crop, crop, 3):
        out = np.pad(out, ((0, crop - rows.size), (0, crop - cols.size), (0, 0)))
    lbl = np.full((crop, crop), fill, np.int32)
    lh, lw = label.shape
    near_rows, near_cols = _nearest_taps(rows, lh, nh), _nearest_taps(cols, lw, nw)
    lbl[: rows.size, : cols.size] = label[near_rows][:, near_cols]
    sigma = draws[5] if draws[4] < np.float32(blur_prob) else np.float32(0.0)
    k = blur_kernel(sigma)
    if np.count_nonzero(k) > 1:  # else the identity: the blur would return its input
        out = blur(out, k)
    out /= np.float32(255.0)
    out -= IMAGENET_MEAN
    out /= IMAGENET_STD
    return {"image": out, "label": lbl}


def read_example(image_path: str, label_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 (h, w, 3) image by PIL (RGB) and the label's stored values
    (a palette PNG's indices), as the readers read them."""
    with Image.open(image_path) as img:
        image = np.asarray(img.convert("RGB"))
    with Image.open(label_path) as lbl:
        label = np.asarray(lbl)
    if label.ndim != 2:
        raise ValueError(f"label {label_path} has shape {label.shape}: want one channel")
    return image, label


def _file_lists(dataset) -> Tuple[List[str], List[str]]:
    """(image paths, label paths) of a reader, its weak-label hook
    included (zs3_tpu's tfdata._file_lists)."""
    if not (hasattr(dataset, "image_dir") and hasattr(dataset, "_label_path")):
        raise ValueError(
            f"input_pipeline='tfdata' reads image and label files by name, and "
            f"{type(dataset).__name__} names none (no image_dir/_label_path): the VOC+SBD "
            "union (use_sbd) is refused (zs3_tpu's stream fails on it; SBD's labels are "
            ".mat files); use input_pipeline='python' with use_sbd")
    images = [os.path.join(dataset.image_dir, name + ".jpg") for name in dataset.names]
    return images, [dataset._label_path(name) for name in dataset.names]


def epoch_batches(dataset, cfg: DataConfig, seed: int, shard: Tuple[int, int] = (0, 1)
                  ) -> List[List[tuple]]:
    """The batches of the epoch of `seed`: for each, rank's rows as
    (image path, label path, draws) items, in zs3_tpu's order; the last
    ragged batch dropped."""
    images, labels = _file_lists(dataset)
    order = shuffle_order(len(images), seed)
    draws = example_draws(seed, np.arange(len(images)), cfg.base_size)
    rank, ranks = shard
    per = cfg.batch_size // ranks
    batches = []
    for b in range(len(images) // cfg.batch_size):
        rows = order[b * cfg.batch_size + rank * per: b * cfg.batch_size + (rank + 1) * per]
        batches.append([(images[i], labels[i], draws[i]) for i in rows])
    return batches


class _Augment(torch.utils.data.Dataset):
    """The map a worker runs over a batch's items, in place: item (slot,
    row, image path, label path, draws) writes its augmented example to
    row `row` of slot `slot` of the ring, a buffer of batches that the
    workers and the consumer share, made once, so that an example crosses
    to the consumer without a copy or a new shared segment."""

    def __init__(self, ring: Dict[str, torch.Tensor], crop: int, fill: int, blur_prob: float):
        self.ring = ring
        self.crop, self.fill, self.blur_prob = crop, fill, blur_prob

    def __getitem__(self, item) -> int:
        slot, row, image_path, label_path, draws = item
        image, label = read_example(image_path, label_path)
        example = augment(image, label, draws, self.crop, self.fill, self.blur_prob)
        for key, value in example.items():
            self.ring[key][slot, row] = torch.from_numpy(value)
        return slot


def _slot_of(rows: List[int]) -> int:
    """collate_fn: the slot a batch's examples were written to."""
    return rows[0]


class _Plan(torch.utils.data.Sampler):
    """The batch sampler: the current epoch's batches of items, batch b
    written to slot b % slots of the ring."""

    def __init__(self, slots: int):
        self.slots = slots
        self.batches: List[List[tuple]] = []

    def __iter__(self):
        for b, batch in enumerate(self.batches):
            yield [(b % self.slots, row, *item) for row, item in enumerate(batch)]

    def __len__(self) -> int:
        return len(self.batches)


class _Stream:
    """The parallel map, batch and prefetch: a torch DataLoader whose
    `cfg.num_workers` processes (0: the calling process) each map a
    batch's examples into the ring; batches come back in order and are
    copied out of the ring (into pinned memory if asked).  A batch's slot
    is written again only once prefetch_factor x workers later batches
    were asked for, after the consumer copied it out.  Workers come from
    a fork server, which forks them from a process of its own without
    threads (no fork of the threaded caller) that imported torch and
    this module once: spawning took about 10 s for 8 workers on an 8-core
    host, and recurs for every loader."""

    def __init__(self, cfg: DataConfig, blur_prob: float, pin_memory: bool, persistent: bool,
                 shard: Tuple[int, int]):
        workers = cfg.num_workers
        prefetch = 2 if workers else 0
        per = cfg.batch_size // shard[1]
        crop = cfg.crop_size
        self.plan = _Plan(slots=prefetch * workers + 1)
        self.ring = {"image": torch.empty((self.plan.slots, per, crop, crop, 3)),
                     "label": torch.empty((self.plan.slots, per, crop, crop), dtype=torch.int32)}
        context = None
        if workers:
            for value in self.ring.values():
                value.share_memory_()
            context = multiprocessing.get_context("forkserver")
            context.set_forkserver_preload([__name__])
        self.pin_memory = pin_memory
        self.loader = torch.utils.data.DataLoader(
            _Augment(self.ring, crop, cfg.ignore_index, blur_prob), batch_sampler=self.plan,
            num_workers=workers, collate_fn=_slot_of, multiprocessing_context=context,
            persistent_workers=persistent and workers > 0, prefetch_factor=prefetch or None)

    def epoch(self, batches: List[List[tuple]]) -> Iterator[Dict[str, torch.Tensor]]:
        """The torch batches of an epoch's plan (epoch_batches)."""
        self.plan.batches = batches
        for slot in self.loader:
            out = {}
            for key, ring in self.ring.items():
                out[key] = torch.empty(ring.shape[1:], dtype=ring.dtype,
                                       pin_memory=self.pin_memory)
                out[key].copy_(ring[slot])
            yield out

    def close(self):
        iterator = self.loader._iterator  # torch's iterator of persistent workers, if any
        if iterator is not None:
            iterator._shutdown_workers()
            self.loader._iterator = None


def build_train_pipeline(dataset, cfg: DataConfig, seed: int = 0, blur_prob: float = 0.5
                         ) -> Iterator[Dict[str, torch.Tensor]]:
    """One epoch of {'image': f32 NHWC, 'label': int32 NHW} torch batches
    for `seed` (zs3_tpu's tf.data.Dataset), mapped on cfg.num_workers
    workers.  blur_prob overrides the gate of the Gaussian blur (0.5),
    as in zs3_tpu."""
    stream = _Stream(cfg, blur_prob, pin_memory=False, persistent=False, shard=(0, 1))
    return stream.epoch(epoch_batches(dataset, cfg, seed))


def as_numpy_iterator(pipeline):
    """Yield numpy batch dicts (what the trainers consume)."""
    for batch in pipeline:
        yield {key: value.numpy() for key, value in batch.items()}


class TFDataLoader:
    """zs3_tpu's TFDataLoader: the DataLoader interface over the stream,
    each epoch's from seed + epoch; its workers live as long as it does."""

    def __init__(self, dataset, cfg: DataConfig, seed: int = 0, pin_memory: bool = False,
                 shard: Tuple[int, int] = (0, 1)):
        if cfg.batch_size % shard[1]:
            raise ValueError(f"train batch size {cfg.batch_size} must be divisible by the "
                             f"data mesh axis ({shard[1]})")
        _file_lists(dataset)  # refuses a dataset without image files now, not at iteration
        self.dataset = dataset
        self._cfg = cfg
        self._seed = seed
        self._epoch = 0
        self.pin_memory = pin_memory
        self.shard = shard
        self._stream = _Stream(cfg, 0.5, pin_memory, persistent=True, shard=shard)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self._cfg.batch_size

    def __iter__(self):
        # The file lists are read now: ZS5's pseudo-labels appear between epochs.
        batches = epoch_batches(self.dataset, self._cfg, self._seed + self._epoch, self.shard)
        for batch in self._stream.epoch(batches):
            yield batch if self.pin_memory else {k: v.numpy() for k, v in batch.items()}

    def close(self):
        """Stop the worker processes now (collecting the loader stops them
        too); a later epoch starts new ones."""
        self._stream.close()
