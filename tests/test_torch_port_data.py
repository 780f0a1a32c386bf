"""The port's data layer against zs3_tpu's on fabricated VOC2012, SBD and
Pascal-Context trees (small images, 50-80 pixels a side).

* `fabricate_*` write zs3_tpu's files byte for byte (a `.mat` file's
  header holds its creation time: the rest of its bytes, and what it
  loads to, are compared);
* the readers (VOC with the unseen filter and the weak-label fallback,
  SBD, `CombineDBs`, Context) give zs3_tpu's names and arrays exactly;
* `make_data_loader` for `pascal` with `use_sbd` at crop 65 gives
  zs3_tpu's batches byte for byte, for two seeds and two epochs, host-
  normalized and with `device_preprocess` (uint8);
* the prefetching loader surfaces a worker's error as RuntimeError and
  reaps an abandoned iterator's producer thread;
* device preprocessing: normalize to 1e-6 of zs3_tpu's, the masked flip
  exact on zs3_tpu's mask, and the seen and ZS3 steps on a uint8 batch
  equal to the steps on the host-normalized batch flipped by the same
  mask;
* the dataset-named class embeddings, the `tfdata` refusal, and ZS5's
  weak labels on the readers' own hook.
"""

import copy
import dataclasses
import json
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.data import context as jax_context
from zs3_tpu.data import fabricate as jax_fabricate
from zs3_tpu.data import sbd as jax_sbd
from zs3_tpu.data import transforms as jax_transforms
from zs3_tpu.data import voc as jax_voc
from zs3_tpu.data.embeddings import load_class_embeddings as jax_load_class_embeddings
from zs3_tpu.data.loader import make_data_loader as jax_make_data_loader
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import Config, DataConfig
from zs3_tpu_torch.data import context, fabricate, sbd, transforms, voc
from zs3_tpu_torch.data.classes import CONTEXT_CLASSES, VOC_CLASSES
from zs3_tpu_torch.data.loader import DataLoader, make_data_loader, make_train_loader
from zs3_tpu_torch.data.synthetic import SyntheticSegmentation
from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
from zs3_tpu_torch.train import gmmn
from zs3_tpu_torch.train.seen import FLIP_STREAM, make_train_step, step_generator
from zs3_tpu_torch.train.self_training import WeakLabelDataset, _gt_view
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils import losses

from tests.test_torch_port_models import LAYERS
from tests.test_torch_port_seen import _randomize_bn_stats
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

SIZES = ((60, 80), (80, 60), (70, 80), (50, 80))
VOC_UNSEEN = (10, 14)
CONTEXT_UNSEEN = (19, 33)


def _fabricate(module, root):
    module.fabricate_voc_tree(root, 9, 3, unseen_classes=VOC_UNSEEN, sizes=SIZES)
    # SBD repeats two VOC names: one of the train split, one of the val split.
    module.fabricate_sbd_tree(root, 6, unseen_classes=VOC_UNSEEN, sizes=SIZES)
    module.fabricate_context_tree(root, 6, 3, unseen_classes=CONTEXT_UNSEEN, sizes=SIZES)
    module.fabricate_embedding_npy(os.path.join(root, "voc.npy"), VOC_CLASSES)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(the port's tree, zs3_tpu's tree, a weak-label dir): one seed each."""
    ours, ref = tmp_path_factory.mktemp("ours"), tmp_path_factory.mktemp("ref")
    _fabricate(fabricate, str(ours))
    _fabricate(jax_fabricate, str(ref))
    sbd_set = ours / "benchmark_RELEASE" / "dataset"
    names = (sbd_set / "train.txt").read_text().split()
    for src, dup in ((names[1], "2008_000001"), (names[4], "2008_900002")):
        for sub, ext in (("img", ".jpg"), ("cls", ".mat")):
            shutil.copy(sbd_set / sub / (src + ext), sbd_set / sub / (dup + ext))
    (sbd_set / "train.txt").write_text("\n".join(names + ["2008_000001", "2008_900002"]) + "\n")
    weak = tmp_path_factory.mktemp("weak")
    from PIL import Image

    for name, shape in (("2008_000000", (60, 80)), ("2010_000003", (50, 80))):
        Image.fromarray(np.full(shape, 7, np.uint8)).save(weak / f"{name}.png")
    return str(ours), str(ref), str(weak)


@pytest.mark.parametrize("tree", ["VOC2012", "benchmark_RELEASE", "VOC2010", "voc.npy"])
def test_fabricated_files_are_zs3_tpus(trees, tree):
    from scipy import io as sio

    ours, ref, _ = trees
    files = []
    for top, _, names in os.walk(os.path.join(ref, tree)):
        files += [os.path.relpath(os.path.join(top, n), ref) for n in names]
    if tree == "voc.npy":
        files = [tree]
    assert len(files) >= 3 or tree == "voc.npy"
    for rel in sorted(files):
        a = open(os.path.join(ours, rel), "rb").read()
        b = open(os.path.join(ref, rel), "rb").read()
        if rel == "benchmark_RELEASE/dataset/train.txt":
            continue  # rewritten by the fixture
        if rel.endswith(".mat"):
            assert a[128:] == b[128:], rel
            load = lambda p: sio.loadmat(p, squeeze_me=True, struct_as_record=False)
            np.testing.assert_array_equal(
                load(os.path.join(ours, rel))["GTcls"].Segmentation,
                load(os.path.join(ref, rel))["GTcls"].Segmentation)
        else:
            assert a == b, rel


READERS = {
    "voc train, unseen filtered": lambda m, root, weak: m["voc"].VOCSegmentation(
        root, "train", VOC_UNSEEN),
    "voc val": lambda m, root, weak: m["voc"].VOCSegmentation(
        root, "val", VOC_UNSEEN, filter_unseen=False),
    "voc train, weak labels": lambda m, root, weak: m["voc"].VOCSegmentation(
        root, "train", VOC_UNSEEN, filter_unseen=False, weak_label_dir=weak),
    "sbd train, unseen filtered": lambda m, root, weak: m["sbd"].SBDSegmentation(
        root, "train", VOC_UNSEEN),
    "voc + sbd": lambda m, root, weak: m["sbd"].CombineDBs(
        [m["voc"].VOCSegmentation(root, "train", VOC_UNSEEN, filter_unseen=False,
                                  weak_label_dir=weak),
         m["sbd"].SBDSegmentation(root, "train")],
        exclude_names=m["voc"].VOCSegmentation(root, "val").names),
    "context train, unseen filtered": lambda m, root, weak: m["context"].ContextSegmentation(
        root, "train", CONTEXT_UNSEEN),
    "context val": lambda m, root, weak: m["context"].ContextSegmentation(
        root, "val", CONTEXT_UNSEEN, filter_unseen=False),
    "context train, weak labels": lambda m, root, weak: m["context"].ContextSegmentation(
        root, "train", CONTEXT_UNSEEN, filter_unseen=False, weak_label_dir=weak),
}
PORT = {"voc": voc, "sbd": sbd, "context": context}
JAX = {"voc": jax_voc, "sbd": jax_sbd, "context": jax_context}


@pytest.mark.parametrize("case", list(READERS))
def test_readers_match(trees, case):
    root, _, weak = trees
    ours, ref = READERS[case](PORT, root, weak), READERS[case](JAX, root, weak)
    assert ours.names == ref.names and len(ours) == len(ref) > 0
    assert ours.NUM_CLASSES == ref.NUM_CLASSES
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a["name"] == b["name"]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
        assert a["image"].dtype == b["image"].dtype and a["label"].dtype == b["label"].dtype
    if "filtered" in case:
        assert all(not np.isin(ours[i]["label"], ours.unseen_classes).any()
                   for i in range(len(ours)))
    if case == "voc + sbd":  # duplicates and val names dropped
        assert len(set(ours.names)) == len(ours.names)
        assert "2008_900002" not in ours.names and "2008_000001" in ours.names
    if "weak" in case:
        assert any((ours[i]["label"] == 7).all() for i in range(len(ours)))


@pytest.mark.parametrize("reader", [voc.VOCSegmentation, context.ContextSegmentation])
def test_readers_refuse_a_missing_split(tmp_path, reader):
    with pytest.raises(FileNotFoundError, match="split list not found"):
        reader(str(tmp_path), "train")


def _loader_cfg(root, seed, device_preprocess):
    return dict(dataset="pascal", root=root, use_sbd=True, crop_size=65, base_size=65,
                batch_size=4, eval_batch_size=4, unseen_classes=VOC_UNSEEN,
                shuffle_seed=seed, num_workers=2, device_preprocess=device_preprocess)


@pytest.mark.parametrize("seed,device_preprocess",
                         [(0, False), (5, False), (0, True), (5, True)])
def test_loader_batches_match_byte_for_byte(trees, seed, device_preprocess):
    root = trees[0]
    kw = _loader_cfg(root, seed, device_preprocess)
    train, val, n = make_data_loader(DataConfig(**kw))
    ref_train, ref_val, ref_n = jax_make_data_loader(JaxDataConfig(**kw))
    assert n == ref_n == 21 and len(train) == len(ref_train) == 3
    for epoch in (0, 3):
        train.set_epoch(epoch)
        ref_train.set_epoch(epoch)
        pairs = list(zip(train, ref_train))
        assert len(pairs) == len(train)
        for ours, ref in pairs:
            assert ours.keys() == {"image", "label"}
            for key in ours:
                assert ours[key].dtype == ref[key].dtype
                np.testing.assert_array_equal(ours[key], ref[key])
        dtype = np.uint8 if device_preprocess else np.float32
        assert pairs[0][0]["image"].dtype == dtype and pairs[0][0]["label"].dtype == np.int32
    for ours, ref in zip(val, ref_val):  # always normalized on the host
        assert ours["image"].dtype == np.float32
        np.testing.assert_array_equal(ours["image"], ref["image"])
        np.testing.assert_array_equal(ours["label"], ref["label"])


def test_loader_propagates_worker_errors():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, idx):
            if idx >= 4:
                raise OSError("corrupt image")
            return {"image": np.zeros((4, 4, 3), np.float32),
                    "label": np.zeros((4, 4), np.int32)}

    dl = DataLoader(Broken(), 4, lambda s: s, shuffle=False, num_workers=2,
                    transform_needs_rng=False)
    with pytest.raises(RuntimeError, match="worker failed") as info:
        for _ in dl:
            pass
    assert isinstance(info.value.__cause__, OSError)


def test_loader_abandoned_iterator_reaps_producer():
    ds = SyntheticSegmentation(64, (16, 16), num_classes=4)
    dl = DataLoader(ds, 4, lambda s: s, shuffle=False, num_workers=2, prefetch=1,
                    transform_needs_rng=False)
    before = threading.active_count()
    for _ in range(3):  # three abandoned epochs
        it = iter(dl)
        next(it)
        it.close()  # what collection does to an abandoned generator
    assert threading.active_count() <= before


def test_normalize_and_masked_flip_match(rng):
    images = rng.integers(0, 256, (5, 9, 11, 3), dtype=np.uint8)
    labels = rng.integers(0, 21, (5, 9, 11)).astype(np.int32)
    want = np.array(jax_transforms.batched_normalize_device(images))
    got = transforms.batched_normalize_device(torch.from_numpy(images))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    key = jax.random.key(3)
    mask = np.asarray(jax.random.bernoulli(key, 0.5, (5,)))
    assert 0 < mask.sum() < 5
    want_img, want_lbl = jax_transforms.batched_random_flip_device(want, labels, key)
    got_img, got_lbl = transforms.batched_flip_device(
        torch.from_numpy(want), torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))


def _uint8_batch(seed, bsz=4, size=33, num_classes=5):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, (bsz, size, size)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.1] = 255
    return {"image": rng.integers(0, 256, (bsz, size, size, 3), dtype=np.uint8),
            "label": labels}


def _host_ready(batch, mask):
    """The uint8 batch normalized on the host and flipped where mask is set."""
    images = np.stack([transforms.normalize({"image": im, "label": lb})["image"]
                       for im, lb in zip(batch["image"], batch["label"])])
    images = np.where(mask[:, None, None, None], images[:, :, ::-1], images)
    labels = np.where(mask[:, None, None], batch["label"][:, :, ::-1], batch["label"])
    return {"image": torch.from_numpy(np.ascontiguousarray(images)),
            "label": torch.from_numpy(np.ascontiguousarray(labels))}


def test_seen_step_with_device_preprocess_is_the_flipped_step():
    """Two steps from one state: the device_preprocess step on uint8
    batches against the plain step on host-normalized batches flipped by
    the masks step_generator(seed, step, FLIP_STREAM) draws, at the seen
    step tests' tolerances (loss rtol 1e-5, parameters 1e-4)."""
    seed = 2
    models = []
    for _ in range(2):
        model = DeepLab(backbone="resnet50", num_classes=5, dropout=False, layers=LAYERS)
        models.append(_randomize_bn_stats(init_deeplab(model, 0), seed=1))
    cfg = Config()
    opts = [SegOptimizer(m, cfg, 10) for m in models]
    loss = losses.build_seg_loss("ce")
    on = make_train_step(loss, seed=seed, device_preprocess=True)
    off = make_train_step(loss, seed=seed)
    masks = []
    for step in range(2):
        batch = _uint8_batch(10 + step)
        mask = (torch.rand(4, generator=step_generator(seed, step, torch.device("cpu"),
                                                       FLIP_STREAM)) < 0.5).numpy()
        masks.append(mask)
        got = on(models[0], opts[0], {k: torch.from_numpy(v) for k, v in batch.items()})
        want = off(models[1], opts[1], _host_ready(batch, mask))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        for (name, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4, err_msg=name)
    assert any(0 < m.sum() < 4 for m in masks)  # flipped and unflipped samples


TINY_ZS3 = ["train-gmmn", "--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
            "--backbone", "resnet50", "--compute-dtype", "float32", "--unseen-split", "2",
            "--batch-size", "4", "--pixels-per-class", "16", "--epochs", "0", "--seed", "4",
            "--device", "cpu"]


def test_zs3_step_with_device_preprocess_is_the_flipped_step(tmp_path):
    """The ZS3 step on a uint8 batch with device_preprocess against the
    same step (a copy of its state) without it on the host-normalized
    batch flipped by the same mask: the flips are a stream of their own,
    so both draw the same scores and noise and train to the same
    parameters."""
    with open(tmp_path / "dp.json", "w") as f:
        json.dump({"data": {"device_preprocess": True, "synthetic_items": 8,
                            "num_workers": 1}}, f)
    with pytest.warns(UserWarning, match="randomly initialised"):
        _, trainer = cli.run([*TINY_ZS3, "--config", str(tmp_path / "dp.json"),
                              "--checkpoint-dir", str(tmp_path)])
    on = trainer.step
    off = copy.deepcopy(on)
    off.device_preprocess = False
    assert on.device_preprocess
    batch = next(iter(trainer.train_loader))
    assert batch["image"].dtype == np.uint8
    step = 3
    mask = (torch.rand(4, generator=step_generator(on.seed, step, torch.device("cpu"),
                                                   FLIP_STREAM)) < 0.5).numpy()
    assert 0 < mask.sum() < 4
    got = on({k: torch.from_numpy(v) for k, v in batch.items()}, step=step)
    want = off(_host_ready(batch, mask), step=step)
    for key in ("mmd", "cls_ce"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6)
    for a, b in zip(zs3_params(on), zs3_params(off)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="step"):
        on({k: torch.from_numpy(v) for k, v in batch.items()}, draws=on.draw(4, 0))


def zs3_params(step):
    return [p.detach() for p in step.generator.parameters()] + [
        v.detach() for v in step.cls.values()]


@pytest.mark.parametrize("dataset,from_file", [("pascal", True), ("pascal", False),
                                               ("context", True), ("context", False)])
def test_class_embeddings_by_dataset_name(tmp_path, dataset, from_file):
    names = CONTEXT_CLASSES if dataset == "context" else VOC_CLASSES
    path = None
    if from_file:
        path = fabricate.fabricate_embedding_npy(str(tmp_path / "e.npy"), names, seed=3)
    cfg = Config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset=dataset, embedding_path=path))
    got = gmmn.class_embeddings(cfg, len(names))
    np.testing.assert_array_equal(got, jax_load_class_embeddings(names, path, 300))
    assert got.shape == (len(names), 300)
    if from_file:
        narrow = cfg.replace(gmmn=dataclasses.replace(cfg.gmmn, embed_dim=64))
        with pytest.raises(ValueError, match="embed_dim"):
            gmmn.class_embeddings(narrow, len(names))


def test_tfdata_is_refused(trees):
    cfg = DataConfig(**_loader_cfg(trees[0], 0, False), input_pipeline="tfdata")
    with pytest.raises(NotImplementedError, match="tfdata"):
        make_data_loader(cfg)


def test_zs5_reads_weak_labels_through_the_readers(trees):
    """With weak_label_dir (what ZS5Trainer sets for pascal and context),
    the pascal + SBD train set keeps the unseen images and reads the
    pseudo-labels through VOCSegmentation's own hook (no
    WeakLabelDataset); _gt_view undoes it inside the union."""
    root, _, weak = trees
    loader, _ = make_train_loader(DataConfig(**_loader_cfg(root, 0, False),
                                             weak_label_dir=weak))
    ds = loader.dataset
    assert isinstance(ds, sbd.CombineDBs) and not isinstance(ds, WeakLabelDataset)
    vocs = [d for d, _ in ds._items if isinstance(d, voc.VOCSegmentation)]
    assert vocs and all(d.weak_label_dir == weak for d in vocs)
    unfiltered = voc.VOCSegmentation(root, "train", VOC_UNSEEN, filter_unseen=False)
    assert set(unfiltered.names) <= set(ds.names)  # no unseen filter
    i = ds.names.index("2008_000000")
    assert (ds[i]["label"] == 7).all()
    gt = _gt_view(ds)
    assert gt.names == ds.names and ds[i]["label"].shape == gt[i]["label"].shape
    np.testing.assert_array_equal(gt[i]["label"], unfiltered[0]["label"])
    assert all(d.weak_label_dir is None for d, _ in gt._items
               if isinstance(d, voc.VOCSegmentation))
    assert vocs[0].weak_label_dir == weak  # the loader's own is left as it was
