"""The port's tf.data stream (zs3_tpu_torch/data/tfdata.py, no TensorFlow)
against zs3_tpu's (zs3_tpu/data/tfdata.py, TensorFlow) on the CPU.

* the per-example draws equal `tf.random.stateless_uniform` bit for bit,
  and the epoch order `Dataset.range(n).shuffle(n, seed,
  reshuffle_each_iteration=False)`;
* batches equal zs3_tpu's `TFDataLoader` and `build_train_pipeline` on
  fabricated VOC2012 and Pascal-Context trees whose images are PNG bytes
  under `.jpg` names (both packages sniff the content, so both decode
  them losslessly): labels exactly, images within IMAGE_ATOL, over epochs
  0 and 1, blur_prob 0, 1 and 0.5, and sizes that make the scale draw
  shrink and grow the image and that take the pad path;
* on real JPEGs labels are equal and images lie within the decoders' own
  gap; a palette label PNG reads as its indices in the port, as
  luminance in zs3_tpu (a fault of the reference, not carried over);
* any number of workers gives the same bytes, shards concatenate to the
  one-rank batch, a worker's error reaches the consumer;
* the factory: synthetic data keeps the python loader, device_preprocess
  and use_sbd are refused; SeenTrainer's first step on the stream within
  LOSS_RTOL of zs3_tpu's;
* `--compilation-cache DIR` on every subcommand.
"""

import dataclasses
import os
import shutil
import jax
import numpy as np
import pytest
from PIL import Image

from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.core.config import OptimConfig as JaxOptimConfig
from zs3_tpu.core.config import TrainConfig as JaxTrainConfig
from zs3_tpu.data import context as jax_context
from zs3_tpu.data import voc as jax_voc
from zs3_tpu.data.loader import make_data_loader as jax_make_data_loader
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import Config, DataConfig
from zs3_tpu_torch.data import context, fabricate, tfdata, voc
from zs3_tpu_torch.data.loader import DataLoader, make_data_loader, make_train_loader
from zs3_tpu_torch.data.transforms import IMAGENET_STD
from zs3_tpu_torch.ops import cuda_build
from zs3_tpu_torch.utils.convert import state_dict_from_flax

from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

# Images: equal on the hosts measured, but where TensorFlow's f32 exp
# rounds a blur tap otherwise (about 4% of sigmas, ~1e-6 normalized).
IMAGE_ATOL = 1e-5
# SeenTrainer's first loss, R50 at 65², f32: 4.1e-5 measured (the two
# frameworks' f32 convolutions through train-mode BN on a 5x5 grid).
LOSS_RTOL = 2e-4
SIZES = ((40, 50), (50, 40), (24, 70), (90, 60))  # base 33: shrink, grow and pad
READERS = {"pascal": (voc.VOCSegmentation, jax_voc.VOCSegmentation),
           "context": (context.ContextSegmentation, jax_context.ContextSegmentation)}


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _as_png_bytes(image_dir):
    """Rewrite every image of the tree as PNG bytes under its .jpg name."""
    for name in os.listdir(image_dir):
        path = os.path.join(image_dir, name)
        with Image.open(path) as img:
            pixels = np.asarray(img.convert("RGB"))
        Image.fromarray(pixels).save(path, format="PNG")


@pytest.fixture(scope="module")
def lossless(tmp_path_factory):
    """A VOC2012 tree (12 train, 2 val) and a Pascal-Context tree (12, 2)
    in SIZES, their images stored losslessly."""
    root = str(tmp_path_factory.mktemp("lossless"))
    fabricate.fabricate_voc_tree(root, 12, 2, sizes=SIZES)
    fabricate.fabricate_context_tree(root, 12, 2, sizes=SIZES)
    for tree in ("VOC2012", "VOC2010"):
        _as_png_bytes(os.path.join(root, tree, "JPEGImages"))
    return root


def _cfgs(root, dataset, **kw):
    fields = {**dict(dataset=dataset, root=root, crop_size=33, base_size=33, batch_size=4,
                     eval_batch_size=2, num_workers=0, input_pipeline="tfdata"), **kw}
    return DataConfig(**fields), JaxDataConfig(**fields)


def _compare(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys() == {"image", "label"}
        assert a["image"].dtype == b["image"].dtype == np.float32
        assert a["label"].dtype == b["label"].dtype == np.int32
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_allclose(a["image"], b["image"], rtol=0, atol=IMAGE_ATOL)
    return ours


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 2])
def test_draws_equal_tensorflow(tf, seed):
    """Every slot of examples up to VOC+SBD's 10,582, the short side's
    range at base 513 and 33 too, bit for bit."""
    indices = np.array([0, 1, 7, 1000, 10581])
    for base in (513, 33):
        got = tfdata.example_draws(seed, indices, base)
        for row, i in enumerate(indices):
            for j in range(tfdata.SLOTS):
                lo, hi = ((float(int(base * 0.5)), float(int(base * 2.0) + 1)) if j == 1
                          else (0.0, 1.0))
                want = tf.random.stateless_uniform(
                    (), seed=tf.constant([seed, int(i) * 8 + j], tf.int32), minval=lo,
                    maxval=hi, dtype=tf.float32).numpy()
                assert got[row, j].tobytes() == want.tobytes(), (seed, i, j, base)


@pytest.mark.parametrize("n", [1, 5, 17, 1000])
def test_order_equals_tensorflow(tf, n):
    for seed in (0, 1, 3, 42):
        want = tf.data.Dataset.range(n).shuffle(n, seed=seed, reshuffle_each_iteration=False)
        np.testing.assert_array_equal(tfdata.shuffle_order(n, seed),
                                      np.fromiter(want.as_numpy_iterator(), np.int64))


@pytest.mark.parametrize("dataset", ["pascal", "context"])
@pytest.mark.parametrize("blur_prob", [0.0, 1.0, 0.5])
def test_batches_match_zs3_tpu(tf, lossless, dataset, blur_prob):
    """build_train_pipeline at the seeds of epochs 0 and 1; at the default
    blur_prob 0.5 the TFDataLoaders' epochs 0 and 1 too."""
    from zs3_tpu.data.tfdata import TFDataLoader as JaxTFDataLoader
    from zs3_tpu.data.tfdata import build_train_pipeline as jax_build_train_pipeline

    cfg, jcfg = _cfgs(lossless, dataset)
    reader, jax_reader = READERS[dataset]
    ds, jax_ds = reader(lossless, "train"), jax_reader(lossless, "train")
    for seed in (0, 1):
        _compare(tfdata.as_numpy_iterator(tfdata.build_train_pipeline(ds, cfg, seed, blur_prob)),
                 jax_build_train_pipeline(jax_ds, jcfg, seed, blur_prob).as_numpy_iterator())
    if blur_prob == 0.5:
        loader, jax_loader = tfdata.TFDataLoader(ds, cfg), JaxTFDataLoader(jax_ds, jcfg)
        assert len(loader) == len(jax_loader) == 3 and loader.dataset is ds
        for epoch in (1, 0):
            loader.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            _compare(loader, jax_loader)
    # The trees' sizes drive each path: the scale shrinks and grows, and pads.
    draws = tfdata.example_draws(0, np.arange(len(ds)), cfg.base_size)
    shapes = [Image.open(os.path.join(ds.image_dir, n + ".jpg")).size[::-1] for n in ds.names]
    scaled = [tfdata.scaled_size(h, w, d[1]) for (h, w), d in zip(shapes, draws)]
    assert any(nh < h for (h, _), (nh, _) in zip(shapes, scaled))
    assert any(nh > h for (h, _), (nh, _) in zip(shapes, scaled))
    assert any(min(nh, nw) < cfg.crop_size for nh, nw in scaled)


def test_real_jpegs_within_the_decoders_gap(tf, tmp_path):
    """JPEGs: PIL and TensorFlow's decoder place pixels a few levels apart
    (stated divergence); labels stay equal, and the images' gap is at most
    the decoders' (bilinear taps and blur kernel are convex) in
    normalized units."""
    from zs3_tpu.data.tfdata import TFDataLoader as JaxTFDataLoader

    root = str(tmp_path)
    fabricate.fabricate_voc_tree(root, 8, 2, sizes=((60, 80), (80, 60)))
    cfg, jcfg = _cfgs(root, "pascal", crop_size=65, base_size=65)
    ds, jax_ds = voc.VOCSegmentation(root, "train"), jax_voc.VOCSegmentation(root, "train")
    decode_gap = 0
    for name in ds.names:
        path = os.path.join(ds.image_dir, name + ".jpg")
        want = tf.io.decode_image(tf.io.read_file(path), channels=3).numpy().astype(int)
        decode_gap = max(decode_gap, int(np.abs(tfdata.read_example(
            path, ds._label_path(name))[0].astype(int) - want).max()))
    assert decode_gap <= 8  # levels of 255
    bound = decode_gap / 255.0 / float(IMAGENET_STD.min()) + IMAGE_ATOL
    ours, ref = list(tfdata.TFDataLoader(ds, cfg)), list(JaxTFDataLoader(jax_ds, jcfg))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["label"], b["label"])
        assert np.abs(a["image"] - b["image"]).max() <= bound


def test_palette_labels_read_as_indices(tf, lossless, tmp_path):
    """A palette PNG (as real VOC's SegmentationClass): the port reads its
    indices, zs3_tpu's decode_png(channels=1) its luminance."""
    from zs3_tpu.data.tfdata import TFDataLoader as JaxTFDataLoader

    root = str(tmp_path)
    shutil.copytree(os.path.join(lossless, "VOC2012"), os.path.join(root, "VOC2012"))
    label_dir = os.path.join(root, "VOC2012", "SegmentationClass")
    palette = np.zeros((256, 3), np.uint8)
    palette[15], palette[255] = (192, 128, 128), (224, 224, 192)  # VOC's person, border
    for name in os.listdir(label_dir):
        with Image.open(os.path.join(label_dir, name)) as lbl:
            idx = np.where(np.asarray(lbl) == 0, 0, 15).astype(np.uint8)
        idx[:3] = 255
        img = Image.fromarray(idx, mode="P")
        img.putpalette(palette.ravel().tolist())
        img.save(os.path.join(label_dir, name))
    cfg, jcfg = _cfgs(root, "pascal")
    ours = list(tfdata.TFDataLoader(voc.VOCSegmentation(root, "train"), cfg))
    ref = list(JaxTFDataLoader(jax_voc.VOCSegmentation(root, "train"), jcfg))
    got = np.concatenate([b["label"] for b in ours])
    luminance = np.concatenate([b["label"] for b in ref])
    assert set(np.unique(got)) == {0, 15, 255}
    assert (got == 15).any() and not (luminance[got == 15] == 15).any()
    np.testing.assert_array_equal(luminance[got == 0], 0)


def test_workers_and_shards_give_the_same_bytes(lossless):
    """num_workers 0 against 2 (spawned processes, kept across epochs
    until close()), two epochs; the rows of two shards concatenate to the
    one-rank batch."""
    cfg, _ = _cfgs(lossless, "pascal")
    ds = voc.VOCSegmentation(lossless, "train")
    inline = tfdata.TFDataLoader(ds, cfg)
    workers = tfdata.TFDataLoader(ds, dataclasses.replace(cfg, num_workers=2))
    shards = [tfdata.TFDataLoader(ds, cfg, shard=(rank, 2)) for rank in range(2)]
    for epoch in (0, 1):
        for loader in (inline, workers, *shards):
            loader.set_epoch(epoch)
        want = list(inline)
        assert len(want) == len(inline) == 3
        for a, b in zip(want, workers, strict=True):
            for key in a:
                assert a[key].tobytes() == b[key].tobytes()
        for a, b, c in zip(want, *shards, strict=True):
            for key in a:
                np.testing.assert_array_equal(np.concatenate([b[key], c[key]]), a[key])
    processes = workers._stream.loader._iterator._workers  # kept across the epochs
    assert len(processes) == 2 and all(p.is_alive() for p in processes)
    workers.close()
    assert not any(p.is_alive() for p in processes)
    with pytest.raises(ValueError, match="divisible"):
        tfdata.TFDataLoader(ds, cfg, shard=(0, 3))


def test_a_worker_error_reaches_the_consumer(lossless, tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(lossless, "VOC2012"), os.path.join(root, "VOC2012"))
    cfg, _ = _cfgs(root, "pascal", num_workers=1)
    loader = tfdata.TFDataLoader(voc.VOCSegmentation(root, "train"), cfg)
    for name in os.listdir(os.path.join(root, "VOC2012", "SegmentationClass")):
        os.remove(os.path.join(root, "VOC2012", "SegmentationClass", name))
    with pytest.raises(FileNotFoundError):
        next(iter(loader))


def test_factory_follows_zs3_tpu(tf, lossless, tmp_path):
    """pascal and context take the TFDataLoader; synthetic falls through
    to the python loader (zs3_tpu/data/loader.py:234); device_preprocess
    is refused by both; use_sbd is refused by the port, and zs3_tpu's
    stream fails on it (CombineDBs names no image files)."""
    for dataset in ("pascal", "context"):
        loader, n = make_train_loader(_cfgs(lossless, dataset)[0])
        assert isinstance(loader, tfdata.TFDataLoader) and n == (21 if dataset == "pascal"
                                                                else 59)
    cfg, jcfg = _cfgs(lossless, "synthetic", synthetic_items=8)
    train, _, n = make_data_loader(cfg)
    jax_train, _, jax_n = jax_make_data_loader(jcfg)
    assert isinstance(train, DataLoader) and n == jax_n == 21
    _, jax_val, _ = jax_make_data_loader(_cfgs(lossless, "pascal")[1])
    assert type(make_data_loader(_cfgs(lossless, "pascal")[0])[1]) is DataLoader
    assert type(jax_val).__name__ == "DataLoader"  # the val loader stays python in both
    for a, b in zip(train, jax_train):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    for make, c in ((make_data_loader, cfg), (jax_make_data_loader, jcfg)):
        refused = dataclasses.replace(c, dataset="pascal", device_preprocess=True)
        with pytest.raises(ValueError, match="device_preprocess"):
            make(refused)
    root = str(tmp_path)
    fabricate.fabricate_voc_tree(root, 4, 2, sizes=SIZES)
    fabricate.fabricate_sbd_tree(root, 4, sizes=SIZES)
    cfg, jcfg = _cfgs(root, "pascal", use_sbd=True)
    with pytest.raises(ValueError, match="use_sbd"):
        make_data_loader(cfg)
    jax_train, _, _ = jax_make_data_loader(jcfg)
    with pytest.raises(AttributeError, match="image_dir"):
        next(iter(jax_train))


def test_seen_trainer_first_step_matches_zs3_tpu(tf, tmp_path):
    """SeenTrainer on input_pipeline="tfdata" (R50, 65², f32, no dropout)
    on a lossless VOC tree, from zs3_tpu's initial weights carried across
    by utils/convert.py: the same first batch, the first loss within
    LOSS_RTOL of zs3_tpu's SeenTrainer."""
    from zs3_tpu.train.seen import SeenTrainer as JaxSeenTrainer
    from zs3_tpu_torch.train.seen import SeenTrainer

    root = str(tmp_path / "data")
    fabricate.fabricate_voc_tree(root, 4, 2, unseen_every=99, sizes=((60, 80), (80, 60)))
    _as_png_bytes(os.path.join(root, "VOC2012", "JPEGImages"))
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="resnet50", num_classes=21, compute_dtype="float32",
                             dropout=False),
        data=JaxDataConfig(dataset="pascal", root=root, crop_size=65, base_size=65,
                           batch_size=2, eval_batch_size=2, input_pipeline="tfdata",
                           num_workers=0),
        optim=JaxOptimConfig(lr=1e-3),
        train=JaxTrainConfig(epochs=1, steps_per_epoch=1, checkpoint_dir=str(tmp_path / "j"),
                             mesh_axes=(("data", 1),)),
    )
    jax_trainer = JaxSeenTrainer(jcfg)
    cfg = Config.from_json(jcfg.to_json())
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp_path / "p")))
    trainer = SeenTrainer(cfg, device="cpu")
    assert isinstance(trainer.train_loader, tfdata.TFDataLoader)
    variables = jax.device_get({"params": jax_trainer.state.params,
                                "batch_stats": jax_trainer.state.batch_stats})
    trainer.model.load_state_dict(state_dict_from_flax(variables))
    batch, jax_batch = next(iter(trainer.train_loader)), next(iter(jax_trainer.train_loader))
    for key in batch:
        np.testing.assert_array_equal(batch[key], jax_batch[key])
    want = jax_trainer.train_epoch(0)["train_loss"]
    got = trainer.train_epoch(0)["train_loss"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.fixture()
def default_build_dir():
    yield
    cuda_build.set_build_dir(None)


def test_compilation_cache_on_every_subcommand(tmp_path, monkeypatch, default_build_dir):
    """Every subcommand takes --compilation-cache DIR (default
    $ZS3_COMPILATION_CACHE); a command makes DIR its kernels' build
    directory (nothing is compiled: no nvcc here), one without the flag
    takes build/kernels back, and a DIR that cannot be made raises."""
    parser = cli.make_parser()
    commands = parser._subparsers._group_actions[0].choices
    assert len(commands) == 13
    for name, sub in commands.items():
        assert any("--compilation-cache" in a.option_strings for a in sub._actions), name
    cache = tmp_path / "kernels"
    monkeypatch.setenv("ZS3_COMPILATION_CACHE", str(cache))
    assert cli.make_parser().parse_args(["show-config"]).compilation_cache == str(cache)
    build_dir = lambda: cuda_build.library_path("upsample_argmax").parent
    cli.run(["show-config"])
    assert build_dir() == cache.resolve() and cache.is_dir()
    assert list(cache.iterdir()) == []
    monkeypatch.delenv("ZS3_COMPILATION_CACHE")
    other = tmp_path / "other"
    cli.run(["show-config", "--compilation-cache", str(other)])
    assert build_dir() == other.resolve()
    cli.run(["show-config"])
    assert build_dir() == cuda_build.BUILD_DIR
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError):
        cli.run(["show-config", "--compilation-cache", str(tmp_path / "file" / "kernels")])
    assert build_dir() == cuda_build.BUILD_DIR
