"""`prepare-context` and `build-embeddings` in the port against zs3_tpu's,
and the evaluate slice on a fabricated VOC tree.

* the RLE codec and `rle_to_mask` equal zs3_tpu's;
* `prepare_context` on a detail-API JSON fabricated from a Context tree
  (all 59 classes and a rare one) and on a hand-made one (2 of the 59:
  the drift warning) writes zs3_tpu's label PNGs and split lists byte
  for byte, with zs3_tpu's stats, and the first gives the tree's labels
  back;
* the word2vec binary/text and GloVe readers and
  `build_embedding_registry` write zs3_tpu's registry for VOC's 21 and
  Context's 59 names;
* both CLI subcommands print what zs3_tpu's print and write its files;
* `evaluate --dataset pascal` on a fabricated VOC tree, ResNet-50 at
  65x65 in f32 on the CPU with the port's seeded weights carried into
  zs3_tpu by convert_deeplab_state_dict: zs3_tpu's confusion matrix,
  except for at most 0.1% of pixels (near-ties of the argmax, as in
  tests/test_torch_port_slice.py), and its metrics within 1e-3.
"""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from zs3_tpu import cli as jax_cli
from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.data import context_prepare as jax_prep
from zs3_tpu.data import embedding_build as jax_build
from zs3_tpu.data.loader import make_data_loader as jax_make_data_loader
from zs3_tpu.metrics.evaluator import Evaluator as JaxEvaluator
from zs3_tpu.models.deeplab import build_deeplab as jax_build_deeplab
from zs3_tpu.train.seen import make_eval_step as jax_make_eval_step
from zs3_tpu.train.state import create_seg_state
from zs3_tpu.utils.torch_convert import convert_deeplab_state_dict
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import ModelConfig
from zs3_tpu_torch.data import context_prepare as prep
from zs3_tpu_torch.data import embedding_build as build
from zs3_tpu_torch.data import fabricate
from zs3_tpu_torch.data.classes import CONTEXT_CLASSES, VOC_CLASSES
from zs3_tpu_torch.models.deeplab import build_deeplab, init_deeplab
from zs3_tpu_torch.train.seen import device_batch, make_eval_step

from tests.test_context_prepare import _square_rle
from tests.test_torch_port_seen import _randomize_bn_stats
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

SIZES = ((60, 80), (80, 60), (70, 80), (50, 80))


def test_rle_codec_and_masks_match(rng):
    for _ in range(20):
        counts = rng.integers(0, 3000, int(rng.integers(1, 12))).tolist()
        text = prep.encode_rle_string(counts)
        assert text == jax_prep.encode_rle_string(counts)
        assert prep.decode_rle_string(text) == jax_prep.decode_rle_string(text) == counts
    for h, w in ((7, 9), (1, 5), (12, 4)):
        mask = rng.random((h, w)) < 0.4
        seg = fabricate._mask_rle(mask)
        np.testing.assert_array_equal(prep.rle_to_mask(seg, h, w), mask)
        np.testing.assert_array_equal(jax_prep.rle_to_mask(seg, h, w), mask)
    for bad in ({"counts": [2, 2], "size": [2, 3]}, [[0.0, 0.0, 4.0, 0.0, 4.0, 4.0]]):
        with pytest.raises(ValueError) as ours:
            prep.rle_to_mask(bad, 2, 3)
        with pytest.raises(ValueError) as ref:
            jax_prep.rle_to_mask(bad, 2, 3)
        assert str(ours.value) == str(ref.value)


def _hand_made_json(path):
    """tests/test_context_prepare.py's JSON: cow, sky, a rare class, an
    image without segments."""
    h, w = 10, 12
    seg_a, _ = _square_rle(h, w, 1, 4, 2, 6)
    seg_b, _ = _square_rle(h, w, 5, 9, 0, 12)
    seg_c, _ = _square_rle(h, w, 0, 1, 0, 2)
    images = [{"image_id": i, "file_name": f"2008_00000{i - 6}.jpg", "height": h, "width": w,
               "phase": phase} for i, phase in ((7, "train"), (8, "val"), (9, "train"))]
    data = {
        "images": images,
        "categories": [{"category_id": 100, "name": "cow"}, {"category_id": 200, "name": "sky"},
                       {"category_id": 300, "name": "ashtray"}],
        "annos_segmentation": [
            {"image_id": 7, "category_id": 100, "segmentation": seg_a},
            {"image_id": 7, "category_id": 300, "segmentation": seg_c},
            {"image_id": 8, "category_id": 200, "segmentation": seg_b},
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f)


def _tree_files(root):
    out = {}
    for top, _, names in os.walk(os.path.join(root, "VOC2010")):
        for n in names:
            path = os.path.join(top, n)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("source", ["fabricated tree", "hand-made"])
def test_prepare_context_matches(tmp_path, source):
    json_path = str(tmp_path / "trainval_merged.json")
    if source == "fabricated tree":
        tree = str(tmp_path / "tree")
        fabricate.fabricate_context_tree(tree, 5, 3, sizes=SIZES)
        fabricate.fabricate_context_detail_json(tree, json_path)
    else:
        _hand_made_json(json_path)
    outs = {}
    for name, fn in (("ours", prep.prepare_context), ("ref", jax_prep.prepare_context)):
        root = str(tmp_path / name)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            stats = fn(json_path, root)
        outs[name] = (stats, [str(w.message) for w in caught], _tree_files(root))
    assert outs["ours"] == outs["ref"]
    stats, caught, files = outs["ours"]
    if source == "hand-made":
        assert stats["unmatched_classes"] == 57 and "no category in the JSON" in caught[0]
        return
    assert stats == {"images": 8, "skipped": 0, "train": 5, "val": 3,
                     "matched_classes": 59, "unmatched_classes": 0} and not caught
    labels = "VOC2010/SegmentationClassContext"
    want = _tree_files(tree)
    assert sorted(k for k in files if k.startswith(labels)) == sorted(
        k for k in want if k.startswith(labels))
    from PIL import Image

    for rel in files:
        if rel.startswith(labels):  # the tree's labels back, pixel for pixel
            np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(tmp_path, "ours", rel))),
                                          np.asarray(Image.open(os.path.join(tree, rel))))
        else:
            assert files[rel] == want[rel], rel


@pytest.fixture(scope="module")
def vectors(tmp_path_factory):
    """word2vec binary and text files of every token VOC's and Context's
    names resolve through, 300 dims; and a headerless GloVe copy."""
    d = tmp_path_factory.mktemp("vectors")
    names = VOC_CLASSES + CONTEXT_CLASSES
    binary = fabricate.fabricate_word_vectors(str(d / "w2v.bin"), names)
    text = fabricate.fabricate_word_vectors(str(d / "w2v.vec"), names, binary=False)
    glove = str(d / "glove.txt")
    with open(text) as f, open(glove, "w") as g:
        g.writelines(f.readlines()[1:])
    return {"bin": binary, "vec": text, "glove": glove}


@pytest.mark.parametrize("kind", ["bin", "vec", "glove"])
def test_word_vector_readers_match(vectors, kind):
    vocab = ["cow", "airplane", "tv", "monitor", "nothere"]
    table, dim = build.read_word_vectors(vectors[kind], vocab)
    want, want_dim = jax_build.read_word_vectors(vectors[kind], vocab)
    assert dim == want_dim == 300 and table.keys() == want.keys() == set(vocab) - {"nothere"}
    for token in table:
        np.testing.assert_array_equal(table[token], want[token])
    if kind != "bin":
        binary, _ = build.read_word_vectors(vectors["bin"], vocab)
        for token in table:
            np.testing.assert_array_equal(table[token], binary[token])


@pytest.mark.parametrize("names,kind,normalize", [
    (VOC_CLASSES, "bin", True), (CONTEXT_CLASSES, "bin", True),
    (CONTEXT_CLASSES, "vec", False), (VOC_CLASSES, "glove", True),
])
def test_build_embedding_registry_matches(vectors, tmp_path, names, kind, normalize):
    ours, ref = str(tmp_path / "ours.npy"), str(tmp_path / "ref.npy")
    report = build.build_embedding_registry(names, [vectors[kind]], ours, normalize=normalize,
                                            aliases={"cow": "cow"})
    want = jax_build.build_embedding_registry(names, [vectors[kind]], ref, normalize=normalize,
                                              aliases={"cow": "cow"})
    assert {**report, "output": None} == {**want, "output": None}
    assert open(ours, "rb").read() == open(ref, "rb").read()
    assert report["classes"] == len(names) and report["dim"] == 300
    with pytest.raises(ValueError, match="no vector for classes"):
        build.build_embedding_registry(list(names) + ["unicorn"], [vectors[kind]], ours)


def test_cli_prepare_context_matches(tmp_path, capsys):
    json_path = str(tmp_path / "tv.json")
    _hand_made_json(json_path)
    out = {}
    for name, main in (("ours", cli.main), ("ref", jax_cli.main)):
        root = str(tmp_path / name)
        with pytest.warns(UserWarning, match="no category"):
            assert main(["prepare-context", json_path, "--data-root", root]) == 0
        # a second run keeps the PNGs unless --overwrite
        with pytest.warns(UserWarning):
            assert main(["prepare-context", json_path, "--data-root", root, "--overwrite"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        out[name] = ([json.loads(line) for line in lines[-2:]], _tree_files(root))
    assert out["ours"] == out["ref"]
    assert out["ours"][0][0]["images"] == 2


@pytest.mark.parametrize("dataset", ["pascal", "context"])
def test_cli_build_embeddings_matches(vectors, tmp_path, capsys, dataset):
    got = {}
    for name, main in (("ours", cli.main), ("ref", jax_cli.main)):
        path = str(tmp_path / f"{name}.npy")
        assert main(["build-embeddings", vectors["bin"], vectors["vec"], "--output", path,
                     "--dataset", dataset, "--no-normalize", "--alias",
                     "tvmonitor=monitor"]) == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        got[name] = ({**result, "output": None}, np.load(path))
    assert got["ours"][0] == got["ref"][0]
    np.testing.assert_array_equal(got["ours"][1], got["ref"][1])
    assert got["ours"][1].shape == (21 if dataset == "pascal" else 59, 600)
    with pytest.raises(SystemExit, match="NAME=TOKENS"):
        cli.main(["build-embeddings", vectors["bin"], "--output", str(tmp_path / "x.npy"),
                  "--alias", "tvmonitor"])


def test_evaluate_pascal_slice_matches(tmp_path):
    # One batch of 8 at 65x65: the shapes of tests/test_torch_port_slice.py,
    # so zs3_tpu's compiled eval step can come from the compilation cache.
    root = str(tmp_path / "data")
    fabricate.fabricate_voc_tree(root, n_train=2, n_val=8)
    model = build_deeplab(ModelConfig(backbone="resnet50", compute_dtype="float32"))
    _randomize_bn_stats(init_deeplab(model, 0), seed=5)
    weights = str(tmp_path / "port.pt")
    torch.save(model.state_dict(), weights)

    jcfg = JaxConfig.from_json(json.dumps({
        "model": {"backbone": "resnet50", "compute_dtype": "float32"},
        "data": {"dataset": "pascal", "root": root, "crop_size": 65, "base_size": 65,
                 "eval_batch_size": 8, "unseen_classes": [10, 14], "num_workers": 1},
    }))
    params, stats = convert_deeplab_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()
         if not k.endswith("num_batches_tracked")})
    state = create_seg_state(jax_build_deeplab(jcfg.model), jcfg, jax.random.key(0),
                             (1, 65, 65, 3), 1,
                             init_variables={"params": params, "batch_stats": stats})
    _, jax_val, n = jax_make_data_loader(jcfg.data)
    jax_step = jax_make_eval_step(n, 255)
    ref_eval = JaxEvaluator(n, 255, (10, 14))

    result, trainer = cli.run([
        "evaluate", "--dataset", "pascal", "--data-root", root, "--unseen-split", "2",
        "--resume", weights, "--backbone", "resnet50", "--crop-size", "65", "--base-size",
        "65", "--compute-dtype", "float32", "--eval-batch-size", "8", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "run"),
    ])
    assert trainer.num_classes == n == 21 and len(trainer.val_loader) == len(jax_val) == 1
    step = make_eval_step(n, 255)
    for batch, jbatch in zip(trainer.val_loader, jax_val):
        np.testing.assert_array_equal(batch["image"], jbatch["image"])
        ref = np.asarray(jax_step(state, jbatch)).astype(np.int64)
        got = step(trainer.model, device_batch(batch, "cpu")).numpy()
        ref_eval.add_confusion(ref)
        valid = int((batch["label"] != 255).sum())
        assert got.sum() == ref.sum() == valid
        moved = np.abs(got - ref).sum() // 2  # each moved pixel counts twice
        assert moved <= 0.001 * valid, f"{moved} of {valid} pixels differ"
    want = ref_eval.compute().as_dict()
    assert result.keys() == want.keys() and "harmonic_miou" in result
    for key in want:
        assert abs(result[key] - want[key]) <= 1e-3, key
