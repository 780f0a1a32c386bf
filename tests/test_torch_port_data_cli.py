"""The port's commands on fabricated VOC2012+SBD and Pascal-Context trees,
on the CPU at a tiny size (ResNet-50, 33x33, f32, batch 4): every
command of the slice runs through `--data-root`, with
`device_preprocess` on where a JSON config asks for it, and none falls
to a refusal.

* `pascal` (without SBD): `train-seen` with device_preprocess,
  `train-gmmn` from a built VOC registry, `evaluate-gmmn` (`evaluate`
  runs in tests/test_torch_port_data_prep.py's slice test);
* `pascal --use-sbd`: `train-seen`, then `train-zs5` (pseudo-labels
  through the VOC reader's weak-label hook, the SBD images as they are);
* `context` at `--unseen-split 4`: `train-seen` (a 59-class trunk), then
  `train-zs5` and `train-gmmn --graph-context` with device_preprocess.
"""

import json
import os

import numpy as np
import pytest

from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import context_unseen_split, voc_unseen_split
from zs3_tpu_torch.data import fabricate
from zs3_tpu_torch.data.classes import CONTEXT_CLASSES, VOC_CLASSES
from zs3_tpu_torch.train.self_training import WeakLabelDataset
from zs3_tpu_torch.utils.saver import Saver
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

SIZES = ((60, 80), (80, 60), (70, 80), (50, 80))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    root = str(d / "root")
    fabricate.fabricate_voc_tree(root, 9, 4, unseen_classes=voc_unseen_split(10), sizes=SIZES)
    fabricate.fabricate_sbd_tree(root, 4, unseen_classes=voc_unseen_split(10), sizes=SIZES)
    fabricate.fabricate_context_tree(root, 9, 4, unseen_classes=context_unseen_split(4),
                                     sizes=SIZES)
    vectors = fabricate.fabricate_word_vectors(str(d / "w2v.bin"), VOC_CLASSES + CONTEXT_CLASSES)
    configs = {}
    for name, preprocess in (("host", False), ("device", True)):
        configs[name] = str(d / f"{name}.json")
        with open(configs[name], "w") as f:
            json.dump({"data": {"device_preprocess": preprocess, "num_workers": 1}}, f)
    return {"root": root, "vectors": vectors, "dir": d, **configs}


def _tiny(data, tmp_path, dataset, split, config="host"):
    return ["--dataset", dataset, "--data-root", data["root"], "--unseen-split", str(split),
            "--backbone", "resnet50", "--crop-size", "33", "--base-size", "33",
            "--compute-dtype", "float32", "--batch-size", "4", "--eval-batch-size", "4",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path), "--config", data[config]]


def _finite(result):
    return all(np.isfinite(v) for k, v in result.items() if k != "epoch")


def _embeddings(data, dataset):
    path = str(data["dir"] / f"{dataset}.npy")
    report, _ = cli.run(["build-embeddings", data["vectors"], "--output", path,
                         "--dataset", dataset])
    assert report["dim"] == 300
    return ["--embedding-path", path, "--pixels-per-class", "16"]


def _seen(data, tmp_path, args):
    result, trainer = cli.run(["train-seen", *args, "--epochs", "1", "--steps-per-epoch", "1"])
    assert _finite(result) and trainer.step == 1
    return trainer, Saver.latest_checkpoint(trainer.saver.directory)


def test_pascal_chain(data, tmp_path):
    args = _tiny(data, tmp_path, "pascal", 10, "device")
    seen, ckpt = _seen(data, tmp_path, args)
    assert seen.cfg.data.device_preprocess
    assert next(iter(seen.train_loader))["image"].dtype == np.uint8
    assert seen.num_classes == 21 and len(seen.val_loader.dataset) == 4
    emb = _embeddings(data, "pascal")
    result, gm = cli.run(["train-gmmn", *args, *emb, "--resume", ckpt, "--epochs", "1",
                          "--steps-per-epoch", "1"])
    assert _finite(result) and result["mmd"] > 0 and gm.step.device_preprocess
    gmmn_ckpt = Saver.latest_checkpoint(gm.saver.directory)
    result, again = cli.run(["evaluate-gmmn", *_tiny(data, tmp_path, "pascal", 10), *emb,
                             "--resume", ckpt, "--gmmn-resume", gmmn_ckpt])
    assert _finite(result) and again.global_step == 1
    assert {"seen_miou", "unseen_miou", "harmonic_miou"} <= result.keys()


def test_pascal_sbd_zs5(data, tmp_path):
    args = [*_tiny(data, tmp_path, "pascal", 10), "--use-sbd"]
    seen, ckpt = _seen(data, tmp_path, args)
    assert len(seen.train_loader.dataset) == 6 + 4  # VOC less its unseen images, and SBD
    result, zs5 = cli.run(["train-zs5", *args, *_embeddings(data, "pascal"), "--resume", ckpt,
                           "--epochs", "1", "--steps-per-epoch", "1"])
    assert _finite(result) and zs5.cfg.gmmn.self_training
    assert not isinstance(zs5.train_loader.dataset, WeakLabelDataset)  # the readers' hook
    written = sorted(os.listdir(zs5.pseudo_dir))
    assert written == [f"2008_0{i:05d}.png" for i in (0, 3, 6)]  # the tagged VOC images
    assert len(zs5.train_loader.dataset) == 9 + 4  # ZS5 keeps them


def test_context_chain(data, tmp_path):
    args = _tiny(data, tmp_path, "context", 4)
    seen, ckpt = _seen(data, tmp_path, args)
    assert seen.num_classes == 59 and seen.model.classifier.weight.shape[0] == 59
    emb = _embeddings(data, "context")
    result, zs5 = cli.run(["train-zs5", *args, *emb, "--resume", ckpt, "--epochs", "1",
                           "--steps-per-epoch", "1"])
    assert _finite(result) and len(os.listdir(zs5.pseudo_dir)) == 3
    result, graph = cli.run(["train-gmmn", *_tiny(data, tmp_path, "context", 4, "device"), *emb,
                             "--graph-context", "--resume", ckpt, "--epochs", "1",
                             "--steps-per-epoch", "1"])
    assert _finite(result) and graph.step.graph_context and graph.step.device_preprocess
    assert graph.embeddings.shape == (59, 300)
