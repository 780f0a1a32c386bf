"""Port rules: zs3_tpu_torch imports no JAX and no zs3_tpu, refuses to fall
back to the CPU, and carries copies (config, classes, synthetic data,
eval transforms) that agree with zs3_tpu's originals."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import zs3_tpu.core.config as jax_config
import zs3_tpu.data.classes as jax_classes
from zs3_tpu.data.synthetic import SyntheticSegmentation as JaxSynthetic
from zs3_tpu.data.transforms import eval_transform as jax_eval_transform
from zs3_tpu_torch.core import config
from zs3_tpu_torch.data import classes
from zs3_tpu_torch.data.synthetic import SyntheticSegmentation
from zs3_tpu_torch.data.transforms import eval_transform
from zs3_tpu_torch.ops import eval_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import zs3_tpu_torch
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)
names = [m.name for m in pkgutil.walk_packages(zs3_tpu_torch.__path__, "zs3_tpu_torch.")
         if not m.name.endswith("__main__")]  # it runs the CLI
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "zs3_tpu",
                                    "tensorflow"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_zs3_tpu():
    # A generous clock: a loaded host imports in a minute or two, and a
    # hang fails this test instead of running the suite into its own limit.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, check=True, timeout=600,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("train.seen", "train.gmmn", "ops.mmd", "ops.mmd_kernels", "ops.sampling",
                 "models.gmmn", "data.embeddings", "cli", "ops.tail_kernels",
                 "train.predict", "serve", "metrics.tta", "utils.viz", "train.state",
                 "utils.saver", "utils.schedules", "utils.losses", "utils.logging",
                 "ops.bottleneck", "ops.bottleneck_kernels", "data.voc", "data.sbd",
                 "data.context", "data.fabricate", "data.context_prepare",
                 "data.embedding_build", "data.loader", "data.transforms",
                 "models.xception", "models.mobilenet", "models.drn", "utils.convert",
                 "utils.profiling", "export", "core.mesh", "parallel", "parallel.spatial",
                 "release_rehearsal", "data.tfdata"):
        assert f"zs3_tpu_torch.{name}" in result["modules"]
    assert result["bad"] == []


@pytest.fixture()
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")


def _tiny_cfg():
    return config.Config(
        model=config.ModelConfig(backbone="resnet50", compute_dtype="float32"),
        data=config.DataConfig(dataset="synthetic", crop_size=33, base_size=33),
    )


def test_entry_points_default_to_the_gpu(no_gpu):
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data.loader import make_val_loader
    from zs3_tpu_torch.serve import InferenceServer, SegmentationService
    from zs3_tpu_torch.train.predict import Predictor
    from zs3_tpu_torch.train.seen import SeenTrainer, build_eval_model, evaluate, validate

    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        build_eval_model(cfg)
    loader, n = make_val_loader(cfg.data)
    model = build_eval_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        validate(model, loader, n, cfg.data)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["evaluate", "--dataset", "synthetic", "--crop-size", "33"])
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        SegmentationService(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceServer(cfg, port=0)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["infer", "image.png", "--crop-size", "33"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["serve", "--crop-size", "33", "--port", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        SeenTrainer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train-seen", "--dataset", "synthetic", "--crop-size", "33"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["evaluate-gmmn", "--dataset", "synthetic", "--crop-size", "33"])


def test_kernel_never_stands_in_for_the_plain_version_on_cpu(rng):
    logits = torch.from_numpy(rng.standard_normal((2, 5, 5, 3)).astype(np.float32))
    before = eval_kernels.upsample_argmax.launches
    with pytest.raises(ValueError, match="CUDA"):
        eval_kernels.upsample_argmax(logits, (17, 17))
    labels = eval_kernels.predict_labels(logits, (17, 17))
    np.testing.assert_array_equal(
        labels.numpy(), eval_kernels.upsample_argmax_reference(logits, (17, 17)).numpy()
    )
    assert eval_kernels.upsample_argmax.launches == before == 0


def test_config_reads_the_jax_json():
    ref = jax_config.Config().replace(
        data=dataclasses.replace(
            jax_config.Config().data, dataset="synthetic",
            unseen_classes=jax_config.voc_unseen_split(4),
        )
    )
    port = config.Config.from_json(ref.to_json())
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    assert port.data.unseen_classes == (10, 14, 1, 18)
    for k in (2, 4, 6, 8, 10):
        assert config.voc_unseen_split(k) == jax_config.voc_unseen_split(k)
        assert config.context_unseen_split(k) == jax_config.context_unseen_split(k)
    assert classes.VOC_CLASSES == jax_classes.VOC_CLASSES
    assert classes.CONTEXT_CLASSES == jax_classes.CONTEXT_CLASSES
    assert classes.seen_classes(21, (10, 14)) == jax_classes.seen_classes(21, (10, 14))


def test_fused_tail_builds_and_never_launches_k4_on_cpu(rng):
    from zs3_tpu_torch.models.deeplab import build_deeplab
    from zs3_tpu_torch.ops import tail_kernels

    model = build_deeplab(config.ModelConfig(
        backbone="resnet50", num_classes=4, compute_dtype="float32", fused_tail=True,
        dropout=False,
    )).eval()
    assert model.fused_tail
    x = torch.from_numpy(rng.standard_normal((1, 33, 33, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((1, 9, 9, 8)).astype(np.float32))
    w, b = torch.ones((8, 4)), torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        tail_kernels.classify_resize(feats, w, b, (33, 33))
    with torch.no_grad():
        out = model(x)
    np.testing.assert_array_equal(
        tail_kernels.tail_logits(feats, w, b, (33, 33)).numpy(),
        tail_kernels.classify_resize_reference(feats, w, b, (33, 33)).numpy(),
    )
    assert out.shape == (1, 33, 33, 4) and out.dtype == torch.float32
    assert tail_kernels.classify_resize.launches == 0


@pytest.mark.parametrize("crop", [65, 48])
def test_synthetic_data_and_eval_transform_match(crop):
    ours = SyntheticSegmentation(4, (65, 65), seed=2)
    ref = JaxSynthetic(4, (65, 65), seed=2)
    np.testing.assert_array_equal(ours.tints, ref.tints)
    for idx in range(len(ref)):
        a, b = ours[idx], ref[idx]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
        ta, tb = eval_transform(a, crop), jax_eval_transform(b, crop)
        np.testing.assert_array_equal(ta["image"], tb["image"])
        np.testing.assert_array_equal(ta["label"], tb["label"])
        assert ta["image"].dtype == np.float32 and ta["label"].dtype == np.int32
