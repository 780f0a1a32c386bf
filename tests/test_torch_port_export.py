"""`export` and its artifact (zs3_tpu_torch.export) against zs3_tpu's
(tests/test_export.py), on the CPU.

The weights are zs3_tpu's seeded init of a ResNet-50 DeepLab (4 classes,
33x33, f32), carried into a port checkpoint by `state_dict_from_flax`:
zs3_tpu's `export_predictor(allow_random=True)` exports the same init.
Labels of the port's artifact must equal zs3_tpu's artifact's and the
port's Predictor's; logits within 1e-5 of the largest.  The artifact
loads through torch.export alone, in a process that never imports the
port; an export as a process's first forward leaves the later eager
forwards of that process as they are in a process that never exported.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.core.config import TrainConfig as JaxTrainConfig
from zs3_tpu.export import export_predictor as jax_export_predictor
from zs3_tpu.export import load_exported as jax_load_exported
from zs3_tpu.export import save_exported as jax_save_exported
from zs3_tpu.models.deeplab import build_deeplab as jax_build_deeplab
from zs3_tpu.train.state import create_seg_state
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.export import export_predictor, load_exported, save_exported
from zs3_tpu_torch.train.predict import Predictor
from zs3_tpu_torch.utils.convert import state_dict_from_flax

from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 4
CPU_ARGS = ["--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
            "--backbone", "resnet50", "--compute-dtype", "float32", "--device", "cpu"]


def _jax_cfg(tmp):
    return JaxConfig(
        model=JaxModelConfig(backbone="resnet50", num_classes=NUM_CLASSES,
                             compute_dtype="float32", dropout=False),
        data=JaxDataConfig(dataset="synthetic", crop_size=33, base_size=33, batch_size=2,
                           eval_batch_size=2),
        train=JaxTrainConfig(checkpoint_dir=str(tmp / "run")),
    )


def _images(seed, n=2):
    return np.random.default_rng(seed).integers(0, 255, (n, 33, 33, 3), dtype=np.uint8)


@pytest.fixture(autouse=True)
def _drop_artifacts(tmp_path):
    """Artifacts are some 160 MB each: none outlives its test."""
    yield
    for path in tmp_path.glob("*.pt*"):
        path.unlink()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(port config, port checkpoint of zs3_tpu's seeded init, zs3_tpu's
    exported labels artifact path and manifest, test images); the
    directory goes with the module."""
    tmp = tmp_path_factory.mktemp("export")
    yield _weights(tmp)
    shutil.rmtree(tmp, ignore_errors=True)


def _weights(tmp):
    jcfg = _jax_cfg(tmp)
    state = create_seg_state(jax_build_deeplab(jcfg.model), jcfg, jax.random.key(jcfg.train.seed),
                             (1, 33, 33, 3), total_steps=1)
    ckpt = str(tmp / "seen.pt")
    torch.save({"model": state_dict_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats})}, ckpt)
    blob, manifest = jax_export_predictor(jcfg, batch_size=2, allow_random=True)
    jax_path = str(tmp / "ref.shlo")
    jax_save_exported(jax_path, blob, manifest)
    cfg = Config.from_json(jcfg.to_json())
    return {"cfg": cfg, "ckpt": ckpt, "jax_path": jax_path, "jax_manifest": manifest,
            "images": _images(0), "tmp": tmp}


@pytest.fixture(scope="module")
def cli_artifact(weights):
    out = str(weights["tmp"] / "labels.pt2")
    result, program = cli.run(["export", "--output", out, "--resume", weights["ckpt"],
                               "--export-batch", "2", "--checkpoint-dir",
                               str(weights["tmp"] / "run"), *CPU_ARGS,
                               "--config", _write_cfg(weights)])
    return out, result, program


def _write_cfg(weights):
    path = weights["tmp"] / "cfg.json"
    path.write_text(weights["cfg"].to_json())
    return str(path)


def test_cli_export_matches_zs3_tpu_artifact_and_predictor(weights, cli_artifact):
    """`cli export --resume`: the artifact and its manifest are written,
    the manifest is zs3_tpu's, and the labels equal zs3_tpu's artifact's
    and the port's Predictor's on the same weights."""
    path, result, _ = cli_artifact
    assert result["artifact"] == path and result["bytes"] == os.path.getsize(path)
    with open(path + ".json") as f:
        manifest = json.load(f)
    assert manifest == weights["jax_manifest"] == {
        k: v for k, v in result.items() if k not in ("artifact", "bytes")}
    assert manifest["platforms"] == ["cpu"] and manifest["emit"] == "labels"
    images = weights["images"]
    got = load_exported(path)(images)
    assert got.dtype == np.int32 and got.shape == (2, 33, 33)
    want = np.asarray(jax_load_exported(weights["jax_path"])(images))
    np.testing.assert_array_equal(got, want)
    predictor = Predictor(weights["cfg"], checkpoint=weights["ckpt"], device="cpu")
    np.testing.assert_array_equal(got, predictor._predict(images))
    # A tensor in gives a tensor out, on the artifact's device.
    out = load_exported(path, device="cpu")(torch.from_numpy(images))
    assert isinstance(out, torch.Tensor) and torch.equal(out, torch.from_numpy(got))


_LOAD_ALONE = """
import sys, numpy as np, torch
module = torch.export.load(sys.argv[1]).module()
with torch.no_grad():
    out = module(torch.from_numpy(np.load(sys.argv[2])))
assert not [m for m in sys.modules if m.split(".")[0] in ("zs3_tpu_torch", "zs3_tpu", "jax")]
np.save(sys.argv[3], out.numpy())
"""


def test_artifact_loads_without_the_port(weights, cli_artifact, tmp_path):
    """torch.export.load(path).module() alone runs the artifact, in a
    process that imports neither the port nor zs3_tpu."""
    path = cli_artifact[0]
    np.save(tmp_path / "x.npy", weights["images"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", _LOAD_ALONE, path, str(tmp_path / "x.npy"),
                    str(tmp_path / "y.npy")], cwd=str(tmp_path), env=env, check=True,
                   timeout=600)
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"),
                                  load_exported(path)(weights["images"]))


def test_export_logits_emit(weights, tmp_path):
    program, manifest = export_predictor(weights["cfg"], checkpoint=weights["ckpt"],
                                         batch_size=1, emit="logits", device="cpu")
    path = str(tmp_path / "logits.pt2")
    save_exported(path, program, manifest)
    images = weights["images"][:1]
    out = load_exported(path)(images)
    assert out.shape == (1, 33, 33, NUM_CLASSES) and out.dtype == np.float32
    want = Predictor(weights["cfg"], checkpoint=weights["ckpt"], device="cpu")._logits(images)
    np.testing.assert_allclose(out, want.numpy(), atol=1e-5 * np.abs(want.numpy()).max())
    assert manifest["output"] == f"float32[1,33,33,{NUM_CLASSES}] logits"


def _gmmn_checkpoint(path, kernel, bias):
    """The {"gen", "cls", ...} payload GMMNTrainer.checkpoint_payload writes."""
    torch.save({"gen": {"hidden0.weight": torch.zeros(4, 4)},
                "cls": {"kernel": torch.from_numpy(kernel), "bias": torch.from_numpy(bias)},
                "gen_opt": {}, "cls_opt": {}, "step": 1}, path)


def test_export_splices_gmmn_classifier(weights, tmp_path):
    """export --resume <seen> --gmmn-resume <gmmn checkpoint> serves the
    retrained classifier: one whose bias favours class 2 labels every
    pixel 2."""
    gmmn = str(tmp_path / "gmmn.pt")
    _gmmn_checkpoint(gmmn, np.zeros((256, NUM_CLASSES), np.float32),
                     np.array([0.0, 0.0, 100.0, 0.0], np.float32))
    program, manifest = export_predictor(weights["cfg"], checkpoint=weights["ckpt"],
                                         gmmn_checkpoint=gmmn, batch_size=1, device="cpu")
    assert manifest["zero_shot_classifier"] is True
    path = str(tmp_path / "zs.pt2")
    save_exported(path, program, manifest)
    np.testing.assert_array_equal(load_exported(path)(np.zeros((1, 33, 33, 3), np.uint8)), 2)


def test_export_refusals(weights, tmp_path):
    """zs3_tpu's refusals (bad emit, no checkpoint, a GMMN-stage checkpoint
    as the trunk and a trunk checkpoint as the GMMN one), a classifier of
    another class count, and the port's own: the fused tail, two
    platforms, an unknown platform, --int8 without --calib-images."""
    cfg, ckpt = weights["cfg"], weights["ckpt"]
    with pytest.raises(ValueError, match="emit"):
        export_predictor(cfg, emit="probabilities", allow_random=True, device="cpu")
    with pytest.raises(ValueError, match="randomly"):
        export_predictor(cfg, device="cpu")
    gmmn = str(tmp_path / "gmmn.pt")
    _gmmn_checkpoint(gmmn, np.zeros((256, NUM_CLASSES), np.float32),
                     np.zeros(NUM_CLASSES, np.float32))
    with pytest.raises(ValueError, match="gmmn-resume"):
        export_predictor(cfg, checkpoint=gmmn, device="cpu")
    with pytest.raises(ValueError, match="not a GMMN-stage"):
        export_predictor(cfg, checkpoint=ckpt, gmmn_checkpoint=ckpt, device="cpu")
    wide = str(tmp_path / "gmmn7.pt")
    _gmmn_checkpoint(wide, np.zeros((256, 7), np.float32), np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="7 classes"):
        export_predictor(cfg, checkpoint=ckpt, gmmn_checkpoint=wide, device="cpu")
    fused = cfg.replace(model=dataclasses.replace(cfg.model, fused_tail=True))
    with pytest.raises(ValueError, match="fused-tail"):
        export_predictor(fused, checkpoint=ckpt, device="cpu")
    with pytest.raises(ValueError, match="one\\s+device"):
        export_predictor(cfg, checkpoint=ckpt, platforms=["cuda", "cpu"], device="cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        export_predictor(cfg, checkpoint=ckpt, platforms=["tpu"], device="cpu")
    with pytest.raises(SystemExit, match="--calib-images"):
        cli.run(["export", "--output", str(tmp_path / "x.pt2"), "--int8", "--allow-random",
                 *CPU_ARGS])
    with pytest.raises(ValueError, match="fused-tail"):
        cli.run(["export", "--output", str(tmp_path / "x.pt2"), "--allow-random",
                 "--fused-tail", *CPU_ARGS])
    assert not os.path.exists(tmp_path / "x.pt2")


def test_int8_artifact_equals_eager_int8(weights, tmp_path):
    """export --int8: calibrated on the letterboxed images as
    Predictor.quantize calibrates (one batch of up to 8 canvases), the
    artifact's labels are the eager int8 Predictor's."""
    rng = np.random.default_rng(3)
    calib = [rng.integers(0, 255, hw + (3,), dtype=np.uint8) for hw in [(40, 50), (33, 33),
                                                                       (20, 45)]]
    program, manifest = export_predictor(weights["cfg"], checkpoint=weights["ckpt"],
                                         batch_size=2, int8_calib_images=calib, device="cpu")
    assert manifest["int8"] is True
    path = str(tmp_path / "int8.pt2")
    save_exported(path, program, manifest)
    got = load_exported(path)(weights["images"])
    predictor = Predictor(weights["cfg"], checkpoint=weights["ckpt"], device="cpu")
    assert predictor.quantize(calib) == 61
    np.testing.assert_array_equal(got, predictor._predict(weights["images"]))


_FRESH = """
import json, sys, numpy as np, torch
torch.set_num_threads(1)
from zs3_tpu_torch.export import make_inference_fn
from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
from zs3_tpu_torch.ops import resize
from zs3_tpu_torch.data import transforms
export_first = sys.argv[1] == "1"
out = {}
for name, backbone, dtype in (("r50", "resnet50", torch.float32),
                              ("mobilenet_bf16", "mobilenet", torch.bfloat16)):
    kw = {"layers": (2, 2, 2, 2)} if backbone == "resnet50" else {}
    model = init_deeplab(DeepLab(backbone=backbone, num_classes=4, dropout=False, dtype=dtype,
                                 **kw), 0).to(memory_format=torch.channels_last).eval()
    infer = make_inference_fn(model, "logits")
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 255, (2, 33, 33, 3),
                                                           dtype=np.uint8))
    with torch.no_grad():
        if export_first:
            program = torch.export.export(infer, (x,))
            # A traced call caches nothing.
            assert resize._linear_matrix.cache_info().currsize == 0
            assert transforms._mean_std.cache_info().currsize == 0
            out[name + "_artifact"] = program.module()(x).float().numpy().tolist()
        eager = infer(x)
        eager2 = infer(x)
    assert torch.equal(eager, eager2)
    out[name] = eager.float().numpy().tolist()
    resize._linear_matrix.cache_clear()
    transforms._mean_std.cache_clear()
print(json.dumps(out))
"""


def test_export_before_any_eager_forward_leaves_eager_forwards_right():
    """The device-tensor caches (ops/resize.py, data/transforms.py) build
    nothing into the cache under a trace: a fresh process whose first
    forward is torch.export's then runs eager forwards equal to those of a
    process that never exported, and the artifact equals both (f32 ResNet
    and bf16 MobileNetV2, whose export failed outright on a cached fake
    tensor)."""
    def run(export_first):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, "-c", _FRESH, "1" if export_first else "0"],
                              cwd=REPO, env=env, capture_output=True, text=True, check=True,
                              timeout=600)
        return json.loads(proc.stdout.strip().splitlines()[-1])

    exported, plain = run(True), run(False)
    for name in ("r50", "mobilenet_bf16"):
        np.testing.assert_array_equal(np.asarray(exported[name]), np.asarray(plain[name]))
        np.testing.assert_array_equal(np.asarray(exported[name + "_artifact"]),
                                      np.asarray(plain[name]))


def test_export_cli_int8_and_gmmn_flags_reach_export(weights, tmp_path):
    """`cli export --int8 --calib-images` and `--gmmn-resume` go through
    export_predictor: the manifest says so."""
    paths = []
    for i, hw in enumerate([(40, 50), (33, 33)]):
        paths.append(str(tmp_path / f"c{i}.png"))
        Image.fromarray(np.random.default_rng(i).integers(0, 255, hw + (3,),
                                                          dtype=np.uint8)).save(paths[-1])
    gmmn = str(tmp_path / "gmmn.pt")
    _gmmn_checkpoint(gmmn, np.zeros((256, NUM_CLASSES), np.float32),
                     np.array([0.0, 100.0, 0.0, 0.0], np.float32))
    out = str(tmp_path / "q.pt2")
    result, _ = cli.run(["export", "--output", out, "--resume", weights["ckpt"],
                         "--gmmn-resume", gmmn, "--int8", "--calib-images", *paths,
                         "--int8-percentile", "99.9", "--config", _write_cfg(weights),
                         *CPU_ARGS])
    assert result["int8"] is True and result["zero_shot_classifier"] is True
    np.testing.assert_array_equal(load_exported(out)(np.zeros((1, 33, 33, 3), np.uint8)), 1)
