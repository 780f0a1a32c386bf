"""The serving path of the port against zs3_tpu on the CPU: letterbox
geometry, palettes, device-side normalization, the Predictor (single,
batched and sliding-window), the HTTP server with micro-batching, and
`cli infer`.

The Predictors run ResNet-50 at 33x33 in f32 on the same weights
(zs3_tpu's seeded init with randomized BN, carried by
`state_dict_from_flax`); labels must be equal, logits within 1e-4.
"""

import concurrent.futures
import dataclasses
import http.client
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.data import transforms as jax_transforms
from zs3_tpu.train.predict import Predictor as JaxPredictor
from zs3_tpu.utils import viz as jax_viz
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.data import transforms
from zs3_tpu_torch.ops import tail_kernels
from zs3_tpu_torch.serve import InferenceServer, SegmentationService
from zs3_tpu_torch.train.predict import Predictor, sliding_windows
from zs3_tpu_torch.utils import viz
from zs3_tpu_torch.utils.convert import state_dict_from_flax

from tests.test_torch_port_models import randomize_bn
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

CPU_ARGS = ["--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
            "--backbone", "resnet50", "--compute-dtype", "float32", "--device", "cpu"]


def _image(rng, h, w):
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("hw", [(40, 50), (375, 500), (500, 375), (33, 33), (7, 120)])
@pytest.mark.parametrize("size", [33, 513])
def test_letterbox_matches_zs3_tpu(hw, size, rng):
    img = _image(rng, *hw)
    canvas, content = transforms.letterbox_image(img, size)
    want_canvas, want_content = jax_transforms.letterbox_image(img, size)
    np.testing.assert_array_equal(canvas, want_canvas)
    assert content == want_content
    pred = rng.integers(0, 21, (size, size)).astype(np.int32)
    got = transforms.unletterbox_pred(pred, content, hw)
    want = jax_transforms.unletterbox_pred(pred, content, hw)
    assert got.dtype == want.dtype == np.int32 and got.shape == hw
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_classes", [5, 21, 60])
def test_decode_segmap_matches_zs3_tpu(num_classes, rng):
    label = rng.integers(-1, num_classes + 3, (17, 23))
    label[0, 0] = 255
    np.testing.assert_array_equal(viz.get_pascal_labels(), jax_viz.get_pascal_labels())
    np.testing.assert_array_equal(
        viz.decode_segmap(label, num_classes), jax_viz.decode_segmap(label, num_classes)
    )


def test_batched_normalize_device_matches_zs3_tpu(rng):
    images = rng.integers(0, 256, (2, 9, 11, 3), dtype=np.uint8)
    got = transforms.batched_normalize_device(torch.from_numpy(images))
    want = np.asarray(jax_transforms.batched_normalize_device(jax.numpy.asarray(images)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def predictor_pair(tmp_path_factory):
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="resnet50", num_classes=5, compute_dtype="float32",
                             dropout=False),
        data=JaxDataConfig(dataset="synthetic", crop_size=33, base_size=33),
    )
    ref = JaxPredictor(jcfg)
    variables = randomize_bn(ref.variables, seed=8)
    ref.variables = jax.device_put(variables)
    path = tmp_path_factory.mktemp("predictor") / "r50.pt"
    torch.save(state_dict_from_flax(variables), path)
    ours = Predictor(Config.from_json(jcfg.to_json()), checkpoint=str(path), device="cpu")
    return ref, ours, str(path)


def test_predictor_logits_match_zs3_tpu(predictor_pair, rng):
    ref, ours, _ = predictor_pair
    canvases = np.stack([_image(rng, 33, 33) for _ in range(2)])
    want = np.asarray(ref._logits(ref.variables, jax.numpy.asarray(canvases)))
    got = ours._logits(canvases).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-4 * scale)
    np.testing.assert_array_equal(ours._predict(canvases), want.argmax(-1))


def test_predict_array_and_batch_match_zs3_tpu(predictor_pair, rng):
    ref, ours, _ = predictor_pair
    images = [_image(rng, 40, 50), _image(rng, 50, 40), _image(rng, 33, 33), _image(rng, 9, 70)]
    for img in images:
        got = ours.predict_array(img)
        assert got.shape == img.shape[:2] and got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.predict_array(img))
    for got, want in zip(ours.predict_batch(images), ref.predict_batch(images)):
        np.testing.assert_array_equal(got, want)


def test_predict_sliding_matches_zs3_tpu(predictor_pair, rng):
    """Odd sizes larger than the crop, one smaller than it; the windows
    are zs3_tpu's; the softmax average runs on the (CPU) device."""
    ref, ours, _ = predictor_pair
    for hw in [(50, 71), (21, 17), (33, 80)]:
        img = _image(rng, *hw)
        got = ours.predict_sliding(img)
        assert got.shape == hw and got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.predict_sliding(img))
    assert sliding_windows((50, 71), 33) == [(0, 0), (0, 22), (0, 38), (17, 0), (17, 22),
                                             (17, 38)]


def test_predictor_refuses_int8(predictor_pair, rng):
    """Predictor.quantize, refused before the port had quantization, now
    calibrates: it refuses only an empty calibration set, warns past its
    cap, quantizes the 61 eligible convs, and every later forward runs
    under its scales (tests/test_torch_port_quant_paths.py holds it against
    zs3_tpu's Predictor).  A fresh predictor: quantize() switches the
    fixture's to int8 for good."""
    from zs3_tpu_torch import quant
    from zs3_tpu_torch.data.transforms import batched_normalize_device

    ours = Predictor(predictor_pair[1].cfg, checkpoint=predictor_pair[2], device="cpu")
    with pytest.raises(ValueError, match="at least one image"):
        ours.quantize([])
    calib = [_image(rng, *hw) for hw in [(40, 50), (33, 33), (20, 45)]]
    with pytest.warns(UserWarning, match="first 2 of 3"):
        assert ours.quantize(calib, calib_batch=1, max_batches=2) == len(ours._scales) == 61
    canvases = np.stack([_image(rng, 33, 33) for _ in range(2)])
    with torch.no_grad(), quant.quantized(ours._scales):
        want = ours.model(batched_normalize_device(torch.from_numpy(canvases))).argmax(-1)
    np.testing.assert_array_equal(ours._predict(canvases), want.numpy())


def _cfg(**model):
    return Config.from_json(JaxConfig(
        model=JaxModelConfig(backbone="resnet50", num_classes=5, compute_dtype="float32",
                             dropout=False, **model),
        data=JaxDataConfig(dataset="synthetic", crop_size=33, base_size=33),
    ).to_json())


@pytest.fixture(scope="module")
def server():
    srv = InferenceServer(_cfg(fused_tail=True), port=0, device="cpu").start(warmup=True)
    yield srv
    srv.stop()


def _conn(srv):
    # A generous clock: a loaded host's forward takes seconds, and a hang
    # fails this test instead of running the suite into its own limit.
    return http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)


def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def test_healthz_and_info(server):
    c = _conn(server)
    c.request("GET", "/healthz")
    r = c.getresponse()
    assert r.status == 200 and json.loads(r.read())["warm"] is True
    c.request("GET", "/info")
    info = json.loads(c.getresponse().read())
    assert info["num_classes"] == 5 and info["crop_size"] == 33
    assert info["fused_tail"] is True and info["device"] == "cpu"


def test_predict_roundtrip(server, rng):
    img = _image(rng, 40, 50)
    c = _conn(server)
    c.request("POST", "/predict", body=_png(img))
    r = c.getresponse()
    assert r.status == 200 and r.getheader("Content-Type") == "image/png"
    pred = np.asarray(Image.open(io.BytesIO(r.read())))
    assert pred.shape == (40, 50) and pred.max() < 5
    np.testing.assert_array_equal(pred, server.service.predictor.predict_array(img))
    c.request("POST", "/predict?color=1&sliding=1", body=_png(img))
    r = c.getresponse()
    color = np.asarray(Image.open(io.BytesIO(r.read())))
    assert r.status == 200 and color.shape == (40, 50, 3)
    want = viz.decode_segmap(server.service.predictor.predict_sliding(img), 5)
    np.testing.assert_array_equal(color, want)
    assert tail_kernels.classify_resize.launches == 0


def test_predict_bad_body(server):
    c = _conn(server)
    c.request("POST", "/predict", body=b"not an image")
    assert c.getresponse().status == 400
    c.request("POST", "/predict", body=b"")
    assert c.getresponse().status == 400
    c.request("POST", "/nope", body=b"x")
    assert c.getresponse().status == 404


def test_micro_batched_serving(rng):
    """--serve-batch aggregates concurrent requests onto one batched
    forward: all answers right, and some forward served several."""
    srv = InferenceServer(_cfg(), port=0, serve_batch=4, device="cpu").start(warmup=True)
    try:
        bodies = [(i, _image(rng, 30 + i, 40)) for i in range(8)]

        def post(item):
            i, img = item
            c = _conn(srv)
            c.request("POST", "/predict", body=_png(img))
            r = c.getresponse()
            assert r.status == 200
            return i, np.asarray(Image.open(io.BytesIO(r.read())))

        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            results = list(ex.map(post, bodies))
        for (i, pred), (_, img) in zip(results, bodies):
            assert pred.shape == (30 + i, 40) and pred.max() < 5
            np.testing.assert_array_equal(pred, srv.service.predictor.predict_array(img))
        sizes = srv.service.batcher.batch_sizes
        assert sum(sizes) == 9  # 8 requests + 1 warmup
        assert max(sizes) > 1, f"no request ever batched: {sizes}"
        assert srv.service.batcher.groups == len(sizes)
        c = _conn(srv)
        c.request("GET", "/info")
        assert json.loads(c.getresponse().read())["serve_batch"] == 4
    finally:
        srv.stop()


def test_device_failure_answers_500_to_every_waiter(rng, monkeypatch):
    """An error in a batched forward reaches every request of its group
    and answers 500 (the backend is unhealthy, the request was fine)."""
    srv = InferenceServer(_cfg(), port=0, serve_batch=4, device="cpu").start(warmup=True)
    try:
        def broken(images):
            raise RuntimeError("device lost")

        monkeypatch.setattr(srv.service.predictor, "predict_batch", broken)
        statuses = []

        def post(_):
            c = _conn(srv)
            c.request("POST", "/predict", body=_png(_image(rng, 20, 20)))
            r = c.getresponse()
            statuses.append((r.status, json.loads(r.read())["error"]))

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            list(ex.map(post, range(4)))
        assert statuses == [(500, "device lost")] * 4
    finally:
        srv.stop()


def test_artifact_and_int8_are_refused(tmp_path, rng):
    """zs3_tpu's refusals around artifacts (a micro-batched artifact, int8
    calibration of an artifact, `serve --int8 --artifact`; the artifact
    itself is served in test_serves_an_artifact_over_http), and int8
    serving refused only without calibration images; with them it
    calibrates and reports its int8 convs."""
    with pytest.raises(ValueError, match="fixed baked-in batch"):
        SegmentationService(_cfg(), artifact="model.pt2", serve_batch=8, device="cpu")
    with pytest.raises(ValueError, match="baked in"):
        SegmentationService(_cfg(), artifact="model.pt2", int8_calib_images=["a.png"],
                            device="cpu")
    with pytest.raises(SystemExit, match="export with --int8"):
        cli.run(["serve", "--int8", "--calib-images", "a.png", "--artifact", "model.pt2",
                 *CPU_ARGS])
    with pytest.raises(SystemExit, match="--calib-images"):
        cli.run(["serve", "--int8", *CPU_ARGS])
    paths = []
    for i, hw in enumerate([(40, 50), (33, 33)]):
        paths.append(str(tmp_path / f"c{i}.png"))
        Image.fromarray(_image(rng, *hw)).save(paths[-1])
    service = SegmentationService(_cfg(), int8_calib_images=paths, device="cpu")
    assert service.int8_convs == len(service.predictor._scales) == 61
    assert service.info()["int8_convs"] == 61
    png = service.predict_image(_image(rng, 20, 30))
    assert Image.open(io.BytesIO(png)).size == (30, 20)


def test_serves_an_artifact_over_http(predictor_pair, tmp_path, rng):
    """`serve --artifact`: an exported labels artifact (batch 2) answers
    /healthz, /info (the manifest's classes and size, source "artifact")
    and /predict with the checkpoint Predictor's labels on the same
    weights; sliding windows and a logits artifact are refused."""
    from zs3_tpu_torch.export import export_predictor, save_exported
    from zs3_tpu_torch.serve import ArtifactPredictor

    _, ours, ckpt = predictor_pair
    path = str(tmp_path / "model.pt2")
    save_exported(path, *export_predictor(ours.cfg, checkpoint=ckpt, batch_size=2,
                                          device="cpu"))
    # The service takes the manifest's shape over the config's.
    cfg = _cfg().replace(model=dataclasses.replace(_cfg().model, num_classes=21))
    srv = InferenceServer(cfg, port=0, artifact=path, device="cpu").start(warmup=True)
    try:
        c = _conn(srv)
        c.request("GET", "/healthz")
        assert json.loads(c.getresponse().read())["warm"] is True
        c.request("GET", "/info")
        info = json.loads(c.getresponse().read())
        assert (info["source"], info["num_classes"], info["crop_size"]) == ("artifact", 5, 33)
        assert info["fused_tail"] is False and info["serve_batch"] == 1
        for hw in [(40, 50), (33, 33), (20, 45)]:
            img = _image(rng, *hw)
            c.request("POST", "/predict", body=_png(img))
            r = c.getresponse()
            assert r.status == 200
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(r.read()))),
                                          ours.predict_array(img))
        c.request("POST", "/predict?sliding=1", body=_png(_image(rng, 40, 50)))
        r = c.getresponse()
        assert r.status == 500 and "sliding" in json.loads(r.read())["error"]
    finally:
        srv.stop()
    logits = str(tmp_path / "logits.pt2")
    save_exported(logits, *export_predictor(ours.cfg, checkpoint=ckpt, emit="logits",
                                            device="cpu"))
    with pytest.raises(ValueError, match="labels artifact"):
        ArtifactPredictor(logits, device="cpu")
    for artifact in (path, logits):  # some 160 MB each
        os.remove(artifact)


@pytest.mark.parametrize("sliding", [False, True])
def test_cli_infer_writes_its_files(tmp_path, rng, sliding):
    paths = []
    for i, hw in enumerate([(40, 50), (33, 33), (20, 45)]):
        paths.append(str(tmp_path / f"im{i}.png"))
        Image.fromarray(_image(rng, *hw)).save(paths[-1])
    out = tmp_path / "out"
    argv = ["infer", *paths, "--output", str(out), "--fused-tail", *CPU_ARGS] + (["--sliding"] if sliding else [])
    result, predictor = cli.run(argv)
    assert result == {"written": 6, "output": str(out)}
    assert isinstance(predictor, Predictor) and predictor.model.fused_tail
    assert sorted(os.listdir(out)) == sorted(
        f"im{i}{s}.png" for i in range(3) for s in ("", "_color"))
    labels = np.asarray(Image.open(out / "im0.png"))
    assert labels.shape == (40, 50) and labels.max() < 21
    assert cli.main(argv + ["--no-color"]) == 0
    assert tail_kernels.classify_resize.launches == 0
