"""The int8 and QAT paths of the port against zs3_tpu's: the int8_eval
eval step, the int8_features ZS3 step, one QAT seen step,
Predictor.quantize, and the CLI's int8 and QAT flags.

The steps run a DeepLab with a (2, 2, 2, 2) ResNet trunk at 33x33 on the
CPU under zs3_tpu's calibration of it (carried across by
`scales_from_flax`), computing in float64.  An int8 path rounds each conv
input onto a grid, so a one-ulp f32 difference between the frameworks
moves a value across a rounding boundary now and then, and the flip
grows through the layers (train-mode BN over the os16 grid's few pixels
amplifies it most); in f64 the values the f32 grid math sees are the same
bits on both sides.  zs3_tpu's stem conv computes in f32 in any case, so
its weights are multiples of 1/64 and the images integers, which makes
every product and partial sum of the stem exact.  zs3_tpu's steps are
compiled without XLA's algebraic simplifier (`OP_BY_OP`): its rewrites of
the grid math's divisions move zs3_tpu's jitted int8 and QAT results off
its own op-by-op ones (0.06 on the QAT logits), to which the port's are
equal.  Tolerances are the plain paths' (tests/test_torch_port_zs3.py,
tests/test_torch_port_seen.py): mmd and cls_ce rtol 1e-4, features 1e-5
of their largest, confusions equal, the seen step's loss, parameters and
BN statistics.  Predictor.quantize runs a ResNet-50 at 33x33 in f32: the
same count of quantized convs, the same scales within rel 1e-5 (the two
trunks' f32 convolutions sum in another order), and under zs3_tpu's
scales int8 labels equal on >= 99% of pixels (a one-ulp upstream
difference can move a value across an int8 rounding boundary).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zs3_tpu import quant as jax_quant
from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import GMMNConfig as JaxGMMNConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.models.gmmn import build_gmmn as jax_build_gmmn
from zs3_tpu.train import gmmn as jax_gmmn
from zs3_tpu.train import seen as jax_seen
from zs3_tpu.train.predict import Predictor as JaxPredictor
from zs3_tpu.train.state import create_seg_state
from zs3_tpu.utils import losses as jax_losses
from zs3_tpu.utils.torch_convert import convert_deeplab_state_dict
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.data.loader import make_data_loader
from zs3_tpu_torch.data.synthetic import synthetic_class_embeddings
from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
from zs3_tpu_torch.models.gmmn import build_gmmn
from zs3_tpu_torch.train import gmmn
from zs3_tpu_torch.train.predict import Predictor
from zs3_tpu_torch.train.seen import device_batch, make_train_step, select_eval_step
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils import losses
from zs3_tpu_torch.utils.convert import (
    gmmn_state_dict_from_flax, scales_from_flax, state_dict_from_flax,
)

from tests.test_torch_port_models import LAYERS, TinyJaxDeepLab, randomize_bn
from tests.test_torch_port_quant import OP_BY_OP
from tests.test_torch_port_seen import TOTAL_STEPS, _batch, _compare, _pair, _randomize_bn_stats
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

N_CLASSES = 21
UNSEEN = (10, 14)


def _exact_stem(batch):
    """The batch with integer images (see the module docstring)."""
    return {**batch, "image": np.round(np.asarray(batch["image"]) * 2).astype(np.float32)}


@pytest.fixture(scope="module")
def int8_pair():
    """(port model in f64, zs3_tpu state in f64, configs, val batches,
    zs3_tpu's scales, the port's); its users enter jax.enable_x64."""
    with jax.enable_x64(True):
        jcfg = JaxConfig(
            model=JaxModelConfig(backbone="resnet50", compute_dtype="float32", dropout=False),
            gmmn=JaxGMMNConfig(embed_dim=32, noise_dim=16, hidden_dim=32, feature_dim=256,
                               pixels_per_class=16, mmd_backend="jnp"),
            data=JaxDataConfig(dataset="synthetic", crop_size=33, base_size=33, batch_size=4,
                               eval_batch_size=8, unseen_classes=UNSEEN, num_workers=1),
        )
        cfg = Config.from_json(jcfg.to_json())
        cfg = cfg.replace(gmmn=dataclasses.replace(cfg.gmmn, mmd_backend="auto"))
        model = DeepLab(backbone="resnet50", num_classes=N_CLASSES, dropout=False,
                        layers=LAYERS, dtype=torch.float64)
        _randomize_bn_stats(init_deeplab(model, 0), seed=2)
        with torch.no_grad():
            stem = model.backbone.conv1.weight
            stem.copy_(torch.round(stem * 64) / 64)
        params, stats = convert_deeplab_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")})
        jmodel = TinyJaxDeepLab(backbone="resnet50", num_classes=N_CLASSES, dropout=False,
                                dtype=jnp.float64)
        state = create_seg_state(jmodel, jcfg, jax.random.key(0), (1, 33, 33, 3), 1,
                                 init_variables={"params": params, "batch_stats": stats})
        model.double().eval()
        train, val, _ = make_data_loader(cfg.data)
        batches = [_exact_stem(b) for b in val]
        jax_scales = jax_quant.calibrate(jmodel.apply, state.eval_variables(),
                                         [b["image"] for b in batches[:2]],
                                         apply_kwargs={"train": False})
    return (model, jmodel, state, jcfg, cfg, batches, _exact_stem(next(iter(train))),
            jax_scales, scales_from_flax(jax_scales))


def test_int8_eval_confusions_match_zs3_tpu(int8_pair):
    """The K1 eval step under int8_eval: zs3_tpu's make_eval_step traced
    under quantized(its scales), the port's select_eval_step under the
    same scales; every val batch's confusion equal."""
    model, _, state, _, cfg, batches, _, jax_scales, scales = int8_pair
    train_cfg = dataclasses.replace(cfg.train, int8_eval=True)
    step = select_eval_step(N_CLASSES, 255, train_cfg, scales)
    with jax.enable_x64(True), jax_quant.quantized(jax_scales):
        jax_step = jax_seen.make_eval_step(N_CLASSES, 255)
        jax_batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
        compiled = jax_step.lower(state, jax_batch).compile(compiler_options=OP_BY_OP)
        for batch in batches:
            want = np.asarray(compiled(state, {k: jnp.asarray(v) for k, v in batch.items()}))
            got = step(model, device_batch(batch, "cpu")).numpy()
            assert got.sum() == int((batch["label"] != 255).sum())
            np.testing.assert_array_equal(got, want.astype(np.int64))
    float_conf = select_eval_step(N_CLASSES, 255, cfg.train)(model, device_batch(batch, "cpu"))
    assert not np.array_equal(float_conf.numpy(), got)  # the int8 convs ran


def test_int8_features_zs3_step_matches_zs3_tpu(int8_pair):
    """One ZS3 step with int8 trunk features: zs3_tpu's make_zs3_step with
    int8_scales and the port's ZS3Step with the same scales, from the same
    generator and classifier, on zs3_tpu's draws."""
    model, jmodel, state, jcfg, cfg, _, batch, jax_scales, scales = int8_pair
    with jax.enable_x64(True):
        emb = synthetic_class_embeddings(N_CLASSES, cfg.gmmn.embed_dim)
        generator = jax_build_gmmn(jcfg.gmmn)
        gen_params = generator.init(jax.random.key(2), jnp.zeros((1, 32)),
                                    jnp.zeros((1, 16)))["params"]
        variables = state.eval_variables()
        cls_params = jax_gmmn.extract_classifier(variables)
        unseen = np.zeros(N_CLASSES, np.float32)
        unseen[list(UNSEEN)] = 1.0
        gen_state = jax_gmmn.GenState.create(apply_fn=generator.apply, params=gen_params,
                                             tx=optax.adam(jcfg.optim.gmmn_lr))
        cls_state = jax_gmmn.ClsState.create(apply_fn=None, params=cls_params,
                                             tx=optax.adam(jcfg.optim.classifier_lr))
        jax_step = jax_gmmn.make_zs3_step(jmodel, generator, jcfg, N_CLASSES,
                                          jnp.asarray(unseen), False, donate=False,
                                          int8_scales=jax_scales)
        rng = jax.random.key(3)
        args = (gen_state, cls_state, variables, jnp.asarray(emb),
                {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        _, _, out = jax_step.lower(*args).compile(compiler_options=OP_BY_OP)(*args)
        # The step's draws, as make_zs3_step splits its key.
        r_sample, r_noise1, r_noise2, _ = jax.random.split(jax.random.fold_in(rng, 0), 4)
        budget, z = jcfg.gmmn.pixels_per_class, jcfg.gmmn.noise_dim
        n_pix = batch["image"].shape[0] * 9 * 9  # the os4 grid of a 33x33 crop
        draws = (jax.random.uniform(r_sample, (N_CLASSES, n_pix), minval=1e-6, maxval=1.0),
                 jax.random.normal(r_noise1, (N_CLASSES, budget, z)),
                 jax.random.normal(r_noise2, (N_CLASSES, budget, z)))
        with jax_quant.quantized(jax_scales):
            features = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                                         method="forward_features"))
            image = jnp.asarray(batch["image"])
            jax_feats = np.asarray(features.lower(variables, image).compile(
                compiler_options=OP_BY_OP)(variables, image))
    port_gen = build_gmmn(cfg.gmmn)
    port_gen.load_state_dict(gmmn_state_dict_from_flax(gen_params))
    unseen_mask = torch.zeros(N_CLASSES)
    unseen_mask[list(UNSEEN)] = 1.0
    step = gmmn.ZS3Step(model, port_gen, gmmn.extract_classifier(model),
                        torch.from_numpy(emb), unseen_mask, cfg, seed=0, int8_scales=scales)
    step.cls = {k: v.float().detach().requires_grad_(True) for k, v in step.cls.items()}
    step.cls_opt = torch.optim.Adam(list(step.cls.values()), lr=cfg.optim.classifier_lr)
    feats, _ = step.features(device_batch(batch, "cpu"))
    want = jax_feats.reshape(feats.shape)
    np.testing.assert_allclose(feats.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    float_feats = model.forward_features(torch.from_numpy(batch["image"])).detach()
    assert not np.allclose(float_feats.reshape(feats.shape).float().numpy(), want, atol=1e-3)
    got = step.body(device_batch(batch, "cpu"),
                    tuple(torch.from_numpy(np.array(a, np.float32)) for a in draws))
    np.testing.assert_allclose(float(got["mmd"]), float(out["mmd"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["cls_ce"]), float(out["cls_ce"]), rtol=1e-4)


TINY = ["--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
        "--backbone", "resnet50", "--compute-dtype", "float32", "--unseen-split", "2",
        "--batch-size", "4", "--eval-batch-size", "8", "--device", "cpu"]


@pytest.mark.parametrize("argv, want", [
    (["evaluate", "--int8", "--int8-percentile", "99.99"],
     {"int8_eval": True, "int8_percentile": 99.99, "int8_features": False, "qat": False}),
    (["evaluate-gmmn", "--int8"], {"int8_eval": True, "int8_percentile": None}),
    (["infer", "a.png", "--int8", "--int8-percentile", "99.9"],
     {"int8_eval": False, "int8_percentile": 99.9}),
    (["serve", "--int8", "--calib-images", "a.png", "b.png"], {"int8_eval": False}),
    (["train-gmmn", "--int8-features", "--int8-percentile", "99.0"],
     {"int8_features": True, "int8_percentile": 99.0, "int8_eval": False}),
    (["train-zs5", "--int8-features"], {"int8_features": True}),
    (["train-seen", "--qat"], {"qat": True, "int8_eval": False}),
])
def test_cli_int8_flags_reach_the_config(argv, want):
    args = cli.make_parser().parse_args(argv + TINY)
    train = cli.build_config(args).train
    assert {k: getattr(train, k) for k in want} == want
    if argv[0] == "serve":
        assert args.calib_images == ["a.png", "b.png"]


def test_cli_infer_int8(tmp_path):
    """infer --int8 calibrates on its input images (the first 8) and
    reports its int8 convs."""
    from PIL import Image

    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"im{i}.png"))
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (30, 40, 3), np.uint8)).save(
            paths[-1])
    result, predictor = cli.run(["infer", *paths, "--int8", "--output", str(tmp_path / "out"),
                                 *TINY])
    assert result == {"written": 4, "output": str(tmp_path / "out"), "int8_convs": 61}
    assert len(predictor._scales) == 61


@pytest.mark.slow
def test_cli_train_zs5_int8_features(tmp_path):
    """train-zs5 --int8-features end to end at 33x33: int8 feature steps,
    int8 pseudo-labels and an int8 validation under one calibration."""
    with pytest.warns(UserWarning):
        result, zs5 = cli.run(["train-zs5", "--int8-features", "--int8-percentile", "99.99",
                               "--epochs", "1", "--steps-per-epoch", "1",
                               "--pixels-per-class", "16", *TINY,
                               "--checkpoint-dir", str(tmp_path / "run")])
    assert zs5.step.int8_scales is zs5.trunk_int8_scales() and len(zs5.step.int8_scales) == 61
    assert np.isfinite(result["mmd"]) and "harmonic_miou" in result


def test_qat_train_step_matches_zs3_tpu():
    """A step on fake-quantized operands against zs3_tpu's QAT step, from
    the same state.  In f32 the two
    frameworks' one-ulp differences move a few values a layer across a
    rounding boundary of the int8 grid, and train-mode BN over the os16
    grid's few pixels amplifies each flip (layer4's outputs end up ~1
    apart); in f64 the values the f32 grid math sees are the same bits.
    zs3_tpu's stem conv computes in f32 whatever the model's dtype, so the
    stem's weights are multiples of 1/64 and the images integers: every
    product and partial sum of the stem is then exact in f32 and f64."""
    with jax.enable_x64(True):
        state, jcfg, model, cfg = _pair(f64=True)
        jax_step = jax_seen.make_train_step(jax_losses.build_seg_loss("ce", 255),
                                            donate=False, qat=True)
        step = make_train_step(losses.build_seg_loss("ce", 255), qat=True)
        optimizer = SegOptimizer(model, cfg, TOTAL_STEPS)
        batch = _batch(seed=30)
        batch["image"] = np.round(batch["image"] * 2)
        args = (state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(3))
        state, out = jax_step.lower(*args).compile(compiler_options=OP_BY_OP)(*args)
        got = step(model, optimizer, {k: torch.from_numpy(v) for k, v in batch.items()})
        _compare(state, model, got["loss"], out["loss"])


def test_predictor_quantize_matches_zs3_tpu(tmp_path):
    rng = np.random.default_rng(0)
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="resnet50", num_classes=5, compute_dtype="float32",
                             dropout=False),
        data=JaxDataConfig(dataset="synthetic", crop_size=33, base_size=33),
    )
    ref = JaxPredictor(jcfg)
    ref.variables = jax.device_put(randomize_bn(ref.variables, seed=8))
    path = str(tmp_path / "r50.pt")
    torch.save(state_dict_from_flax(ref.variables), path)
    ours = Predictor(Config.from_json(jcfg.to_json()), checkpoint=path, device="cpu")
    image = lambda h, w: rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    calib = [image(*hw) for hw in [(40, 50), (33, 33), (20, 45)] * 3]  # 2 batches of 4 kept
    with pytest.warns(UserWarning, match="first 8 of 9"):
        n = ours.quantize(calib, calib_batch=4, max_batches=2, percentile=99.99)
    with pytest.warns(UserWarning, match="first 8 of 9"):
        assert ref.quantize(calib, calib_batch=4, max_batches=2, percentile=99.99) == n == 61
    want = scales_from_flax(ref._scales)
    assert set(ours._scales) == set(want)
    np.testing.assert_allclose([ours._scales[k] for k in sorted(want)],
                               [want[k] for k in sorted(want)], rtol=1e-5)
    ours._scales = want  # a 1e-5 change in a scale moves values near a rounding boundary
    canvases = jnp.asarray(np.stack([image(33, 33) for _ in range(2)]))
    apply = jax.jit(ref._apply).lower(ref.variables, canvases).compile(compiler_options=OP_BY_OP)
    expect = np.asarray(apply(ref.variables, canvases)).argmax(-1)
    agree = float((ours._predict(np.asarray(canvases)) == expect).mean())
    assert agree >= 0.99, agree
