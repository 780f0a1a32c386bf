"""The port's paths on the new backbones against zs3_tpu's, and the
subcommands show-config and profile.

* A MobileNetV2 seen train step (its depthwise gradients): loss,
  updated parameters and BN statistics, as tests/test_torch_port_seen.py
  compares them.
* A ZS3 step on an Xception trunk, on zs3_tpu's draws, as
  tests/test_torch_port_zs3.py compares it.
* `evaluate --int8` on MobileNetV2: zs3_tpu's eval step traced under its
  calibration and compiled op by op against the port's under the same
  scales, in float64 as tests/test_torch_port_quant_paths.py runs it;
  the depthwise convs stay float on both sides.  Confusions equal.
* `show-config` prints zs3_tpu's JSON for the same flags; `profile` gives
  zs3_tpu's result keys in each mode, and a trace with --trace-dir.
"""

import contextlib
import dataclasses
import io
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs3_tpu import cli as jax_cli
from zs3_tpu import quant as jax_quant
from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import GMMNConfig as JaxGMMNConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.core.config import OptimConfig as JaxOptimConfig
from zs3_tpu.models.deeplab import build_deeplab as jax_build_deeplab
from zs3_tpu.models.gmmn import build_gmmn as jax_build_gmmn
from zs3_tpu.train import gmmn as jax_gmmn
from zs3_tpu.train import seen as jax_seen
from zs3_tpu.train.state import create_seg_state
from zs3_tpu.utils import losses as jax_losses
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.data.loader import make_data_loader
from zs3_tpu_torch.data.synthetic import synthetic_class_embeddings
from zs3_tpu_torch.models.deeplab import build_deeplab
from zs3_tpu_torch.models.gmmn import build_gmmn
from zs3_tpu_torch.train import gmmn
from zs3_tpu_torch.train.seen import device_batch, make_train_step, select_eval_step
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils import losses
from zs3_tpu_torch.utils.convert import (
    gmmn_state_dict_from_flax,
    scales_from_flax,
    state_dict_from_flax,
)

from tests.test_torch_port_backbones import random_variables
from tests.test_torch_port_quant import OP_BY_OP
from tests.test_torch_port_seen import NUM_CLASSES, TOTAL_STEPS, _batch, _compare
from tests.test_torch_port_zs3 import _close_grads, _close_where_signed, _jax_step_reference
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

t = torch.from_numpy


def test_mobilenet_seen_train_step_matches_zs3_tpu():
    """One step from random weights and BN statistics, carried into the
    port by state_dict_from_flax, both sides in float64
    (tests/test_torch_port_seen.py's f32 pair is a (2, 2, 2, 2) ResNet: the
    17 blocks' f32 convolutions, summed in another order on each side,
    move train-mode BN's statistics over the 3x3 os16 grid by 1e-5 of their
    size)."""
    with jax.enable_x64(True):
        jcfg = JaxConfig(
            model=JaxModelConfig(backbone="mobilenet", num_classes=NUM_CLASSES,
                                 compute_dtype="float64", dropout=False),
            optim=JaxOptimConfig(lr=1e-3),
        )
        cfg = Config.from_json(jcfg.to_json())
        jmodel = jax_build_deeplab(jcfg.model)
        state = create_seg_state(jmodel, jcfg, jax.random.key(0), (1, 33, 33, 3), TOTAL_STEPS,
                                 init_variables=random_variables(jmodel, (1, 33, 33, 3), 1))
        model = build_deeplab(cfg.model)  # computes in float64
        model.load_state_dict(state_dict_from_flax({"params": state.params,
                                                    "batch_stats": state.batch_stats}))
        model.double()
        jax_step = jax_seen.make_train_step(jax_losses.build_seg_loss("ce", 255), donate=False)
        step = make_train_step(losses.build_seg_loss("ce", 255))
        optimizer = SegOptimizer(model, cfg, TOTAL_STEPS)
        batch = _batch(seed=10)
        state, out = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.key(3))
        got = step(model, optimizer, {k: t(v) for k, v in batch.items()})
        _compare(state, model, got["loss"], out["loss"])
    depthwise = model.backbone.features[2].conv[3]
    assert depthwise.groups == depthwise.in_channels and depthwise.weight.grad.abs().max() > 0


def test_zs3_step_on_an_xception_trunk_matches_zs3_tpu():
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="xception", compute_dtype="float32", dropout=False),
        gmmn=JaxGMMNConfig(embed_dim=32, noise_dim=16, hidden_dim=32, feature_dim=256,
                           pixels_per_class=16, mmd_backend="jnp"),
        data=JaxDataConfig(dataset="synthetic", crop_size=33, base_size=33, batch_size=4,
                           eval_batch_size=8, unseen_classes=(10, 14), num_workers=1),
    )
    cfg = Config.from_json(jcfg.to_json())
    cfg = cfg.replace(gmmn=dataclasses.replace(cfg.gmmn, mmd_backend="auto"))
    jmodel = jax_build_deeplab(jcfg.model)
    variables = random_variables(jmodel, (1, 33, 33, 3), seed=5)
    model = build_deeplab(cfg.model)
    model.load_state_dict(state_dict_from_flax(variables))
    model.eval()
    train, _, n = make_data_loader(cfg.data)
    batch = next(iter(train))
    emb = synthetic_class_embeddings(n, cfg.gmmn.embed_dim)
    gen_params = jax_build_gmmn(jcfg.gmmn).init(
        jax.random.key(2), jnp.zeros((1, 32)), jnp.zeros((1, 16)))["params"]
    cls_params = jax_gmmn.extract_classifier(variables)
    new_gen, new_cls, out, gen_grads, cls_grads, draws = _jax_step_reference(
        jcfg, jmodel, variables, batch, jnp.asarray(emb), gen_params, cls_params,
        jax.random.key(3))

    port_gen = build_gmmn(cfg.gmmn)
    port_gen.load_state_dict(gmmn_state_dict_from_flax(gen_params))
    unseen = torch.zeros(n)
    unseen[[10, 14]] = 1.0
    step = gmmn.ZS3Step(model, port_gen, gmmn.extract_classifier(model), t(emb), unseen,
                        cfg, seed=0)
    got = step.body(device_batch(batch, "cpu"), tuple(t(a) for a in draws))
    np.testing.assert_allclose(float(got["mmd"]), float(out["mmd"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["cls_ce"]), float(out["cls_ce"]), rtol=1e-4)
    want_g, want_p = gmmn_state_dict_from_flax(gen_grads), gmmn_state_dict_from_flax(new_gen)
    for name, p in port_gen.named_parameters():
        g = want_g[name].numpy()
        _close_grads(p.grad.numpy(), g, name)
        _close_where_signed(p.detach().numpy(), want_p[name].numpy(), g, name)
    for name in ("kernel", "bias"):
        g = np.asarray(cls_grads[name])
        _close_grads(step.cls[name].grad.numpy(), g, name)
        _close_where_signed(step.cls[name].detach().numpy(), np.asarray(new_cls[name]), g, name)


def _power_of_four_variances(variables, seed):
    """BN running variances of 4^k (k in -1..1), for BN epsilon 0.  flax's
    eval BN takes rsqrt(var + eps) and its product with the scale in f32,
    the f32 of its parameters, even in a float64 model; the port's f64 BN
    does both in f64.  At a power of four both are exact, so the two sides'
    BN outputs round alike and only the int8 path is compared."""
    rng = np.random.default_rng(seed)
    stats = flax.traverse_util.flatten_dict(variables["batch_stats"])
    stats = {k: (4.0 ** rng.integers(-1, 2, v.shape)).astype(np.float32) if k[-1] == "var" else v
             for k, v in stats.items()}
    return {**variables, "batch_stats": flax.traverse_util.unflatten_dict(stats)}


def test_mobilenet_int8_eval_confusions_match_zs3_tpu():
    with jax.enable_x64(True):
        jcfg = JaxConfig(
            model=JaxModelConfig(backbone="mobilenet", compute_dtype="float64", dropout=False,
                                 bn_epsilon=0.0),
            data=JaxDataConfig(dataset="synthetic", crop_size=33, base_size=33,
                               eval_batch_size=8, unseen_classes=(10, 14), num_workers=1),
        )
        jmodel = jax_build_deeplab(jcfg.model)
        variables = _power_of_four_variances(random_variables(jmodel, (1, 33, 33, 3), 2),
                                             seed=3)
        state = create_seg_state(jmodel, jcfg, jax.random.key(0), (1, 33, 33, 3), 1,
                                 init_variables=variables)
        cfg = Config.from_json(jcfg.to_json())
        model = build_deeplab(cfg.model)  # computes in float64
        model.load_state_dict(state_dict_from_flax(variables))
        model = model.double().eval()
        _, val, n = make_data_loader(cfg.data)
        batches = list(val)[:2]
        jax_scales = jax_quant.calibrate(jmodel.apply, state.eval_variables(),
                                         [b["image"] for b in batches[:1]],
                                         apply_kwargs={"train": False})
        scales = scales_from_flax(jax_scales)
        grouped = [name for name, m in model.named_modules()
                   if getattr(m, "groups", 1) > 1]
        assert grouped and not set(grouped) & set(scales)  # depthwise convs stay float
        step = select_eval_step(n, 255, dataclasses.replace(cfg.train, int8_eval=True), scales)
        with jax_quant.quantized(jax_scales):
            jax_step = jax_seen.make_eval_step(n, 255)
            jax_batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
            compiled = jax_step.lower(state, jax_batch).compile(compiler_options=OP_BY_OP)
            for batch in batches:
                want = np.asarray(compiled(state, {k: jnp.asarray(v) for k, v in batch.items()}))
                got = step(model, device_batch(batch, "cpu")).numpy()
                assert got.sum() == int((batch["label"] != 255).sum())
                np.testing.assert_array_equal(got, want.astype(np.int64))
    float_conf = select_eval_step(n, 255, cfg.train)(model, device_batch(batch, "cpu"))
    assert not np.array_equal(float_conf.numpy(), got)  # the int8 convs ran


FLAGS = ["--dataset", "synthetic", "--backbone", "drn", "--crop-size", "65", "--base-size",
         "65", "--unseen-split", "4", "--compute-dtype", "float32", "--batch-size", "4",
         "--lr", "0.01", "--pixels-per-class", "32", "--eval-scales", "0.75,1.0",
         "--eval-flip", "--epochs", "3", "--qat"]


def test_show_config_is_zs3_tpus():
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert jax_cli.main(["show-config", *FLAGS]) == 0
    want = json.loads(printed.getvalue())
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert cli.main(["show-config", *FLAGS]) == 0
    got = json.loads(printed.getvalue())
    assert got == want and got["model"]["backbone"] == "drn"
    assert got["train"]["qat"] and got["data"]["unseen_classes"] == [10, 14, 1, 18]


@pytest.mark.parametrize("mode", ["fwd", "train", "int8-fwd"])
def test_profile_keys_and_trace(mode, tmp_path):
    trace = tmp_path / "trace"
    result, trainer = cli.run([
        "profile", "--mode", mode, "--steps", "2", "--trace-dir", str(trace),
        "--dataset", "synthetic", "--backbone", "mobilenet", "--crop-size", "33",
        "--base-size", "33", "--batch-size", "2", "--compute-dtype", "float32",
        "--unseen-split", "2", "--checkpoint-dir", str(tmp_path / "run"), "--device", "cpu",
    ])
    assert set(result) == {"mode", "steps", "mean_step_ms", "p50_step_ms", "images_per_sec",
                           "trace_dir", "device_attribution_per_step"}
    assert result["mode"] == mode and result["steps"] == 1 and result["trace_dir"] == str(trace)
    assert result["mean_step_ms"] > 0 and result["images_per_sec"] > 0
    assert result["device_attribution_per_step"] is None  # no device on the CPU
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    assert trainer.step == (2 if mode == "train" else 0)
    assert os.path.isdir(trainer.saver.directory)
