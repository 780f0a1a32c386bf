"""Seen-class training in the port against zs3_tpu: the train step, the
optimizer and its schedules, the losses and BN's running statistics.

The train step runs a DeepLab with a (2, 2, 2, 2) ResNet trunk (both
packages' own modules) at 33x33 in f32 on the CPU, dropout off, from the
port's seeded init with random BN statistics, carried into zs3_tpu with
zs3_tpu/utils/torch_convert.py::convert_deeplab_state_dict.  Images and
labels (some 255) come from a numpy seed.  After each of two steps:

* the loss within rtol 1e-5;
* updated parameters within 1e-4 where |g| > 1e-3 max|g| (the port's
  gradient): both sides' SGD steps are lr x (g + wd p) plus momentum, and
  the two frameworks' f32 convolutions sum in another order;
* BN running means and variances within 1e-5.

Each step starts from the same state: after a step is compared, the port
takes zs3_tpu's parameters, BN statistics and SGD momentum.  Without that,
the second step would start from weights that already differ by lr x the
two frameworks' f32 gradient difference, which train-mode BN over the few
pixels of the os16 grid amplifies.  The base LR is 1e-3 for the same
reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.core.config import OptimConfig as JaxOptimConfig
from zs3_tpu.models.layers import BatchNorm as JaxBatchNorm
from zs3_tpu.train import seen as jax_seen
from zs3_tpu.train.state import create_seg_state
from zs3_tpu.utils import losses as jax_losses
from zs3_tpu.utils.schedules import build_schedule as jax_build_schedule
from zs3_tpu.utils.torch_convert import convert_deeplab_state_dict
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
from zs3_tpu_torch.models.layers import BatchNorm
from zs3_tpu_torch.train.seen import make_train_step
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils import losses
from zs3_tpu_torch.utils.convert import state_dict_from_flax
from zs3_tpu_torch.utils.schedules import build_schedule

from tests.test_torch_port_models import LAYERS, TinyJaxDeepLab

NUM_CLASSES = 5
TOTAL_STEPS = 10


def _randomize_bn_stats(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
    return model


def _batch(seed, bsz=4):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((bsz, 33, 33, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (bsz, 33, 33)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.1] = 255
    return {"image": images, "label": labels}


def _pair(optim=None):
    """(zs3_tpu state, its apply config, port model, port config)."""
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="resnet50", num_classes=NUM_CLASSES,
                             compute_dtype="float32", dropout=False),
        optim=optim or JaxOptimConfig(lr=1e-3),
    )
    cfg = Config.from_json(jcfg.to_json())
    model = DeepLab(backbone="resnet50", num_classes=NUM_CLASSES, dropout=False,
                    layers=LAYERS)
    _randomize_bn_stats(init_deeplab(model, 0), seed=1)
    params, stats = convert_deeplab_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()
         if not k.endswith("num_batches_tracked")})
    jmodel = TinyJaxDeepLab(backbone="resnet50", num_classes=NUM_CLASSES, dropout=False)
    state = create_seg_state(jmodel, jcfg, jax.random.key(0), (1, 33, 33, 3), TOTAL_STEPS,
                             init_variables={"params": params, "batch_stats": stats})
    return state, jcfg, model, cfg


def _load_jax_state(model, optimizer, state):
    """The port's parameters, BN statistics and momentum buffers set to
    zs3_tpu's (the two LR groups' traces merged into one tree)."""
    traces = [optimizer_state.inner_state[1][0].trace
              for optimizer_state in state.opt_state.inner_states.values()]
    masked = lambda x: isinstance(x, optax.MaskedNode)
    trace = jax.tree.map(lambda a, b: b if masked(a) else a, *traces, is_leaf=masked)
    weights = state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats})
    momentum = state_dict_from_flax({"params": trace})
    with torch.no_grad():
        for name, value in model.state_dict().items():
            if not name.endswith("num_batches_tracked"):
                value.copy_(weights[name])
        for name, p in model.named_parameters():
            optimizer.sgd.state[p]["momentum_buffer"].copy_(momentum[name])


def _compare(state, model, loss, jax_loss):
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)
    want = state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats})
    got = model.state_dict()
    grads = dict(model.named_parameters())
    checked = 0
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        value = got[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value, ref.numpy(), rtol=0, atol=1e-5, err_msg=name)
            continue
        g = grads[name].grad.abs().numpy()
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(value[big], ref.numpy()[big], rtol=0, atol=1e-4,
                                   err_msg=name)
        checked += int(big.sum())
    assert checked > 0


def check_train_step_parity(loss_at, grad_accum):
    """Two steps of the port's make_train_step against zs3_tpu's, each
    from the same state (see the module docstring)."""
    state, jcfg, model, cfg = _pair()
    jax_step = jax_seen.make_train_step(
        jax_losses.build_seg_loss("ce", 255), donate=False, loss_at=loss_at,
        grad_accum=grad_accum)
    step = make_train_step(losses.build_seg_loss("ce", 255), loss_at, grad_accum)
    optimizer = SegOptimizer(model, cfg, TOTAL_STEPS)
    for i in range(2):
        batch = _batch(seed=10 + i, bsz=4 * grad_accum)  # microbatches of 4 images
        state, out = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.key(3))
        got = step(model, optimizer, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert optimizer.step == int(state.step) == i + 1
        _compare(state, model, got["loss"], out["loss"])
        _load_jax_state(model, optimizer, state)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_zs3_tpu(grad_accum):
    """Loss at full resolution (tests/test_torch_port_seen_feature.py has
    the feature-grid loss)."""
    check_train_step_parity("full", grad_accum)


def test_train_step_with_nesterov_focal_and_class_weights():
    optim = JaxOptimConfig(lr=1e-3, nesterov=True, schedule="cos", warmup_steps=1,
                           loss_type="focal")
    state, jcfg, model, cfg = _pair(optim)
    weights = np.linspace(0.5, 2.0, NUM_CLASSES).astype(np.float32)
    jax_step = jax_seen.make_train_step(
        jax_losses.build_seg_loss("focal", 255, jnp.asarray(weights)), donate=False)
    step = make_train_step(losses.build_seg_loss("focal", 255, torch.from_numpy(weights)))
    optimizer = SegOptimizer(model, cfg, TOTAL_STEPS)
    for i in range(3):  # the warmup step's lr is 0; the next two move
        batch = _batch(seed=20 + i)
        state, out = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.key(3))
        got = step(model, optimizer, {k: torch.from_numpy(v) for k, v in batch.items()})
        _compare(state, model, got["loss"], out["loss"])
        _load_jax_state(model, optimizer, state)


def test_train_step_refuses_what_is_not_ported():
    loss = losses.build_seg_loss("ce")
    with pytest.raises(NotImplementedError, match="qat"):
        make_train_step(loss, qat=True)
    with pytest.raises(ValueError):
        make_train_step(loss, grad_accum=0)
    model = DeepLab(backbone="resnet50", num_classes=NUM_CLASSES, dropout=False, layers=LAYERS)
    step = make_train_step(loss, grad_accum=3)
    with pytest.raises(ValueError, match="divisible"):
        step(model, SegOptimizer(model, Config(), 1),
             {k: torch.from_numpy(v) for k, v in _batch(0).items()})


# ---- BN running statistics -------------------------------------------------------

@pytest.mark.parametrize("bsz", [2, 4])
def test_bn_running_var_is_flax_biased_update(bsz, rng):
    """One train-mode forward at the os16 grid of a 33x33 crop (3x3 pixels
    a channel and image: n = 9 * bsz) moves running_var with the biased
    batch variance, as flax does; torch's own BatchNorm2d moves it with
    the unbiased one, n/(n-1) larger (18/17 at batch 2)."""
    c = 8
    x = rng.standard_normal((bsz, 3, 3, c)).astype(np.float32) * 2.0 + 0.5
    mean0 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    var0 = (rng.random(c) + 0.5).astype(np.float32)
    jbn = JaxBatchNorm()
    variables = jbn.init(jax.random.key(0), jnp.asarray(x))
    variables = {"params": variables["params"],
                 "batch_stats": {"bn": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}}
    want_y, updates = jbn.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    bn = BatchNorm(c).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    stats = updates["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(want_y), atol=1e-5)
    biased = x.reshape(-1, c).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var0 + 0.1 * biased, rtol=1e-5)


# ---- losses ----------------------------------------------------------------------

def _logits_labels(rng, c=6):
    logits = (rng.standard_normal((2, 9, 7, c)) * 3).astype(np.float32)
    labels = rng.integers(0, c + 2, (2, 9, 7)).astype(np.int32)  # some >= C
    labels[rng.random(labels.shape) < 0.2] = 255
    return logits, labels


@pytest.mark.parametrize("mode,weighted", [("ce", False), ("ce", True), ("focal", False),
                                           ("focal", True)])
def test_losses_match_zs3_tpu(mode, weighted, rng):
    logits, labels = _logits_labels(rng)
    weights = (rng.random(6) + 0.5).astype(np.float32) if weighted else None
    want = jax_losses.build_seg_loss(
        mode, 255, None if weights is None else jnp.asarray(weights))(
        jnp.asarray(logits), jnp.asarray(labels))
    got = losses.build_seg_loss(mode, 255, None if weights is None else torch.from_numpy(
        weights))(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # bf16 logits: the log-softmax still runs in f32.
    got16 = losses.build_seg_loss(mode)(torch.from_numpy(logits).bfloat16(),
                                        torch.from_numpy(labels))
    want16 = jax_losses.build_seg_loss(mode)(jnp.asarray(logits, jnp.bfloat16),
                                            jnp.asarray(labels))
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(float(got16), float(want16), rtol=1e-5)


def test_losses_with_every_pixel_ignored_are_zero():
    logits = torch.randn(1, 4, 4, 3)
    labels = torch.full((1, 4, 4), 255, dtype=torch.int32)
    for mode in ("ce", "focal"):
        assert float(losses.build_seg_loss(mode)(logits, labels)) == 0.0
    with pytest.raises(ValueError):
        losses.build_seg_loss("dice")


def test_class_weights_match_zs3_tpu(tmp_path, rng):
    hist = rng.integers(0, 1000, 7)
    np.testing.assert_allclose(
        losses.calculate_class_weights(hist).numpy(),
        np.asarray(jax_losses.calculate_class_weights(jnp.asarray(hist))), rtol=1e-6)
    dataset = [{"label": rng.integers(0, 9, (5, 5)).astype(np.int64)} for _ in range(4)]
    dataset[0]["label"][0, 0] = 255
    cache = tmp_path / "sub" / "hist.npy"
    got = losses.compute_dataset_class_weights(dataset, 7, 255, cache_path=str(cache))
    want = jax_losses.compute_dataset_class_weights(dataset, 7, 255)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert cache.exists()
    again = losses.compute_dataset_class_weights([], 7, 255, cache_path=str(cache))
    np.testing.assert_array_equal(again.numpy(), got.numpy())  # read from the cache


# ---- schedules and the optimizer -------------------------------------------------

@pytest.mark.parametrize("mode", ["poly", "cos", "step", "const"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_optax_at_every_step(mode, warmup):
    total = 12
    want = jax_build_schedule(mode, 0.01, total, warmup, 0.9)
    got = build_schedule(mode, 0.01, total, warmup, 0.9)
    for step in range(total + 4):
        # optax computes in f32: within rtol 1e-6 or 1e-6 of the base LR.
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-8,
                                   err_msg=f"{mode} warmup {warmup} step {step}")
    with pytest.raises(ValueError):
        build_schedule("linear", 0.01, total)


def test_optimizer_groups_and_lr_follow_zs3_tpu():
    """backbone.* at 1x, the rest at head_lr_mult x, both from the schedule
    at the count before the update; weight decay on every parameter."""
    model = DeepLab(backbone="resnet50", num_classes=NUM_CLASSES, dropout=False, layers=LAYERS)
    cfg = Config()
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr=0.01, head_lr_mult=10.0))
    opt = SegOptimizer(model, cfg, total_steps=4)
    backbone, head = opt.sgd.param_groups
    names = {id(p): n for n, p in model.named_parameters()}
    assert all(names[id(p)].startswith("backbone.") for p in backbone["params"])
    assert not any(names[id(p)].startswith("backbone.") for p in head["params"])
    assert len(backbone["params"]) + len(head["params"]) == len(list(model.parameters()))
    assert backbone["weight_decay"] == head["weight_decay"] == cfg.optim.weight_decay
    sched = optax.polynomial_schedule(0.01, 0.0, 0.9, 4)
    for step in range(4):
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.apply()
        assert opt.step == step + 1
        np.testing.assert_allclose(backbone["lr"], float(sched(step)), rtol=1e-6)
        np.testing.assert_allclose(head["lr"], 10 * float(sched(step)), rtol=1e-6)
    restored = SegOptimizer(model, cfg, total_steps=4)
    restored.load_state_dict(opt.state_dict())
    assert restored.step == 4 and restored.lr() == opt.lr() == 0.0
