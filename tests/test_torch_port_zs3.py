"""The ZS3 slice end to end: one ZS3 step and the ZS3 eval step of the
port against zs3_tpu's, on the same weights, batch and random draws.

ResNet-50 at 65x65 in f32 on the CPU, 21 classes, unseen (10, 14), 32
pixels per class, zs3_tpu's draws (scores and both noises) injected into
the port's step body:

* mmd and cls_ce to rtol 1e-4;
* gradients to rtol 1e-3 with an atol of 1e-4 of the tensor's largest
  entry: the two trunks' convolutions sum in another order, and the
  features carry that into every gradient;
* Adam-updated params to 1e-6 where |g| > 1e-3 max|g|: Adam's first step
  is +-lr wherever |g| >> eps, so an entry whose sign rests on rounding
  may move either way;
* the ZS3 eval step with the retrained classifier within 0.1% of pixels
  (near-ties of the argmax).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import GMMNConfig as JaxGMMNConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.models.deeplab import build_deeplab as jax_build_deeplab
from zs3_tpu.models.gmmn import build_gmmn as jax_build_gmmn
from zs3_tpu.ops import mmd as jax_mmd
from zs3_tpu.ops.sampling import downsample_labels as jax_downsample_labels
from zs3_tpu.ops.sampling import sample_class_pixels as jax_sample_class_pixels
from zs3_tpu.train import gmmn as jax_gmmn
from zs3_tpu.train.state import create_seg_state
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.data.loader import make_data_loader
from zs3_tpu_torch.data.synthetic import synthetic_class_embeddings
from zs3_tpu_torch.models.deeplab import build_deeplab
from zs3_tpu_torch.models.gmmn import build_gmmn
from zs3_tpu_torch.train import gmmn
from zs3_tpu_torch.train.seen import device_batch
from zs3_tpu_torch.utils.convert import gmmn_state_dict_from_flax, state_dict_from_flax

from tests.test_torch_port_models import randomize_bn

t = torch.from_numpy


@pytest.fixture(scope="module")
def zs3_pair():
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="resnet50", compute_dtype="float32", dropout=False),
        gmmn=JaxGMMNConfig(
            embed_dim=32, noise_dim=16, hidden_dim=32, feature_dim=256,
            pixels_per_class=32, mmd_backend="jnp",
        ),
        data=JaxDataConfig(
            dataset="synthetic", crop_size=65, base_size=65, batch_size=4,
            eval_batch_size=8, unseen_classes=(10, 14), num_workers=2,
        ),
    )
    cfg = Config.from_json(jcfg.to_json())
    cfg = cfg.replace(gmmn=dataclasses.replace(cfg.gmmn, mmd_backend="auto"))
    jmodel = jax_build_deeplab(jcfg.model)
    state = create_seg_state(jmodel, jcfg, jax.random.key(0), (1, 65, 65, 3), 1)
    variables = randomize_bn(state.eval_variables(), seed=5)
    model = build_deeplab(cfg.model)
    model.load_state_dict(state_dict_from_flax(variables))
    model.eval()
    train, val, n = make_data_loader(cfg.data)
    return jcfg, cfg, jmodel, variables, model, next(iter(train)), val, n


def _jax_step_reference(jcfg, jmodel, variables, batch, emb, gen_params, cls_params, rng):
    """zs3_tpu's step, run, plus its gradients recomputed with the same
    zs3_tpu functions, and the draws it made."""
    n_cls = 21
    unseen = np.zeros(n_cls, np.float32)
    unseen[list(jcfg.data.unseen_classes)] = 1.0
    generator = jax_build_gmmn(jcfg.gmmn)
    gen_state = jax_gmmn.GenState.create(
        apply_fn=generator.apply, params=gen_params, tx=optax.adam(jcfg.optim.gmmn_lr)
    )
    cls_state = jax_gmmn.ClsState.create(
        apply_fn=None, params=cls_params, tx=optax.adam(jcfg.optim.classifier_lr)
    )
    step = jax_gmmn.make_zs3_step(
        jmodel, generator, jcfg, n_cls, jnp.asarray(unseen), False, donate=False
    )
    new_gen, new_cls, out = step(gen_state, cls_state, variables, emb, batch, rng)

    budget, z = jcfg.gmmn.pixels_per_class, jcfg.gmmn.noise_dim

    @jax.jit
    def recompute(new_gen_params):
        r_sample, r_noise1, r_noise2, _ = jax.random.split(jax.random.fold_in(rng, 0), 4)
        feats = jmodel.apply(variables, batch["image"], train=False, method="forward_features")
        b, h, w, d = feats.shape
        labels = jax_downsample_labels(batch["label"], (h, w)).reshape(-1)
        flat = feats.reshape(-1, d).astype(jnp.float32)
        real, real_mask = jax_sample_class_pixels(flat, labels, n_cls, budget, r_sample)
        u = jax.random.uniform(r_sample, (n_cls, flat.shape[0]), minval=1e-6, maxval=1.0)
        noise1 = jax.random.normal(r_noise1, (n_cls, budget, z))
        noise2 = jax.random.normal(r_noise2, (n_cls, budget, z))
        fm, rm = jax_gmmn.mmd_training_masks(real_mask, 1.0 - unseen, False)
        emb_b = jnp.broadcast_to(emb[:, None], (n_cls, budget, emb.shape[1]))

        def gen_loss(gp):
            fake = generator.apply({"params": gp}, emb_b, noise1)
            return jax_mmd.batched_mmd_loss(fake, real, fm, rm, jcfg.gmmn.mmd_sigmas)

        fake_all = generator.apply({"params": new_gen_params}, emb_b, noise2)
        feats_c, mask_c = jax_gmmn.classifier_training_set(
            real, real_mask, fake_all, unseen, False
        )

        def cls_loss(cp):
            logits = jnp.einsum("cpd,dk->cpk", feats_c, cp["kernel"]) + cp["bias"]
            nll = -jnp.einsum("cpk,ck->cp", jax.nn.log_softmax(logits, -1), jnp.eye(n_cls))
            return jnp.sum(nll * mask_c) / jnp.maximum(jnp.sum(mask_c), 1.0)

        return jax.grad(gen_loss)(gen_params), jax.grad(cls_loss)(cls_params), (u, noise1, noise2)

    gen_grads, cls_grads, draws = recompute(new_gen.params)
    draws = tuple(np.array(a) for a in draws)
    return new_gen.params, new_cls.params, out, gen_grads, cls_grads, draws


def _close_grads(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale, err_msg=name)


def _close_where_signed(got, want, grad, name):
    big = np.abs(grad) > 1e-3 * np.abs(grad).max()
    assert big.mean() > 0.5, name
    np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6, err_msg=name)


def test_zs3_step_and_eval_step_match_jax(zs3_pair):
    jcfg, cfg, jmodel, variables, model, batch, val, n = zs3_pair
    emb = synthetic_class_embeddings(n, cfg.gmmn.embed_dim)
    generator = jax_build_gmmn(jcfg.gmmn)
    gen_params = generator.init(
        jax.random.key(2), jnp.zeros((1, 32)), jnp.zeros((1, 16))
    )["params"]
    cls_params = jax_gmmn.extract_classifier(variables)
    new_gen, new_cls, out, gen_grads, cls_grads, draws = _jax_step_reference(
        jcfg, jmodel, variables, batch, jnp.asarray(emb), gen_params, cls_params,
        jax.random.key(3),
    )

    port_gen = build_gmmn(cfg.gmmn)
    port_gen.load_state_dict(gmmn_state_dict_from_flax(gen_params))
    port_cls = gmmn.extract_classifier(model)
    np.testing.assert_array_equal(port_cls["kernel"].numpy(), np.asarray(cls_params["kernel"]))
    unseen = torch.zeros(n)
    unseen[[10, 14]] = 1.0
    step = gmmn.ZS3Step(model, port_gen, port_cls, t(emb), unseen, cfg, seed=0)
    got = step.body(device_batch(batch, "cpu"), tuple(t(a) for a in draws))
    np.testing.assert_allclose(float(got["mmd"]), float(out["mmd"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["cls_ce"]), float(out["cls_ce"]), rtol=1e-4)
    assert float(got["mmd"]) > 0

    want_g = gmmn_state_dict_from_flax(gen_grads)
    want_p = gmmn_state_dict_from_flax(new_gen)
    for name, p in port_gen.named_parameters():
        g = want_g[name].numpy()
        _close_grads(p.grad.numpy(), g, name)
        _close_where_signed(p.detach().numpy(), want_p[name].numpy(), g, name)
    for name in ("kernel", "bias"):
        g = np.asarray(cls_grads[name])
        _close_grads(step.cls[name].grad.numpy(), g, name)
        _close_where_signed(step.cls[name].detach().numpy(), np.asarray(new_cls[name]), g, name)

    jax_eval = jax_gmmn.make_zs3_eval_step(jmodel, n, 255)
    eval_step = gmmn.make_zs3_eval_step(n, 255)
    for vb in val:
        ref = np.asarray(jax_eval(variables, new_cls, vb)).astype(np.int64)
        conf = eval_step(model, step.cls, device_batch(vb, "cpu")).numpy()
        valid = int((vb["label"] != 255).sum())
        assert conf.sum() == ref.sum() == valid
        moved = np.abs(conf - ref).sum() // 2
        assert moved <= 0.001 * valid, f"{moved} of {valid} pixels differ"


def test_splice_extract_roundtrip(zs3_pair):
    model = zs3_pair[4]
    cls = gmmn.extract_classifier(model)
    assert cls["kernel"].shape == (256, 21)
    new = {"kernel": cls["kernel"] + 1.0, "bias": cls["bias"] - 1.0}
    try:
        out = gmmn.extract_classifier(gmmn.splice_classifier(model, new))
        np.testing.assert_array_equal(out["kernel"].numpy(), new["kernel"].numpy())
        np.testing.assert_array_equal(out["bias"].numpy(), new["bias"].numpy())
    finally:
        gmmn.splice_classifier(model, cls)
