"""Kernel K4's plain version, the fused-tail DeepLab, ms+flip TTA and the
evaluate paths that honour it, against zs3_tpu on the CPU.

K4's plain version (`classify_resize_reference`) is held against
zs3_tpu's Pallas kernel run in interpret mode at the shapes of
tests/test_pallas_tail.py (f32 to rtol/atol 1e-5, bf16 to its 0.05).
The models are ResNet-50 (or a 2-2-2-2 ResNet) at 33x33 in f32 on
weights carried by `state_dict_from_flax`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.core.config import TrainConfig as JaxTrainConfig
from zs3_tpu.data.loader import make_data_loader
from zs3_tpu.metrics.evaluator import Evaluator as JaxEvaluator
from zs3_tpu.metrics.tta import make_tta_eval_step as jax_make_tta_eval_step
from zs3_tpu.metrics.tta import tta_probs as jax_tta_probs
from zs3_tpu.models.deeplab import build_deeplab as jax_build_deeplab
from zs3_tpu.ops import pallas_tail
from zs3_tpu.train.seen import make_eval_step as jax_make_eval_step
from zs3_tpu.train.state import create_seg_state
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.data.loader import make_val_loader
from zs3_tpu_torch.metrics import tta
from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.ops import tail_kernels
from zs3_tpu_torch.train.seen import device_batch, evaluate, select_eval_step
from zs3_tpu_torch.utils.convert import state_dict_from_flax

from tests.test_torch_port_models import LAYERS, TinyJaxDeepLab, randomize_bn


def _tail_inputs(seed, bsz, hw, c, k, dtype=np.float32):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((bsz, hw, hw, c)).astype(np.float32)
    w = (rng.standard_normal((c, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((k,)) * 0.1).astype(np.float32)
    return feats, w, b


@pytest.mark.parametrize(
    "bsz,hw,c,k",
    [
        (2, 17, 16, 5),    # crop-65 geometry, odd class count
        (1, 9, 8, 21),     # one band and the clamped last row
        (3, 17, 32, 128),  # K = 128
    ],
)
def test_plain_version_matches_pallas_kernel_f32(bsz, hw, c, k):
    feats, w, b = _tail_inputs(0, bsz, hw, c, k)
    size = (4 * (hw - 1) + 1,) * 2
    assert tail_kernels.supported((hw, hw), size, k)
    want = pallas_tail.classify_resize_fused(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(b), size, interpret=True
    )
    got = tail_kernels.classify_resize_reference(
        torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(b), size
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (bsz, *size, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_version_matches_pallas_kernel_bf16():
    """bf16 features: the output stays bf16; tolerance at bf16 grain, as
    tests/test_pallas_tail.py states it (0.05)."""
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 17, 17, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 7)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((7,)) * 0.1).astype(np.float32)
    jfeats, jw = jnp.asarray(feats, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = pallas_tail.classify_resize_fused(
        jfeats, jw, jnp.asarray(b), (65, 65), interpret=True
    )
    tfeats = torch.from_numpy(np.array(jfeats.astype(jnp.float32))).to(torch.bfloat16)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(torch.bfloat16)
    got = tail_kernels.classify_resize_reference(tfeats, tw, torch.from_numpy(b), (65, 65))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=0.05, atol=0.05
    )


@pytest.mark.parametrize(
    "in_hw,out_hw,k",
    [
        ((129, 129), (513, 513), 21),
        ((129, 129), (513, 512), 21),   # not exact 4x
        ((128, 128), (509, 509), 21),   # (h-1) % 8 != 0
        ((129, 129), (513, 513), 129),  # K > 128
        ((5, 5), (17, 17), 21),         # h <= band
    ],
)
def test_supported_matches_zs3_tpu(in_hw, out_hw, k):
    assert tail_kernels.supported(in_hw, out_hw, k) == pallas_tail.supported(in_hw, out_hw, k)


def test_dispatch_takes_the_plain_version_on_cpu():
    feats, w, b = (torch.from_numpy(a) for a in _tail_inputs(2, 1, 9, 8, 3))
    want = tail_kernels.classify_resize_reference(feats, w, b, (33, 33))
    np.testing.assert_array_equal(
        tail_kernels.tail_logits(feats, w, b, (33, 33)).numpy(), want.numpy()
    )
    with pytest.raises(ValueError, match="CUDA"):
        tail_kernels.classify_resize(feats, w, b, (33, 33))
    assert tail_kernels.classify_resize.launches == 0


@pytest.fixture(scope="module")
def tiny_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 33, 33, 3)).astype(np.float32)
    jmodel = TinyJaxDeepLab(num_classes=6, dropout=False, fused_tail=True)
    variables = randomize_bn(jmodel.init(jax.random.key(5), jnp.asarray(x)), seed=6)
    sd = state_dict_from_flax(variables)
    fused = DeepLab(num_classes=6, dropout=False, layers=LAYERS, fused_tail=True)
    standard = DeepLab(num_classes=6, dropout=False, layers=LAYERS)
    fused.load_state_dict(sd)
    standard.load_state_dict(sd)
    return x, jmodel, variables, fused.eval(), standard.eval()


def test_fused_tail_deeplab_matches_zs3_tpu_and_the_standard_tail(tiny_pair):
    """33x33 input -> 9x9 features: the exact-4x geometry, so the fused
    tail is taken (its plain version on the CPU); logits within 5e-3 of
    zs3_tpu's fused-tail model (tests/test_torch_port_models.py's
    tolerance) and within 1e-5 of the port's standard tail."""
    x, jmodel, variables, fused, standard = tiny_pair
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = fused(torch.from_numpy(x)).numpy()
        base = standard(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 33, 33, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999
    np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-5)
    assert tail_kernels.classify_resize.launches == 0


def test_fused_tail_keeps_the_standard_tail_in_training(tiny_pair):
    """Training mode and unsupported geometries take the standard,
    differentiable tail, as zs3_tpu's __call__ does."""
    import copy

    _, _, _, fused, standard = tiny_pair
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 29, 29, 3)))
    with torch.no_grad():  # 29x29 -> 8x8 features: not 8-row bands
        np.testing.assert_array_equal(fused(x.float()).numpy(), standard(x.float()).numpy())
    model = copy.deepcopy(fused).train()  # training updates the BN statistics
    model(torch.ones((2, 33, 33, 3))).square().sum().backward()
    assert model.classifier.weight.grad is not None


def test_tta_probs_match_zs3_tpu(tiny_pair):
    x, jmodel, variables, fused, _ = tiny_pair
    want = jax_tta_probs(
        lambda v, xx: jmodel.apply(v, xx), variables, jnp.asarray(x),
        scales=(0.75, 1.0), flip=True,
    )
    with torch.no_grad():
        got = tta.tta_probs(fused, torch.from_numpy(x), (0.75, 1.0), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def r50_tta(tmp_path_factory):
    """zs3_tpu's R50 (randomized BN) at 33x33 with its weights saved as a
    port state_dict, and a TTA config both packages read."""
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="resnet50", compute_dtype="float32", dropout=False),
        data=JaxDataConfig(
            dataset="synthetic", crop_size=33, base_size=33, eval_batch_size=8,
            unseen_classes=(10, 14), num_workers=1,
        ),
        train=JaxTrainConfig(eval_scales=(0.75, 1.0), eval_flip=True),
    )
    jmodel = jax_build_deeplab(jcfg.model)
    state = create_seg_state(jmodel, jcfg, jax.random.key(0), (1, 33, 33, 3), 1)
    variables = randomize_bn(state.eval_variables(), seed=7)
    path = tmp_path_factory.mktemp("r50") / "r50.pt"
    torch.save(state_dict_from_flax(variables), path)
    cfg = Config.from_json(jcfg.to_json())
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, resume=str(path), checkpoint_dir=str(tmp_path_factory.mktemp("run"))))
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    return jcfg, jmodel, state, variables, cfg


@pytest.fixture(scope="module")
def jax_confusions(r50_tta):
    """(classes, TTA confusions, single-scale confusions) of zs3_tpu over
    the val set."""
    jcfg, jmodel, state, variables, _ = r50_tta
    _, jax_val, n = make_data_loader(jcfg.data)
    jax_tta = jax_make_tta_eval_step(
        lambda v, xx: jmodel.apply(v, xx, train=False), n, 255, (0.75, 1.0), True
    )
    jax_single = jax_make_eval_step(n, 255)
    tta_conf = [np.asarray(jax_tta(variables, b)).astype(np.int64) for b in jax_val]
    single = [np.asarray(jax_single(state, b)).astype(np.int64) for b in jax_val]
    return n, tta_conf, single


def test_evaluate_honours_eval_scales_and_eval_flip(r50_tta, jax_confusions):
    """The port's evaluate runs ms+flip TTA when the config asks for it
    (zs3_tpu/train/seen.py:311-325): its metrics are those of zs3_tpu's
    make_tta_eval_step over the same val batches, which differ from the
    single-scale ones it reported before."""
    jcfg, _, _, _, cfg = r50_tta
    n, tta_conf, single = jax_confusions
    want_eval = JaxEvaluator(n, 255, jcfg.data.unseen_classes)
    single_eval = JaxEvaluator(n, 255, jcfg.data.unseen_classes)
    for a, b in zip(tta_conf, single):
        want_eval.add_confusion(a)
        single_eval.add_confusion(b)
    want = want_eval.compute().as_dict()
    assert want != single_eval.compute().as_dict()
    got = evaluate(cfg, device="cpu")
    assert got.keys() == want.keys() and "harmonic_miou" in got
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-9, key


def test_tta_eval_step_confusions_match_zs3_tpu(r50_tta, jax_confusions):
    """Batch by batch, the TTA step `select_eval_step` gives for that
    config yields zs3_tpu's confusion matrices exactly."""
    _, _, _, _, cfg = r50_tta
    n, tta_conf, _ = jax_confusions
    val, _ = make_val_loader(cfg.data)
    step = select_eval_step(n, 255, cfg.train)
    model = DeepLab(backbone="resnet50", num_classes=n, dropout=False)
    model.load_state_dict(torch.load(cfg.train.resume, weights_only=True))
    model.eval()
    for batch, want in zip(val, tta_conf):
        np.testing.assert_array_equal(step(model, device_batch(batch, "cpu")).numpy(), want)


def test_evaluate_refuses_int8_eval():
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, int8_eval=True))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        evaluate(cfg, device="cpu")


def test_gmmn_trainer_validates_under_tta(r50_tta):
    """GMMNTrainer no longer refuses TTA: its validation runs the TTA step
    on the spliced classifier (zs3_tpu/train/gmmn.py:495-505), whose
    confusion equals the TTA step on the model itself."""
    from zs3_tpu_torch.train.gmmn import GMMNTrainer

    _, _, _, _, cfg = r50_tta
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=4))
    trainer = GMMNTrainer(cfg, device="cpu")
    batch = device_batch(next(iter(trainer.val_loader)), "cpu")
    want = tta.make_tta_eval_step(trainer.num_classes, 255, (0.75, 1.0), True)(
        trainer.model, batch
    )
    got = trainer.eval_fn(trainer.model, trainer.step.cls, batch)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(NotImplementedError, match="int8_eval"):
        GMMNTrainer(cfg.replace(train=dataclasses.replace(cfg.train, int8_eval=True)),
                    device="cpu")
