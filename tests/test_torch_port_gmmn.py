"""The modules of the port's ZS3 generator step against zs3_tpu, on the CPU.

Same seeded numpy inputs through both packages:

* K2's and K3's plain versions against zs3_tpu's Pallas kernels run in
  interpret mode and against the jnp oracle: sums to rtol 1e-4, dx and
  dwx to rtol 1e-3 / atol 1e-6 (sums taken in another order, as in
  tests/test_pallas_mmd.py); `KernelSum`'s backward against jax.grad.
* sampling, labels, masks exactly; the generator through the weight
  carrier to 1e-6.
* the train loader's batches byte for byte.
* class embeddings from .npy/.npz/.pkl files exactly as zs3_tpu reads them.
* the `train-gmmn` entry point on the CPU, and the settings it refuses.

The step as a whole is in tests/test_torch_port_zs3.py.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import GMMNConfig as JaxGMMNConfig
from zs3_tpu.data.embeddings import load_class_embeddings as jax_load_class_embeddings
from zs3_tpu.data.loader import make_data_loader as jax_make_data_loader
from zs3_tpu.models.gmmn import build_gmmn as jax_build_gmmn
from zs3_tpu.ops import mmd as jax_mmd
from zs3_tpu.ops.pallas_mmd import _grad_x_impl, _prepare
from zs3_tpu.ops.pallas_mmd import kernel_sum as jax_kernel_sum
from zs3_tpu.ops.sampling import downsample_labels as jax_downsample_labels
from zs3_tpu.ops.sampling import sample_class_pixels as jax_sample_class_pixels
from zs3_tpu.train import gmmn as jax_gmmn
from zs3_tpu.utils.torch_convert import convert_gmmn
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.data.loader import make_data_loader
from zs3_tpu_torch.models.gmmn import GraphContextGMMN, build_gmmn
from zs3_tpu_torch.ops import mmd, mmd_kernels
from zs3_tpu_torch.ops.sampling import downsample_labels, sample_class_pixels
from zs3_tpu_torch.train import gmmn
from zs3_tpu_torch.utils.convert import gmmn_state_dict_from_flax
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

SIGMAS = mmd.DEFAULT_SIGMAS
t = torch.from_numpy


def _masked_pair(rng, c, n, m, d, shift=0.0, scale=1.0):
    x = (rng.standard_normal((c, n, d)) * scale).astype(np.float32)
    y = (rng.standard_normal((c, m, d)) * scale + shift).astype(np.float32)
    wx = (rng.random((c, n)) > 0.3).astype(np.float32)
    wy = (rng.random((c, m)) > 0.3).astype(np.float32)
    return x, y, wx, wy


# ---- K2 / K3 plain versions -------------------------------------------------


@pytest.mark.parametrize("n,m,d", [(50, 70, 16), (128, 128, 128)])
def test_kernel_sum_reference_matches_pallas_and_oracle(n, m, d, rng):
    x, y, wx, wy = _masked_pair(rng, 2, n, m, d, scale=0.5)
    got = mmd_kernels.kernel_sum_reference(t(x), t(y), t(wx), t(wy), SIGMAS).numpy()
    sig = jnp.asarray(SIGMAS, jnp.float32)
    for c in range(2):
        pallas = float(jax_kernel_sum(x[c], y[c], wx[c], wy[c], interpret=True))
        oracle = float(jax_mmd._kernel_sum(x[c], y[c], wx[c], wy[c], sig))
        np.testing.assert_allclose(got[c], pallas, rtol=1e-4)
        np.testing.assert_allclose(got[c], oracle, rtol=1e-4)


def test_kernel_sum_grad_reference_matches_pallas(rng):
    n, m, d = 50, 70, 16
    x, y, wx, wy = _masked_pair(rng, 1, n, m, d, scale=0.5)
    dx, dwx = mmd_kernels.kernel_sum_grad_reference(t(x), t(y), t(wx), t(wy), SIGMAS)
    xp, yp, wxp, wyp = _prepare(x[0], y[0], wx[0], wy[0])
    ref_dx, ref_dwx = _grad_x_impl(xp, yp, wxp, wyp, SIGMAS, True)
    np.testing.assert_allclose(dx[0].numpy(), np.asarray(ref_dx)[:n, :d], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(dwx[0].numpy(), np.asarray(ref_dwx)[0, :n], rtol=1e-3, atol=1e-6)
    dx_only, none = mmd_kernels.kernel_sum_grad_reference(
        t(x), t(y), t(wx), t(wy), SIGMAS, with_dwx=False
    )
    assert none is None
    np.testing.assert_array_equal(dx_only.numpy(), dx.numpy())


@pytest.mark.parametrize("wrt", ["fake", "real"])
def test_kernel_sum_backward_matches_jax_grad(wrt, rng):
    fake = rng.standard_normal((40, 32)).astype(np.float32)
    real = (rng.standard_normal((60, 32)) + 0.5).astype(np.float32)
    fm = np.ones(40, np.float32)
    rm = (rng.random(60) > 0.3).astype(np.float32)
    argnum = 0 if wrt == "fake" else 1
    want = jax.grad(jax_mmd.mmd_loss, argnums=argnum)(fake, real, fm, rm)
    f = t(fake).requires_grad_(wrt == "fake")
    r = t(real).requires_grad_(wrt == "real")
    loss = mmd_kernels.kernel_mmd_loss(f, r, t(fm), t(rm))
    (got,) = torch.autograd.grad(loss, f if wrt == "fake" else r)
    np.testing.assert_allclose(float(loss.detach()), float(jax_mmd.mmd_loss(fake, real, fm, rm)),
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-6)


def test_batched_kernel_mmd_loss_matches_jax(rng):
    c, n, d = 5, 24, 16
    fake, real, fm, rm = _masked_pair(rng, c, n, n, d, shift=0.3)
    rm[1] = 0.0  # a class absent from the batch
    fm[3] = 0.0  # an unseen class
    want_loss, want_grad = jax.value_and_grad(jax_mmd.batched_mmd_loss)(fake, real, fm, rm)
    f = t(fake).requires_grad_(True)
    loss = mmd_kernels.batched_kernel_mmd_loss(f, t(real), t(fm), t(rm))
    (grad,) = torch.autograd.grad(loss, f)
    oracle = mmd.batched_mmd_loss(t(fake), t(real), t(fm), t(rm))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    np.testing.assert_allclose(float(oracle), float(want_loss), rtol=1e-4)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-3, atol=1e-6)
    assert not grad[[1, 3]].any()


def test_kernel_sum_shared_input_backward_is_both_sides(rng):
    """x is y (the fake-fake sum): one K3 for both sides, the same bits as
    the two-sided backward of an equal copy."""
    x, _, wx, _ = (t(a) for a in _masked_pair(rng, 3, 20, 20, 8))
    shared = x.clone().requires_grad_(True)
    w_shared = wx.clone().requires_grad_(True)
    one = mmd_kernels.KernelSum.apply(shared, shared, w_shared, w_shared, SIGMAS)
    one.sum().backward()
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    wa, wb = wx.clone().requires_grad_(True), wx.clone().requires_grad_(True)
    two = mmd_kernels.KernelSum.apply(a, b, wa, wb, SIGMAS)
    two.sum().backward()
    np.testing.assert_array_equal(one.detach().numpy(), two.detach().numpy())
    np.testing.assert_array_equal(shared.grad.numpy(), (a.grad + b.grad).numpy())
    np.testing.assert_array_equal(w_shared.grad.numpy(), (wa.grad + wb.grad).numpy())


def test_empty_masks_give_zero(rng):
    fake = t(rng.standard_normal((16, 8)).astype(np.float32))
    real = t(rng.standard_normal((16, 8)).astype(np.float32))
    assert float(mmd_kernels.kernel_mmd_loss(fake, real, torch.zeros(16), torch.ones(16))) == 0.0
    assert float(mmd.mmd_loss(fake, real, torch.ones(16), torch.zeros(16))) == 0.0
    zeros = torch.zeros(3, 16)
    assert float(mmd_kernels.batched_kernel_mmd_loss(
        fake.expand(3, -1, -1), real.expand(3, -1, -1), zeros, zeros)) == 0.0


def test_kernels_refuse_cpu_tensors_and_count_nothing(rng):
    x, y, wx, wy = (t(a) for a in _masked_pair(rng, 1, 8, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        mmd_kernels.kernel_sum(x, y, wx, wy)
    with pytest.raises(ValueError, match="CUDA"):
        mmd_kernels.kernel_sum_grad(x, y, wx, wy)
    loss = mmd_kernels.batched_kernel_mmd_loss(x.requires_grad_(True), y, wx, wy)
    loss.backward()
    assert mmd_kernels.kernel_sum.launches == 0
    assert mmd_kernels.kernel_sum_grad.launches == 0


# ---- sampling, generator, masks ----------------------------------------------


def test_sample_class_pixels_matches_jax(rng):
    n, d, c, budget = 300, 8, 6, 16
    feats = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    labels[labels == 2] = 255  # class 2 absent, some pixels ignored
    labels[:40] = 4  # class 4 has more pixels than the budget
    key = jax.random.key(7)
    want, want_mask = jax_sample_class_pixels(feats, labels, c, budget, key)
    u = np.array(jax.random.uniform(key, (c, n), minval=1e-6, maxval=1.0))
    got, mask = sample_class_pixels(t(feats), t(labels), c, budget, t(u))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert mask[2].sum() == 0 and mask[4].sum() == budget


def test_downsample_labels_matches_jax(rng):
    labels = rng.integers(0, 21, (2, 65, 65)).astype(np.int32)
    want = np.asarray(jax_downsample_labels(labels, (17, 17)))
    np.testing.assert_array_equal(downsample_labels(t(labels), (17, 17)).numpy(), want)


@pytest.mark.parametrize("num_hidden", [1, 2])
def test_generator_matches_flax(num_hidden, rng):
    jcfg = JaxGMMNConfig(embed_dim=32, noise_dim=16, hidden_dim=32, num_hidden=num_hidden)
    flax_gen = jax_build_gmmn(jcfg)
    params = flax_gen.init(jax.random.key(1), jnp.zeros((1, 32)), jnp.zeros((1, 16)))
    emb = rng.standard_normal((3, 5, 32)).astype(np.float32)
    noise = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = np.asarray(flax_gen.apply(params, emb, noise))
    gen = build_gmmn(gmmn_cfg(jcfg))
    state = gmmn_state_dict_from_flax(params)
    gen.load_state_dict(state)
    got = gen(t(emb), t(noise)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got >= 0).all()
    back = convert_gmmn({k: v.numpy() for k, v in gen.state_dict().items()})
    for layer, leaves in params["params"].items():
        for name, value in leaves.items():
            np.testing.assert_array_equal(back[layer][name], np.asarray(value))


def test_generator_dropout_only_when_asked(rng):
    cfg = dataclasses.replace(Config().gmmn, dropout_rate=0.5)
    gen = build_gmmn(cfg)
    emb = t(rng.standard_normal((4, 300)).astype(np.float32))
    noise = t(rng.standard_normal((4, 300)).astype(np.float32))
    torch.testing.assert_close(gen(emb, noise), gen(emb, noise))
    torch.manual_seed(0)
    assert not torch.equal(gen(emb, noise, deterministic=False), gen(emb, noise))
    assert build_gmmn(Config().gmmn).dropout is None


def gmmn_cfg(jcfg):
    return Config.from_json(JaxConfig(gmmn=jcfg).to_json()).gmmn


def test_graph_context_generator_is_refused():
    """The graph-context generator is built now; what stays refused is
    loading its state into the plain generator, and the plain one's into
    it (evaluate-gmmn without --graph-context on a graph checkpoint)."""
    graph = build_gmmn(dataclasses.replace(Config().gmmn, graph_context=True))
    plain = build_gmmn(Config().gmmn)
    assert isinstance(graph, GraphContextGMMN) and not isinstance(plain, GraphContextGMMN)
    with pytest.raises(RuntimeError, match="graph_embed"):
        plain.load_state_dict(graph.state_dict())
    with pytest.raises(RuntimeError, match="graph_embed"):
        graph.load_state_dict(plain.state_dict())


@pytest.mark.parametrize("self_training", [False, True])
def test_training_masks_and_sets_match_jax(self_training):
    real_mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    seen_f = np.array([1.0, 0.0], np.float32)
    want = jax_gmmn.mmd_training_masks(jnp.asarray(real_mask), jnp.asarray(seen_f), self_training)
    got = gmmn.mmd_training_masks(t(real_mask), t(seen_f), self_training)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    c, p, d = 4, 3, 2
    real = np.arange(c * p * d, dtype=np.float32).reshape(c, p, d)
    fake = -np.ones((c, p, d), np.float32)
    real_mask = np.array([[1, 1, 0], [1, 0, 0], [1, 1, 1], [1, 0, 0]], np.float32)
    unseen = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    want = jax_gmmn.classifier_training_set(real, real_mask, fake, unseen, self_training)
    got = gmmn.classifier_training_set(t(real), t(real_mask), t(fake), t(unseen), self_training)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- train data --------------------------------------------------------------


def test_train_batches_match_jax():
    jdata = JaxDataConfig(
        dataset="synthetic", crop_size=65, base_size=65, unseen_classes=(10, 14),
        num_workers=2,
    )
    train, _, n = make_data_loader(Config.from_json(JaxConfig(data=jdata).to_json()).data)
    jax_train, _, jax_n = jax_make_data_loader(jdata)
    assert n == jax_n == 21 and len(train) == len(jax_train) == 8
    for epoch in (0, 1):
        train.set_epoch(epoch)
        jax_train.set_epoch(epoch)
        for b, (ours, ref) in enumerate(zip(train, jax_train)):
            if b == 2:
                break
            assert ours.keys() == {"image", "label"}
            np.testing.assert_array_equal(ours["image"], ref["image"])
            np.testing.assert_array_equal(ours["label"], ref["label"])
            assert not np.isin(ours["label"], (10, 14)).any()


# ---- entry points --------------------------------------------------------------

TINY = ["--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
        "--backbone", "resnet50", "--compute-dtype", "float32", "--unseen-split", "2",
        "--batch-size", "4", "--eval-batch-size", "8", "--epochs", "1",
        "--steps-per-epoch", "2", "--pixels-per-class", "16"]


def test_cli_train_gmmn_on_cpu(capsys, tmp_path):
    with pytest.warns(UserWarning, match="randomly initialised"):
        assert cli.main(["train-gmmn", *TINY, "--device", "cpu",
                         "--checkpoint-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"mmd", "cls_ce", "seen_miou", "unseen_miou", "harmonic_miou"} <= out.keys()
    assert all(np.isfinite(v) for v in out.values())
    assert out["mmd"] > 0
    assert mmd_kernels.kernel_sum.launches == 0
    assert mmd_kernels.kernel_sum_grad.launches == 0


def test_cli_train_gmmn_no_val(capsys, tmp_path):
    with pytest.warns(UserWarning):
        assert cli.main(["train-gmmn", *TINY, "--no-val", "--device", "cpu",
                         "--checkpoint-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"epoch", "mmd", "cls_ce", "epoch_seconds"}


def test_train_gmmn_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train-gmmn", *TINY])
    with pytest.raises(RuntimeError, match="cuda"):
        gmmn.GMMNTrainer(Config())


def check_int8_trainer(field):
    """GMMNTrainer at 33x33 under `field`: its trunk scales calibrate on
    the val set (the 61 convs of forward_features), validation runs under
    them (its confusion is the eval step's under quant.quantized), and
    with int8_features the step's features are the quantized trunk's."""
    from zs3_tpu_torch import quant
    from zs3_tpu_torch.train.seen import device_batch, select_eval_step

    args = cli.make_parser().parse_args(["train-gmmn", *TINY, "--device", "cpu"])
    cfg = cli.build_config(args)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **{field: True}),
                      data=dataclasses.replace(cfg.data, eval_batch_size=2))
    with pytest.warns(UserWarning):
        trainer = gmmn.GMMNTrainer(cfg, device="cpu")
    scales = trainer.trunk_int8_scales()
    assert len(scales) == 61 and not any("classifier" in k for k in scales)
    batch = device_batch(next(iter(trainer.val_loader)), "cpu")
    want = select_eval_step(trainer.num_classes, 255, cfg.train, scales)(trainer.model, batch)
    assert torch.equal(trainer.eval_fn(trainer.model, trainer.step.cls, batch), want)
    if field == "int8_eval":
        assert trainer.step.int8_scales is None
        return
    assert trainer.step.int8_scales is scales
    with torch.no_grad(), quant.quantized(scales):
        feats = trainer.model.forward_features(batch["image"])
    got, _ = trainer.step.features(batch)
    assert torch.equal(got, feats.reshape(-1, feats.shape[-1]).float())


def check_backbone_trainer(backbone):
    """GMMNTrainer at 33x33 on `backbone`: the trunk is that backbone, and
    the step's features are its DeepLab's 256-d pixel embeddings."""
    from zs3_tpu_torch.train.seen import device_batch

    args = cli.make_parser().parse_args(["train-gmmn", *TINY, "--backbone", backbone])
    with pytest.warns(UserWarning):
        trainer = gmmn.GMMNTrainer(cli.build_config(args), device="cpu")
    assert trainer.model.backbone_name == backbone
    assert type(trainer.model.backbone).__name__ == {
        "mobilenet": "MobileNetV2Backbone", "drn": "DRN54", "xception": "AlignedXception"}[backbone]
    batch = device_batch(next(iter(trainer.train_loader)), "cpu")
    feats, labels = trainer.step.features(batch)
    assert feats.shape == (batch["image"].shape[0] * 9 * 9, 256) == (labels.shape[0], 256)


@pytest.mark.parametrize("change", [
    ("data", "input_pipeline", "tfdata"),  # the pascal and context readers are ported now
    ("train", "int8_features", True),
    ("model", "backbone", "mobilenet"),  # device_preprocess is ported now
    ("train", "int8_eval", True),     # TTA (eval_scales/eval_flip) is ported now
    ("model", "backbone", "drn"),
    ("model", "backbone", "xception"),  # gmmn_resume is ported now
])
def test_trainer_refuses_unported_settings(change):
    """Each setting whose path is not ported raises.  The int8 settings
    and the backbones were among them until the port had quantization and
    the other backbones: their cases now check that the trainer runs them
    (check_int8_trainer, check_backbone_trainer)."""
    node, field, value = change
    if field in ("int8_features", "int8_eval"):
        check_int8_trainer(field)
        return
    if field == "backbone":
        check_backbone_trainer(value)
        return
    cfg = Config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset="synthetic"))
    cfg = cfg.replace(**{node: dataclasses.replace(getattr(cfg, node), **{field: value})})
    with pytest.raises(NotImplementedError, match=field.split("_")[0]):
        gmmn.GMMNTrainer(cfg, device="cpu")


def test_mmd_backend_dispatch():
    for backend in ("auto", "pallas", "jnp"):
        assert gmmn.select_mmd(backend, "cpu") is mmd_kernels.batched_kernel_mmd_loss
    for backend in ("auto", "pallas"):
        assert gmmn.select_mmd(backend, "cuda") is mmd_kernels.batched_kernel_mmd_loss
    with pytest.raises(ValueError, match="K2/K3"):
        gmmn.select_mmd("jnp", torch.device("cuda"))
    with pytest.raises(ValueError):
        gmmn.select_mmd("xla", "cpu")


# ---- class embeddings from files -------------------------------------------------

NAMES = [f"class_{i}" for i in range(21)]


def _embedding_files(tmp_path, rng):
    """(path for --embedding-path) of each file format, 300 features."""
    table = rng.standard_normal((21, 300)).astype(np.float32)
    np.save(tmp_path / "emb.npy", table)
    np.savez(tmp_path / "emb.npz", **dict(zip(NAMES, table)))
    with open(tmp_path / "emb.pkl", "wb") as f:
        pickle.dump(dict(zip(NAMES, table)), f)
    np.save(tmp_path / "left.npy", table[:, :120])
    np.savez(tmp_path / "right.npz", **dict(zip(NAMES, table[:, 120:])))
    return {
        "npy": str(tmp_path / "emb.npy"),
        "npz": str(tmp_path / "emb.npz"),
        "pkl": str(tmp_path / "emb.pkl"),
        "npy,npz": f"{tmp_path / 'left.npy'},{tmp_path / 'right.npz'}",
    }


@pytest.mark.parametrize("kind", ["npy", "npz", "pkl", "npy,npz"])
def test_class_embeddings_match_jax(kind, tmp_path, rng):
    path = _embedding_files(tmp_path, rng)[kind]
    cfg = Config()  # synthetic data names its classes class_<i>
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset="synthetic",
                                               embedding_path=path))
    want = jax_load_class_embeddings(NAMES, path, 300)
    np.testing.assert_array_equal(gmmn.class_embeddings(cfg, 21), want)
    np.testing.assert_allclose(np.linalg.norm(want, axis=1), 1.0, rtol=1e-6)


def test_class_embeddings_refuse_bad_files(tmp_path, rng):
    np.save(tmp_path / "narrow.npy", rng.standard_normal((21, 64)).astype(np.float32))
    np.savez(tmp_path / "few.npz", class_0=np.ones(300, np.float32))
    cfg = Config()
    for name, match in (("narrow.npy", "embed_dim"), ("few.npz", "missing")):
        bad = cfg.replace(
            data=dataclasses.replace(cfg.data, embedding_path=str(tmp_path / name))
        )
        with pytest.raises(ValueError, match=match):
            gmmn.class_embeddings(bad, 21)


def test_cli_train_gmmn_embedding_path(tmp_path, rng):
    path = _embedding_files(tmp_path, rng)["npz"]
    with pytest.warns(UserWarning, match="randomly initialised"):
        result, trainer = cli.run(["train-gmmn", *TINY, "--steps-per-epoch", "1",
                                   "--no-val", "--embedding-path", path, "--device", "cpu",
                                   "--checkpoint-dir", str(tmp_path)])
    np.testing.assert_array_equal(
        trainer.embeddings.numpy(), jax_load_class_embeddings(NAMES, path, 300)
    )
    assert np.isfinite(result["mmd"]) and result["mmd"] > 0
