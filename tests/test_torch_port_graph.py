"""The graph-context generator in the port against zs3_tpu's.

* `class_adjacency` and `per_image_adjacency` exact (255 pixels count
  nothing); `neighbor_lists_from_adjacency` and `generic_context_fallback`
  exact, with ties across the K-th place going to the lower class id as
  `jax.lax.top_k` breaks them; `sample_class_pixels(return_indices=True)`
  exact on injected scores (indices where a slot holds a real pixel).
* `GraphContextGMMN` to rtol 1e-5 after `gmmn_state_dict_from_flax`; it
  ignores masked-out neighbours and follows the mask.
* One graph-context ZS3 step (ResNet-50 at 65x65, f32, the CPU) against
  zs3_tpu's `make_zs3_step` with its draws injected: the per-slot
  neighbour lists exact, mmd and cls_ce to rtol 1e-4, gradients and
  updated params to the tolerances of tests/test_torch_port_zs3.py.
  `check_step_parity` also serves the ZS5 step (tests/test_torch_port_zs5.py).
* `train-gmmn --graph-context`, then `evaluate-gmmn --graph-context
  --gmmn-resume` restores it; the synthetic context-tint acceptance
  ordering (graph >= plain - 0.01 unseen mIoU on the CPU) as a slow test.
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
from zs3_tpu.ops import sampling as jax_sampling
from zs3_tpu.train import gmmn as jax_gmmn
from zs3_tpu.train.state import create_seg_state
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import Config, GMMNConfig
from zs3_tpu_torch.data.loader import make_train_loader
from zs3_tpu_torch.data.synthetic import synthetic_class_embeddings
from zs3_tpu_torch.models.deeplab import build_deeplab
from zs3_tpu_torch.models.gmmn import GraphContextGMMN, build_gmmn
from zs3_tpu_torch.ops import sampling
from zs3_tpu_torch.train import gmmn
from zs3_tpu_torch.train.seen import device_batch
from zs3_tpu_torch.utils.convert import gmmn_state_dict_from_flax, state_dict_from_flax
from zs3_tpu_torch.utils.saver import Saver

from tests.test_torch_port_models import randomize_bn
from tests.test_torch_port_zs3 import _close_grads, _close_where_signed
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

t = torch.from_numpy


def _labels(seed, shape, num_classes, ignore=0.1):
    """Blocky labels (regions, so classes touch) with some 255 pixels."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    coarse = rng.integers(0, num_classes, (b, -(-h // 4), -(-w // 4)))
    labels = coarse.repeat(4, 1).repeat(4, 2)[:, :h, :w].astype(np.int32)
    labels[rng.random(shape) < ignore] = 255
    return labels


@pytest.mark.parametrize("seed,shape,num_classes", [
    (0, (2, 9, 11), 5), (1, (3, 17, 17), 21), (2, (1, 33, 20), 7), (3, (4, 8, 8), 3),
])
def test_adjacency_matches_jax(seed, shape, num_classes):
    labels = _labels(seed, shape, num_classes)
    want_img = np.asarray(jax_sampling.per_image_adjacency(jnp.asarray(labels), num_classes))
    want = np.asarray(jax_sampling.class_adjacency(jnp.asarray(labels), num_classes))
    got_img = sampling.per_image_adjacency(t(labels), num_classes)
    got = sampling.class_adjacency(t(labels), num_classes)
    assert got.dtype == torch.float32 and got_img.shape == (shape[0], num_classes, num_classes)
    np.testing.assert_array_equal(got_img.numpy(), want_img)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0 and np.all(np.diag(want) == 0)


def test_adjacency_ignores_255_and_counts_pairs():
    labels = np.array([[[0, 0, 1], [255, 1, 1], [2, 2, 255]]], np.int32)
    adj = sampling.class_adjacency(t(labels), 3).numpy()
    # 0-1: (0,1)->(0,2) and (0,1)->(1,1); 1-2: (1,1)->(2,1); 255 touches nothing.
    np.testing.assert_array_equal(adj, [[0, 2, 0], [2, 0, 1], [0, 1, 0]])


def _tied_adjacency(seed, c):
    """Symmetric integer counts in 0..3: ties everywhere, at every place."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (c, c)).astype(np.float32)
    a = a + a.T
    np.fill_diagonal(a, 0)
    r = rng.integers(0, c)
    a[r] = a[:, r] = 0  # a class with no neighbour
    return a


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 3, 8])
def test_neighbor_lists_and_fallback_match_jax_with_ties(seed, k):
    c = 9
    adj = _tied_adjacency(seed, c)
    nb, nbm = sampling.neighbor_lists_from_adjacency(t(adj), k)
    want_nb, want_nbm = jax_sampling.neighbor_lists_from_adjacency(jnp.asarray(adj), k)
    assert nb.dtype == torch.int32
    np.testing.assert_array_equal(nb.numpy(), np.asarray(want_nb))
    np.testing.assert_array_equal(nbm.numpy(), np.asarray(want_nbm))
    got = gmmn.generic_context_fallback(nb, nbm, t(adj))
    want = jax_gmmn.generic_context_fallback(want_nb, want_nbm, jnp.asarray(adj))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the same on a batch of graphs (the step's per-image lists)
    batch = np.stack([adj, _tied_adjacency(seed + 10, c)])
    nb_b, nbm_b = sampling.neighbor_lists_from_adjacency(t(batch), k)
    want_b = jax.vmap(lambda a: jax_sampling.neighbor_lists_from_adjacency(a, k))(
        jnp.asarray(batch))
    np.testing.assert_array_equal(nb_b.numpy(), np.asarray(want_b[0]))
    np.testing.assert_array_equal(nbm_b.numpy(), np.asarray(want_b[1]))


def test_neighbor_list_tie_at_the_cutoff_takes_the_lower_id():
    adj = np.zeros((6, 6), np.float32)
    adj[0, [5, 4, 2, 1]] = [7.0, 3.0, 3.0, 3.0]  # three-way tie for places 2-4
    nb, nbm = sampling.neighbor_lists_from_adjacency(t(adj), 3)
    np.testing.assert_array_equal(nb[0].numpy(), [5, 1, 2])
    np.testing.assert_array_equal(nbm[0].numpy(), [1, 1, 1])
    want_nb, _ = jax_sampling.neighbor_lists_from_adjacency(jnp.asarray(adj), 3)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(want_nb))
    # an empty row takes the mass top-k: columns 5, then 1, 2, 4 tie at 3
    fb, fbm = gmmn.generic_context_fallback(nb, nbm, t(adj))
    np.testing.assert_array_equal(fb[3].numpy(), [5, 1, 2])
    np.testing.assert_array_equal(fb[0].numpy(), nb[0].numpy())


@pytest.mark.parametrize("seed", range(3))
def test_sample_class_pixels_indices_match_jax(seed):
    rng = np.random.default_rng(seed)
    c, n, d, budget = 6, 300, 4, 16
    feats = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, c + 1, n).astype(np.int32)
    labels[labels == c] = 255
    labels[labels == 3] = 0  # class 3 has no pixel
    key = jax.random.key(seed)
    want_g, want_m, want_i = jax_sampling.sample_class_pixels(
        jnp.asarray(feats), jnp.asarray(labels), c, budget, key, return_indices=True)
    u = np.asarray(jax.random.uniform(key, (c, n), minval=1e-6, maxval=1.0))
    got_g, got_m, got_i = sampling.sample_class_pixels(
        t(feats), t(labels), c, budget, t(u), return_indices=True)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    real = np.asarray(want_m) > 0
    assert real.any() and not real.all()
    np.testing.assert_array_equal(got_i.numpy()[real], np.asarray(want_i)[real])
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    two = sampling.sample_class_pixels(t(feats), t(labels), c, budget, t(u))
    assert len(two) == 2 and torch.equal(two[0], got_g)


def _graph_pair(seed=0, e=12, z=6, k=4, ctx=10, hidden=16):
    jcfg = JaxGMMNConfig(embed_dim=e, noise_dim=z, hidden_dim=hidden, feature_dim=8,
                         graph_context=True, graph_hidden_dim=ctx, max_graph_neighbors=k)
    jgen = jax_build_gmmn(jcfg)
    params = jgen.init(jax.random.key(seed), jnp.zeros((1, e)), jnp.zeros((1, z)),
                       jnp.zeros((1, k, e)), jnp.zeros((1, k)))["params"]
    cfg = GMMNConfig(**dataclasses.asdict(jcfg))
    gen = build_gmmn(cfg)
    gen.load_state_dict(gmmn_state_dict_from_flax(params))
    return jgen, params, gen


def test_graph_generator_matches_jax_after_conversion():
    jgen, params, gen = _graph_pair()
    assert isinstance(gen, GraphContextGMMN)
    assert isinstance(build_gmmn(GMMNConfig(graph_context=True)), GraphContextGMMN)
    assert set(gen.state_dict()) == {"graph_embed.weight", "graph_embed.bias", "hidden0.weight",
                                     "hidden0.bias", "out.weight", "out.bias"}
    assert gen.graph_embed.weight.shape == (10, 12) and gen.hidden0.in_features == 12 + 6 + 10
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((3, 5, 12)).astype(np.float32)
    noise = rng.standard_normal((3, 5, 6)).astype(np.float32)
    nbs = rng.standard_normal((3, 5, 4, 12)).astype(np.float32)
    mask = (rng.random((3, 5, 4)) < 0.6).astype(np.float32)
    mask[0, 0] = 0.0  # an empty list: zero context
    want = np.asarray(jgen.apply({"params": params}, emb, noise, nbs, mask))
    got = gen(t(emb), t(noise), t(nbs), t(mask)).detach().numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_graph_generator_ignores_masked_neighbors_and_follows_the_mask():
    _, _, gen = _graph_pair(seed=3)
    rng = np.random.default_rng(2)
    emb = t(rng.standard_normal((7, 12)).astype(np.float32))
    noise = t(rng.standard_normal((7, 6)).astype(np.float32))
    nbs = t(rng.standard_normal((7, 4, 12)).astype(np.float32))
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0]).expand(7, 4)
    out = gen(emb, noise, nbs, mask)
    other = nbs.clone()
    other[:, 2:] = 100.0 * torch.randn(7, 2, 12)  # masked-out slots
    assert torch.allclose(gen(emb, noise, other, mask), out, rtol=0, atol=1e-6)
    assert not torch.allclose(gen(emb, noise, nbs, torch.ones(7, 4)), out)
    changed = nbs.clone()
    changed[:, 0] += 1.0  # a live neighbour
    assert not torch.allclose(gen(emb, noise, changed, mask), out)


# --------------------------------------------------------------------------
# One step against zs3_tpu's make_zs3_step


def step_configs(graph: bool, self_training: bool, weak_label_dir=None):
    """(zs3_tpu config, port config) of the step parity tests: ResNet-50
    at 65x65 in f32, 21 classes, unseen (10, 14), 32 pixels per class."""
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="resnet50", compute_dtype="float32", dropout=False),
        gmmn=JaxGMMNConfig(
            embed_dim=32, noise_dim=16, hidden_dim=32, feature_dim=256,
            pixels_per_class=32, mmd_backend="jnp", graph_context=graph,
            graph_hidden_dim=24, max_graph_neighbors=4, self_training=self_training,
        ),
        data=JaxDataConfig(
            dataset="synthetic", crop_size=65, base_size=65, batch_size=4,
            eval_batch_size=8, unseen_classes=(10, 14), num_workers=2,
            weak_label_dir=weak_label_dir,
        ),
    )
    cfg = Config.from_json(jcfg.to_json())
    return jcfg, cfg.replace(gmmn=dataclasses.replace(cfg.gmmn, mmd_backend="auto"))


def _jax_context(batch_labels, pix_idx, real_mask, grid_pixels, n_cls, k):
    """zs3_tpu's graph branch of make_zs3_step, on its own functions."""
    adj_img = jax_sampling.per_image_adjacency(batch_labels, n_cls)
    nb_img, nbm_img = jax.vmap(
        lambda a: jax_sampling.neighbor_lists_from_adjacency(a, k))(adj_img)
    img_ids = pix_idx // grid_pixels
    nb_pix = jax.vmap(lambda nb, ids: nb[ids])(nb_img.transpose(1, 0, 2), img_ids)
    nbm_pix = jax.vmap(lambda m, ids: m[ids])(nbm_img.transpose(1, 0, 2), img_ids)
    adj_b = jax_sampling.class_adjacency(batch_labels, n_cls)
    nb_b, nbm_b = jax_gmmn.generic_context_fallback(
        *jax_sampling.neighbor_lists_from_adjacency(adj_b, k), adj_b)
    has = real_mask[..., None] > 0
    return jnp.where(has, nb_pix, nb_b[:, None]), jnp.where(has, nbm_pix, nbm_b[:, None])


def _jax_step_reference(jcfg, jmodel, variables, batch, emb, gen_params, cls_params, rng):
    """zs3_tpu's step, run; its gradients recomputed with the same zs3_tpu
    functions; its draws and (under graph context) neighbour lists."""
    n_cls = 21
    graph, st = jcfg.gmmn.graph_context, jcfg.gmmn.self_training
    unseen = np.zeros(n_cls, np.float32)
    unseen[list(jcfg.data.unseen_classes)] = 1.0
    generator = jax_build_gmmn(jcfg.gmmn)
    gen_state = jax_gmmn.GenState.create(
        apply_fn=generator.apply, params=gen_params, tx=optax.adam(jcfg.optim.gmmn_lr))
    cls_state = jax_gmmn.ClsState.create(
        apply_fn=None, params=cls_params, tx=optax.adam(jcfg.optim.classifier_lr))
    step = jax_gmmn.make_zs3_step(jmodel, generator, jcfg, n_cls, jnp.asarray(unseen), graph,
                                  donate=False)
    new_gen, new_cls, out = step(gen_state, cls_state, variables, emb, batch, rng)
    budget, z, k = jcfg.gmmn.pixels_per_class, jcfg.gmmn.noise_dim, jcfg.gmmn.max_graph_neighbors

    @jax.jit
    def recompute(new_gen_params):
        r_sample, r_noise1, r_noise2, _ = jax.random.split(jax.random.fold_in(rng, 0), 4)
        feats = jmodel.apply(variables, batch["image"], train=False, method="forward_features")
        b, h, w, d = feats.shape
        labels = jax_sampling.downsample_labels(batch["label"], (h, w)).reshape(-1)
        flat = feats.reshape(-1, d).astype(jnp.float32)
        real, real_mask, idx = jax_sampling.sample_class_pixels(
            flat, labels, n_cls, budget, r_sample, return_indices=True)
        u = jax.random.uniform(r_sample, (n_cls, flat.shape[0]), minval=1e-6, maxval=1.0)
        noise1 = jax.random.normal(r_noise1, (n_cls, budget, z))
        noise2 = jax.random.normal(r_noise2, (n_cls, budget, z))
        fm, rm = jax_gmmn.mmd_training_masks(real_mask, 1.0 - unseen, st)
        emb_b = jnp.broadcast_to(emb[:, None], (n_cls, budget, emb.shape[1]))
        if graph:
            nb, nbm = _jax_context(batch["label"], idx, real_mask, h * w, n_cls, k)
        else:
            nb = nbm = jnp.zeros((n_cls, budget, k))

        def apply(gp, noise):
            if graph:
                return generator.apply({"params": gp}, emb_b, noise, emb[nb], nbm)
            return generator.apply({"params": gp}, emb_b, noise)

        def gen_loss(gp):
            return jax_mmd.batched_mmd_loss(apply(gp, noise1), real, fm, rm, jcfg.gmmn.mmd_sigmas)

        feats_c, mask_c = jax_gmmn.classifier_training_set(
            real, real_mask, apply(new_gen_params, noise2), unseen, st)

        def cls_loss(cp):
            logits = jnp.einsum("cpd,dk->cpk", feats_c, cp["kernel"]) + cp["bias"]
            nll = -jnp.einsum("cpk,ck->cp", jax.nn.log_softmax(logits, -1), jnp.eye(n_cls))
            return jnp.sum(nll * mask_c) / jnp.maximum(jnp.sum(mask_c), 1.0)

        return (jax.grad(gen_loss)(gen_params), jax.grad(cls_loss)(cls_params),
                (u, noise1, noise2), (nb, nbm))

    gen_grads, cls_grads, draws, context = recompute(new_gen.params)
    draws = tuple(np.array(a) for a in draws)
    return new_gen.params, new_cls.params, out, gen_grads, cls_grads, draws, context


def check_step_parity(jcfg, cfg, seed=0):
    """One step of the port (`ZS3Step.body` with zs3_tpu's draws) against
    zs3_tpu's on the same weights and batch; returns the port's step."""
    graph = jcfg.gmmn.graph_context
    jmodel = jax_build_deeplab(jcfg.model)
    state = create_seg_state(jmodel, jcfg, jax.random.key(seed), (1, 65, 65, 3), 1)
    variables = randomize_bn(state.eval_variables(), seed=5)
    model = build_deeplab(cfg.model)
    model.load_state_dict(state_dict_from_flax(variables))
    model.eval()
    loader, n = make_train_loader(cfg.data)
    batch = next(iter(loader))
    emb = synthetic_class_embeddings(n, cfg.gmmn.embed_dim)
    generator = jax_build_gmmn(jcfg.gmmn)
    e, z, k = 32, 16, jcfg.gmmn.max_graph_neighbors
    init_args = [jnp.zeros((1, e)), jnp.zeros((1, z))]
    if graph:
        init_args += [jnp.zeros((1, k, e)), jnp.zeros((1, k))]
    gen_params = generator.init(jax.random.key(2), *init_args)["params"]
    cls_params = jax_gmmn.extract_classifier(variables)
    new_gen, new_cls, out, gen_grads, cls_grads, draws, context = _jax_step_reference(
        jcfg, jmodel, variables, batch, jnp.asarray(emb), gen_params, cls_params,
        jax.random.key(3))

    port_gen = build_gmmn(cfg.gmmn)
    assert isinstance(port_gen, GraphContextGMMN) == graph
    port_gen.load_state_dict(gmmn_state_dict_from_flax(gen_params))
    unseen = torch.zeros(n)
    unseen[[10, 14]] = 1.0
    step = gmmn.ZS3Step(model, port_gen, gmmn.extract_classifier(model), t(emb), unseen, cfg,
                        seed=0)
    tb = device_batch(batch, "cpu")
    if graph:  # the per-slot neighbour lists, exactly
        _, labels = step.features(tb)
        _, real_mask, idx = step.sample(torch.zeros(labels.shape[0], 1), labels, t(draws[0]),
                                        return_indices=True)
        nb, nbm = step.context(tb["label"], idx, real_mask, labels.shape[0] // tb["label"].shape[0])
        assert nb.shape == (n, 32, k)
        np.testing.assert_array_equal(nb.numpy(), np.asarray(context[0]))
        np.testing.assert_array_equal(nbm.numpy(), np.asarray(context[1]))
        assert 0 < float(nbm.mean()) < 1
    got = step.body(tb, tuple(t(a) for a in draws))
    np.testing.assert_allclose(float(got["mmd"]), float(out["mmd"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["cls_ce"]), float(out["cls_ce"]), rtol=1e-4)
    assert float(got["mmd"]) > 0

    want_g = gmmn_state_dict_from_flax(gen_grads)
    want_p = gmmn_state_dict_from_flax(new_gen)
    assert set(want_g) == {name for name, _ in port_gen.named_parameters()}
    for name, p in port_gen.named_parameters():
        g = want_g[name].numpy()
        _close_grads(p.grad.numpy(), g, name)
        _close_where_signed(p.detach().numpy(), want_p[name].numpy(), g, name)
    for name in ("kernel", "bias"):
        g = np.asarray(cls_grads[name])
        _close_grads(step.cls[name].grad.numpy(), g, name)
        _close_where_signed(step.cls[name].detach().numpy(), np.asarray(new_cls[name]), g, name)
    return step


def test_graph_context_step_matches_jax():
    check_step_parity(*step_configs(graph=True, self_training=False))


# --------------------------------------------------------------------------
# The CLI

EVAL_TINY = ["--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
             "--backbone", "resnet50", "--compute-dtype", "float32", "--unseen-split", "2",
             "--batch-size", "4", "--eval-batch-size", "8", "--pixels-per-class", "16",
             "--device", "cpu"]
TINY = [*EVAL_TINY, "--epochs", "1", "--steps-per-epoch", "2"]


def small_config(directory) -> list:
    """["--config", path] of a JSON config with 16 synthetic train images
    and one loader thread: the CLI tests' runs stay short."""
    cfg = Config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, synthetic_items=16, num_workers=1))
    path = directory / "small.json"
    path.write_text(cfg.to_json())
    return ["--config", str(path)]


def test_cli_graph_context_train_then_evaluate_restores(tmp_path):
    """(evaluate-gmmn without --graph-context refuses the checkpoint:
    test_graph_context_generator_is_refused.)"""
    ck = ["--checkpoint-dir", str(tmp_path), "--checkname", "g", *small_config(tmp_path)]
    with pytest.warns(UserWarning, match="randomly initialised"):
        result, trainer = cli.run(["train-gmmn", *TINY, *ck, "--graph-context"])
    assert isinstance(trainer.generator, GraphContextGMMN)
    assert np.isfinite(result["mmd"]) and "harmonic_miou" in result
    ckpt = Saver.latest_checkpoint(trainer.saver.directory)
    assert "-gmmn" in ckpt
    with pytest.warns(UserWarning, match="randomly initialised"):
        again, restored = cli.run(["evaluate-gmmn", *EVAL_TINY, *ck, "--graph-context",
                                   "--gmmn-resume", ckpt])
    assert isinstance(restored.generator, GraphContextGMMN) and restored.global_step == 2
    for key, value in trainer.generator.state_dict().items():
        assert torch.equal(restored.generator.state_dict()[key], value), key
    for key, value in trainer.step.cls.items():
        assert torch.equal(restored.step.cls[key], value), key
    assert again["harmonic_miou"] == pytest.approx(result["harmonic_miou"], abs=1e-6)


@pytest.mark.slow
def test_graph_context_transfer_on_context_data(tmp_path):
    """The ordering of tests/test_graph_context_acceptance.py at its CPU
    bar: on one seen trunk, then the graph and plain generators from the
    same seed, graph-context unseen mIoU >= plain - 0.01.  zs3_tpu's
    absolute unseen bars are not carried over: they hold for its random
    streams, and the port's transfer moves with the seen trunk it trains
    from its own."""
    from zs3_tpu_torch.core.config import DataConfig, ModelConfig, OptimConfig, TrainConfig
    from zs3_tpu_torch.train.seen import SeenTrainer

    cfg = Config(
        model=ModelConfig(backbone="resnet50", num_classes=10, compute_dtype="float32",
                          dropout=False),
        gmmn=GMMNConfig(embed_dim=8, noise_dim=8, hidden_dim=128, pixels_per_class=64,
                        max_graph_neighbors=4, graph_context=True),
        data=DataConfig(dataset="synthetic", crop_size=49, base_size=49, batch_size=8,
                        eval_batch_size=8, unseen_classes=(3, 5), synthetic_classes=10,
                        synthetic_items=32, synthetic_embed_dim=8, synthetic_tint_weight=1.0,
                        synthetic_context_tint=0.35),
        optim=OptimConfig(lr=0.02, gmmn_lr=1e-3, classifier_lr=1e-2),
        train=TrainConfig(epochs=40, eval_interval=10**9, checkpoint_dir=str(tmp_path / "run"),
                          keep_checkpoints=1),
    )
    seen = SeenTrainer(cfg, device="cpu")
    for e in range(cfg.train.epochs):
        seen.train_epoch(e)
    seen_report = seen.validate(cfg.train.epochs - 1)
    assert seen_report["seen_miou"] > 0.15, seen_report
    trunk = Saver.latest_checkpoint(seen.saver.directory)
    reports = {}
    for variant in ("graph", "plain"):
        gcfg = cfg.replace(
            train=dataclasses.replace(cfg.train, epochs=90, resume=trunk),
            gmmn=dataclasses.replace(cfg.gmmn, graph_context=(variant == "graph")),
        )
        trainer = gmmn.GMMNTrainer(gcfg, device="cpu")
        for e in range(gcfg.train.epochs):
            trainer.train_epoch(e)
        reports[variant] = trainer.validate(gcfg.train.epochs - 1)
    assert all(np.isfinite(r["miou"]) for r in reports.values()), reports
    assert reports["graph"]["unseen_miou"] > reports["plain"]["unseen_miou"] - 0.01, reports
