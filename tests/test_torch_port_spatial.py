"""Spatial sharding (zs3_tpu_torch/parallel/spatial.py) on gloo ranks on
the CPU, against zs3_tpu's parallel/spatial.py on the same mesh of host
devices and against the port's one-rank run.

The ranks are spawned once for the module, 2, 3 and 4 of them at once
(torchrun running tests/torch_port_spatial_worker.py, a 600 s limit on
each launch and 300 s on each collective); the tests assert on what they wrote.  The
model is a DeepLab with a (2, 2, 2, 2) ResNet trunk in f32 with random
BN statistics, its weights carried into zs3_tpu by
zs3_tpu/utils/torch_convert.py::convert_deeplab_state_dict
(tests/test_torch_port_seen.py's pair), images and labels from a numpy
seed:

* the eval forward on ("space", 2) at 64x64 and 66x66 (an uneven 17/16
  split from the os4 grid on), on ("space", 4) at 32x32 (ranks without
  rows from os8 on): within 2e-4 of zs3_tpu's spatially_sharded_forward
  on that mesh (tests/test_torch_port_models.py's tolerance), within
  1e-5 of the port's unsharded forward; forward_features too;
* on ("space", 3) at 129x129 the fused tail (K4's plain version on the
  os4 features gathered whole) and the portable tail, within 1e-5 of the
  unsharded forward;
* Xception-65, MobileNetV2 and DRN-D-54 (os8: the ASPP at dilation 36
  reads rows two ranks away) on ("space", 2): within 1e-5 of their
  unsharded forward; the int8 route within 1e-5 of the unsharded int8
  forward, an f64 QAT step within 1e-8 of the unsharded one (its fake
  quantization runs in f32);
* the train step on ("data", 2) x ("space", 2) against zs3_tpu's
  spatially_sharded_train_step with tests/test_spatial.py's bounds (loss
  1e-5, parameters 5e-3, BN statistics 1e-3) at 64x64; in f64 at 34x34,
  with loss_at="feature" (1e-8: its loss takes f32 logits) and with
  device_preprocess and dropout, within 1e-10 of the port's one-rank
  step (f32 gradients differ by rounding that train-mode BN over the
  few os16 pixels amplifies: 1.5e-5 on the stem after one step at lr
  1e-3); the ranks end bit-equal;
* fetch_rows and its gradient against slicing and autograd of the whole
  level; space-to-batch on a window of rows (H padding 0) against
  F.conv2d;
* the trainers' mesh (mesh_from_config) with a space axis: row-major
  layout, the batch split over data alone, and replicas that add into no
  sum twice (an eval confusion and a seen step on 33x33, global batch
  8, as the one-rank run's, within tests/test_torch_port_mesh.py's
  data-parallel bounds).
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from zs3_tpu.core.mesh import make_mesh as jax_make_mesh
from zs3_tpu.parallel import spatial as jax_spatial
from zs3_tpu.utils import losses as jax_losses
from zs3_tpu_torch import quant
from zs3_tpu_torch.core import mesh
from zs3_tpu_torch.core.config import Config, OptimConfig
from zs3_tpu_torch.models.layers import conv2d_space_to_batch
from zs3_tpu_torch.parallel import spatial
from zs3_tpu_torch.train.seen import make_eval_step, make_train_step, sum_confusion
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils import losses
from zs3_tpu_torch.utils.convert import state_dict_from_flax

from tests import torch_port_spatial_worker as worker
from tests.test_torch_port_models import TinyJaxDeepLab
from tests.test_torch_port_seen import _batch, _pair
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train_batches(rng, hw, suffix=""):
    """{"batch": f32 images and labels (some 255), "uint8_batch": uint8
    images and those labels}, global batch 2, keys with `suffix`."""
    labels = rng.integers(0, worker.NUM_CLASSES, (2, hw, hw)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.1] = 255
    images = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    uint8 = rng.integers(0, 256, (2, hw, hw, 3), dtype=np.uint8)
    return {f"batch{suffix}": {"image": torch.from_numpy(images),
                               "label": torch.from_numpy(labels)},
            f"uint8_batch{suffix}": {"image": torch.from_numpy(uint8),
                                     "label": torch.from_numpy(labels)}}


def _inputs():
    state, _, model, _ = _pair()
    rng = np.random.default_rng(4)
    val = [{k: torch.from_numpy(v[:3]) for k, v in _batch(seed=11, bsz=4).items()},
           {k: torch.from_numpy(v[:1]) for k, v in _batch(seed=12, bsz=4).items()}]
    inputs = {
        "deeplab": {k: v.clone() for k, v in model.state_dict().items()},
        **_train_batches(rng, 64), **_train_batches(rng, 34, "_34"),
        "batch_33": {k: torch.from_numpy(v) for k, v in _batch(seed=10, bsz=8).items()},
        "val": val,
        **{f"images_{hw}": worker.images(hw, seed=hw) for hw in (32, 64, 66, worker.TAIL_HW)},
    }
    return state, inputs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("spatial")
    state, data = _inputs()
    torch.save(data, directory / "inputs.pt")
    return directory, state, data


WORLDS = (2, 3, 4)


@pytest.fixture(scope="module")
def launches(inputs):
    """torchrun of the worker on 2, 3 and 4 ranks at once, one thread a
    rank; world -> each rank's results."""
    directory = inputs[0]
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": "1"}
    procs = {}
    for world in WORLDS:
        out = directory / f"world{world}"
        out.mkdir()
        os.link(directory / "inputs.pt", out / "inputs.pt")
        procs[world] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(world), "-m", "tests.torch_port_spatial_worker", str(out)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    results = {}
    try:
        for world, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            results[world] = [torch.load(directory / f"world{world}" / f"rank{r}.pt",
                                         weights_only=True) for r in range(world)]
    finally:
        for proc in procs.values():
            proc.kill()
        for world in WORLDS:
            shutil.rmtree(directory / f"world{world}", ignore_errors=True)
    return results


@pytest.fixture(scope="module")
def two(launches):
    return launches[2]


@pytest.fixture(scope="module")
def three(launches):
    return launches[3]


@pytest.fixture(scope="module")
def four(launches):
    return launches[4]


def _gathered(ranks, key):
    """The space ranks' blocks of `key` stacked along H."""
    return torch.cat([r[key] for r in ranks], dim=1).numpy()


def _one_rank(model, x, method=None):
    with torch.inference_mode():
        return getattr(model.eval(), method or "forward")(x).numpy()


def _jax_variables(state):
    return {"params": state.params, "batch_stats": state.batch_stats}


@pytest.mark.parametrize("world,hw", [(2, 64), (2, 66), (4, 32)])
def test_forward_matches_zs3_tpu_and_the_unsharded_port(inputs, two, four, world, hw):
    """zs3_tpu's spatially_sharded_forward on make_mesh((("space", S),))
    of S host devices (tests/test_spatial.py's layout), and the port on S
    gloo ranks; rows that split unevenly (66) and ranks without rows
    (32 over 4) included."""
    _, state, data = inputs
    ranks = {2: two, 4: four}[world]
    got = _gathered(ranks, f"r50_{hw}")
    x = data[f"images_{hw}"]
    want = _one_rank(worker.r50(data["deeplab"]), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jmesh = jax_make_mesh((("space", world),), devices=jax.devices()[:world])
    jmodel = TinyJaxDeepLab(backbone="resnet50", num_classes=worker.NUM_CLASSES, dropout=False,
                            dtype=jnp.float32)
    fwd = jax_spatial.spatially_sharded_forward(jmodel, jmesh, data_axis=None)
    xs = jax.device_put(jnp.asarray(x.numpy()), jax_spatial.spatial_batch_sharding(jmesh, None))
    np.testing.assert_allclose(got, np.asarray(fwd(_jax_variables(state), xs)), rtol=0,
                               atol=2e-4)


def test_forward_features_and_layouts(inputs, two):
    """method="forward_features" (the os4 embedding: 17/16 rows at 66x66)
    and the blocks each rank holds."""
    _, _, data = inputs
    assert [tuple(r["r50_66_features"].shape) for r in two] == [(2, 9, 17, 256),
                                                               (2, 8, 17, 256)]
    want = _one_rank(worker.r50(data["deeplab"]), data["images_66"], "forward_features")
    np.testing.assert_allclose(_gathered(two, "r50_66_features"), want, rtol=0, atol=1e-5)
    assert [tuple(r["r50_66"].shape) for r in two] == [(2, 33, 66, 5)] * 2


def test_int8_and_qat_routes_under_sharding(inputs, two):
    """The int8 route (every eligible conv at input absmax 4) on its
    windows of rows, as the one-rank int8 forward; an f64 QAT step (fake
    quantization against the whole level's |x| max) as the one-rank QAT
    step."""
    _, _, data = inputs
    model = worker.r50(data["deeplab"]).eval()
    with quant.quantized(worker.int8_scales(model)):
        want = _one_rank(model, data["images_66"])
    np.testing.assert_allclose(_gathered(two, "r50_66_int8"), want, rtol=0, atol=1e-5)
    assert two[1]["qat_f64"]["digest"] == worker.digest(two[0]["qat_f64"]["state"])
    one = worker.qat_step(data)
    np.testing.assert_allclose(two[0]["qat_f64"]["loss"], one["loss"], rtol=1e-12)
    # Fake quantization runs in f32 (quant.fake_quant_conv_operands), so the
    # straight-through gradients carry f32 roundings (x lr 1e-3).
    _assert_state_close(two[0]["qat_f64"]["state"], one["state"], atol=1e-8)


@pytest.mark.parametrize("case", ["tail_fused", "tail_portable"])
def test_fused_and_portable_tail_on_three_ranks(inputs, three, case):
    """129x129 over 3 ranks (43 rows each; 22/22/21 at os4): the fused
    tail gathers the os4 features whole and keeps its rows of K4's
    logits (the kernel's plain version on the CPU); the portable tail
    resizes its own rows."""
    _, _, data = inputs
    model = worker.r50(data["deeplab"], fused_tail=case == "tail_fused")
    want = _one_rank(model, data[f"images_{worker.TAIL_HW}"])
    assert [tuple(r[case].shape)[1] for r in three] == [43, 43, 43]
    np.testing.assert_allclose(_gathered(three, case), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("backbone", sorted(worker.BACKBONES))
def test_backbones_give_their_unsharded_forward(two, backbone):
    """Xception's strided and dilated depthwise convs (grouped
    space-to-batch from d = 2), MobileNetV2's, DRN's os8 ASPP at d = 12,
    24, 36 (windows that reach past the neighbouring rank's rows)."""
    x = worker.images(worker.BACKBONE_HW, 7, 1)
    want = _one_rank(worker.backbone_model(backbone), x)
    np.testing.assert_allclose(_gathered(two, backbone), want, rtol=0, atol=1e-5)


def _jax_train_step(state, batch, loss_at):
    """zs3_tpu's spatially_sharded_train_step on ("data", 2) x ("space", 2)
    of four host devices (tests/test_spatial.py)."""
    jmesh = jax_make_mesh((("data", 2), ("space", 2)), devices=jax.devices()[:4])
    step = jax_spatial.spatially_sharded_train_step(
        jax_losses.build_seg_loss("ce", 255), jmesh, donate=False, loss_at=loss_at)
    rep = NamedSharding(jmesh, P())
    jbatch = {
        "image": jax.device_put(jnp.asarray(batch["image"].numpy()),
                                jax_spatial.spatial_batch_sharding(jmesh)),
        "label": jax.device_put(jnp.asarray(batch["label"].numpy()),
                                NamedSharding(jmesh, P("data", "space", None))),
    }
    return step(jax.device_put(state, rep), jbatch, jax.random.key(7))


def test_train_step_matches_zs3_tpus_spatial_step(inputs, four):
    _, state, data = inputs
    new, out = _jax_train_step(state, data["batch"], "full")
    got = four[0]["plain"]
    np.testing.assert_allclose(got["loss"], float(out["loss"]), rtol=0, atol=1e-5)
    want = state_dict_from_flax({"params": new.params, "batch_stats": new.batch_stats})
    worst = {"params": 0.0, "stats": 0.0}
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        kind = "stats" if name.endswith(("running_mean", "running_var")) else "params"
        err = float(np.abs(got["state"][name].numpy() - ref.numpy()).max())
        worst[kind] = max(worst[kind], err)
    assert worst["params"] < 5e-3 and worst["stats"] < 1e-3, worst


@pytest.fixture(scope="module")
def one_rank_steps(inputs):
    """The port's unsharded f64 seen step of each f64 case on its global
    batch: case -> (loss, state_dict)."""
    _, _, data = inputs
    out = {}
    for case, (loss_at, preprocess, dropout, dtype) in worker.TRAIN_CASES.items():
        if dtype != torch.float64:
            continue
        model = worker.r50(data["deeplab"], dropout, dtype=dtype)
        optimizer = SegOptimizer(model, Config(optim=OptimConfig(lr=1e-3)), 10)
        step = make_train_step(losses.build_seg_loss("ce", 255), loss_at, 1, seed=0,
                               device_preprocess=preprocess)
        loss = step(model, optimizer, worker.train_batch(data, preprocess, dtype))["loss"]
        out[case] = float(loss), model.state_dict()
    return out


def _assert_state_close(got, want, atol):
    """Parameters within `atol`; BN running statistics within 1e-7: the
    one-rank path's running variance passes through f32
    (models/layers.py::BatchNorm reads native_batch_norm's inverse std)."""
    for name, ref in want.items():
        if ref.is_floating_point():
            stats = name.endswith(("running_mean", "running_var"))
            np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=0,
                                       atol=1e-7 if stats else atol, err_msg=name)


@pytest.mark.parametrize("case", sorted(worker.TRAIN_CASES))
def test_train_step_ranks_agree_and_match_one_rank(four, one_rank_steps, case):
    """The four ranks end bit-equal; in f64, within 1e-10 of the port's
    one-rank step on the global batch (loss_at="feature": the labels
    resized nearest across ranks, the loss in f32 as the logits are, so
    1e-8;
    device_preprocess with dropout: the same flips and masks, drawn for
    the global batch and H)."""
    for r in four[1:]:
        assert r[case]["loss"] == four[0][case]["loss"]
        assert r[case]["digest"] == worker.digest(four[0][case]["state"])
    if case not in one_rank_steps:
        return  # the f32 step: held against zs3_tpu's
    loss, state = one_rank_steps[case]
    # loss_at="feature" takes the loss of f32 logits: its value and the
    # logits' gradient carry f32 roundings (x lr 1e-3 in the parameters).
    f32_loss = worker.TRAIN_CASES[case][0] == "feature"
    np.testing.assert_allclose(four[0][case]["loss"], loss, rtol=1e-6 if f32_loss else 1e-12)
    _assert_state_close(four[0][case]["state"], state, atol=1e-8 if f32_loss else 1e-10)


def test_fetch_rows_and_its_gradient(four):
    """Rows [lo, hi) of a 10-row level over 4 ranks (3/3/2/2), reaching
    two ranks away, past both ends (padded) and empty; the gradient of
    sum(rows * w) on each rank against autograd of the whole level."""
    x, weights = worker.fetch_inputs()
    x = x.clone().requires_grad_(True)
    padded = torch.cat([torch.full((2, 3, 3, 4), worker.FETCH_PAD, dtype=x.dtype), x,
                        torch.full((2, 3, 3, 4), worker.FETCH_PAD, dtype=x.dtype)], 1)
    total = 0
    for r, (lo, hi) in enumerate(worker.FETCH_SPANS):
        rows = padded[:, lo + 3:hi + 3]
        assert torch.equal(four[r]["fetch"]["rows"], rows.detach()), r
        total = total + (rows * weights[r]).sum()
    total.backward()
    got = torch.cat([r["fetch"]["grad"] for r in four], 1)
    torch.testing.assert_close(got, x.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("d,groups", [(2, 8), (12, 1)])
def test_space_to_batch_on_a_window_of_rows(d, groups):
    """A sharded conv's window of rows (H padding 0: valid in H, "same" in
    W) through space-to-batch is the dilated conv's, depthwise from d = 2
    and dense from d = 12, as models/layers.py routes them."""
    gen = torch.Generator().manual_seed(d)
    x = torch.randn((2, 8, 2 * d + 5, 11), generator=gen)
    w = torch.randn((8, 8 // groups, 3, 3), generator=gen)
    want = torch.nn.functional.conv2d(x, w, None, 1, (0, d), d, groups)
    got = conv2d_space_to_batch(x, w, None, d, groups, pad_h=0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_row_split_and_batch_block():
    assert spatial.row_split(66, 2) == [(0, 33), (33, 66)]
    assert spatial.row_split(17, 2) == [(0, 9), (9, 17)]
    assert spatial.row_split(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    block = spatial.spatial_batch_sharding(mesh.make_mesh((("data", 2), ("space", 2)),
                                                          world=4, rank=3))
    x = torch.arange(4 * 6).reshape(4, 6)
    assert block.take(x).tolist() == [[15, 16, 17], [21, 22, 23]]
    with pytest.raises(ValueError, match="does not split over"):
        block.take(torch.zeros(4, 5))
    with pytest.raises(ValueError, match="must split over"):
        spatial.spatial_batch_sharding(mesh.make_mesh((("data", 2), ("space", 2)), world=4),
                                       data_axis=None)
    with pytest.raises(ValueError, match="no space group"):
        spatial.spatially_sharded_forward(
            None, mesh.make_mesh((("space", 2),), world=2))(torch.zeros(1, 4, 4, 3))
    with pytest.raises(ValueError, match="donate=False"):
        spatial.spatially_sharded_train_step(None, mesh.make_mesh(), donate=False)


def test_trainer_mesh_holds_each_data_block_on_its_space_ranks(inputs, four):
    """mesh_from_config with ("data", 2) x ("space", 2): ranks row-major
    (data outer, space inner, as zs3_tpu's reshape), the batch split over
    data alone, and the space replicas of a block counted once: the seen
    step and the eval confusion are the one-rank run's on the global
    batch."""
    _, _, data = inputs
    assert [r["layouts"]["data_space"] for r in four] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["layouts"]["space_data"] for r in four] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    reps = [r["replicas"] for r in four]
    assert all(r["shape"] == {"data": 2, "space": 2} and r["replicas"] for r in reps)
    assert [r["data"] for r in reps] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert [r["space"] for r in reps] == [(0, 2), (1, 2), (0, 2), (1, 2)]
    assert [r["rows"] for r in reps] == [[0, 1, 2, 3]] * 2 + [[4, 5, 6, 7]] * 2
    model = worker.r50(data["deeplab"]).eval()
    eval_step = make_eval_step(worker.NUM_CLASSES)
    confusion = sum_confusion(lambda b: eval_step(model, b), data["val"], worker.NUM_CLASSES,
                              torch.device("cpu"), 255)
    optimizer = SegOptimizer(model, Config(optim=OptimConfig(lr=1e-3)), 10)
    loss = make_train_step(losses.build_seg_loss("ce", 255))(
        model, optimizer, data["batch_33"])["loss"]
    for r in reps:
        assert torch.equal(r["confusion"], confusion)
        assert r["loss"] == reps[0]["loss"]
    for r in reps[1:]:
        assert r["digest"] == worker.digest(reps[0]["state"])
    # tests/test_torch_port_mesh.py's data-parallel bounds
    np.testing.assert_allclose(reps[0]["loss"], float(loss), rtol=1e-6)
    for name, ref in model.state_dict().items():
        if ref.is_floating_point():
            np.testing.assert_allclose(reps[0]["state"][name].numpy(), ref.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
