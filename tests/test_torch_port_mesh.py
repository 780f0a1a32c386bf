"""Data parallelism (zs3_tpu_torch/core/mesh.py) on two gloo ranks on the
CPU, against the one-rank port and zs3_tpu's step on a two-device data
mesh (tests/test_sharding.py, tests/test_mesh.py).

The two ranks are spawned once for the module (torchrun running
tests/torch_port_mesh_worker.py, a 600 s limit on the launch and 300 s
on each collective); the tests assert on what they wrote.  The model is
a DeepLab with a (2, 2, 2, 2) ResNet trunk at 33x33 in f32 (the seen
step tests' pair, tests/test_torch_port_seen.py), global batch 8:

* the seen step (plain, grad_accum 2, device_preprocess with dropout):
  the ranks end bit-equal; the loss within rtol 1e-6 of the one-rank
  step's on the same global batch, parameters within 1e-5, BN running
  statistics within 1e-5 (global statistics: the one-rank run's, up to
  the order of f32 sums).  With grad_accum the microbatches are zs3_tpu's
  mesh step's (each rank's rows cut in two), so the one-rank step is
  given the batch in that order;
* the plain and grad_accum steps against zs3_tpu's on make_mesh((("data",
  2),)) as tests/test_torch_port_seen.py holds one device: loss rtol
  1e-5, parameters within 1e-4 where |g| > 1e-3 max|g|, BN statistics
  within 1e-5;
* the eval confusion of a ragged val set (3 rows, then 1): padded with
  inert rows and summed over the ranks, exactly the one-rank confusion;
* the ZS3 step (plain and graph-context): the generator and classifier
  bit-equal on the ranks, within 1e-6 of the one-rank step's;
* `cli evaluate` under torchrun prints one line, the one-rank result.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs3_tpu.core.mesh import make_mesh as jax_make_mesh
from zs3_tpu.core.mesh import pad_eval_batch as jax_pad_eval_batch
from zs3_tpu.core.mesh import replicate, shard_batch as jax_shard_batch
from zs3_tpu.train import seen as jax_seen
from zs3_tpu.utils import losses as jax_losses
from zs3_tpu_torch.core import mesh
from zs3_tpu_torch.core.config import Config, ModelConfig, TrainConfig
from zs3_tpu_torch.models.gmmn import build_gmmn, init_gmmn
from zs3_tpu_torch.utils.convert import state_dict_from_flax

from tests import torch_port_mesh_worker as worker
from tests.test_torch_port_seen import _batch, _pair
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
GLOBAL_BATCH = 8


def _torchrun(args, timeout=600):
    """`torchrun --standalone --nproc_per_node 2 args` from the repo root,
    one thread a rank; its completed process (check=True)."""
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(RANKS), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def _inputs():
    state, _, model, _ = _pair()
    batch = _batch(seed=10, bsz=GLOBAL_BATCH)
    rng = np.random.default_rng(4)
    uint8 = {"image": torch.from_numpy(rng.integers(0, 256, (GLOBAL_BATCH, 33, 33, 3),
                                                    dtype=np.uint8)),
             "label": torch.from_numpy(batch["label"])}
    val = [{k: torch.from_numpy(v[:3]) for k, v in _batch(seed=11, bsz=4).items()},
           {k: torch.from_numpy(v[:1]) for k, v in _batch(seed=12, bsz=4).items()}]
    return state, {
        "deeplab": {k: v.clone() for k, v in model.state_dict().items()},
        "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
        "uint8_batch": uint8,
        "val": val,
        "embeddings": torch.from_numpy(rng.standard_normal((worker.NUM_CLASSES, 8))
                                       .astype(np.float32)),
        "gen": init_gmmn(build_gmmn(worker.zs3_cfg(False).gmmn), 1).state_dict(),
        "graph_gen": init_gmmn(build_gmmn(worker.zs3_cfg(True).gmmn), 1).state_dict(),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(each rank's results, the inputs, zs3_tpu's initial state)."""
    directory = tmp_path_factory.mktemp("mesh")
    state, inputs = _inputs()
    torch.save(inputs, directory / "inputs.pt")
    _torchrun(["-m", "tests.torch_port_mesh_worker", str(directory)])
    results = [torch.load(directory / f"rank{r}.pt", weights_only=True) for r in range(RANKS)]
    return results, inputs, state


@pytest.fixture(scope="module")
def one_rank(ranks):
    """The one-rank port on the global batches; with grad_accum, on the
    batch in zs3_tpu's mesh microbatch order."""
    _, inputs, _ = ranks
    out = worker.run(inputs, None)
    order = _mesh_micro_order(2)
    permuted = {**inputs, "batch": {k: v[order] for k, v in inputs["batch"].items()}}
    out["accum2"] = worker.seen_step(permuted, "accum2", None)
    return out


def _mesh_micro_order(grad_accum):
    """Global rows in zs3_tpu's mesh microbatch order: microbatch k is
    every rank's k-th sub-chunk of its contiguous rows."""
    per = GLOBAL_BATCH // RANKS
    sub = per // grad_accum
    return [r * per + k * sub + j for k in range(grad_accum) for r in range(RANKS)
            for j in range(sub)]


def _assert_state_close(got, want, atol):
    for name, ref in want.items():
        if ref.is_floating_point():
            np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=0, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("case", sorted(worker.SEEN_CASES))
def test_seen_step_on_two_ranks_is_the_one_rank_step(ranks, one_rank, case):
    results, _, _ = ranks
    a, b = results[0][case], results[1][case]
    assert a["loss"] == b["loss"]
    for name in a["state"]:
        assert torch.equal(a["state"][name], b["state"][name]), name
    want = one_rank[case]
    np.testing.assert_allclose(a["loss"], want["loss"], rtol=1e-6)
    _assert_state_close(a["state"], want["state"], atol=1e-5)
    grads_moved = [n for n in a["grads"] if a["grads"][n].abs().max() > 0]
    assert len(grads_moved) == len(a["grads"])


@pytest.mark.parametrize("case,grad_accum", [("plain", 1), ("accum2", 2)])
def test_seen_step_on_two_ranks_is_zs3_tpus_mesh_step(ranks, case, grad_accum):
    """zs3_tpu's step on two of the eight host devices, the batch sharded
    P("data") and the state replicated (tests/test_sharding.py)."""
    results, inputs, state = ranks
    jmesh = jax_make_mesh((("data", RANKS),), devices=jax.devices()[:RANKS])
    step = jax_seen.make_train_step(jax_losses.build_seg_loss("ce", 255), donate=False,
                                    grad_accum=grad_accum, mesh=jmesh)
    batch = {k: jnp.asarray(v.numpy()) for k, v in inputs["batch"].items()}
    new, out = step(replicate(state, jmesh), jax_shard_batch(batch, jmesh), jax.random.key(3))
    got = results[0][case]
    np.testing.assert_allclose(got["loss"], float(out["loss"]), rtol=1e-5)
    want = state_dict_from_flax({"params": new.params, "batch_stats": new.batch_stats})
    checked = 0
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        value = got["state"][name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value, ref.numpy(), rtol=0, atol=1e-5, err_msg=name)
            continue
        g = got["grads"][name].abs().numpy()
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(value[big], ref.numpy()[big], rtol=0, atol=1e-4,
                                   err_msg=name)
        checked += int(big.sum())
    assert checked > 0


def test_eval_confusion_is_summed_and_padding_is_inert(ranks, one_rank):
    """Both ranks hold the global confusion, equal to the one-rank count
    of every pixel (4 images x 33 x 33, less the ignored ones)."""
    results, inputs, _ = ranks
    for r in range(RANKS):
        assert torch.equal(results[r]["confusion"], one_rank["confusion"])
    labels = np.concatenate([b["label"] for b in inputs["val"]])
    assert int(one_rank["confusion"].sum()) == int((labels != 255).sum())
    # The padding itself: zs3_tpu's inert rows.
    batch = {k: v.numpy() for k, v in inputs["val"][0].items()}
    got = mesh.pad_eval_batch(batch, RANKS)
    want = jax_pad_eval_batch(batch, RANKS)
    for key in ("image", "label"):
        np.testing.assert_array_equal(got[key], want[key])
    assert (got["label"][3] == 255).all() and (got["image"][3] == 0).all()


@pytest.mark.parametrize("case", ["zs3", "zs3_graph"])
def test_zs3_step_on_two_ranks_is_the_one_rank_step(ranks, one_rank, case):
    results, _, _ = ranks
    a, b = results[0][case], results[1][case]
    for part in ("gen", "cls"):
        for name in a[part]:
            assert torch.equal(a[part][name], b[part][name]), (part, name)
        _assert_state_close(a[part], one_rank[case][part], atol=1e-6)
    np.testing.assert_allclose([a["mmd"], a["cls_ce"]],
                               [one_rank[case]["mmd"], one_rank[case]["cls_ce"]], rtol=1e-6)


def test_make_mesh_and_the_config_knobs(ranks):
    """make_mesh's layouts and errors (zs3_tpu's messages), a space axis
    (its indices; no process group of this size, so no space group), and
    the three knobs of zs3_tpu's jit path: mesh_axes wired (the ranks'
    meshes), bn_axis_name None or "data", donate_state True; the rest
    refused."""
    results, _, _ = ranks
    assert [r["mesh"]["rank"] for r in results] == [0, 1]
    assert all(r["mesh"]["shape"] == {"data": 2} for r in results)
    assert all(r["mesh"]["two_level"] == {"dcn": 1, "data": 2} for r in results)
    assert mesh.make_mesh((("dcn", 2), ("data", -1)), world=8, rank=5).shape == {
        "dcn": 2, "data": 4}
    assert mesh.make_mesh(world=8, rank=5).size == 8
    assert mesh.make_mesh().shape == {"data": 1}  # no process group: one rank
    with pytest.raises(ValueError, match="at most one mesh axis"):
        mesh.make_mesh((("a", -1), ("b", -1)), world=2)
    with pytest.raises(ValueError, match="not divisible by fixed axes product 3"):
        mesh.make_mesh((("dcn", 3), ("data", -1)), world=8)
    with pytest.raises(ValueError, match="mesh wants 4 devices, have 2"):
        mesh.make_mesh((("data", 4),), world=2)
    with pytest.raises(ValueError, match="leaves 1 of the 2"):
        mesh.make_mesh((("data", 1),), world=2)
    spatial = mesh.make_mesh((("data", 1), ("space", 2)), world=2, rank=1)
    assert (spatial.data_index, spatial.data_size, spatial.space_index,
            spatial.space_size, spatial.space_group) == (0, 1, 1, 2, None)
    base = Config()
    for bn_axis in (None, "data"):
        cfg = base.replace(model=dataclasses.replace(base.model, bn_axis_name=bn_axis))
        assert mesh.mesh_from_config(cfg).size == 1
    with pytest.raises(ValueError, match="bn_axis_name"):
        mesh.mesh_from_config(base.replace(model=ModelConfig(bn_axis_name="batch")))
    with pytest.raises(ValueError, match="donate_state"):
        mesh.mesh_from_config(base.replace(train=TrainConfig(donate_state=False)))
    with pytest.raises(ValueError, match="mesh wants 2 devices, have 1"):
        mesh.mesh_from_config(base.replace(train=TrainConfig(mesh_axes=(("data", 2),))))


def test_batch_plumbing_errors_match_zs3_tpu():
    """device_batch and bounded_train_batches refuse a train batch that
    does not divide over the ranks with zs3_tpu's message; an eval batch
    is padded instead; shard_batch gives rank r its contiguous rows."""
    two = mesh.make_mesh(world=2, rank=1)
    batch = {"image": np.arange(3 * 2).reshape(3, 2).astype(np.float32),
             "label": np.arange(3).astype(np.int32)}
    msg = "train batch size 3 must be divisible by the data mesh axis \\(2\\)"
    with pytest.raises(ValueError, match=msg):
        mesh.device_batch(batch, two, 255, torch.device("cpu"))
    with pytest.raises(ValueError, match=msg):
        list(mesh.bounded_train_batches([batch], two, 5))
    got = mesh.device_batch(batch, two, 255, torch.device("cpu"), eval=True)
    assert got["label"].tolist() == [2, 255]
    assert mesh.shard_batch({"x": np.arange(8)}, mesh.make_mesh(world=4, rank=2))[
        "x"].tolist() == [4, 5]
    assert mesh.pad_to_multiple(5, 4) == 8


def test_cli_evaluate_under_torchrun_prints_the_one_rank_result(tmp_path):
    """`torchrun --nproc_per_node 2 -m zs3_tpu_torch.cli evaluate`: one
    JSON line (rank 0's), the one-rank evaluate's metrics, and one
    checkpoint directory (rank 0's saver)."""
    args = ["evaluate", "--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
            "--backbone", "resnet50", "--compute-dtype", "float32", "--unseen-split", "2",
            "--eval-batch-size", "3", "--device", "cpu"]
    two = _torchrun(["-m", "zs3_tpu_torch.cli", *args, "--checkpoint-dir",
                     str(tmp_path / "two")])
    lines = [ln for ln in two.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    one = subprocess.run([sys.executable, "-m", "zs3_tpu_torch.cli", *args, "--checkpoint-dir",
                          str(tmp_path / "one")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600, check=True)
    assert json.loads(lines[0]) == json.loads(one.stdout.strip().splitlines()[-1])
    runs = os.listdir(tmp_path / "two" / "synthetic" / "deeplab-resnet101")
    assert runs == ["experiment_0"]
    for run in ("one", "two"):  # the checkpoints: some 200 MB each
        shutil.rmtree(tmp_path / run)
