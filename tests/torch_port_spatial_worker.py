"""One rank of tests/test_torch_port_spatial.py's spatially sharded runs.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m tests.torch_port_spatial_worker DIR

Each rank joins the gloo group torchrun describes (300 s collective
timeout), reads the inputs the test wrote to DIR/inputs.pt (a DeepLab with
a (2, 2, 2, 2) ResNet trunk, its images and train batches) and runs, by
the world size N:

  * 2: ("space", 2): the DeepLab's forward at 64x64 and 66x66 (33 rows
    at the stem, then 17/16), at 66x66 through the int8 route too, one
    forward each of Xception-65, MobileNetV2 (os16) and DRN-D-54 (os8, the
    ASPP at d = 36) at 34x34, and an f64 QAT train step at 34x34;
  * 3: ("space", 3): the forward at 129x129 with the fused tail (K4's
    plain version on the features gathered whole) and without it;
  * 4: ("space", 4): the forward at 32x32 (ranks without rows from os8
    on), and fetch_rows with its gradient on spans that reach past the
    neighbours and outside the image; ("data", 2) x ("space", 2): the
    train step (plain in f32; loss_at="feature" and device_preprocess
    with dropout in f64); the trainers' mesh (mesh_from_config) on that
    layout: its indices, its batch split over data alone, an eval
    confusion and a replica train step at 33x33, global batch 8.

It writes what came out to DIR/rank<r>.pt (the trained states on rank 0,
their digests on the others).  Imports no JAX.
"""

import datetime
import hashlib
import sys

import numpy as np
import torch

from zs3_tpu_torch.core.config import Config, OptimConfig, TrainConfig
from zs3_tpu_torch.core.mesh import (
    init_data_parallel, make_mesh, mesh_from_config, shard_batch,
)
from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
from zs3_tpu_torch import quant
from zs3_tpu_torch.models.layers import BatchNorm, Conv
from zs3_tpu_torch.parallel import spatial
from zs3_tpu_torch.train.seen import make_eval_step, make_train_step, sum_confusion
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils import losses

LAYERS = (2, 2, 2, 2)
NUM_CLASSES = 5
FORWARDS = {2: (64, 66), 3: (), 4: (32,)}  # world size -> the R50 forwards' sizes
BACKBONES = {"xception": 16, "mobilenet": 16, "drn": 8}  # backbone -> output stride
BACKBONE_HW = 34
TAIL_HW = 129  # 4 * (33 - 1) + 1: K4's exact 4x geometry, 43 rows a rank
# case -> (loss_at, device_preprocess, dropout, dtype): f32 at 64x64 against
# zs3_tpu's step; f64 at 34x34 (17/17 rows, 5/4 at os4, 2/1 at os16) against
# the port's one-rank step, whose f32 gradients differ by rounding that
# train-mode BN over the few os16 pixels amplifies.
TRAIN_CASES = {"plain": ("full", False, False, torch.float32),
               "feature_f64": ("feature", False, False, torch.float64),
               "preprocess_dropout_f64": ("full", True, True, torch.float64)}
FETCH_HEIGHT = 10  # 3/3/2/2 rows over 4 ranks
FETCH_SPANS = [(-3, 5), (0, 10), (6, 13), (4, 4)]
FETCH_PAD = -1.5


def r50(state_dict, dropout=False, fused_tail=False, dtype=torch.float32) -> DeepLab:
    model = DeepLab(backbone="resnet50", num_classes=NUM_CLASSES, dropout=dropout,
                    layers=LAYERS, fused_tail=fused_tail, dtype=dtype)
    model.load_state_dict(state_dict)
    return model.to(dtype)


def backbone_model(name: str) -> DeepLab:
    """A full-depth DeepLab on `name`, seeded, with random BN statistics."""
    model = init_deeplab(DeepLab(backbone=name, output_stride=BACKBONES[name],
                                 num_classes=NUM_CLASSES, dropout=False), 0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
    return model.eval()


def images(hw: int, seed: int, n: int = 2) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 3)).astype(np.float32))


def fetch_inputs():
    """(the level's global rows, each rank's output weights): f64."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, FETCH_HEIGHT, 3, 4), generator=gen, dtype=torch.float64)
    weights = [torch.randn((2, hi - lo, 3, 4), generator=gen, dtype=torch.float64)
               for lo, hi in FETCH_SPANS]
    return x, weights


def forward(model, mesh, x, method=None):
    """This rank's block of the sharded forward of the global batch x."""
    block = spatial.spatial_batch_sharding(mesh, data_axis=None)
    return spatial.spatially_sharded_forward(model, mesh, data_axis=None,
                                             method=method)(block.take(x)).clone()


def train_batch(inputs, preprocess: bool, dtype) -> dict:
    """The global batch of a train case: 64x64 in f32, 34x34 in f64."""
    size = "" if dtype == torch.float32 else "_34"
    return inputs[("uint8_batch" if preprocess else "batch") + size]


def state_or_digest(model, rank: int) -> dict:
    """{"state": the state_dict} on rank 0, {"digest": its sha256} on the
    others (the ranks must end bit-equal; one copy is compared)."""
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if rank == 0:
        return {"state": state}
    return {"digest": digest(state)}


def digest(state: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def train_step(inputs, case, mesh):
    """One sharded seen train step of `case`: (loss, state_dict)."""
    loss_at, preprocess, dropout, dtype = TRAIN_CASES[case]
    model = r50(inputs["deeplab"], dropout, dtype=dtype)
    optimizer = SegOptimizer(model, Config(optim=OptimConfig(lr=1e-3)), 10)
    step = spatial.spatially_sharded_train_step(
        losses.build_seg_loss("ce", 255, mesh=mesh), mesh, device_preprocess=preprocess,
        loss_at=loss_at)
    block = spatial.spatial_batch_sharding(mesh)
    batch = train_batch(inputs, preprocess, dtype)
    out = step(model, optimizer, {k: block.take(v) for k, v in batch.items()})
    return {"loss": float(out["loss"]), **state_or_digest(model, mesh.rank)}


def int8_scales(model) -> dict:
    """An input absmax of 4 for every conv the int8 route takes."""
    return {name: 4.0 for name, m in model.named_modules()
            if isinstance(m, Conv) and quant.quantizable(m)}


def qat_step(inputs, mesh=None):
    """One f64 QAT seen step (fake-quantized conv operands) on the 34x34
    batch: sharded over `mesh`'s space ranks, unsharded without one."""
    model = r50(inputs["deeplab"], dtype=torch.float64)
    optimizer = SegOptimizer(model, Config(optim=OptimConfig(lr=1e-3)), 10)
    batch = inputs["batch_34"]
    if mesh is not None:
        block = spatial.spatial_batch_sharding(mesh, data_axis=None)
        batch = {k: block.take(v) for k, v in batch.items()}
    step = make_train_step(losses.build_seg_loss("ce", 255, mesh=mesh), qat=True, mesh=mesh)
    out = step(model, optimizer, batch)
    return {"loss": float(out["loss"]),
            **state_or_digest(model, 0 if mesh is None else mesh.rank)}


def replicas(inputs):
    """The trainers' mesh on ("data", 2) x ("space", 2): its indices, the
    rows shard_batch gives it, the eval confusion of the val batches, then
    a seen step."""
    cfg = Config(optim=OptimConfig(lr=1e-3),
                 train=TrainConfig(mesh_axes=(("data", 2), ("space", 2))))
    mesh = mesh_from_config(cfg)
    model = r50(inputs["deeplab"]).eval()
    eval_step = make_eval_step(NUM_CLASSES)
    confusion = sum_confusion(lambda b: eval_step(model, b), inputs["val"], NUM_CLASSES,
                              torch.device("cpu"), 255, mesh)
    optimizer = SegOptimizer(model, cfg, 10)
    step = make_train_step(losses.build_seg_loss("ce", 255, mesh=mesh), mesh=mesh)
    out = step(model, optimizer, shard_batch(inputs["batch_33"], mesh))
    return {"shape": mesh.shape, "replicas": mesh.space_replicas,
            "data": (mesh.data_index, mesh.data_size),
            "space": (mesh.space_index, mesh.space_size),
            "rows": shard_batch({"x": np.arange(8)}, mesh)["x"].tolist(),
            "loss": float(out["loss"]), **state_or_digest(model, mesh.rank),
            "confusion": confusion}


def run(inputs, world: int) -> dict:
    out = {}
    space = make_mesh((("space", world),))
    model = r50(inputs["deeplab"]).eval()
    for hw in FORWARDS[world]:
        out[f"r50_{hw}"] = forward(model, space, inputs[f"images_{hw}"])
    if world == 2:
        for name in BACKBONES:
            out[name] = forward(backbone_model(name), space, images(BACKBONE_HW, 7, 1))
        out["r50_66_features"] = forward(model, space, inputs["images_66"], "forward_features")
        with quant.quantized(int8_scales(model)):
            out["r50_66_int8"] = forward(model, space, inputs["images_66"])
        out["qat_f64"] = qat_step(inputs, space)
    if world == 3:
        x = inputs[f"images_{TAIL_HW}"]
        out["tail_fused"] = forward(r50(inputs["deeplab"], fused_tail=True), space, x)
        out["tail_portable"] = forward(model, space, x)
    if world == 4:
        x, weights = fetch_inputs()
        lo, hi = spatial.row_split(FETCH_HEIGHT, 4)[space.space_index]
        local = x[:, lo:hi].clone().requires_grad_(True)
        with spatial.sharding(space):
            rows = spatial.fetch_rows(local, FETCH_SPANS, FETCH_HEIGHT, FETCH_PAD)
        (rows * weights[space.space_index]).sum().backward()
        out["fetch"] = {"rows": rows.detach(), "grad": local.grad}
        grid = make_mesh((("data", 2), ("space", 2)))
        out["layouts"] = {
            "data_space": (grid.data_index, grid.space_index),
            "space_data": (lambda m: (m.data_index, m.space_index))(
                make_mesh((("space", 2), ("data", 2)))),
        }
        for case in TRAIN_CASES:
            out[case] = train_step(inputs, case, grid)
        out["replicas"] = replicas(inputs)
    return out


def main(directory: str):
    torch.set_num_threads(1)
    init_data_parallel("cpu", timeout=datetime.timedelta(seconds=300))
    inputs = torch.load(f"{directory}/inputs.pt", weights_only=True)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    out = run(inputs, world)
    torch.save(out, f"{directory}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
