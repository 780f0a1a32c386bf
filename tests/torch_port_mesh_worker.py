"""One rank of tests/test_torch_port_mesh.py's data-parallel runs.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m tests.torch_port_mesh_worker DIR

Each rank joins the gloo group torchrun describes
(core/mesh.py::init_data_parallel, 300 s collective timeout), reads the
inputs the test wrote to DIR/inputs.pt (the initial DeepLab and generator
weights, the global batches) and takes its rows of each batch through:
three seen train steps (plain, grad_accum 2, and device_preprocess with
dropout), the eval confusion of a ragged val set, and the ZS3 step
(plain and graph-context).  It writes what came out to DIR/rank<r>.pt.
Imports no JAX.
"""

import datetime
import sys

import torch

from zs3_tpu_torch.core.config import Config, GMMNConfig, ModelConfig, OptimConfig, TrainConfig
from zs3_tpu_torch.core.mesh import init_data_parallel, make_mesh, mesh_from_config, shard_batch
from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.models.gmmn import build_gmmn
from zs3_tpu_torch.train.gmmn import ZS3Step, extract_classifier
from zs3_tpu_torch.train.seen import make_eval_step, make_train_step, sum_confusion
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils import losses

LAYERS = (2, 2, 2, 2)
NUM_CLASSES = 5
SEEN_CASES = {"plain": (1, False, False), "accum2": (2, False, False),
              "preprocess_dropout": (1, True, True)}  # grad_accum, device_preprocess, dropout


def deeplab(state_dict, dropout=False) -> DeepLab:
    model = DeepLab(backbone="resnet50", num_classes=NUM_CLASSES, dropout=dropout,
                    layers=LAYERS)
    model.load_state_dict(state_dict)
    return model


def seen_step(inputs, case, mesh):
    """One seen train step of `case` on this rank's rows (all rows
    without a mesh): (loss, state_dict, grads)."""
    grad_accum, preprocess, dropout = SEEN_CASES[case]
    model = deeplab(inputs["deeplab"], dropout)
    cfg = Config(optim=OptimConfig(lr=1e-3))
    step = make_train_step(losses.build_seg_loss("ce", 255, mesh=mesh), "full", grad_accum,
                           seed=0, device_preprocess=preprocess, mesh=mesh)
    optimizer = SegOptimizer(model, cfg, 10)
    batch = inputs["uint8_batch" if preprocess else "batch"]
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    out = step(model, optimizer, batch)
    return {"loss": float(out["loss"]),
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}


def zs3_cfg(graph: bool) -> Config:
    return Config(
        model=ModelConfig(backbone="resnet50", num_classes=NUM_CLASSES,
                          compute_dtype="float32", dropout=False),
        gmmn=GMMNConfig(embed_dim=8, noise_dim=8, hidden_dim=16, pixels_per_class=16,
                        graph_context=graph, graph_hidden_dim=16, max_graph_neighbors=3),
    )


def zs3_step(inputs, graph, mesh):
    """One ZS3 step (step 0's draws) on this rank's rows: the generator's
    and the classifier's parameters after it, and its losses."""
    cfg = zs3_cfg(graph)
    model = deeplab(inputs["deeplab"])
    generator = build_gmmn(cfg.gmmn)
    generator.load_state_dict(inputs["graph_gen" if graph else "gen"])
    unseen = torch.zeros(NUM_CLASSES)
    unseen[3] = 1.0
    step = ZS3Step(model, generator, extract_classifier(model), inputs["embeddings"], unseen,
                   cfg, seed=2, mesh=mesh)
    batch = inputs["batch"] if mesh is None else shard_batch(inputs["batch"], mesh)
    out = step(batch, step=0)
    return {"mmd": float(out["mmd"]), "cls_ce": float(out["cls_ce"]),
            "gen": {k: v.clone() for k, v in generator.state_dict().items()},
            "cls": {k: v.detach().clone() for k, v in step.cls.items()}}


def confusion(inputs, mesh):
    """The eval step's confusion over the ragged val batches (3 rows, then
    1): each rank its rows of every batch padded to the ranks."""
    model = deeplab(inputs["deeplab"]).eval()
    eval_step = make_eval_step(NUM_CLASSES)
    return sum_confusion(lambda b: eval_step(model, b), inputs["val"], NUM_CLASSES,
                         torch.device("cpu"), 255, mesh)


def run(inputs, mesh) -> dict:
    """Everything a rank computes (a one-rank run without a mesh)."""
    out = {case: seen_step(inputs, case, mesh) for case in SEEN_CASES}
    out["zs3"] = zs3_step(inputs, False, mesh)
    out["zs3_graph"] = zs3_step(inputs, True, mesh)
    out["confusion"] = confusion(inputs, mesh)
    return out


def main(directory: str):
    torch.set_num_threads(1)
    init_data_parallel("cpu", timeout=datetime.timedelta(seconds=300))
    inputs = torch.load(f"{directory}/inputs.pt", weights_only=True)
    mesh = make_mesh()
    out = run(inputs, mesh)
    two_level = Config(train=TrainConfig(mesh_axes=(("dcn", 1), ("data", -1))))
    out["mesh"] = {"rank": mesh.rank, "shape": mesh.shape,
                   "two_level": mesh_from_config(two_level).shape}
    torch.save(out, f"{directory}/rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
