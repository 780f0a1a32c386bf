"""Data parallelism over ranks (port of zs3_tpu.core.mesh).

zs3_tpu's multi-device path is jit over a Mesh: the batch sharded over
the `data` axis, parameters replicated, and XLA inserting the gradient
all-reduce and the BN statistics' pmean, so every statistic is one of
the global batch.  The port gets the same semantics from one process per
device (torchrun, or any launcher that sets RANK, WORLD_SIZE and
LOCAL_RANK):

  * rank r takes the contiguous rows [r*B/N, (r+1)*B/N) of each global
    batch of B rows (`shard_batch`, NamedSharding(P("data")));
  * train-mode BatchNorm all-reduces its per-channel sums
    (models/layers.py), and the loss is the global batch's mean
    (utils/losses.py), so the gradients summed over the ranks
    (`all_reduce_grads_`) are the one-rank run's on the global batch;
  * eval batches are padded with inert rows (ignore_index labels) and
    the confusion matrices summed over the ranks.

A `space` axis (H of the activations split over ranks,
parallel/spatial.py) lays the ranks out row-major over the axes, as
zs3_tpu's `np.array(devices).reshape(sizes)` does: the batch splits over
the other axes (the data index, outer), and the ranks of one data index
form a space group (`Mesh.space_group`, inner).  The trainers
(`mesh_from_config`) hold each data block whole on every space rank, as
zs3_tpu's trainers do (`shard_batch` over `data` alone): those replicas
compute the same numbers, and only space index 0 adds them into a sum
over the ranks (`Mesh.contributes`).

Collectives are `all_reduce` and `broadcast` only, which both NCCL and
gloo take on CUDA tensors; an all-gather is an all-reduce into a
zero-filled buffer where each rank fills its own rows (`gather_rows`).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from zs3_tpu_torch.core.device import resolve_device


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_data_parallel(
    device: Union[str, torch.device] = "cuda",
    timeout: Optional[datetime.timedelta] = None,
) -> torch.device:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device:
    NCCL and cuda:LOCAL_RANK for `cuda`, gloo for `cpu`.  Without
    WORLD_SIZE > 1 there is no group and `device` comes back as it is.
    A group the caller started already is kept as it is (two gloo ranks
    on one card, say); its ranks then share the current card."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return dev
    rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, rank=rank, world_size=world, **kwargs)
    return dev


SPACE = "space"  # the mesh axis H is split over (parallel/spatial.py)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the process group laid out row-major as `shape`
    ({"data": N}; {"dcn": n, "data": m}: one group of n*m ranks holding one
    global batch; {"data": d, "space": s}: H split over s ranks).  `rank`
    is this process's place in it and `size` the number of ranks.  The
    batch splits over every axis but `space` (`data_index` of
    `data_size`); `space_group` is the process group of this rank's space
    ranks (None without a space axis of several ranks or a process group).
    With `space_replicas` every space rank holds its data block whole (the
    trainers); else each holds its rows of H (parallel/spatial.py)."""

    shape: Dict[str, int]
    rank: int = 0
    space_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    space_replicas: bool = False

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes checkpoints, logs and results (rank 0)."""
        return self.rank == 0

    def index(self, axis: str) -> int:
        """This rank's index on `axis` (0 for an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        indices = np.unravel_index(self.rank, tuple(self.shape.values()))
        return int(indices[list(self.shape).index(axis)])

    @property
    def space_size(self) -> int:
        return self.shape.get(SPACE, 1)

    @property
    def space_index(self) -> int:
        return self.index(SPACE)

    @property
    def data_size(self) -> int:
        """The number of batch shards: the ranks of every axis but space."""
        return self.size // self.space_size

    @property
    def data_index(self) -> int:
        """This rank's batch shard: its indices on every axis but space,
        row-major."""
        index = 0
        for name, n in self.shape.items():
            if name != SPACE:
                index = index * n + self.index(name)
        return index

    @property
    def contributes(self) -> bool:
        """Whether this rank adds its numbers into a sum over the ranks:
        every rank, but only space index 0 of replicas."""
        return not self.space_replicas or self.space_index == 0


def space_groups(shape: Dict[str, int], rank: int):
    """dist.new_group of every space group of `shape`, in one order on
    every rank (new_group is collective); returns this rank's."""
    sizes = tuple(shape.values())
    grid = np.arange(math.prod(sizes)).reshape(sizes)
    mine = None
    for ranks in np.moveaxis(grid, list(shape).index(SPACE), -1).reshape(-1, shape[SPACE]):
        group = dist.new_group(ranks.tolist())
        if rank in ranks:
            mine = group
    return mine


def make_mesh(
    axes: Sequence[Tuple[str, int]] = (("data", -1),),
    world: Optional[int] = None,
    rank: Optional[int] = None,
) -> Mesh:
    """A Mesh of (axis name, size) pairs over the process group's ranks
    (`world`, `rank` default to the group's); size -1 takes the ranks the
    other axes leave.  The sizes' product must be the world size.  A
    `space` axis of several ranks makes its process groups when the mesh
    is the process group's (every rank must then call make_mesh)."""
    if rank is None:
        rank = dist.get_rank() if world_size() > 1 else 0
    world = world_size() if world is None else world
    names = [name for name, _ in axes]
    sizes = [int(size) for _, size in axes]
    n_wild = sum(1 for s in sizes if s == -1)
    if n_wild > 1:
        raise ValueError("at most one mesh axis may have size -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_wild:
        if world % fixed:
            raise ValueError(f"{world} devices not divisible by fixed axes product {fixed}")
        sizes = [world // fixed if s == -1 else s for s in sizes]
    total = math.prod(sizes)
    if total > world:
        raise ValueError(f"mesh wants {total} devices, have {world}")
    if total < world:
        raise ValueError(f"mesh of {total} devices leaves {world - total} of the {world} "
                         "ranks without a shard of the batch")
    shape = dict(zip(names, sizes))
    group = None
    if shape.get(SPACE, 1) > 1 and world > 1 and world == world_size():
        group = space_groups(shape, rank)
    return Mesh(shape, rank, group)


def mesh_from_config(cfg) -> Mesh:
    """make_mesh(cfg.train.mesh_axes) for the trainers, after the knobs of
    zs3_tpu's jit path that torch has no use for: `model.bn_axis_name` may
    be None or "data" (BN takes the global batch's statistics whenever
    there is more than one rank, as zs3_tpu's jit path does),
    `train.donate_state` must be True (torch updates the state in place;
    there is no copy to keep).  Under a `space` axis the space ranks are
    replicas of their data block, as zs3_tpu's trainers shard the batch
    over `data` alone."""
    if cfg.model.bn_axis_name not in (None, "data"):
        raise ValueError(
            f"model.bn_axis_name={cfg.model.bn_axis_name!r}: the port's BatchNorm "
            "reduces over the data group (None or 'data'); it has no other axis")
    if not cfg.train.donate_state:
        raise ValueError(
            "train.donate_state=False: torch updates the train state in place, so "
            "there is no undonated copy to keep; set it True")
    mesh = make_mesh(cfg.train.mesh_axes)
    return dataclasses.replace(mesh, space_replicas=mesh.space_size > 1)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_eval_batch(batch: dict, multiple: int, ignore_index: int = 255) -> dict:
    """Pad the batch dim to a multiple of the data group with inert rows:
    zero images, all-`ignore_index` labels, which no confusion matrix or
    masked loss counts."""
    n = next(iter(batch.values())).shape[0]
    target = pad_to_multiple(n, multiple)
    if target == n:
        return batch
    out = {}
    for key, value in batch.items():
        value = np.asarray(value)
        widths = [(0, target - n)] + [(0, 0)] * (value.ndim - 1)
        out[key] = np.pad(value, widths, constant_values=ignore_index if key == "label" else 0)
    return out


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous rows of every array of a global batch (its
    data index's: the space ranks of one data index take the same rows)."""
    n = next(iter(batch.values())).shape[0]
    shards, index = mesh.data_size, mesh.data_index
    if n % shards:
        raise ValueError(f"batch of {n} rows does not split over {shards} ranks")
    per = n // shards
    return {key: value[index * per:(index + 1) * per] for key, value in batch.items()}


def _check_train_batch(n: int, mesh: Mesh):
    if n % mesh.data_size:
        raise ValueError(f"train batch size {n} must be divisible by the data mesh axis "
                         f"({mesh.data_size})")


def device_batch(batch, mesh: Mesh, ignore_index: int, device: torch.device,
                 eval: bool = False):
    """This rank's part of one global host batch, on `device`: a train
    batch must divide over the batch shards; an eval batch is padded with
    inert rows first."""
    from zs3_tpu_torch.train.seen import device_batch as to_device

    batch = {"image": batch["image"], "label": batch["label"]}
    if mesh.data_size > 1:
        if eval:
            batch = pad_eval_batch(batch, mesh.data_size, ignore_index)
        else:
            _check_train_batch(batch["image"].shape[0], mesh)
        batch = shard_batch(batch, mesh)
    return to_device(batch, device)


def bounded_train_batches(loader: Iterable, mesh: Mesh, max_steps: int) -> Iterator[dict]:
    """Host batches of one epoch, each checked to divide over the batch
    shards, at most max_steps of them."""
    for i, batch in enumerate(loader):
        if i >= max_steps:
            break
        _check_train_batch(batch["image"].shape[0], mesh)
        yield {"image": batch["image"], "label": batch["label"]}


def all_reduce_(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `tensor` over the ranks in place (nothing on one rank); a
    replica that does not contribute adds zeros."""
    if mesh.size > 1:
        if not mesh.contributes:
            tensor.zero_()
        dist.all_reduce(tensor)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks (the default group's for None) whose
    backward sums the gradient too: every rank's output depends on every
    rank's input."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_autograd(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """`tensor` summed over the ranks of `group` (the default group's for
    None), differentiably."""
    return _AllReduceSum.apply(tensor, group)


def gather_rows(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The batch shards' equal-sized `tensor`s stacked along dim 0 in data
    index order (one shard: `tensor`).  An all-reduce into a zero-filled
    buffer where each rank fills its own rows (a replica that does not
    contribute fills none): x + 0 is x, so the rows arrive exact."""
    if mesh.size == 1:
        return tensor
    n, index = tensor.shape[0], mesh.data_index
    out = tensor.new_zeros((n * mesh.data_size, *tensor.shape[1:]))
    if mesh.contributes:
        out[index * n:(index + 1) * n] = tensor
    dist.all_reduce(out)
    return out


def all_reduce_grads_(params: Iterable[torch.nn.Parameter], mesh: Mesh,
                      extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Sum every parameter's .grad (and `extra`, a small f32 tensor such
    as the step's loss) over the ranks with one all-reduce of one flat
    buffer; returns the summed `extra`.  Nothing moves on one rank; a
    replica that does not contribute adds zeros."""
    if mesh.size == 1:
        return extra
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1) for g in grads] + ([extra.reshape(-1)] if extra is not None else [])
    flat = torch.cat(parts)
    if not mesh.contributes:
        flat.zero_()
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()
    return None if extra is None else flat[offset:].view(extra.shape)
