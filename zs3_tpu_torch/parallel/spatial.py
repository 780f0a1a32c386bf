"""Spatial sharding (port of zs3_tpu.parallel.spatial): H of the NHWC
activations split over the ranks of a `space` mesh axis, the batch over
the other axes, parameters replicated.

zs3_tpu leaves every halo exchange to XLA's SPMD partitioner.  Here each
op that reads across rows fetches the rows it needs from the ranks that
own them, and its backward returns their gradient to the owners:

  * The partition.  Every level (the input, and each op's output) is
    split over the space group by `row_split` of its global height: the
    first height % S ranks one row more.  Deeper levels split unevenly
    (66 rows over 2: 33 at the stem, then 17/16), and a rank may own no
    row at all (32 rows over 4 leave 1/1/0/0 at os16).
  * The plan.  A rank cannot tell a level's global height from its own
    rows, so the call is first run once on the `meta` device at the
    global shapes (`plan`): each H-global op appends a `Record` of its
    global input and output heights, in call order.  The sharded run walks
    the records in the same order (`Space.next`), each op checking its
    kind and its local rows against them.  Plans are cached by input
    shape (`Planner`).
  * The exchange (`fetch_rows`): global rows [lo, hi) of a level for each
    space rank, rows outside [0, H) filled with a pad value.  Built from
    `all_reduce` alone, which gloo and NCCL both take on CUDA tensors:
    each rank lays out a zero-filled table of every rank's rows it does
    not own, fills what it owns, and one differentiable all-reduce over
    the space group (core/mesh.py::all_reduce_autograd) sums it.  Its
    backward is the same all-reduce of the gradient, which returns each
    fetched row's gradient to its owner.
  * The ops: `Conv` and `max_pool_3x3_s2` fetch their window of rows and
    run with H padding 0 (`windowed`); the bilinear and nearest resizes
    fetch their source rows and take the matching slice of the
    interpolation matrix or index (`resample_rows`); the ASPP's global
    pool all-reduces its sums and counts over the space group
    (`mean_hw`); train-mode BN already reduces over every rank with
    per-rank counts; Dropout draws the global mask and keeps this rank's
    rows (`level_rows`); the fused tail gathers the os4 features and runs
    kernel K4 on them whole, as XLA gives the Pallas call its operand
    whole (`fused_tail`).

Every rank runs the same collectives in the same order, forward and
backward: each rank's ops follow the plan, an op whose output has no
row on this rank still fetches and computes one row's window and keeps
none of it, and every exchange's result stays in the graph of the
rank's output, so autograd (which runs the nodes of one device in
reverse creation order) reaches the backward all-reduces everywhere.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from zs3_tpu_torch.core.mesh import SPACE, Mesh, all_reduce_autograd


def row_split(height: int, parts: int) -> List[Tuple[int, int]]:
    """The balanced split of `height` rows over `parts` ranks: rank i owns
    [start_i, start_i+1), the first height % parts ranks one row more."""
    base, extra = divmod(height, parts)
    starts = [i * base + min(i, extra) for i in range(parts + 1)]
    return list(zip(starts[:-1], starts[1:]))


@dataclasses.dataclass(frozen=True)
class Record:
    """One H-global op of a planned call: its kind and the global heights
    of its input and its output."""

    kind: str
    height_in: int
    height_out: int


class _Planning:
    """The planner's pass: the ops run unsharded on meta tensors at the
    global shapes and append their Records."""

    def __init__(self):
        self.records: List[Record] = []


class Space:
    """The active sharding of one call: this rank's place in its space
    group and the call's plan, walked in call order."""

    def __init__(self, mesh: Mesh, records: Sequence[Record]):
        if mesh.space_group is None:
            raise ValueError(f"mesh {mesh.shape} has no space group: spatial sharding needs "
                             "a 'space' axis of several ranks in a process group")
        self.group = mesh.space_group
        self.index = mesh.space_index
        self.size = mesh.space_size
        self.records = records
        self.cursor = 0

    def next(self, kind: str, height: int) -> Record:
        """The next record, which must be an op of `kind` whose input has
        `height` rows on this rank."""
        if self.cursor >= len(self.records):
            raise RuntimeError(f"spatial sharding: a {kind} op beyond the call's plan of "
                               f"{len(self.records)} ops")
        record = self.records[self.cursor]
        lo, hi = row_split(record.height_in, self.size)[self.index]
        if record.kind != kind or hi - lo != height:
            raise RuntimeError(
                f"spatial sharding: op {self.cursor} of the plan is a {record.kind} of "
                f"{record.height_in} rows ({hi - lo} on space rank {self.index}), but a "
                f"{kind} of {height} rows ran")
        self.cursor += 1
        return record

    def own(self, height: int) -> Tuple[int, int]:
        """This rank's rows of a level `height` rows high."""
        return row_split(height, self.size)[self.index]


_STATE: contextvars.ContextVar = contextvars.ContextVar("zs3_torch_space", default=None)


def active() -> bool:
    """Whether a sharded call or its planner is running."""
    return _STATE.get() is not None


def _sharding() -> Optional[Space]:
    state = _STATE.get()
    return state if isinstance(state, Space) else None


def current():
    """The active state and its place in the plan, for a recomputation
    that runs later or on another thread (an activation-checkpointed
    block's backward)."""
    state = _STATE.get()
    return state, state.cursor if isinstance(state, Space) else None


@contextlib.contextmanager
def restored(saved):
    """Re-enter a state `current()` returned, at its place in the plan."""
    state, cursor = saved
    if cursor is not None:
        state.cursor = cursor
    token = _STATE.set(state)
    try:
        yield
    finally:
        _STATE.reset(token)


def plan(fn: Callable, *inputs: torch.Tensor) -> Tuple[Record, ...]:
    """The records of fn(*inputs) run unsharded on the meta device (no
    data moves and no collective runs); `inputs` are meta tensors of the
    global shapes."""
    state = _Planning()
    token = _STATE.set(state)
    try:
        with torch.no_grad():
            fn(*inputs)
    finally:
        _STATE.reset(token)
    return tuple(state.records)


@contextlib.contextmanager
def sharding(mesh: Mesh, records: Sequence[Record] = ()):
    """Inside, the H-global ops (and fetch_rows) act as this rank's share
    of a call planned as `records`; yields the Space."""
    space = Space(mesh, records)
    token = _STATE.set(space)
    try:
        yield space
    finally:
        _STATE.reset(token)


class Planner:
    """The plans of one function, by the shapes, dtypes and train mode of
    its inputs; `sharded` runs a call under its plan."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.plans: Dict[tuple, Tuple[Record, ...]] = {}

    @contextlib.contextmanager
    def sharded(self, fn: Callable, model: torch.nn.Module, *inputs: torch.Tensor):
        """Inside, the H-global ops take this rank's rows of fn(*inputs):
        each input holds rows [i*h, (i+1)*h) of the global one on space
        rank i (dim 1: NHWC images, NHW labels)."""
        if self.mesh.space_size == 1:  # H is not split
            yield
            return
        key = (model.training, *((tuple(t.shape), t.dtype) for t in inputs))
        if key not in self.plans:
            s = self.mesh.space_size
            self.plans[key] = plan(fn, *(
                torch.empty((t.shape[0], t.shape[1] * s, *t.shape[2:]), dtype=t.dtype,
                            device="meta") for t in inputs))
        with sharding(self.mesh, self.plans[key]) as space:
            yield
        if space.cursor != len(space.records):
            raise RuntimeError(f"spatial sharding: the call ran {space.cursor} of its plan's "
                               f"{len(space.records)} ops")


def _zeros(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.new_zeros((x.shape[0], rows, *x.shape[2:]))


def fetch_rows(x: torch.Tensor, spans: Sequence[Tuple[int, int]], height: int,
               pad: float = 0.0) -> torch.Tensor:
    """Global rows [lo, hi) of a level `height` rows high (dim 1 of an NHWC
    or NHW tensor), (lo, hi) = spans[i] on space rank i; every rank passes
    every rank's span.  `x` is this rank's rows of the level (row_split);
    rows outside [0, height) are `pad`.  The rows this rank does not own
    come from their owners, however far (a dilation-36 window reaches 36
    rows): a zero-filled table of every rank's missing rows, each owner
    filling its own, summed by one all-reduce over the space group.  The
    all-reduce is differentiable: a fetched row's gradient is summed back
    onto its owner's."""
    space = _sharding()
    owned = row_split(height, space.size)
    a, b = owned[space.index]
    if x.shape[1] != b - a:
        raise ValueError(f"space rank {space.index} holds {x.shape[1]} rows of a level of "
                         f"{height}, not {b - a}")
    # x's place in the table's graph, where it sends nothing too: the
    # table needs a gradient on every rank or on none.
    pieces, blocks, total = [x[:, :0]], [], 0
    for r, (lo, hi) in enumerate(spans):
        ra, rb = owned[r]
        for u, v in ((max(lo, 0), min(hi, ra)), (max(lo, rb), min(hi, height))):
            v = max(u, v)
            blocks.append((total, total + v - u))
            total += v - u
            i, j = max(u, a), min(v, b)
            if j > i:
                pieces += [_zeros(x, i - u), x[:, i - a:j - a], _zeros(x, v - j)]
            elif v > u:
                pieces.append(_zeros(x, v - u))
    if total:  # every rank sees the same spans, so all skip or none
        table = all_reduce_autograd(torch.cat(pieces, 1), space.group)
    else:
        table = torch.cat(pieces, 1)
    lo, hi = spans[space.index]
    (t0, t1), (b0, b1) = blocks[2 * space.index], blocks[2 * space.index + 1]
    i, j = min(max(lo, a), b), max(min(hi, b), a)
    return torch.cat([
        x.new_full((x.shape[0], max(0, min(hi, 0) - lo), *x.shape[2:]), pad),
        table[:, t0:t1], x[:, i - a:max(i, j) - a], table[:, b0:b1],
        x.new_full((x.shape[0], max(0, hi - max(lo, height)), *x.shape[2:]), pad),
    ], 1)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def windowed(kind: str, x: torch.Tensor, kernel: int, stride: int, padding: int,
             dilation: int, run: Callable[[torch.Tensor, int], torch.Tensor],
             pad: float = 0.0) -> torch.Tensor:
    """An op whose output row o reads input rows o*stride - padding +
    dilation*t, t < kernel (a conv or a pool; NCHW, rows on dim 2):
    `run(x, h_padding)` computes it with that H padding.  Unsharded:
    run(x, padding).  Sharded: run on the window of this rank's output
    rows, fetched with `pad` outside the image, with H padding 0 (a rank
    without output rows computes one row's window and keeps none)."""
    state = _STATE.get()
    if state is None or (kernel == 1 and stride == 1 and padding == 0):
        if x.shape[2] or not isinstance(state, Space):
            return run(x, padding)
        # A rank without rows of the level: one row of zeros in, none out.
        return run(torch.cat([x, x.new_zeros((*x.shape[:2], 1, x.shape[3]))], 2), 0)[:, :, :0]
    if isinstance(state, _Planning):
        y = run(x, padding)
        state.records.append(Record(kind, x.shape[2], y.shape[2]))
        return y
    record = state.next(kind, x.shape[2])

    def span(o0, o1):
        o1 = max(o1, o0 + 1)
        return o0 * stride - padding, (o1 - 1) * stride - padding + dilation * (kernel - 1) + 1

    outs = row_split(record.height_out, state.size)
    rows = fetch_rows(_nhwc(x), [span(*o) for o in outs], record.height_in, pad)
    o0, o1 = outs[state.index]
    y = run(_nchw(rows), 0)
    return y[:, :, :o1 - o0]


def resample_rows(kind: str, x: torch.Tensor, height_out: int,
                  sources: Callable[[int, int], Tuple[np.ndarray, np.ndarray]],
                  apply: Callable[[torch.Tensor, int, int, int, int, int], torch.Tensor]
                  ) -> torch.Tensor:
    """An H resize of x (NHWC or NHW, rows on dim 1) to `height_out` rows:
    `sources(h_in, h_out)` gives each output row's first source row and
    one past its last, `apply(rows, h_in, h_out, o0, o1, c0)` the output
    rows [o0, o1) from source rows starting at row c0.  Unsharded: every
    row (nothing when the height stays).  Sharded: the heights are the
    plan's (`height_out` is this rank's share), and each rank fetches the
    source rows of its output rows."""
    state = _STATE.get()
    if isinstance(state, Space):
        record = state.next(kind, x.shape[1])
        h_in, h_out = record.height_in, record.height_out
        outs = row_split(h_out, state.size)
        o0, o1 = outs[state.index]
        if o1 - o0 != height_out:
            raise RuntimeError(f"spatial sharding: a {kind} resize to {height_out} rows on "
                               f"space rank {state.index}, whose share of {h_out} is {o1 - o0}")
        if h_out == h_in:
            return x
        first, stop = sources(h_in, h_out)
        spans = [(int(first[o0:o1].min()), int(stop[o0:o1].max())) if o1 > o0 else (0, 0)
                 for o0, o1 in outs]
        rows = fetch_rows(x, spans, h_in)
        return apply(rows, h_in, h_out, o0, o1, spans[state.index][0])
    h = x.shape[1]
    if isinstance(state, _Planning):
        state.records.append(Record(kind, h, height_out))
    if height_out == h:
        return x
    return apply(x, h, height_out, 0, height_out, 0)


def level_rows(kind: str, height: int) -> Optional[Tuple[int, int, int]]:
    """(the level's global height, this rank's first row, one past its
    last) for an op that needs its rows' global place (Dropout's mask):
    the plan's under a sharding, None unsharded."""
    state = _STATE.get()
    if isinstance(state, _Planning):
        state.records.append(Record(kind, height, height))
        return height, 0, height
    if isinstance(state, Space):
        total = state.next(kind, height).height_in
        return (total, *state.own(total))
    return None


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC11 mean over H and W of the whole level: this rank's sums
    and count of values, summed over the space group (differentiably), in
    f32 (f64 for f64 x)."""
    space = _sharding()
    if space is None:
        return x.mean(dim=(2, 3), keepdim=True)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    count = xf.new_full((x.shape[0], 1), x.shape[2] * x.shape[3])
    sums = all_reduce_autograd(torch.cat([xf.sum(dim=(2, 3)), count], 1), space.group)
    mean = sums[:, :-1] / sums[:, -1:]
    return mean.to(x.dtype)[:, :, None, None]


def max_abs(x: torch.Tensor) -> Optional[torch.Tensor]:
    """max |x| over the space group's rows of the level (a 0-dim f32
    tensor, no gradient) under a sharding; None unsharded."""
    space = _sharding()
    if space is None:
        return None
    local = x.detach().abs().amax().float() if x.numel() else x.new_zeros((), dtype=torch.float32)
    dist.all_reduce(local, op=dist.ReduceOp.MAX, group=space.group)
    return local


def fused_tail(feats: torch.Tensor, size: Tuple[int, int],
               supported: Callable[[Tuple[int, int], Tuple[int, int]], bool],
               tail: Callable[[torch.Tensor, Tuple[int, int]], torch.Tensor]
               ) -> Optional[torch.Tensor]:
    """The fused classify+upsample of NHWC os4 features to an image of
    `size` under a sharding: where `supported(feature grid, image size)`
    holds on the global shapes, every rank gathers the features whole,
    runs `tail` on them (kernel K4) and keeps its rows of the logits;
    None where it does not hold (the portable tail then runs sharded)."""
    state = _STATE.get()
    if isinstance(state, _Planning):
        state.records.append(Record("tail", feats.shape[1], size[0]))
        if not supported(tuple(feats.shape[1:3]), size):
            return None
        return feats.new_empty((feats.shape[0], *size, 1), dtype=torch.float32)
    record = state.next("tail", feats.shape[1])
    h, image = record.height_in, (record.height_out, size[1])
    if not supported((h, feats.shape[2]), image):
        return None
    whole = fetch_rows(feats, [(0, h)] * state.size, h)
    lo, hi = state.own(image[0])
    token = _STATE.set(None)  # the whole level: its ops (the plain version's) unsharded
    try:
        return tail(whole, image)[:, lo:hi]
    finally:
        _STATE.reset(token)


@dataclasses.dataclass(frozen=True)
class BatchBlock:
    """This rank's block of a global NHWC batch (NHW labels alike): batch
    rows by its data index, H rows by its space index; an axis absent
    from the mesh does not split."""

    data_index: int = 0
    data_size: int = 1
    space_index: int = 0
    space_size: int = 1

    def take(self, x):
        """This rank's block of the global array `x` (a view)."""
        n, h = x.shape[0], x.shape[1]
        if n % self.data_size or h % self.space_size:
            raise ValueError(f"a batch of {n} x {h} rows does not split over {self.data_size} "
                             f"data x {self.space_size} space ranks")
        b, r = n // self.data_size, h // self.space_size
        return x[self.data_index * b:(self.data_index + 1) * b,
                 self.space_index * r:(self.space_index + 1) * r]


def spatial_batch_sharding(mesh: Mesh, data_axis: Optional[str] = "data",
                           space_axis: str = "space") -> BatchBlock:
    """NHWC batches: batch over `data`, H over `space` (zs3_tpu's
    NamedSharding P(data, space, None, None)).  The batch splits over every
    axis of the mesh but `space`; `data_axis` None (or absent) may leave it
    whole only where the mesh has no other axis of several ranks."""
    if space_axis != SPACE and space_axis in mesh.shape:
        raise ValueError(f"the port splits H over the mesh axis {SPACE!r}, not {space_axis!r}")
    split_data = data_axis is not None and data_axis in mesh.shape
    if not split_data and mesh.data_size > 1:
        raise ValueError(f"data_axis={data_axis!r}: the batch must split over the mesh's "
                         f"{mesh.data_size} data ranks (a whole batch on each would count "
                         "its rows once per rank in every sum)")
    return BatchBlock(mesh.data_index, mesh.data_size, mesh.space_index, mesh.space_size)


def _check_sharded_mesh(mesh: Mesh, data_axis, space_axis):
    """Refuse a mesh this module cannot split H over."""
    spatial_batch_sharding(mesh, data_axis, space_axis)
    if mesh.space_size > 1 and mesh.space_group is None:
        raise ValueError(f"mesh {mesh.shape} has no space group: spatial sharding needs "
                         "the process group's make_mesh on every rank")
    if mesh.space_replicas:
        raise ValueError("a mesh of space replicas (mesh_from_config's) holds whole images: "
                         "spatial sharding takes make_mesh's")


def spatially_sharded_forward(model: torch.nn.Module, mesh: Mesh,
                              data_axis: Optional[str] = "data", space_axis: str = "space",
                              method: Optional[str] = None) -> Callable:
    """forward(x): the eval-mode forward of `model` (or its `method`, such
    as "forward_features") on this rank's block of a global NHWC batch
    (spatial_batch_sharding), returning this rank's block of the output:
    its batch rows and its rows of the output's H.  Parameters are the
    model's own, the same on every rank.  The global H must divide over
    the space ranks."""
    _check_sharded_mesh(mesh, data_axis, space_axis)
    fn = getattr(model, method or "forward")
    planner = Planner(mesh)

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        training = model.training
        model.eval()
        try:
            with planner.sharded(fn, model, x):
                return fn(x)
        finally:
            model.train(training)

    return forward


def spatially_sharded_train_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    data_axis: Optional[str] = "data",
    space_axis: str = "space",
    donate: bool = True,
    device_preprocess: bool = False,
    loss_at: str = "full",
) -> Callable:
    """train_step(model, optimizer, batch): the port's make_train_step on
    this rank's (data x space) block of the global batch
    (spatial_batch_sharding: images NHWC, labels NHW).  BN statistics, the
    loss's weight sum and the gradients reduce over every rank, so the
    step is the one-rank step on the global batch up to the order of sums;
    `loss_fn` is build_seg_loss(..., mesh=mesh).  `donate` must be True:
    torch updates the model and optimizer in place, so there is no
    undonated copy to keep.  (make_train_step(..., mesh=mesh) with a mesh
    of this kind takes its other options sharded too: grad_accum, qat.)"""
    from zs3_tpu_torch.train.seen import make_train_step

    if not donate:
        raise ValueError("donate=False: torch updates the train state in place, so there is "
                         "no undonated copy to keep; pass donate=True")
    _check_sharded_mesh(mesh, data_axis, space_axis)
    return make_train_step(loss_fn, loss_at=loss_at, device_preprocess=device_preprocess,
                           mesh=mesh)
