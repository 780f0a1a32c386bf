"""Train-mode BatchNorm on one rank, with the ReLU that reads it and the
running statistics' update folded in (csrc/batch_norm_train.cu).

zs3_tpu's BatchNorm is flax's nn.BatchNorm, not a Pallas kernel; on the
H100 the port ran torch.native_batch_norm (torch's channels_last
kernels at about half the card's bandwidth), nine small launches to
update the running statistics and a ReLU kernel each way.  Here a CUDA
tensor takes two hand-written kernels forward (statistics, then the
affine map and the ReLU) and two backward (the per-channel sums, then
dx), 8 passes over the tensor where those took 13.

`plan` lays a launch out on the host: x as the row-major (rows, C)
matrix of a channels_last tensor, each thread 16 bytes of channels, the
grid (channel blocks, slabs of rows) three CTAs to an SM; `dense` gives
the kernels their layout and alignment.

`batch_norm_train` sends a CPU tensor to the plain version
(`batch_norm_train_reference`: native_batch_norm, then the running
statistics and F.relu, the port's arithmetic before the kernels) and a
bf16, f32 or f64 CUDA tensor to the kernels, with no fallback between
them.  bf16 and f32 accumulate in f32 with f32 parameters and
statistics; f64 (the step the card is held to the CPU's with) in f64.
Its `launches` counts the calls that took the kernels, `relu_fused`
those of them that fused their ReLU.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from zs3_tpu_torch.ops.cuda_build import CudaLibrary

THREADS = 256  # a CTA: TX channel groups by 256 / TX rows
CTAS_PER_SM = 3  # the kernels' __launch_bounds__ minimum: one wave fills the card
# A CTA's channel groups by the row's channel groups: 8 up to 32 groups (256
# bf16 channels), 16 up to 127, 32 from 128.  On an H100, against 8 at
# every width (bf16, fwd + bwd): (48,512,65,65) 0.587 against 0.698 ms,
# (32,1536,33,33) 0.312 (16) and 0.321 (32) against 0.373, (48,1024,33,33)
# 0.323 (32) and 0.365 (16) against 0.374; (48,256,33,33) 0.0893 (8)
# against 0.0956 (16), where more channels a CTA leave fewer CTAs to
# merge the more slabs.
TX_BY_GROUPS = ((32, 8), (127, 16))
MAX_MERGE = 16  # most slab partials one thread of the last CTA merges
DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}  # the C side's Geometry.type

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_LIB = CudaLibrary(
    "batch_norm_train",
    {
        "zs3_bn_forward": ([_P] * 11 + [_D, _D, _D, _I, _I, _P], _I),
        "zs3_bn_backward": ([_P] * 10 + [_I, _I, _P], _I),
        "zs3_bn_error_string": ([_I], ctypes.c_char_p),
    },
)


class Plan(NamedTuple):
    vec: int  # channels a thread loads at once: 16 bytes, or 1
    tx: int  # channel groups of a CTA (a power of two)
    ty: int  # rows of a CTA walked at once, THREADS // tx
    cblocks: int  # channel blocks of tx * vec channels
    slabs: int  # slabs of rows, each non-empty
    rows_per_slab: int


@functools.lru_cache(maxsize=256)
def plan(rows: int, channels: int, dtype: torch.dtype, sm_count: int = 132) -> Plan:
    """How the kernels cover a (rows, channels) matrix of `dtype`.

    A thread takes 16 bytes of channels (8 bf16, 4 f32, 2 f64); a CTA takes tx
    of those groups (the next power of two of the groups, at most
    TX_BY_GROUPS's width) and the grid as many slabs of rows as make
    CTAS_PER_SM CTAs an SM, but no more than give each thread a row, nor
    than MAX_MERGE partials a thread of the last CTA to merge.  TypeError
    for a dtype, ValueError for an empty matrix or channels that are not
    a multiple of 16 bytes."""
    if dtype not in DTYPES:
        raise TypeError(f"batch_norm_train takes float32, bfloat16 or float64, got {dtype}")
    rows, channels = int(rows), int(channels)
    vec = 16 // dtype.itemsize
    if rows < 1 or channels < 1 or channels % vec:
        raise ValueError(f"batch_norm_train needs values in a multiple of {vec} {dtype} "
                         f"channels, got ({rows}, {channels})")
    groups = channels // vec
    widest = next((tx for most, tx in TX_BY_GROUPS if groups <= most), 32)
    tx = min(widest, 1 << (groups - 1).bit_length())
    ty = THREADS // tx
    cblocks = -(-groups // tx)
    slabs = max(1, min(-(-CTAS_PER_SM * sm_count // cblocks), -(-rows // ty), MAX_MERGE * ty))
    rows_per_slab = -(-rows // slabs)
    return Plan(vec, tx, ty, cblocks, -(-rows // rows_per_slab), rows_per_slab)


@functools.lru_cache(maxsize=256)
def _geometry(rows: int, channels: int, dtype: torch.dtype, device_index: int):
    """(plan on the card's SMs, the C interface's geometry array)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    p = plan(rows, channels, dtype, sms)
    geometry = (ctypes.c_longlong * 7)(_TYPE_CODE[dtype], rows, channels, p.tx, p.cblocks,
                                       p.slabs, p.rows_per_slab)
    return p, geometry


# Per (device, stream): the slabs' partials and the channel blocks' tickets
# (zero between launches: the last CTA resets its own).  Kernels on one
# stream run in turn, so they share these (the split-attention kernels,
# ops/splat_kernels.py, too); the lock keeps a buffer that is replaced by a
# larger one alive until every launch that took it is queued.
_WORK: dict = {}
WORK_LOCK = threading.Lock()


def workspace(device: torch.device, stream: int, nbytes: int, tickets: int):
    """(partials of at least `nbytes`, at least `tickets` zeroed int32
    tickets) for launches on `stream`, taken under WORK_LOCK."""
    part, count = _WORK.get((device.index, stream), (None, None))
    if part is None or part.numel() < nbytes:
        part = torch.empty(nbytes, dtype=torch.uint8, device=device)
    if count is None or count.numel() < tickets:
        count = torch.zeros(max(tickets, 64), dtype=torch.int32, device=device)
    _WORK[(device.index, stream)] = (part, count)
    return part, count


def dense(t: torch.Tensor, dtype: torch.dtype,
          memory_format: torch.memory_format = torch.channels_last) -> torch.Tensor:
    """t in `dtype` and `memory_format` (channels_last) at a 16-byte aligned
    address, as the kernels read it: t itself where it is so already, else
    a copy."""
    t = t.to(dtype).contiguous(memory_format=memory_format)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=memory_format)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the kernels accumulate x's values of `dtype` in, and
    take its per-channel parameters and statistics in."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check_params(x: torch.Tensor, *params: torch.Tensor) -> None:
    c, acc = x.shape[1], acc_dtype(x.dtype)
    for p in params:
        if p.dtype != acc or p.device != x.device or p.numel() != c or not p.is_contiguous():
            raise ValueError(f"batch_norm_train takes {acc} contiguous per-channel parameters "
                             f"and statistics on x's device for {x.dtype} x")


def _launch(fn: str, x: torch.Tensor, layout: Plan, geometry, pointers, tail) -> None:
    """`fn` of the library on x's device and its current stream: the
    geometry, `pointers` (device tensors'), the plan's workspace, `tail`."""
    lib = _LIB.get()
    index = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        with WORK_LOCK:
            part, tickets = workspace(
                x.device, stream, 2 * layout.slabs * x.shape[1] * acc_dtype(x.dtype).itemsize,
                layout.cblocks)
            rc = getattr(lib, fn)(geometry, *pointers, part.data_ptr(), tickets.data_ptr(),
                                  *tail, stream)
    if rc != 0:
        raise RuntimeError(f"batch_norm_train launch failed: "
                           f"{lib.zs3_bn_error_string(rc).decode()} ({rc})")


def bn_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running, eps: float,
               relu: bool):
    """The forward kernels on a CUDA tensor x as `dense` gives it:
    (y, stats) with y channels_last in x's dtype and stats (3, C) in
    acc_dtype, the
    batch mean, 1/sqrt(var + eps) and biased variance.  `running` is None
    or (running_mean, running_var, num_batches_tracked, momentum), updated
    in place as running = (1 - momentum) * running + momentum * batch."""
    c = x.shape[1]
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = x.new_empty((3, c), dtype=acc_dtype(x.dtype))
    layout, geometry = _geometry(x.numel() // c, c, x.dtype, x.device.index)
    if running is None:
        _check_params(x, weight, bias)
        stat_ptrs, keep, momentum = (None, None, None), 1.0, 0.0
    else:
        running_mean, running_var, tracked, momentum = running
        _check_params(x, weight, bias, running_mean, running_var)
        if tracked.dtype != torch.int64 or tracked.device != x.device:
            raise ValueError("batch_norm_train takes an int64 num_batches_tracked on x's device")
        stat_ptrs = (running_mean.data_ptr(), running_var.data_ptr(), tracked.data_ptr())
        keep = 1.0 - momentum
    _launch("zs3_bn_forward", x, layout, geometry, (x.data_ptr(), y.data_ptr()),
            (stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), *stat_ptrs, keep, momentum,
             eps, int(running is not None), int(relu)))
    return y, stats


def bn_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                stats: torch.Tensor, relu: bool, need_dx: bool = True):
    """The backward kernels: (dx or None, grad_weight, grad_bias) of the
    forward that gave `stats`, dy made `dense` in x's dtype."""
    c = x.shape[1]
    dy = dense(dy, x.dtype)
    grads = stats.new_empty((2, c))
    dx = torch.empty_like(x, memory_format=torch.channels_last) if need_dx else None
    layout, geometry = _geometry(x.numel() // c, c, x.dtype, x.device.index)
    _launch("zs3_bn_backward", x, layout, geometry,
            (dy.data_ptr(), x.data_ptr(), None if dx is None else dx.data_ptr()),
            (stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), grads.data_ptr(), int(relu),
             int(need_dx)))
    return dx, grads[0], grads[1]


class _TrainBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running, eps, relu):
        y, stats = bn_forward(x, weight, bias, running, eps, relu)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.relu = relu
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        dx, grad_weight, grad_bias = bn_backward(dy, x, weight, bias, stats, ctx.relu,
                                                 ctx.needs_input_grad[0])
        return (dx, grad_weight if ctx.needs_input_grad[1] else None,
                grad_bias if ctx.needs_input_grad[2] else None, None, None, None)


def update_running_stats(running_mean: torch.Tensor, running_var: torch.Tensor,
                         num_batches_tracked: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, momentum: float) -> None:
    """running = (1 - momentum) * running + momentum * batch (var clamped
    at 0), in place, and one more batch tracked; in the running
    statistics' own dtype, so f64 ones keep f64 precision."""
    with torch.no_grad():
        keep = 1.0 - momentum
        running_mean.mul_(keep).add_(mean.to(running_mean.dtype), alpha=momentum)
        running_var.mul_(keep).add_(var.clamp(min=0.0), alpha=momentum)
        num_batches_tracked.add_(1)


def batch_norm_train_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                               running_mean: torch.Tensor, running_var: torch.Tensor,
                               num_batches_tracked: torch.Tensor, eps: float, momentum: float,
                               relu: bool = False, update_stats: bool = True) -> torch.Tensor:
    """Plain version: torch.native_batch_norm with the batch's statistics,
    the biased variance recovered from its saved inverse std, the running
    statistics updated unless `update_stats` is False, then F.relu if
    `relu`."""
    out, mean, invstd = torch.native_batch_norm(x, weight, bias, None, None, True, 0.0, eps)
    if update_stats:
        var = invstd.to(running_var.dtype).reciprocal().square() - eps
        update_running_stats(running_mean, running_var, num_batches_tracked, mean, var,
                             momentum)
    return F.relu(out) if relu else out


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     num_batches_tracked: torch.Tensor, eps: float, momentum: float,
                     relu: bool = False, update_stats: bool = True) -> torch.Tensor:
    """Train-mode BN of (N, C, H, W) x over its own batch (then ReLU if
    `relu`), the running statistics updated unless `update_stats` is
    False: the plain version on the CPU, the kernels on a CUDA tensor
    (made `dense` first; f32, bf16 or f64, else TypeError; channels a
    multiple of 16 bytes, else ValueError); the output keeps x's dtype.  Launches
    on the current stream."""
    if x.device.type == "cpu":
        return batch_norm_train_reference(x, weight, bias, running_mean, running_var,
                                          num_batches_tracked, eps, momentum, relu,
                                          update_stats)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_train runs on the CPU or a CUDA card, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"batch_norm_train takes float32, bfloat16 or float64 CUDA tensors, "
                        f"got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"batch_norm_train needs (N, C, H, W), got {tuple(x.shape)}")
    x = dense(x, x.dtype)
    running = ((running_mean, running_var, num_batches_tracked, momentum) if update_stats
               else None)
    y = _TrainBatchNorm.apply(x, weight, bias, running, eps, bool(relu))
    batch_norm_train.launches += 1
    batch_norm_train.relu_fused += int(bool(relu))
    return y


batch_norm_train.launches = 0
batch_norm_train.relu_fused = 0
