"""Split attention of radix 2 (ResNeSt's SplAt), its memory-bound ends:
csrc/split_attention.cu.

A SplAt block's grouped conv gives u, (N, 2C, H, W), whose splits u_0 =
channels [0, C) and u_1 = [C, 2C) are mixed per channel by a two-way
softmax over a gate on their global mean (models/resnest.py):

    g = mean_hw(u_0 + u_1);  z = gate(g);  a = softmax_r(z);  out = a_0 u_0 + a_1 u_1

`split_attention(u, gate)` computes it with `gate` (fc1, BN, ReLU, fc2)
run by torch in between, on g and z in the accumulation type (f32 for
bf16 u: the gate's BN normalises N global means that differ little from
image to image, which magnifies rounding; models/resnest.py).  On a CUDA tensor
four kernels do the rest:
`splat_gap` (g, one read of u), `splat_combine` (the softmax and out,
one read of u and one write of out), and backward `splat_bwd_reduce`
(sum_hw dy u_r and the softmax's backward, one read of dy and u) and
`splat_dx` (du_r = a_r dy + dg / HW, one read of dy and one write of du).

du has two parts that autograd would bring from two places: a_r dy from
the combine, dg / HW from the mean, after the gate's backward.  So that
one pass writes both, the combine's backward (which runs first: the gate
lies between) leaves dy and a with a `_Pair` the mean's backward shares,
returns no gradient for u itself, and the mean's backward writes the
whole of du.

On the CPU the same two autograd functions run the plain versions
(`gap_reference`, `combine_reference`, `bwd_reduce_reference`,
`dx_reference`: torch ops, accumulating as the kernels do), with no
fallback between the two.  bf16 and f32 accumulate in f32, f64 in f64.
`split_attention.launches` counts the calls that took the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from zs3_tpu_torch.ops.bn_kernels import (
    CTAS_PER_SM,
    MAX_MERGE,
    THREADS,
    TX_BY_GROUPS,
    WORK_LOCK,
    acc_dtype,
    dense,
    workspace,
)
from zs3_tpu_torch.ops.cuda_build import CudaLibrary

DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}  # the C side's Geometry.type

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = CudaLibrary(
    "split_attention",
    {
        "zs3_splat_gap": ([_P] * 6, _I),
        "zs3_splat_combine": ([_P] * 6, _I),
        "zs3_splat_bwd_reduce": ([_P] * 8, _I),
        "zs3_splat_dx": ([_P] * 6, _I),
        "zs3_splat_error_string": ([_I], ctypes.c_char_p),
    },
)


class Plan(NamedTuple):
    vec: int  # channels a thread loads at once: 16 bytes
    tx: int  # channel groups of a CTA (a power of two)
    ty: int  # rows of a CTA walked at once, THREADS // tx
    cblocks: int  # channel blocks of tx * vec channels of C
    slabs: int  # slabs of an image's pixels, each non-empty
    rows_per_slab: int


@functools.lru_cache(maxsize=256)
def plan(n: int, pixels: int, channels: int, dtype: torch.dtype, sm_count: int = 132) -> Plan:
    """How the kernels cover n images of `pixels` rows of 2 x `channels`
    (C) values of `dtype`.

    A thread takes 16 bytes of C's channels (8 bf16, 4 f32, 2 f64), in both
    splits; a CTA takes tx of those groups (BN's widths: ops/bn_kernels.py)
    and the grid (channel blocks, slabs, n) as many slabs of an image as
    fit CTAS_PER_SM CTAs an SM in one wave (at least one), but no more
    than give each thread a row, nor than MAX_MERGE partials a thread of
    the last CTA to sum.  (Rounding up to a second wave left its 84 of 480
    CTAs alone on the card: the two reductions at 63-69% of their bytes
    bound on the cell's stage shapes.)
    TypeError for a dtype, ValueError for no values or C not a multiple
    of 16 bytes."""
    if dtype not in DTYPES:
        raise TypeError(f"split_attention takes float32, bfloat16 or float64, got {dtype}")
    n, pixels, channels = int(n), int(pixels), int(channels)
    vec = 16 // dtype.itemsize
    if n < 1 or pixels < 1 or channels < 1 or channels % vec:
        raise ValueError(f"split_attention needs each split's channels in a multiple of {vec} "
                         f"{dtype} values, got {n} images of {pixels} pixels, C = {channels}")
    groups = channels // vec
    widest = next((tx for most, tx in TX_BY_GROUPS if groups <= most), 32)
    tx = min(widest, 1 << (groups - 1).bit_length())
    ty = THREADS // tx
    cblocks = -(-groups // tx)
    slabs = max(1, min(CTAS_PER_SM * sm_count // (cblocks * n), -(-pixels // ty),
                       MAX_MERGE * ty))
    rows_per_slab = -(-pixels // slabs)
    return Plan(vec, tx, ty, cblocks, -(-pixels // rows_per_slab), rows_per_slab)


@functools.lru_cache(maxsize=256)
def _geometry(n: int, pixels: int, channels: int, dtype: torch.dtype, device_index: int):
    """(plan on the card's SMs, the C interface's geometry array)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    p = plan(n, pixels, channels, dtype, sms)
    geometry = (ctypes.c_longlong * 8)(_TYPE_CODE[dtype], n, pixels, channels, p.tx, p.cblocks,
                                       p.slabs, p.rows_per_slab)
    return p, geometry


def _launch(fn: str, u: torch.Tensor, pointers, reduces: bool) -> None:
    """`fn` of the library for u's (N, 2C, H, W) on its device and current
    stream: the geometry, `pointers` (device tensors'), and for a
    reduction the plan's share of the BN kernels' per-stream workspace."""
    lib = _LIB.get()
    n, c2, h, w = u.shape
    layout, geometry = _geometry(n, h * w, c2 // 2, u.dtype, u.device.index)
    index = u.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        with WORK_LOCK:
            work = ()
            if reduces:
                part, tickets = workspace(
                    u.device, stream, n * layout.slabs * c2 * acc_dtype(u.dtype).itemsize,
                    n * layout.cblocks)
                work = (part.data_ptr(), tickets.data_ptr())
            rc = getattr(lib, fn)(geometry, *pointers, *work, stream)
    if rc != 0:
        raise RuntimeError(f"split_attention launch failed: "
                           f"{lib.zs3_splat_error_string(rc).decode()} ({rc})")


def gap_reference(u: torch.Tensor) -> torch.Tensor:
    """Plain version of splat_gap: (N, C) mean over the pixels of u_0 +
    u_1, in acc_dtype."""
    c = u.shape[1] // 2
    acc = acc_dtype(u.dtype)
    return (u[:, :c].to(acc) + u[:, c:].to(acc)).mean((2, 3))


def combine_reference(u: torch.Tensor, z: torch.Tensor):
    """Plain version of splat_combine: (out, a) with a (N, 2C) the softmax
    over r of the (N, 2C) logits z in acc_dtype, and out = a_0 u_0 + a_1
    u_1 in u's dtype."""
    n, c2 = u.shape[:2]
    c = c2 // 2
    acc = acc_dtype(u.dtype)
    a = torch.softmax(z.reshape(n, 2, c).to(acc), dim=1)
    out = a[:, 0, :, None, None] * u[:, :c].to(acc) + a[:, 1, :, None, None] * u[:, c:].to(acc)
    return out.to(u.dtype), a.reshape(n, c2)


def bwd_reduce_reference(dy: torch.Tensor, u: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain version of splat_bwd_reduce: the (N, 2C) gradient of the
    logits, a_r (da_r - sum_r' a_r' da_r') with da_r = sum_hw dy u_r, in
    acc_dtype."""
    n, c2 = u.shape[:2]
    c = c2 // 2
    acc = acc_dtype(u.dtype)
    d = dy.to(acc)
    da = torch.stack([(d * u[:, :c].to(acc)).sum((2, 3)), (d * u[:, c:].to(acc)).sum((2, 3))], 1)
    a = a.reshape(n, 2, c).to(acc)
    dz = a * (da - (a * da).sum(1, keepdim=True))
    return dz.reshape(n, c2)


def dx_reference(dy: torch.Tensor, a: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    """Plain version of splat_dx: du_r = a_r dy + dg / HW, (N, 2C, H, W)
    in dy's dtype."""
    n, c, h, w = dy.shape
    acc = acc_dtype(dy.dtype)
    a = a.reshape(n, 2, c, 1, 1).to(acc)
    k = dg.reshape(n, c, 1, 1).to(acc) / (h * w)
    d = dy.to(acc)
    return torch.cat([a[:, 0] * d + k, a[:, 1] * d + k], 1).to(dy.dtype)


class _Pair:
    """What the combine's backward leaves for the mean's: dy and a."""

    __slots__ = ("dy", "a")

    def __init__(self):
        self.dy = self.a = None


class _SplatGap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, pair):
        n, c2, h, w = u.shape
        ctx.pair, ctx.shape, ctx.dtype = pair, (n, c2, h, w), u.dtype
        if not u.is_cuda:
            return gap_reference(u)
        g = u.new_empty((n, c2 // 2), dtype=acc_dtype(u.dtype))
        _launch("zs3_splat_gap", u, (u.data_ptr(), g.data_ptr()), reduces=True)
        return g

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dg):
        pair, (n, c2, h, w) = ctx.pair, ctx.shape
        dy, a = pair.dy, pair.a
        pair.dy = pair.a = None
        if dy is None:  # out took no part in what is differentiated
            dy = dg.new_zeros((n, c2 // 2, h, w), dtype=ctx.dtype)
            dy = dy.contiguous(memory_format=torch.channels_last)
            a = dg.new_zeros((n, c2), dtype=acc_dtype(ctx.dtype))
        dg = dense(dg, acc_dtype(dy.dtype), torch.contiguous_format)
        if not dy.is_cuda:
            return dx_reference(dy, a, dg), None
        du = torch.empty((n, c2, h, w), dtype=dy.dtype, device=dy.device,
                         memory_format=torch.channels_last)
        _launch("zs3_splat_dx", du, (dy.data_ptr(), a.data_ptr(), dg.data_ptr(), du.data_ptr()),
                reduces=False)
        return du, None


class _SplatCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, z, pair):
        n, c2, h, w = u.shape
        ctx.z_shape = z.shape
        z = dense(z.reshape(n, c2), acc_dtype(u.dtype), torch.contiguous_format)
        if not u.is_cuda:
            out, a = combine_reference(u, z)
        else:
            out = torch.empty((n, c2 // 2, h, w), dtype=u.dtype, device=u.device,
                              memory_format=torch.channels_last)
            a = u.new_empty((n, c2), dtype=acc_dtype(u.dtype))
            _launch("zs3_splat_combine", u,
                    (u.data_ptr(), z.data_ptr(), out.data_ptr(), a.data_ptr()), reduces=False)
        ctx.save_for_backward(u, a)
        ctx.pair = pair
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        u, a = ctx.saved_tensors
        n, c2 = u.shape[:2]
        dy = dense(dy, u.dtype) if u.is_cuda else dy.to(u.dtype)
        if ctx.needs_input_grad[0]:  # the mean's backward writes du whole
            ctx.pair.dy, ctx.pair.a = dy, a
        if not u.is_cuda:
            dz = bwd_reduce_reference(dy, u, a)
        else:
            dz = u.new_empty((n, c2), dtype=a.dtype)
            _launch("zs3_splat_bwd_reduce", u,
                    (dy.data_ptr(), u.data_ptr(), a.data_ptr(), dz.data_ptr()), reduces=True)
        return None, dz.reshape(ctx.z_shape) if ctx.needs_input_grad[1] else None, None


def split_attention(u: torch.Tensor, gate: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Radix-2 split attention of the (N, 2C, H, W) tensor u: out = a_0 u_0
    + a_1 u_1, a the softmax over r of gate(g) for g = mean_hw(u_0 + u_1),
    (N, C, 1, 1) in acc_dtype, and gate's (N, 2C, 1, 1) logits.  The plain
    version on the CPU, the kernels on a CUDA tensor (made channels_last
    and aligned first; f32, bf16 or f64, else TypeError; C a multiple of 16
    bytes, else ValueError); out is channels_last in u's dtype.  Launches
    on the current stream."""
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"split_attention runs on the CPU or a CUDA card, got {u.device}")
    if u.ndim != 4 or u.shape[1] % 2:
        raise ValueError(f"split_attention needs (N, 2C, H, W), got {tuple(u.shape)}")
    if u.is_cuda:
        if u.dtype not in DTYPES:
            raise TypeError(f"split_attention takes float32, bfloat16 or float64 CUDA tensors, "
                            f"got {u.dtype}")
        n, c2, h, w = u.shape
        plan(n, h * w, c2 // 2, u.dtype)  # refuses what the kernels do not take
        u = dense(u, u.dtype)
    n, c2 = u.shape[:2]
    pair = _Pair()
    g = _SplatGap.apply(u, pair).reshape(n, c2 // 2, 1, 1)
    out = _SplatCombine.apply(u, gate(g), pair)
    if u.is_cuda:
        split_attention.launches += 1
    return out


split_attention.launches = 0
