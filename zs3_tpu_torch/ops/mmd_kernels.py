"""Kernel sums for the MMD loss (port of zs3_tpu.ops.pallas_mmd).

The generator's MMD needs three weighted Gaussian kernel sums per class
(fake-fake, real-real, fake-real).  The plain version materialises the
(N, M) distance and kernel matrices; the CUDA kernels in
csrc/mmd_kernel_sum.cu never do: K2 computes the sums, K3 the gradient
with respect to one side.  Both run their products (K2's x.y^T, K3's
x.y^T and C.y) on the tensor cores in 3xTF32: each f32 operand becomes a
TF32 high part and a TF32 residual, and hi.hi + hi.lo + lo.hi is
accumulated in f32, which keeps f32's accuracy where one TF32 product
would not.  `sum_plan` lays out K2's launch (how many CTAs share a
class's 32 x 32 tile pairs, so that the card is full; the last CTA of a
class sums the class's partials in a fixed order), `grad_plan` K3's
(thread-block clusters that split the y rows when the x tiles alone
would not fill the card).  `KernelSum` is the autograd.Function over a
batch of classes whose forward is K2 (over the pairs a <= b only when
both sides are one tensor) and whose backward launches K3 once for each
side that needs a gradient (with the arguments swapped for y), as
zs3_tpu's custom VJP does, and once in all when both sides are the same
tensor.  On a CPU tensor it runs the plain versions; on a CUDA tensor it
launches the kernels or raises.

`kernel_mmd_loss` and `batched_kernel_mmd_loss` assemble the sqrt-MMD
with the oracle's own `assemble_sqrt_mmd` and `mean_over_present_classes`
(zs3_tpu_torch.ops.mmd), so only the kernel-sum backend differs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from zs3_tpu_torch.ops.cuda_build import CudaLibrary
from zs3_tpu_torch.ops.mmd import (
    DEFAULT_SIGMAS,
    _kernel_sum,
    assemble_sqrt_mmd,
    mean_over_present_classes,
    pairwise_sq_dists,
    resolve_weights,
)

MAX_FEATURES = 512
MAX_SIGMAS = 8

# The kernels' tiles (csrc/mmd_kernel_sum.cu): CTAs of GRAD_THREADS threads
# over tiles of GRAD_ROWS rows, y tiles through a ring of GRAD_STAGES,
# features padded to panels of GRAD_PANEL.  K3 (kernel_sum_grad_3xtf32)
# owns tiles of x rows; K2 (kernel_sum_3xtf32) walks (x tile, y tile) pairs.
GRAD_ROWS = 32
GRAD_THREADS = 256
GRAD_STAGES = 2
GRAD_PANEL = 32
GRAD_RED_PITCH = 40
GRAD_SMALL_FLOATS = 6 * GRAD_ROWS
SUM_SMALL_FLOATS = (2 + 2 * GRAD_STAGES) * GRAD_ROWS + GRAD_THREADS // 32
SUM_CTAS_PER_SM = 2  # K2's __launch_bounds__ minimum
MAX_CLUSTER = 8
SM_COUNT = 132  # H100 SXM
MAX_SHARED_BYTES = 232_448  # H100: dynamic shared memory one CTA may take
SM_SHARED_BYTES = 233_472  # H100: shared memory of an SM, 1 KB of it reserved per CTA

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUM_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I]  # x, y, wx, wy, C, N, M, D, sigmas, S
_LIB = CudaLibrary(
    "mmd_kernel_sum",
    {
        "zs3_mmd_kernel_sum": (_SUM_ARGS + [_I, _I, _P, _P, _P, _P], ctypes.c_int),
        "zs3_mmd_kernel_sum_grad": (_SUM_ARGS + [_P, _P, _I, _P], ctypes.c_int),
        "zs3_mmd_sum_smem": ([_I], ctypes.c_int),
        "zs3_mmd_sum_ctas_per_sm": ([_I], ctypes.c_int),
        "zs3_mmd_grad_smem": ([_I], ctypes.c_int),
        "zs3_mmd_grad_ctas_per_sm": ([_I], ctypes.c_int),
        "zs3_mmd_error_string": ([_I], ctypes.c_char_p),
    },
)


def _check(x, y, wx, wy, name: str) -> Tuple[int, int, int, int]:
    """(C, N, M, D) after checking what the kernels take."""
    for t in (x, y, wx, wy):
        if t.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} needs float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    if x.ndim != 3 or y.ndim != 3 or wx.ndim != 2 or wy.ndim != 2:
        raise ValueError(
            f"{name} needs x (C,N,D), y (C,M,D), wx (C,N), wy (C,M); got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(wx.shape)}, {tuple(wy.shape)}"
        )
    c, n, d = x.shape
    m = y.shape[1]
    if y.shape[0] != c or y.shape[2] != d or tuple(wx.shape) != (c, n) or tuple(wy.shape) != (c, m):
        raise ValueError(
            f"{name}: mismatched shapes {tuple(x.shape)}, {tuple(y.shape)}, "
            f"{tuple(wx.shape)}, {tuple(wy.shape)}"
        )
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"{name} takes 1..{MAX_FEATURES} features, got {d}")
    if min(c, n, m) < 1 or c >= 2**16 or c * max(n, m) * d >= 2**31:
        raise ValueError(f"{name}: bad sizes C={c} N={n} M={m} D={d}")
    if len({x.device, y.device, wx.device, wy.device}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    return c, n, m, d


def _sigma_array(sigmas: Sequence[float]):
    if not 1 <= len(sigmas) <= MAX_SIGMAS:
        raise ValueError(f"1..{MAX_SIGMAS} sigmas, got {len(sigmas)}")
    return (ctypes.c_float * len(sigmas))(*(float(s) for s in sigmas))


def _raise_on(lib, rc: int, name: str):
    if rc != 0:
        msg = lib.zs3_mmd_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


def sum_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one K2 CTA at d features (the kernel's
    sum_smem_bytes): K3's tiles and `red`, the x row norms and weights,
    a pair of |y|^2 and wy rows for each stage of the ring, the warps'
    sums and the mbarriers."""
    dp = -(-d // GRAD_PANEL) * GRAD_PANEL
    floats = (GRAD_ROWS * dp * (1 + GRAD_STAGES) + 2 * GRAD_ROWS * GRAD_RED_PITCH
              + SUM_SMALL_FLOATS)
    return 1024 + 4 * floats + 8 * (GRAD_STAGES + 1)


def sum_plan(c: int, n: int, m: int, d: int, symmetric: bool = False) -> dict:
    """How K2 lays out a call over x (c,n,d) and y (c,m,d): a class's work
    is its (x tile, y tile) pairs of 32 x 32 rows in row-major order (the
    pairs a <= b when `symmetric`: x is y, counted twice off the
    diagonal), cut into `split` contiguous runs, one CTA each, on a grid
    (split, c).  `split` fills the CTAs the card holds at once (SM_COUNT
    times what shared memory and the launch bounds let an SM hold), then
    shrinks while the longest run stays as long: 8 at (21, 128, 128,
    256), 168 CTAs of 2 pairs.  Raises on sizes the kernel refuses."""
    if not 1 <= d <= MAX_FEATURES or min(c, n, m) < 1 or (symmetric and n != m):
        raise ValueError(f"kernel_sum: bad sizes C={c} N={n} M={m} D={d} symmetric={symmetric}")
    smem = sum_smem_bytes(d)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"kernel_sum: {smem} bytes of shared memory at D={d}")
    x_tiles, y_tiles = -(-n // GRAD_ROWS), -(-m // GRAD_ROWS)
    pairs = y_tiles * (y_tiles + 1) // 2 if symmetric else x_tiles * y_tiles
    per_sm = min(SUM_CTAS_PER_SM, SM_SHARED_BYTES // (smem + 1024))
    split = min(pairs, max(1, SM_COUNT * per_sm // c))
    per_cta = -(-pairs // split)
    split = -(-pairs // per_cta)
    return {
        "rows": GRAD_ROWS, "x_tiles": x_tiles, "y_tiles": y_tiles, "symmetric": symmetric,
        "pairs": pairs, "split": split, "pairs_per_cta": per_cta, "grid": (split, c),
        "ctas": split * c, "ctas_per_sm": per_sm, "threads": GRAD_THREADS,
        "stages": GRAD_STAGES, "d_pad": -(-d // GRAD_PANEL) * GRAD_PANEL, "smem_bytes": smem,
    }


_WORKSPACE = {}


def _workspace(device: torch.device, stream: int, c: int, split: int):
    """K2's (tickets, partials) for a call on `stream`: kept from call to
    call, so there is no allocation and no memset a call.  The tickets are
    zeroed once, when made, and every launch leaves them 0; a stream has
    its own, as two launches in flight at once must not share them."""
    key = (device, stream)
    tickets, partials = _WORKSPACE.get(key, (None, None))
    if tickets is None or tickets.numel() < c:
        tickets = torch.zeros(c, dtype=torch.int32, device=device)
    if partials is None or partials.numel() < c * split:
        partials = torch.empty(c * split, dtype=torch.float32, device=device)
    _WORKSPACE[key] = tickets, partials
    return tickets, partials


def kernel_sum(
    x: torch.Tensor,
    y: torch.Tensor,
    wx: torch.Tensor,
    wy: torch.Tensor,
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
    symmetric: bool = False,
) -> torch.Tensor:
    """K2: (C,) sums_ij wx_i wy_j sum_s exp(-d2_ij / (2 sigma_s)) per class,
    for x (C,N,D), y (C,M,D), wx (C,N), wy (C,M) f32 CUDA tensors.  With
    `symmetric` (y is x and wy is wx) it takes the tile pairs a <= b only
    and counts those off the diagonal twice.

    One launch on the current stream, laid out by `sum_plan`; the class
    sums are taken in a fixed order, so repeated calls agree bit for bit.
    `kernel_sum.launches` counts the calls."""
    c, n, m, d = _check(x, y, wx, wy, "kernel_sum")
    if symmetric and (x.data_ptr() != y.data_ptr() or wx.data_ptr() != wy.data_ptr()
                      or n != m):
        raise ValueError("kernel_sum: symmetric needs y to be x and wy to be wx")
    plan = sum_plan(c, n, m, d, symmetric)
    sig = _sigma_array(sigmas)
    lib = _LIB.get()
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tickets, partials = _workspace(x.device, stream, c, plan["split"])
        rc = lib.zs3_mmd_kernel_sum(
            x.data_ptr(), y.data_ptr(), wx.data_ptr(), wy.data_ptr(), c, n, m, d,
            sig, len(sigmas), plan["split"], int(symmetric), tickets.data_ptr(),
            partials.data_ptr(), out.data_ptr(), stream,
        )
    _raise_on(lib, rc, "kernel_sum")
    kernel_sum.launches += 1
    return out


kernel_sum.launches = 0


def grad_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one K3 CTA at d features (the kernel's
    grad_smem_bytes): alignment slack, the x tile and the y ring (d padded
    to panels of 32, 32 rows each), the C tile's two TF32 parts, the row
    norms, weights and partial sums, and the ring's mbarriers."""
    dp = -(-d // GRAD_PANEL) * GRAD_PANEL
    floats = (GRAD_ROWS * dp * (1 + GRAD_STAGES) + 2 * GRAD_ROWS * GRAD_RED_PITCH
              + GRAD_SMALL_FLOATS)
    return 1024 + 4 * floats + 8 * (GRAD_STAGES + 1)


def grad_plan(c: int, n: int, m: int, d: int) -> dict:
    """How K3 lays out a call over x (c,n,d) and y (c,m,d): a CTA owns
    (class, tile of 32 x rows, cluster rank); the `cluster` CTAs of a tile
    split its y tiles (rank r takes r, r + cluster, ...) and sum their
    partial C.y in rank order through distributed shared memory, rank r
    writing rows [32 r / cluster, 32 (r + 1) / cluster) of the tile.  The
    cluster doubles from 1 while the CTAs fill fewer than the card's
    SM_COUNT SMs and the y tiles allow (at most 8): 2 at (21, 128, 128,
    256), 168 CTAs.  Raises on sizes the kernel refuses."""
    if not 1 <= d <= MAX_FEATURES or min(c, n, m) < 1:
        raise ValueError(f"kernel_sum_grad: bad sizes C={c} N={n} M={m} D={d}")
    x_tiles, y_tiles = -(-n // GRAD_ROWS), -(-m // GRAD_ROWS)
    cluster = 1
    while c * x_tiles * cluster < SM_COUNT and 2 * cluster <= min(MAX_CLUSTER, y_tiles):
        cluster *= 2
    dp = -(-d // GRAD_PANEL) * GRAD_PANEL
    smem = grad_smem_bytes(d)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"kernel_sum_grad: {smem} bytes of shared memory at D={d}")
    return {
        "rows": GRAD_ROWS, "x_tiles": x_tiles, "y_tiles": y_tiles, "cluster": cluster,
        "grid": (x_tiles * cluster, c), "ctas": x_tiles * cluster * c,
        "threads": GRAD_THREADS, "stages": GRAD_STAGES, "d_pad": dp,
        "col_tiles_per_warp": -(-dp // 64), "smem_bytes": smem,
    }


def kernel_sum_grad(
    x: torch.Tensor,
    y: torch.Tensor,
    wx: torch.Tensor,
    wy: torch.Tensor,
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
    with_dwx: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3: the gradient of `kernel_sum` with respect to x and wx, per class:
    dx (C,N,D) = C.y - rowsum(C) x with C_ij = wx_i wy_j sum_s e_s/sigma_s,
    dwx (C,N) = sum_j wy_j K_ij (None unless with_dwx).  Both products run
    on the tensor cores in 3xTF32, laid out by `grad_plan`.

    Launches on the current stream; `kernel_sum_grad.launches` counts the
    calls."""
    c, n, m, d = _check(x, y, wx, wy, "kernel_sum_grad")
    plan = grad_plan(c, n, m, d)
    sig = _sigma_array(sigmas)
    lib = _LIB.get()
    dx = torch.empty((c, n, d), dtype=torch.float32, device=x.device)
    dwx = torch.empty((c, n), dtype=torch.float32, device=x.device) if with_dwx else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.zs3_mmd_kernel_sum_grad(
            x.data_ptr(), y.data_ptr(), wx.data_ptr(), wy.data_ptr(), c, n, m, d,
            sig, len(sigmas), dx.data_ptr(), None if dwx is None else dwx.data_ptr(),
            plan["cluster"], stream,
        )
    _raise_on(lib, rc, "kernel_sum_grad")
    kernel_sum_grad.launches += 1
    return dx, dwx


kernel_sum_grad.launches = 0


def kernel_sum_reference(
    x: torch.Tensor,
    y: torch.Tensor,
    wx: torch.Tensor,
    wy: torch.Tensor,
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
) -> torch.Tensor:
    """Plain version of K2 (the oracle's `_kernel_sum` over classes): every
    pair, whether or not x is y."""
    return _kernel_sum(x.float(), y.float(), wx.float(), wy.float(), sigmas)


def kernel_sum_grad_reference(
    x: torch.Tensor,
    y: torch.Tensor,
    wx: torch.Tensor,
    wy: torch.Tensor,
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
    with_dwx: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K3, in the TPU kernel's arithmetic."""
    x, y, wx, wy = x.float(), y.float(), wx.float(), wy.float()
    d2 = pairwise_sq_dists(x, y)
    k = torch.zeros_like(d2)
    c = torch.zeros_like(d2)
    for s in sigmas:
        e = torch.exp(d2 * (-1.0 / (2.0 * float(s))))
        k = k + e
        c = c + e * (1.0 / float(s))
    cw = (wx[..., :, None] * c) * wy[..., None, :]
    dx = cw @ y - cw.sum(-1, keepdim=True) * x
    dwx = (k * wy[..., None, :]).sum(-1) if with_dwx else None
    return dx, dwx


def _operands(x, y, wx, wy, same: bool):
    """The kernels' operands: f32 and contiguous.  When both sides are one
    tensor (`same`) they stay one tensor, converted once, as K2's
    symmetric call requires."""
    x, wx = x.float().contiguous(), wx.float().contiguous()
    if same:
        return x, x, wx, wx
    return x, y.float().contiguous(), wx, wy.float().contiguous()


class KernelSum(torch.autograd.Function):
    """(C,) weighted kernel sums with a kernel for the backward too:
    forward K2, backward K3 once for each side that needs a gradient.
    When x is y and wx is wy (the fake-fake and real-real sums) the kernel
    is symmetric: K2 takes the tile pairs a <= b only, and both sides'
    gradients are the same, so K3 runs once and counts twice.  CPU tensors
    take the plain versions."""

    @staticmethod
    def forward(ctx, x, y, wx, wy, sigmas):
        ctx.sigmas = tuple(float(s) for s in sigmas)
        ctx.same = x is y and wx is wy
        x, y, wx, wy = _operands(x, y, wx, wy, ctx.same)
        ctx.save_for_backward(x, y, wx, wy)
        if x.device.type == "cpu":
            return kernel_sum_reference(x, y, wx, wy, ctx.sigmas)
        return kernel_sum(x, y, wx, wy, ctx.sigmas, symmetric=ctx.same)

    @staticmethod
    def backward(ctx, g):
        x, y, wx, wy = ctx.saved_tensors
        grad = kernel_sum_grad_reference if x.device.type == "cpu" else kernel_sum_grad
        need_x, need_y, need_wx, need_wy = ctx.needs_input_grad[:4]
        dx = dy = dwx = dwy = None
        if ctx.same:
            # x and y are one input: its gradient is both slots' sum.
            gx, gwx = grad(x, y, wx, wy, ctx.sigmas, with_dwx=need_wx)
            dx = (2.0 * g)[:, None, None] * gx if need_x else None
            dwx = (2.0 * g)[:, None] * gwx if need_wx else None
            return dx, None, dwx, None, None
        if need_x or need_wx:
            gx, gwx = grad(x, y, wx, wy, ctx.sigmas, with_dwx=need_wx)
            dx = g[:, None, None] * gx if need_x else None
            dwx = g[:, None] * gwx if need_wx else None
        if need_y or need_wy:
            gy, gwy = grad(y, x, wy, wx, ctx.sigmas, with_dwx=need_wy)
            dy = g[:, None, None] * gy if need_y else None
            dwy = g[:, None] * gwy if need_wy else None
        return dx, dy, dwx, dwy, None


def _sqrt_mmd(fake, real, wf, wr, sigmas) -> torch.Tensor:
    """(C,) sqrt-MMD from three `KernelSum`s over (C, N, D) vs (C, M, D)."""
    sig = tuple(float(s) for s in sigmas)
    k_ff = KernelSum.apply(fake, fake, wf, wf, sig)
    k_rr = KernelSum.apply(real, real, wr, wr, sig)
    k_fr = KernelSum.apply(fake, real, wf, wr, sig)
    return assemble_sqrt_mmd(k_ff, k_rr, k_fr, wf.sum(-1), wr.sum(-1))


def batched_kernel_mmd_loss(
    fake: torch.Tensor,
    real: torch.Tensor,
    fake_mask: torch.Tensor,
    real_mask: torch.Tensor,
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
) -> torch.Tensor:
    """Mean sqrt-MMD over a leading class axis, (C, N, D) vs (C, M, D),
    on `KernelSum`: three K2 launches, and in the backward with respect
    to fake two K3 launches (fake-fake, fake-real)."""
    wf, wr = resolve_weights(fake, real, fake_mask, real_mask)
    per_class = _sqrt_mmd(fake, real, wf, wr, sigmas)
    return mean_over_present_classes(per_class, fake_mask, real_mask)


def kernel_mmd_loss(
    fake: torch.Tensor,
    real: torch.Tensor,
    fake_mask: Optional[torch.Tensor] = None,
    real_mask: Optional[torch.Tensor] = None,
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
) -> torch.Tensor:
    """Drop-in for ops.mmd.mmd_loss, fake (N, D) vs real (M, D), on
    `KernelSum` (a batch of one class)."""
    if fake.ndim != 2 or real.ndim != 2 or fake.shape[1] != real.shape[1]:
        raise ValueError(
            f"kernel_mmd_loss expects (N, D) and (M, D) with equal D; got "
            f"{tuple(fake.shape)} vs {tuple(real.shape)}"
        )
    wf, wr = resolve_weights(fake, real, fake_mask, real_mask)
    return _sqrt_mmd(fake[None], real[None], wf[None], wr[None], sigmas)[0]
