"""Fused eval-mode ResNet bottleneck, kernel K5 (port of
zs3_tpu.ops.pallas_bottleneck).

`fused_bottleneck(x, *params, dilation)` launches the CUDA kernel
(csrc/fused_bottleneck.cu) on a CUDA tensor, one launch per block.  In
bf16 it is one persistent cooperative launch in three phases (y1, y2,
out) on `wgmma` fed by TMA, with the N tile that `plan` picks from the
card's occupancy and weights packed once by `pack_block`; in f32 it is
the exact-FMA parity kernel.  It equals
ops/bottleneck.py's plain `fused_bottleneck` up to the order of the f32
sums.  `fused_stage` sends a CPU tensor to the plain version and a CUDA
tensor to the kernel, block by block, with no fallback between them.
There is no gradient (as on the TPU), and nothing in models/ calls it:
like zs3_tpu's, the kernel is an eval-mode option held against the
trunk's own layers (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping, Optional, Sequence, Union

import torch

from zs3_tpu_torch.ops import bottleneck
from zs3_tpu_torch.ops.cuda_build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = CudaLibrary(
    "fused_bottleneck",
    {
        "zs3_fused_bottleneck_f32": (
            [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P], ctypes.c_int),
        "zs3_fused_bottleneck_f32_plan": ([_I, _I, _I, _I, _I, _P], ctypes.c_int),
        "zs3_fused_bottleneck_bf16": ([_I] * 7 + [_P] * 12, ctypes.c_int),
        "zs3_fused_bottleneck_bf16_ctas_per_sm": ([_I], ctypes.c_int),
        "zs3_cuda_error_string": ([_I], ctypes.c_char_p),
    },
)

BM = 64  # pixels of an M tile: the rows of one warpgroup's wgmma
BK = 64  # K chunk: one 128-byte swizzled row of bf16
RING = 4  # stages of the copy ring (a constant of the kernel)
THREADS = 160  # one consumer warpgroup and one producer warp
# CTAs an SM holds at each N tile, as the occupancy API reported them on an
# NVIDIA H100 80GB HBM3 (144 and 80 registers, 99,392 and 66,624 bytes of
# shared memory): plan's default when it is not given the card's.
H100_CTAS_PER_SM = {64: 3, 128: 2}


@dataclasses.dataclass(frozen=True)
class PackedBlock:
    """A block's weights cast once to the kernel's dtype and laid out for
    it.  bf16: the transposes w1t (P, C), w2t (9 P, P) (tap-major, then
    output channel) and w3t (C, P), each K-major for `wgmma`'s B operand;
    f32: w1 (C, P), w2 (3, 3, P, P), w3 (P, C) as given.  The
    biases are f32."""

    dtype: torch.dtype
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor

    @property
    def channels(self) -> int:
        return int(self.b3.shape[0])

    @property
    def planes(self) -> int:
        return int(self.b1.shape[0])


def pack_block(params: bottleneck.Block, dtype: torch.dtype) -> PackedBlock:
    """Cast and lay out (w1, b1, w2, b2, w3, b3) once for the kernel."""
    w1, b1, w2, b2, w3, b3 = params
    c, p = (int(s) for s in w1.shape)
    shapes = [tuple(t.shape) for t in params]
    if shapes != [(c, p), (p,), (3, 3, p, p), (p,), (p, c), (c,)]:
        raise ValueError(f"block shapes {shapes} do not fit {c} channels and {p} planes")
    w1, w2, w3 = (t.detach().to(dtype) for t in (w1, w2, w3))
    if dtype == torch.bfloat16:
        w1, w3 = w1.t(), w3.t()
        w2 = w2.permute(0, 1, 3, 2).reshape(9 * p, p)
    b1, b2, b3 = (t.detach().float().contiguous() for t in (b1, b2, b3))
    return PackedBlock(dtype, w1.contiguous(), b1, w2.contiguous(), b2, w3.contiguous(), b3)


def unpack_block(packed: PackedBlock) -> bottleneck.Block:
    """The (w1, b1, w2, b2, w3, b3) a PackedBlock holds, in zs3_tpu's
    layouts and the packed dtype."""
    w1, w2, w3 = packed.w1, packed.w2, packed.w3
    if packed.dtype == torch.bfloat16:
        p = packed.planes
        w1, w3 = w1.t(), w3.t()
        w2 = w2.reshape(3, 3, p, p).permute(0, 1, 3, 2)
    return (w1.contiguous(), packed.b1, w2.contiguous(), packed.b2, w3.contiguous(), packed.b3)


def ring_bytes(bn: int) -> int:
    """Shared memory of a bf16 CTA: alignment slack, the ring's A and B
    tiles, a full and an empty mbarrier a stage."""
    return 1024 + RING * (BM * BK * 2 + bn * BK * 2) + 2 * RING * 8


def plan(x_shape, planes: int, dilation: int, dtype: torch.dtype,
         sm_count: Optional[int] = None,
         ctas_per_sm: Optional[Mapping[int, int]] = None) -> dict:
    """How a launch lays out (B, H, W, C) x with `planes` planes at
    `dilation`.

    bf16 (pure; C and P multiples of 64, else ValueError): the N tile
    `bn`, the row width `row_width` = W + 2d and rows `pad_rows` = H + 2d
    of y1's padded scratch, per phase ("A" y1, "B" y2, "C" out) its M
    tiles of `bm` pixels or raster positions, N tiles, K chunks of 64 and
    items, the ring depth, the shared-memory bytes of a CTA, the grid on
    `sm_count` SMs (132 when None) holding `ctas_per_sm` CTAs each (the
    card's occupancy at each N tile, `resident_ctas`; H100_CTAS_PER_SM
    when None), and the share of phase B's positions that fall in the
    pad.  The N tile is 128 unless P or C is not a multiple of 128 or
    phase B would then leave CTAs of the grid without an item; the kernel
    takes the shape and the N tile and derives the same layout itself.
    f32: the exact-FMA kernel's tile from its C planner (builds the
    library)."""
    b, h, w, c = (int(s) for s in x_shape)
    p, d = int(planes), int(dilation)
    if min(b, h, w, c, p, d) < 1:
        raise ValueError(f"fused_bottleneck: bad shape {tuple(x_shape)}, {p} planes, "
                         f"dilation {d}")
    if dtype == torch.float32:
        info = (ctypes.c_int * 4)()
        if _LIB.get().zs3_fused_bottleneck_f32_plan(h, w, c, p, d, info) != 0:
            raise ValueError(f"fused_bottleneck: no tile of {tuple(x_shape)} with {p} planes "
                             f"at dilation {d} fits shared memory")
        return dict(zip(("tile_rows", "tile_cols", "halo_pixels", "smem_bytes"), info),
                    route="fma")
    if dtype != torch.bfloat16:
        raise TypeError(f"fused_bottleneck takes float32 or bfloat16, got {dtype}")
    if c % 64 or p % 64:
        raise ValueError(f"fused_bottleneck: bf16 needs channels ({c}) and planes ({p}) "
                         "that are multiples of 64")
    wt, hp = w + 2 * d, h + 2 * d
    tiles_img = -(-h * wt // BM)
    m_tiles = -(-b * h * w // BM)
    sms = 132 if sm_count is None else int(sm_count)
    per_sm = dict(H100_CTAS_PER_SM if ctas_per_sm is None else ctas_per_sm)
    # N tiles of 128 halve the re-reads of each A tile, unless phase B
    # would then leave CTAs without an item (layer3 at batch 4).
    wide = p % 128 == 0 and c % 128 == 0
    bn = 128 if wide and b * tiles_img * (p // 128) >= sms * per_sm[128] else 64
    phases = {
        "A": (m_tiles, p // bn, c // BK),
        "B": (b * tiles_img, p // bn, 9 * p // BK),
        "C": (m_tiles, c // bn, p // BK),
    }
    return {
        "route": "wgmma", "shape": (b, h, w, c), "planes": p, "dilation": d, "bm": BM,
        "bn": bn, "row_width": wt, "pad_rows": hp, "tiles_per_image": tiles_img,
        "phases": {k: {"m_tiles": m, "n_tiles": n, "k_chunks": kc, "items": m * n}
                   for k, (m, n, kc) in phases.items()},
        "ring": RING, "smem_bytes": ring_bytes(bn), "threads": THREADS,
        "ctas_per_sm": per_sm[bn], "grid": sms * per_sm[bn], "pad_share": (wt - w) / wt,
    }


@functools.lru_cache(maxsize=None)
def resident_ctas(device_index: int) -> tuple:
    """(SMs, {N tile: CTAs an SM holds}) of the bf16 kernel on a card, by
    the occupancy API, asked once per card (builds the library).  The
    launch takes its grid from the same query."""
    lib = _LIB.get()
    with torch.cuda.device(device_index):
        per_sm = {bn: lib.zs3_fused_bottleneck_bf16_ctas_per_sm(bn) for bn in (64, 128)}
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    for bn, n in per_sm.items():
        if n < 1:
            msg = lib.zs3_cuda_error_string(-n).decode() if n < 0 else "no CTA fits an SM"
            raise RuntimeError(f"fused_bottleneck: occupancy at N tile {bn}: {msg}")
    return sms, per_sm


@functools.lru_cache(maxsize=1024)
def _n_tile(shape: tuple, planes: int, dilation: int, device_index: int) -> int:
    """plan's N tile for a bf16 launch on a card, kept per shape."""
    sms, per_sm = resident_ctas(device_index)
    return plan(shape, planes, dilation, torch.bfloat16, sms, per_sm)["bn"]


_Params = Union[PackedBlock, torch.Tensor]


def _check(x, packed: PackedBlock):
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"fused_bottleneck needs contiguous NHWC x, got {tuple(x.shape)}")
    if packed.channels != x.shape[-1]:
        raise ValueError(f"block of {packed.channels} channels for x of {x.shape[-1]}")
    tensors = (packed.w1, packed.b1, packed.w2, packed.b2, packed.w3, packed.b3)
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_bottleneck: x and the block's weights on different devices")


def fused_bottleneck(x: torch.Tensor, *params: _Params, dilation: int = 1) -> torch.Tensor:
    """(B, H, W, C) contiguous CUDA x, f32 or bf16 -> the block's output in
    x's dtype (kernel K5).  `params` is (w1, b1, w2, b2, w3, b3) in
    zs3_tpu's layouts, packed here for this call, or one PackedBlock of
    x's dtype.  Launches on the current stream;
    `fused_bottleneck.launches` counts the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_bottleneck takes float32 or bfloat16, got {x.dtype}")
    if len(params) not in (1, 6):
        raise TypeError(f"fused_bottleneck takes 6 tensors or one PackedBlock, got {len(params)}")
    packed = params[0] if len(params) == 1 else None
    tensors = (x,) if packed is not None else (x, *params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("fused_bottleneck has no gradient: call it under no_grad or "
                           "inference_mode")
    if packed is None:
        packed = pack_block(params, x.dtype)
    elif packed.dtype != x.dtype:
        raise TypeError(f"block packed for {packed.dtype}, x is {x.dtype}")
    _check(x, packed)
    bsz, h, w, c = x.shape
    p, d = packed.planes, int(dilation)
    lib = _LIB.get()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        out = torch.empty_like(x)
        if x.dtype == torch.float32:
            rc = lib.zs3_fused_bottleneck_f32(
                x.data_ptr(), bsz, h, w, c, p, d, packed.w1.data_ptr(), packed.b1.data_ptr(),
                packed.w2.data_ptr(), packed.b2.data_ptr(), packed.w3.data_ptr(),
                packed.b3.data_ptr(), out.data_ptr(), stream)
        else:
            bn = _n_tile(tuple(x.shape), p, d, x.device.index)
            y1p = torch.empty((bsz, h + 2 * d, w + 2 * d, p), dtype=x.dtype, device=x.device)
            y2 = torch.empty((bsz * h * w, p), dtype=x.dtype, device=x.device)
            counter = torch.zeros(1, dtype=torch.int32, device=x.device)
            rc = lib.zs3_fused_bottleneck_bf16(
                bsz, h, w, c, p, d, bn, x.data_ptr(), packed.w1.data_ptr(), packed.b1.data_ptr(),
                packed.w2.data_ptr(), packed.b2.data_ptr(), packed.w3.data_ptr(),
                packed.b3.data_ptr(), y1p.data_ptr(), y2.data_ptr(), counter.data_ptr(),
                out.data_ptr(), stream)
    if rc != 0:
        msg = lib.zs3_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_bottleneck launch failed: {msg} ({rc})")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0


def fused_stage(x: torch.Tensor, blocks: Sequence[Union[bottleneck.Block, PackedBlock]],
                dilations: Sequence[int]) -> torch.Tensor:
    """Consecutive identity blocks on NHWC x: the plain version on the
    CPU, one K5 launch per block on the GPU, each block packed once."""
    if x.device.type == "cpu":
        raw = [unpack_block(b) if isinstance(b, PackedBlock) else b for b in blocks]
        return bottleneck.fused_stage(x, raw, dilations)
    x = x.contiguous()
    packed = [b if isinstance(b, PackedBlock) else pack_block(b, x.dtype) for b in blocks]
    for blk, d in zip(packed, dilations):
        x = fused_bottleneck(x, blk, dilation=d)
    return x
