"""Fused 1x1 classify + exact-4x bilinear upsample (port of
zs3_tpu.ops.pallas_tail).

`classify_resize(feats, w, b, size)` equals
``resize_bilinear(feats @ w + b, size, align_corners=True)`` for the
DeepLab os4 -> input geometry ``size = (4(H-1)+1, 4(W-1)+1)``.  The CUDA
kernel (csrc/classify_resize.cu, kernel K4) classifies at the feature
grid in shared memory and writes only the full-resolution logits; the
plain version classifies, then resizes (ops/resize.py).  Output dtype
follows the features (f32 or bf16); the kernel accumulates in f32 (bf16
features classify on the tensor cores) and rounds once at the store,
where the plain bf16 version rounds after the classify and after each
resize product.  There is no gradient (as on the TPU): the kernel is the
inference tail.

The launch is persistent: `plan` picks the work item's width (16, 8 or
4 source columns of an 8-row band) and the grid from the card's SMs and
occupancy; the kernel derives the rest of its layout itself.  Weights
and bias are read as they are (f32, any strides) and rounded to the
features' dtype in the kernel, so a call casts nothing.

`tail_logits` sends a CPU tensor to the plain version and a CUDA tensor
to the kernel, with no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, Optional, Tuple

import torch

from zs3_tpu_torch.ops.cuda_build import CudaLibrary
from zs3_tpu_torch.ops.eval_kernels import MAX_SHARED_BYTES
from zs3_tpu_torch.ops.resize import resize_bilinear

_SRC = 8  # source rows per band (exact 4x: 32 output rows)
MAX_CLASSES = 128
TILE_COLS = (16, 8, 4)  # the work item widths the kernel takes
THREADS = 256
RING = 3  # bf16: stages of the features' copy ring
WARPS = THREADS // 32  # each stages one output row at a time
SM_BYTES = 233_472  # H100: shared memory of an SM, for plan's estimate of residency

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = CudaLibrary(
    "classify_resize",
    {
        "zs3_classify_resize": (
            [_P, _I, _I, _I, _I, _I, _P, _L, _L, _P, _I, _I, _I, _P, _P], ctypes.c_int),
        "zs3_classify_resize_smem": ([_I, _I, _I, _I], ctypes.c_int),
        "zs3_classify_resize_ctas_per_sm": ([_I, _I, _I, _I], ctypes.c_int),
        "zs3_cuda_error_string": ([_I], ctypes.c_char_p),
    },
)


def supported(in_hw: Tuple[int, int], out_hw: Tuple[int, int], num_classes: int) -> bool:
    """True when the fused tail's geometry contract holds: exact 4×
    align-corners upsample on both axes, source rows divisible into
    8-row bands, and at most 128 classes."""
    (h, w), (oh, ow) = in_hw, out_hw
    return (
        oh == 4 * (h - 1) + 1
        and ow == 4 * (w - 1) + 1
        and (h - 1) % _SRC == 0
        and h > _SRC
        and 1 <= num_classes <= MAX_CLASSES
    )


def classify_resize_reference(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, size: Tuple[int, int]
) -> torch.Tensor:
    """Plain version: classify in the features' dtype, then resize."""
    logits = feats @ w.to(feats.dtype) + b.to(feats.dtype)
    return resize_bilinear(logits, size, align_corners=True)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(dtype: torch.dtype, c: int, k: int, tile_cols: int) -> int:
    """Shared memory of one CTA (the kernel's make_geo): alignment slack;
    bf16: the ring (stages of the 9 x (tc + 1) box's pixels, rounded up to
    16, x 64 channels), the weights (8 NT classes x C rounded up to 64, plus 8
    of skew) and the bias; f32: the weights (C x 8 NK) and the bias; then
    the source logits (9, tc + 1, K) f32, a staged output row per warp
    and, for bf16, the ring's mbarriers."""
    esize = 2 if dtype == torch.bfloat16 else 4
    pitch = _round16((4 * tile_cols + 1) * k * esize + 16)
    if dtype == torch.bfloat16:
        need = -(-k // 8)
        np_ = 8 * (need if need <= 4 else 8 if need <= 8 else 16)
        cp = -(-c // 64) * 64
        stage = -(-9 * (tile_cols + 1) // 16) * 16 * 64 * 2  # the box's pixels x 64 channels
        head = RING * stage + _round16(np_ * (cp + 8) * 2) + _round16(np_ * 4)
    else:
        kp = 8 * (1 << max(0, (-(-k // 8) - 1).bit_length()))
        head = _round16(c * kp * 4) + _round16(kp * 4)
    tail = _round16(9 * (tile_cols + 1) * k * 4) + WARPS * pitch
    return 1024 + head + tail + (RING * 8 if dtype == torch.bfloat16 else 0)


def widest_tile(k: int) -> int:
    """The widest work item the classes allow: the staged output rows grow
    with 4 tc K."""
    return 16 if k <= 32 else 8 if k <= 64 else 4


def estimated_ctas(dtype: torch.dtype, c: int, k: int, tc: int) -> int:
    """CTAs an SM holds by shared memory alone (plan's stand-in for the
    card's occupancy)."""
    return max(1, min(8, SM_BYTES // (smem_bytes(dtype, c, k, tc) + 1024)))


def tile_cols(shape, k: int, sm_count: int, ctas_per_sm: Mapping[int, int]) -> int:
    """Source columns of a work item (image, band of 8 source rows, tile):
    the widest the classes allow, unless its items fill the grid
    (`sm_count` x the CTAs an SM holds at that width) less than twice;
    then half of it (on an NVIDIA H100 at K = 21: one request at 129x129,
    128 items of 16 columns, and TTA's 97x97 at batch 4, 288 items, run
    faster at 8 columns; batch 8 at 129x129, 1024 items, and TTA's 161x161
    at batch 4, 800, at 16; chip_smoke.py's tile sweep)."""
    b, h, w = (int(s) for s in shape[:3])
    tc = widest_tile(k)
    items = b * ((h - 1) // _SRC) * max(1, -(-(w - 1) // tc))
    if tc > 4 and items < 2 * sm_count * ctas_per_sm[tc]:
        tc //= 2
    return tc


def plan(shape, k: int, dtype: torch.dtype, sm_count: int = 132,
         ctas_per_sm: Optional[Mapping[int, int]] = None) -> dict:
    """How a launch over (B, H, W, C) features with k classes is laid out:
    the items' `tile_cols`, `bands` and `tiles` (per image) and their
    count; `grid`, the persistent launch: the items, or fewer,
    `sm_count` x the CTAs an SM holds at that tile width (`ctas_per_sm`,
    {tile: CTAs}, the card's occupancy, `resident_ctas`; estimated from
    shared memory alone when None); the CTA's `smem_bytes`; `route`:
    "tma" (bf16 with C % 8 == 0, at an aligned address), "loads" (other
    bf16) or "fma" (f32).  Raises ValueError for a geometry that
    `supported` refuses or a layout that does not fit shared memory."""
    b, h, w, c = (int(s) for s in shape)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"classify_resize takes float32 or bfloat16 features, got {dtype}")
    if min(b, c) < 1 or not supported((h, w), (4 * (h - 1) + 1, 4 * (w - 1) + 1), k):
        raise ValueError(f"classify_resize: unsupported geometry {tuple(shape)} with {k} "
                         "classes")
    if ctas_per_sm is None:
        ctas_per_sm = {tc: estimated_ctas(dtype, c, k, tc) for tc in TILE_COLS}
    tc = tile_cols(shape, k, sm_count, ctas_per_sm)
    bands, tiles = (h - 1) // _SRC, -(-(w - 1) // tc) if w > 1 else 1
    items = b * bands * tiles
    smem = smem_bytes(dtype, c, k, tc)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"classify_resize: {c} channels x {k} classes need {smem} bytes of "
                         f"shared memory, more than {MAX_SHARED_BYTES}")
    route = "fma" if dtype == torch.float32 else "tma" if c % 8 == 0 else "loads"
    return {
        "tile_cols": tc, "bands": bands, "tiles": tiles, "items": items,
        "grid": min(items, sm_count * ctas_per_sm[tc]), "ctas_per_sm": ctas_per_sm[tc],
        "smem_bytes": smem, "threads": THREADS, "route": route,
    }


@functools.lru_cache(maxsize=None)
def resident_ctas(device_index: int, is_bf16: int, c: int, k: int, tile_cols: int) -> int:
    """CTAs of one layout an SM of a card holds, by the occupancy API
    (builds the library), asked once per card and layout."""
    lib = _LIB.get()
    with torch.cuda.device(device_index):
        n = lib.zs3_classify_resize_ctas_per_sm(is_bf16, c, k, tile_cols)
    if n < 1:
        msg = lib.zs3_cuda_error_string(-n).decode() if n < 0 else "no CTA fits an SM"
        raise RuntimeError(f"classify_resize: occupancy: {msg}")
    return n


@functools.lru_cache(maxsize=1024)
def card_plan(shape: tuple, k: int, dtype: torch.dtype, device_index: int) -> dict:
    """plan on a card's SMs and occupancy, kept per shape: what the launch
    takes."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    plan(shape, k, dtype, sms)  # refuses a geometry or a layout the kernel does not take
    widest = widest_tile(k)
    per_sm = {tc: resident_ctas(device_index, int(dtype == torch.bfloat16), shape[3], k, tc)
              for tc in (widest, max(4, widest // 2))}
    return plan(shape, k, dtype, sms, per_sm)


def classify_resize(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, size: Tuple[int, int]
) -> torch.Tensor:
    """(B, H, W, C) CUDA features, (C, K) weights, (K,) bias ->
    (B, HO, WO, K) logits in the features' dtype (kernel K4).

    The kernel rounds w and b to the features' dtype, as the plain
    version's classify does; f32 weights of any strides are read in
    place.  Launches on the current stream; `classify_resize.launches`
    counts the launches.
    """
    if feats.device.type != "cuda":
        raise ValueError(f"classify_resize needs a CUDA tensor, got {feats.device}")
    if torch.is_grad_enabled() and (feats.requires_grad or w.requires_grad or b.requires_grad):
        raise RuntimeError("classify_resize has no gradient: call it under no_grad or "
                           "inference_mode")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"classify_resize takes float32 or bfloat16 features, got {feats.dtype}")
    if feats.ndim != 4 or not feats.is_contiguous():
        raise ValueError(f"classify_resize needs contiguous NHWC features, got "
                         f"{tuple(feats.shape)}")
    bsz, hi, wi, c = feats.shape
    if w.shape[0] != c or w.ndim != 2 or tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"classifier shapes {tuple(w.shape)}, {tuple(b.shape)} do not fit "
                         f"{c} channels")
    k = int(w.shape[1])
    ho, wo = (int(s) for s in size)
    if not supported((hi, wi), (ho, wo), k):
        raise ValueError(f"classify_resize: unsupported geometry {tuple(feats.shape)} -> "
                         f"{(ho, wo)} with {k} classes")
    if w.device != feats.device or b.device != feats.device:
        raise ValueError("classify_resize: features and classifier on different devices")
    layout = card_plan(tuple(feats.shape), k, feats.dtype, feats.device.index)
    w32 = w.detach().float()  # no copy for f32 weights
    b32 = b.detach().float().contiguous()
    out = torch.empty((bsz, ho, wo, k), dtype=feats.dtype, device=feats.device)
    lib = _LIB.get()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        rc = lib.zs3_classify_resize(
            feats.data_ptr(), int(feats.dtype == torch.bfloat16), bsz, hi, wi, c,
            w32.data_ptr(), w32.stride(0), w32.stride(1), b32.data_ptr(), k,
            layout["tile_cols"], layout["grid"], out.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.zs3_cuda_error_string(rc).decode()
        raise RuntimeError(f"classify_resize launch failed: {msg} ({rc})")
    classify_resize.launches += 1
    return out


classify_resize.launches = 0


def tail_logits(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, size: Tuple[int, int]
) -> torch.Tensor:
    """Logits at `size` from NHWC features: the plain version on the CPU,
    K4 on the GPU."""
    if feats.device.type == "cpu":
        return classify_resize_reference(feats, w, b, size)
    return classify_resize(feats.contiguous(), w, b, size)
