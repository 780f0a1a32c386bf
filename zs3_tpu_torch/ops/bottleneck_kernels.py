"""Fused eval-mode ResNet bottleneck, kernel K5 (port of
zs3_tpu.ops.pallas_bottleneck).

`fused_bottleneck(x, w1, b1, w2, b2, w3, b3, dilation)` launches the
CUDA kernel (csrc/fused_bottleneck.cu) on a CUDA tensor: one launch per
block, whose intermediate activations stay in shared memory.  It equals
ops/bottleneck.py's plain `fused_bottleneck` up to the order of the f32
sums.  `fused_stage` sends a CPU tensor to the plain version and a CUDA
tensor to the kernel, block by block, with no fallback between them.
There is no gradient (as on the TPU), and nothing in models/ calls it:
like zs3_tpu's, the kernel is an eval-mode option held against the
trunk's own layers (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from zs3_tpu_torch.ops import bottleneck
from zs3_tpu_torch.ops.cuda_build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = CudaLibrary(
    "fused_bottleneck",
    {
        "zs3_fused_bottleneck": (
            [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P], ctypes.c_int),
        "zs3_fused_bottleneck_plan": ([_I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "zs3_cuda_error_string": ([_I], ctypes.c_char_p),
    },
)


def plan(x_shape, planes: int, dilation: int, dtype: torch.dtype) -> dict:
    """The tile a launch takes for these shapes: rows, columns, halo
    pixels and shared-memory bytes of a block (builds the library)."""
    _, h, w, c = x_shape
    info = (ctypes.c_int * 4)()
    rc = _LIB.get().zs3_fused_bottleneck_plan(
        int(dtype == torch.bfloat16), h, w, c, planes, dilation, info)
    if rc != 0:
        raise ValueError(f"fused_bottleneck: no tile of {tuple(x_shape)} with {planes} planes "
                         f"at dilation {dilation} fits shared memory")
    return dict(zip(("tile_rows", "tile_cols", "halo_pixels", "smem_bytes"), info))


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, dilation: int = 1) -> torch.Tensor:
    """(B, H, W, C) contiguous CUDA x, f32 or bf16 -> the block's output in
    x's dtype (kernel K5).  The weights are cast to x's dtype and the
    biases to f32, as zs3_tpu's kernel takes them.  Launches on the current
    stream; `fused_bottleneck.launches` counts the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck needs a CUDA tensor, got {x.device}")
    params = (w1, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        raise RuntimeError("fused_bottleneck has no gradient: call it under no_grad or "
                           "inference_mode")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_bottleneck takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"fused_bottleneck needs contiguous NHWC x, got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    p = int(w1.shape[-1])
    shapes = [tuple(t.shape) for t in params]
    if shapes != [(c, p), (p,), (3, 3, p, p), (p,), (p, c), (c,)]:
        raise ValueError(f"block shapes {shapes} do not fit {c} channels and {p} planes")
    if any(t.device != x.device for t in params):
        raise ValueError("fused_bottleneck: x and the block's weights on different devices")
    w1, w2, w3 = (t.detach().to(x.dtype).contiguous() for t in (w1, w2, w3))
    b1, b2, b3 = (t.detach().float().contiguous() for t in (b1, b2, b3))
    out = torch.empty_like(x)
    lib = _LIB.get()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.zs3_fused_bottleneck(
            x.data_ptr(), int(x.dtype == torch.bfloat16), bsz, h, w, c, p, int(dilation),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
            b3.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.zs3_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_bottleneck launch failed: {msg} ({rc})")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0


def fused_stage(x: torch.Tensor, blocks: Sequence[bottleneck.Block],
                dilations: Sequence[int]) -> torch.Tensor:
    """Consecutive identity blocks on NHWC x: the plain version on the
    CPU, one K5 launch per block on the GPU."""
    if x.device.type == "cpu":
        return bottleneck.fused_stage(x, blocks, dilations)
    x = x.contiguous()
    for params, d in zip(blocks, dilations):
        x = fused_bottleneck(x, *params, dilation=d)
    return x
