"""Fused bilinear-upsample + argmax (port of zs3_tpu.ops.pallas_eval).

Validation computes ``argmax(resize_bilinear(logits, 513), -1)``.  The
plain version materialises the (B, 513, 513, C) f32 logits in device
memory only to reduce them away; the CUDA kernel
(csrc/upsample_argmax.cu, kernel K1) never does.  Semantics match the
plain version: first-max tie-breaking, f32 interpolation.

`predict_labels` sends a CPU tensor to the plain version and a CUDA
tensor to the kernel, with no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from zs3_tpu_torch.ops.cuda_build import CudaLibrary
from zs3_tpu_torch.ops.resize import _linear_matrix_np, resize_bilinear

MAX_CLASSES = 128
# Shared memory a block may use on Hopper (dynamic, after opting in).
MAX_SHARED_BYTES = 232_448

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = CudaLibrary(
    "upsample_argmax",
    {
        "zs3_upsample_argmax": (
            [_P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P], ctypes.c_int
        ),
        "zs3_cuda_error_string": ([_I], ctypes.c_char_p),
    },
)


@functools.lru_cache(maxsize=64)
def tap_table(
    in_size: int, out_size: int, align_corners: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Compact form of `_linear_matrix_np(in_size, out_size, ...)`.

    Returns (idx int32 (2, out), w f32 (2, out)): row o of the matrix is
    w[0, o] at column idx[0, o] plus w[1, o] at column idx[1, o].  A row
    with a single nonzero gets a second tap on the same column with
    weight 0.
    """
    mat = _linear_matrix_np(in_size, out_size, align_corners)
    idx = np.zeros((2, out_size), np.int32)
    w = np.zeros((2, out_size), np.float32)
    for o in range(out_size):
        cols = np.flatnonzero(mat[o])
        if not 1 <= len(cols) <= 2:
            raise ValueError(f"interpolation row {o} has {len(cols)} taps")
        idx[:, o] = cols[0]
        w[0, o] = mat[o, cols[0]]
        if len(cols) == 2:
            idx[1, o] = cols[1]
            w[1, o] = mat[o, cols[1]]
    return idx, w


@functools.lru_cache(maxsize=64)
def _device_taps(in_size, out_size, align_corners, device):
    idx, w = tap_table(in_size, out_size, align_corners)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def upsample_argmax_reference(
    logits: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Plain version: (B, HI, WI, C) -> (B, HO, WO) int32 via f32 resize."""
    up = resize_bilinear(logits.float(), size, align_corners)
    return up.argmax(dim=-1).to(torch.int32)


def upsample_argmax(
    logits: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """(B, HI, WI, C) f32 CUDA logits -> (B, HO, WO) int32 labels (kernel K1).

    Launches on the current stream; `upsample_argmax.launches` counts
    the launches.
    """
    if logits.device.type != "cuda":
        raise ValueError(f"upsample_argmax needs a CUDA tensor, got {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"upsample_argmax needs float32 logits, got {logits.dtype}")
    if logits.ndim != 4:
        raise ValueError(f"upsample_argmax needs (B, H, W, C), got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("upsample_argmax needs contiguous NHWC logits")
    bsz, hi, wi, c = logits.shape
    ho, wo = (int(s) for s in size)
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"upsample_argmax takes 1..{MAX_CLASSES} classes, got {c}")
    if wi * c * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"a row of {wi}x{c} logits does not fit in shared memory")
    if min(bsz, hi, wi, ho, wo) < 1 or bsz * ho >= 2**31:
        raise ValueError(f"bad geometry {tuple(logits.shape)} -> {(ho, wo)}")
    h_idx, h_w = _device_taps(hi, ho, align_corners, logits.device)
    w_idx, w_w = _device_taps(wi, wo, align_corners, logits.device)
    out = torch.empty((bsz, ho, wo), dtype=torch.int32, device=logits.device)
    lib = _LIB.get()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = lib.zs3_upsample_argmax(
            logits.data_ptr(), bsz, hi, wi, c,
            h_idx.data_ptr(), h_w.data_ptr(), ho,
            w_idx.data_ptr(), w_w.data_ptr(), wo,
            out.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.zs3_cuda_error_string(rc).decode()
        raise RuntimeError(f"upsample_argmax launch failed: {msg} ({rc})")
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0


def predict_labels(
    logits: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Labels at `size`: the plain version on the CPU, K1 on the GPU."""
    logits = logits.float()
    if logits.device.type == "cpu":
        return upsample_argmax_reference(logits, size, align_corners)
    return upsample_argmax(logits.contiguous(), size, align_corners)
