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
resize product.  f32 features may take any channel count that fits
shared memory (C x K floats); bf16 any.  There is no gradient (as on
the TPU): the kernel is the inference tail.

`tail_logits` sends a CPU tensor to the plain version and a CUDA tensor
to the kernel, with no fallback between them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from zs3_tpu_torch.ops.cuda_build import CudaLibrary
from zs3_tpu_torch.ops.eval_kernels import MAX_SHARED_BYTES
from zs3_tpu_torch.ops.resize import resize_bilinear

_SRC = 8  # source rows per band (exact 4x: 32 output rows)
MAX_CLASSES = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = CudaLibrary(
    "classify_resize",
    {
        "zs3_classify_resize": ([_P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P], ctypes.c_int),
        "zs3_classify_resize_smem": ([_I, _I, _I], ctypes.c_int),
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


def classify_resize(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, size: Tuple[int, int]
) -> torch.Tensor:
    """(B, H, W, C) CUDA features, (C, K) weights, (K,) bias ->
    (B, HO, WO, K) logits in the features' dtype (kernel K4).

    w and b are rounded to the features' dtype first, as the plain
    version's classify rounds them.  Launches on the current stream;
    `classify_resize.launches` counts the launches.
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
    lib = _LIB.get()
    is_bf16 = int(feats.dtype == torch.bfloat16)
    smem = lib.zs3_classify_resize_smem(is_bf16, c, k)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"classify_resize: {c} channels x {k} classes need {smem} bytes of "
                         f"shared memory, more than {MAX_SHARED_BYTES}")
    w32 = w.detach().to(feats.dtype).float().contiguous()
    b32 = b.detach().to(feats.dtype).float().contiguous()
    out = torch.empty((bsz, ho, wo, k), dtype=feats.dtype, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        rc = lib.zs3_classify_resize(
            feats.data_ptr(), is_bf16, bsz, hi, wi, c,
            w32.data_ptr(), b32.data_ptr(), k, out.data_ptr(), stream,
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
