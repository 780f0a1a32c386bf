"""Bilinear / nearest resize as two small products (port of zs3_tpu.ops.resize).

The reference upsamples with ``F.interpolate(..., mode='bilinear',
align_corners=True)``.  As in zs3_tpu, the (out, in) interpolation
matrix is built once per geometry on the host and applied as two
products, H first and then W, so the arithmetic order matches the JAX
package exactly.  Layout is NHWC (or HWC), as in zs3_tpu.  Under
spatial sharding (parallel/spatial.py) the H pass takes the plan's global
heights, fetches the source rows of this rank's output rows and applies
the matching slice of the matrix (of the index, for nearest).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from zs3_tpu_torch.core.device import device_constant_cache
from zs3_tpu_torch.parallel import spatial


@functools.lru_cache(maxsize=128)
def _linear_matrix_np(
    in_size: int, out_size: int, align_corners: bool
) -> np.ndarray:
    """Row-stochastic (out_size, in_size) 1-D linear interpolation matrix."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    if out_size == 1:
        # align_corners picks source 0; half-pixel picks the center.
        if align_corners:
            w[0, 0] = 1.0
        else:
            pos = 0.5 * in_size / 1.0 - 0.5
            lo = int(np.clip(np.floor(pos), 0, in_size - 1))
            hi = min(lo + 1, in_size - 1)
            frac = pos - lo
            w[0, lo] += 1.0 - frac
            w[0, hi] += frac
        return w
    if align_corners:
        pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        pos = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
        pos = np.clip(pos, 0.0, in_size - 1)
    lo = np.floor(pos).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (pos - lo).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w


@device_constant_cache(maxsize=128)
def _linear_matrix(
    in_size: int, out_size: int, align_corners: bool,
    device: torch.device, dtype: torch.dtype,
) -> torch.Tensor:
    """`_linear_matrix_np` on `device`, uploaded once: a copy from pageable
    host memory on every call would make the host wait for the stream.
    Made outside inference mode, so autograd may save it later; built
    anew under a trace (device_constant_cache)."""
    with torch.inference_mode(False):
        mat = _linear_matrix_np(in_size, out_size, align_corners)
        return torch.from_numpy(mat).to(device, dtype)


def resize_bilinear(
    x: torch.Tensor,
    size: Tuple[int, int],
    align_corners: bool = True,
) -> torch.Tensor:
    """Bilinear-resize NHWC (or HWC) images to `size` = (H_out, W_out).

    bf16 input interpolates in bf16 (its own rounding dwarfs the
    product's); every other dtype interpolates in f32 and is cast back.
    """
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    out_h, out_w = size
    orig_dtype = x.dtype
    wdtype = torch.bfloat16 if orig_dtype == torch.bfloat16 else torch.float32
    y = x.to(wdtype)

    def sources(h_in, h_out):
        taps = _linear_matrix_np(h_in, h_out, align_corners) != 0
        return taps.argmax(1), h_in - taps[:, ::-1].argmax(1)

    def apply(rows, h_in, h_out, o0, o1, c0):
        wh = _linear_matrix(h_in, h_out, align_corners, rows.device, wdtype)
        return torch.einsum("oh,bhwc->bowc", wh[o0:o1, c0:c0 + rows.shape[1]], rows)

    y = spatial.resample_rows("bilinear", y, out_h, sources, apply)
    if out_w != w:
        ww = _linear_matrix(w, out_w, align_corners, y.device, wdtype)
        y = torch.einsum("ow,bhwc->bhoc", ww, y)
    y = y.to(orig_dtype)
    return y[0] if squeeze else y


def _nearest_index_np(in_size: int, out_size: int) -> np.ndarray:
    # torch 'nearest' semantics: floor(i * in/out).
    idx = np.floor(np.arange(out_size) * in_size / out_size).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


@device_constant_cache(maxsize=128)
def _nearest_index(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_nearest_index_np(in_size, out_size)).to(device)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbor resize for label maps. NHW, NHWC or HW layouts."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    w = x.shape[2]
    out_h, out_w = size

    def sources(h_in, h_out):
        idx = _nearest_index_np(h_in, h_out)
        return idx, idx + 1

    def apply(rows, h_in, h_out, o0, o1, c0):
        index = _nearest_index(h_in, h_out, rows.device)[o0:o1]
        return rows.index_select(1, index - c0 if c0 else index)

    x = spatial.resample_rows("nearest", x, out_h, sources, apply)
    if out_w != w:
        x = x.index_select(2, _nearest_index(w, out_w, x.device))
    return x[0] if squeeze else x
