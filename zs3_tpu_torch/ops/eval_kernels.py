"""Fused bilinear-upsample + argmax (port of zs3_tpu.ops.pallas_eval).

Validation computes ``argmax(resize_bilinear(logits, 513), -1)``.  The
plain version materialises the (B, 513, 513, C) f32 logits in device
memory only to reduce them away; the CUDA kernel
(csrc/upsample_argmax.cu, kernel K1) never does.  Semantics match the
plain version: first-max tie-breaking, f32 interpolation.  The kernel
reads f32 or bf16 logits as they are (bf16 widens exactly), so the eval
step hands it the model's bf16 logits without a cast.

`plan` lays a launch out on the host: each axis cut into runs of output
positions that share a pair of source positions (`axis_runs`), a CTA per
(image, band of row groups), and the band's shared memory.

`predict_labels` sends a CPU tensor to the plain version and a CUDA
tensor to the kernel, with no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from zs3_tpu_torch.core.device import device_constant_cache
from zs3_tpu_torch.ops.cuda_build import CudaLibrary
from zs3_tpu_torch.ops.resize import _linear_matrix_np, resize_bilinear

MAX_CLASSES = 128
# Shared memory a block may use on Hopper (dynamic, after opting in).
MAX_SHARED_BYTES = 232_448
THREADS = 512  # most threads of a CTA: one (row group, column run) tile each
ROW_GROUP = 2  # most output rows of a tile
COL_RUN = 5  # most output columns of a tile (a fifth only in the warps that need one)
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = CudaLibrary(
    "upsample_argmax",
    {
        "zs3_upsample_argmax": (
            [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _P,
             _I, _I, _I, _I, _P, _P],
            ctypes.c_int,
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


class Runs(NamedTuple):
    """One axis of a K1 launch, cut into runs of consecutive outputs whose
    taps lie on one pair of source positions (base, base + 1)."""

    starts: np.ndarray  # int32 (runs,): first output of each run
    counts: np.ndarray  # int32 (runs,): outputs of each run
    base: np.ndarray  # int32 (runs,): source position of each run's first tap
    weights: np.ndarray  # f32 (out, 2): each output's weights on base and base + 1


@functools.lru_cache(maxsize=64)
def axis_runs(in_size: int, out_size: int, align_corners: bool, cap: int) -> Runs:
    """`tap_table` regrouped for the kernel: greedy runs of at most `cap`
    outputs.  An output whose one tap is base or base + 1 gets weight 0
    on the other, which for finite logits adds a zero: the kernel's
    fl(fl(wa*x[base]) + fl(wb*x[base+1])) gives the labels of the tap
    table's fl(fl(w0*x[lo]) + fl(w1*x[hi])).  129 -> 513 with a cap of 5
    gives 128 runs: the first of 5 outputs, the others of 4."""
    idx, w = tap_table(in_size, out_size, align_corners)
    lo, hi = idx
    if (np.diff(lo) < 0).any() or ((hi != lo) & (hi != lo + 1)).any():
        raise ValueError(f"taps of {in_size} -> {out_size} are not monotone neighbours")
    starts, counts, base = [], [], []
    o = 0
    while o < out_size:
        n = 1
        while n < cap and o + n < out_size and hi[o + n] <= lo[o] + 1:
            n += 1
        starts.append(o)
        counts.append(n)
        base.append(lo[o])
        o += n
    counts = np.asarray(counts, np.int32)
    at_base = lo == np.repeat(np.asarray(base, np.int32), counts)
    weights = np.zeros((out_size, 2), np.float32)
    weights[at_base] = w[:, at_base].T  # w[1] is at base + 1, or 0
    weights[~at_base, 1] = w[0, ~at_base]  # one tap, at base + 1
    return Runs(np.asarray(starts, np.int32), counts, np.asarray(base, np.int32), weights)


def _round16(n: int) -> int:
    return (int(n) + 15) // 16 * 16


def plan(shape, size, align_corners: bool = True, dtype: torch.dtype = torch.float32,
         sm_count: int = 132) -> dict:
    """How K1 lays out (B, HI, WI, C) logits -> `size` labels: `rows`
    (row groups of at most ROW_GROUP) and `cols` (column runs of at most
    COL_RUN) from `axis_runs`; `groups_per_band`, the most row groups a
    CTA takes such that its tiles fit THREADS and the B x `bands` CTAs
    fill `sm_count` SMs once (4 at 129 -> 513: 8 output rows from 3
    source rows, 260 CTAs at B=4); `threads`; the most source rows a band
    stages (`staged_rows`) and output rows it writes (`band_rows`); the
    shared memory: barriers, then the staged rows at `off_src`, then the
    labels at `off_lab`, `smem_bytes` in all.  Fewer groups a band when
    that does not fit MAX_SHARED_BYTES; ValueError when one group does
    not (two source rows and its labels), or for a geometry or class
    count the kernel does not take; TypeError for a dtype."""
    bsz, hi, wi, c = (int(s) for s in shape)
    ho, wo = (int(s) for s in size)
    if dtype not in DTYPES:
        raise TypeError(f"upsample_argmax takes float32 or bfloat16 logits, got {dtype}")
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"upsample_argmax takes 1..{MAX_CLASSES} classes, got {c}")
    if min(bsz, hi, wi, ho, wo) < 1 or bsz * ho * wo >= 2**31:
        raise ValueError(f"bad geometry {tuple(shape)} -> {(ho, wo)}")
    rows = axis_runs(hi, ho, bool(align_corners), ROW_GROUP)
    cols = axis_runs(wi, wo, bool(align_corners), COL_RUN)
    ngroups, nruns = len(rows.starts), len(cols.starts)
    row_bytes = wi * c * (2 if dtype == torch.bfloat16 else 4)
    for per_band in range(ngroups, 0, -1):
        bands = -(-ngroups // per_band)
        if per_band > 1 and (per_band * nruns > THREADS
                             or bsz * bands < min(sm_count, bsz * ngroups)):
            continue
        first = np.arange(bands) * per_band
        last = np.minimum(first + per_band, ngroups) - 1
        band_rows = int((rows.starts[last] + rows.counts[last] - rows.starts[first]).max())
        staged = int((np.minimum(rows.base[last] + 1, hi - 1) - rows.base[first] + 1).max())
        off_src = _round16(8 * staged)
        off_lab = off_src + _round16(staged * row_bytes + 32)
        smem = off_lab + _round16((band_rows * wo + 4) * 4)
        if smem <= MAX_SHARED_BYTES:
            break
    else:
        raise ValueError(f"upsample_argmax: two source rows of {wi}x{c} logits and "
                         f"{ROW_GROUP} rows of {wo} labels do not fit in shared memory")
    return {
        "rows": rows, "cols": cols, "groups_per_band": per_band, "bands": bands,
        "ctas": bsz * bands, "threads": min(THREADS, -(-per_band * nruns // 32) * 32),
        "staged_rows": staged, "band_rows": band_rows,
        "off_src": off_src, "off_lab": off_lab, "smem_bytes": smem,
    }


@device_constant_cache(maxsize=64)
def card_plan(shape: tuple, size: tuple, align_corners: bool, dtype: torch.dtype,
              device_index: int):
    """plan on a card's SMs, with its tables on the card, kept per shape:
    (plan, int32 (groups + runs, 4) of (first, count, base, 0), f32 row
    then column weights)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    layout = plan(shape, size, align_corners, dtype, sms)
    rows, cols = layout["rows"], layout["cols"]
    ints = np.zeros((len(rows.starts) + len(cols.starts), 4), np.int32)
    ints[:, :3] = np.concatenate([np.stack(r[:3], 1) for r in (rows, cols)])
    floats = np.concatenate([rows.weights.ravel(), cols.weights.ravel()])
    device = torch.device("cuda", device_index)
    with torch.inference_mode(False):
        return layout, torch.from_numpy(ints).to(device), torch.from_numpy(floats).to(device)


def upsample_argmax_reference(
    logits: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Plain version: (B, HI, WI, C) -> (B, HO, WO) int32 via f32 resize."""
    up = resize_bilinear(logits.float(), size, align_corners)
    return up.argmax(dim=-1).to(torch.int32)


def upsample_argmax(
    logits: torch.Tensor, size: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """(B, HI, WI, C) f32 or bf16 CUDA logits -> (B, HO, WO) int32 labels
    (kernel K1).

    Launches on the current stream; `upsample_argmax.launches` counts
    the launches.
    """
    if logits.device.type != "cuda":
        raise ValueError(f"upsample_argmax needs a CUDA tensor, got {logits.device}")
    if logits.dtype not in DTYPES:
        raise TypeError(f"upsample_argmax takes float32 or bfloat16 logits, got {logits.dtype}")
    if logits.ndim != 4:
        raise ValueError(f"upsample_argmax needs (B, H, W, C), got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("upsample_argmax needs contiguous NHWC logits")
    bsz, hi, wi, c = logits.shape
    ho, wo = (int(s) for s in size)
    layout, ints, floats = card_plan(tuple(logits.shape), (ho, wo), bool(align_corners),
                                     logits.dtype, logits.device.index)
    ngroups, nruns = len(layout["rows"].starts), len(layout["cols"].starts)
    out = torch.empty((bsz, ho, wo), dtype=torch.int32, device=logits.device)
    lib = _LIB.get()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = lib.zs3_upsample_argmax(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16), bsz, hi, wi, c, ho, wo,
            ints.data_ptr(), ngroups, layout["groups_per_band"], floats.data_ptr(),
            ints.data_ptr() + 16 * ngroups, nruns, floats.data_ptr() + 8 * ho,
            layout["threads"], layout["off_src"], layout["off_lab"], layout["smem_bytes"],
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
    """Labels at `size`: the plain version on the CPU, K1 on the GPU.
    f32 and bf16 logits reach K1 as they are, other dtypes as f32."""
    if logits.device.type == "cpu":
        return upsample_argmax_reference(logits, size, align_corners)
    if logits.dtype not in DTYPES:
        logits = logits.float()
    return upsample_argmax(logits.contiguous(), size, align_corners)
