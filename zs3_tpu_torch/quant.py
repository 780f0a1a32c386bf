"""int8 quantization of the convolutions (port of zs3_tpu.quant).

Post-training quantization (PTQ): per-tensor symmetric activation scales
from calibration (the |input| max of each conv over a few batches, or a
percentile of it), per-output-channel symmetric weight scales computed
from the f32 weights at every call.  A conv then runs as s8 x s8 -> s32,
exactly, and dequantizes into the model's compute dtype.  The stem (3
input channels, below MIN_QUANT_IN_CH) and the logits-producing
classifier (DEFAULT_EXCLUDE) stay float.

How it runs: `quantized(scales)` and `qat()` are context managers that
set context variables; `models.layers.Conv.forward` reads them at every
call (the port runs eagerly: zs3_tpu needs them at trace time).  A conv
is named by its module name in the model (`Conv.quant_path`, set once
when DeepLab is built: "backbone.layer1.0.conv1", "aspp1.conv", ...).

The int8 product: `int8_conv` quantizes both operands, then on the GPU
takes an im2col of the int8 input and `torch._int_mm` (cuBLASLt,
s8 x s8 -> s32) and counts the launch in `int8_conv.launches`; on the
CPU it takes its plain version, a float64 conv of the int8 values, which
is exact (127^2 x K stays far below 2^53).  A CUDA tensor never reaches
the plain version, and a product the card refuses raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Scales = Dict[str, float]
PathLike = Union[str, Sequence[str]]

_ACTIVE: contextvars.ContextVar[Optional[Scales]] = contextvars.ContextVar(
    "zs3_torch_quant_scales", default=None
)
_QAT: contextvars.ContextVar[bool] = contextvars.ContextVar("zs3_torch_qat", default=False)

# Paths holding any of these substrings never quantize: the classifier
# conv emits the logits the zero-shot pipeline retrains and compares in f32.
DEFAULT_EXCLUDE: Tuple[str, ...] = ("classifier",)

# Convs with fewer input channels than this stay float (the 3-channel
# stem: no int8 gain, and the first layer is the most accuracy-sensitive).
# Enforced in calibrate() and in Conv.forward, even under hand-written scales.
MIN_QUANT_IN_CH = 16

# cuBLASLt's int8 GEMM refuses 16 rows or fewer (`torch._int_mm`).
_INT_MM_MIN_ROWS = 17


def _name(path: PathLike) -> str:
    return path if isinstance(path, str) else ".".join(path)


def scale_for(path: PathLike) -> Optional[float]:
    """The calibrated input absmax of the conv at `path` while quantized()
    is active, else None (the conv runs float)."""
    scales = _ACTIVE.get()
    if not scales:
        return None
    return scales.get(_name(path))


def path_excluded(path: PathLike, exclude: Sequence[str] = DEFAULT_EXCLUDE) -> bool:
    """True if the path's joined form holds an exclude substring."""
    joined = path if isinstance(path, str) else "/".join(path)
    return any(sub in joined for sub in exclude)


def filter_excluded(scales: Scales, exclude: Sequence[str]) -> Scales:
    """Drop every path that holds an exclude substring."""
    return {p: v for p, v in scales.items() if not path_excluded(p, exclude)}


@contextlib.contextmanager
def quantized(scales: Dict[PathLike, float]):
    """Run the convs named in `scales` (module name -> input absmax, not the
    scale itself) as int8.  Excluded paths are dropped on entry, so the
    classifier never runs s8 whatever the scales hold."""
    norm = {
        _name(k): float(v) for k, v in scales.items() if not path_excluded(_name(k))
    }
    token = _ACTIVE.set(norm)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def qat():
    """Quantization-aware training: inside, every eligible conv (ungrouped,
    >= MIN_QUANT_IN_CH input channels, path not excluded) runs on
    fake-quantized operands with straight-through gradients."""
    token = _QAT.set(True)
    try:
        yield
    finally:
        _QAT.reset(token)


def qat_active() -> bool:
    return _QAT.get()


def current() -> Tuple[Optional[Scales], bool]:
    """The active (scales, qat) state, for a recomputation that runs later
    or on another thread (an activation-checkpointed block's backward)."""
    return _ACTIVE.get(), _QAT.get()


@contextlib.contextmanager
def restored(state: Tuple[Optional[Scales], bool]):
    """Re-enter a state `current()` returned."""
    scales_token, qat_token = _ACTIVE.set(state[0]), _QAT.set(state[1])
    try:
        yield
    finally:
        _QAT.reset(qat_token)
        _ACTIVE.reset(scales_token)


def under(scales: Optional[Scales], fn: Callable) -> Callable:
    """`fn` run inside quantized(scales) at every call (fn itself when
    scales is None)."""
    if scales is None:
        return fn

    def run(*args, **kwargs):
        with quantized(scales):
            return fn(*args, **kwargs)

    return run


def _f32(value: float, device) -> torch.Tensor:
    """A 0-dim f32 tensor on `device`.  Dividing by it is a true division:
    CUDA divides by a host scalar as a multiply by its reciprocal, which is
    not bit-equal to zs3_tpu's division."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _weight_scales(weight: torch.Tensor) -> torch.Tensor:
    """Per-output-channel weight scale (O,) f32: max(|W|, 1e-8) / 127 over
    each OIHW filter."""
    w_absmax = weight.float().abs().amax(dim=(1, 2, 3)).clamp_min(1e-8)
    return w_absmax / _f32(127.0, weight.device)


def _snap(value: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(value / scale) clipped to +-127, in f32 (half to even)."""
    return torch.round(value / scale).clamp_(-127.0, 127.0)


def fake_quant_conv_operands(
    x: torch.Tensor, weight: torch.Tensor, act_absmax: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-dequantize conv operands onto the int8 grid (QAT).

    The activation per tensor, against `act_absmax` when given, else the
    batch's own |x| max; the OIHW weight per output channel.  The grid math
    runs in f32, and gradients pass straight through both roundings:
    x + (q(x) - x).detach()."""
    xf = x.float()
    amax = xf.abs().amax().detach() if act_absmax is None else _f32(act_absmax, x.device)
    s_act = amax.clamp_min(1e-8) / _f32(127.0, x.device)
    xq = _snap(xf, s_act) * s_act
    x_fq = (xf + (xq - xf).detach()).to(x.dtype)

    wf = weight.float()
    s_w = _weight_scales(wf.detach())[:, None, None, None]
    wq = _snap(wf, s_w) * s_w
    w_fq = (wf + (wq - wf).detach()).to(weight.dtype)
    return x_fq, w_fq


def int8_conv_plain(xq, wq, stride, padding, dilation) -> torch.Tensor:
    """The plain version of the int8 product: (B, C, H, W) int8 input,
    (O, C, kh, kw) int8 weight -> (B, O, Ho, Wo) int32, through a float64
    conv (every partial sum is an integer below 2^53, so exact)."""
    y = F.conv2d(xq.double(), wq.double(), None, stride, padding, dilation)
    return y.to(torch.int32)


def im2col(xq: torch.Tensor, kernel_size, stride, padding, dilation):
    """(B, C, H, W) int8 -> ((B*Ho*Wo, kh*kw*C) int8, (B, Ho, Wo)): each
    row the taps of one output pixel, ordered (ky, kx, c) in channels_last.
    A 1x1 conv of stride 1 without padding takes the input as it lies."""
    b, c, h, w = xq.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel_size, stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = xq.permute(0, 2, 3, 1)  # NHWC: a view of a channels_last tensor
    if ph or pw:
        padded = x.new_zeros((b, h + 2 * ph, w + 2 * pw, c))
        padded[:, ph:ph + h, pw:pw + w] = x
        x = padded
    taps = [
        x[:, ky * dh:ky * dh + (ho - 1) * sh + 1:sh, kx * dw:kx * dw + (wo - 1) * sw + 1:sw]
        for ky in range(kh) for kx in range(kw)
    ]
    cols = taps[0] if len(taps) == 1 else torch.stack(taps, dim=3)
    return cols.reshape(b * ho * wo, kh * kw * c), (b, ho, wo)


def int8_conv_route(xq, wq, stride, padding, dilation) -> torch.Tensor:
    """The int8 product as the card runs it: im2col of the int8 input, then
    `torch._int_mm` against the (kh*kw*C, O) weight; int32 (B, O, Ho, Wo)
    in channels_last.  Rows are padded with zeros (which add nothing) up
    to the 17 that `_int_mm` needs; K and O must be multiples of 8 on the
    card, which raises otherwise."""
    o = wq.shape[0]
    cols, (b, ho, wo) = im2col(xq, wq.shape[2:], stride, padding, dilation)
    m = cols.shape[0]
    if m < _INT_MM_MIN_ROWS:
        cols = torch.cat([cols, cols.new_zeros((_INT_MM_MIN_ROWS - m, cols.shape[1]))])
    wmat = wq.permute(0, 2, 3, 1).reshape(o, -1).t()  # (K, O), column-major
    y = torch._int_mm(cols, wmat)[:m]
    return y.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def int8_conv(
    x: torch.Tensor,
    weight: torch.Tensor,
    act_absmax: float,
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    dilation: Tuple[int, int],
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """s8 x s8 -> s32 conv with symmetric per-channel dequantization, NCHW
    in (x in any float dtype), NCHW out in `out_dtype`, no bias.

    The numbers are zs3_tpu.quant.int8_conv's: s_act = f32(max(absmax,
    1e-8) / 127) (the division in double), s_w from the f32 weight, both
    operands rounded half to even and clipped to +-127, exact int32 sums,
    then y * (s_act * s_w) in f32, cast to `out_dtype`.  A CUDA input runs
    the im2col + `_int_mm` route and counts `int8_conv.launches`; a CPU
    input the plain version."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv runs on the CPU or a CUDA card, not {x.device}")
    xq, wq, s_act, s_w = quantize_operands(x, weight, act_absmax)
    if x.is_cuda:
        y = int8_conv_route(xq, wq, stride, padding, dilation)
        int8_conv.launches += 1
    else:
        y = int8_conv_plain(xq, wq, stride, padding, dilation)
    return dequantize(y, s_act, s_w, out_dtype)


int8_conv.launches = 0


def quantize_operands(x: torch.Tensor, weight: torch.Tensor, act_absmax: float):
    """(x int8, weight int8, s_act (), s_w (O,)) as int8_conv quantizes them."""
    s_act = _f32(float(np.float32(max(act_absmax, 1e-8) / 127.0)), x.device)
    s_w = _weight_scales(weight)
    xq = _snap(x.float(), s_act).to(torch.int8)
    wq = _snap(weight.float(), s_w[:, None, None, None]).to(torch.int8)
    return xq, wq, s_act, s_w


def dequantize(y: torch.Tensor, s_act, s_w, out_dtype: torch.dtype) -> torch.Tensor:
    """int32 (B, O, Ho, Wo) -> y * (s_act * s_w) in f32, cast to out_dtype."""
    y = y.permute(0, 2, 3, 1)  # along the channels, in NHWC
    return (y.float() * (s_act * s_w)).to(out_dtype).permute(0, 3, 1, 2)


def quantizable(module) -> bool:
    """The conv eligibility rule: ungrouped, >= MIN_QUANT_IN_CH inputs."""
    return module.groups == 1 and module.in_channels >= MIN_QUANT_IN_CH


def percentile_of(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-th percentile of x's values by linear interpolation, as
    jnp.percentile (and numpy, for f32 data) computes it: the position
    q / 100 * (n - 1) and the weights in f32.  An f32 0-dim tensor on x's
    device.  Only the tail on the side of the rank is selected
    (torch.topk), so it takes any size (torch.quantile refuses more than
    2^24 elements)."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    pos = np.float32(q) / np.float32(100.0) * (np.float32(n) - np.float32(1.0))
    lo, hi = (min(max(int(f(pos)), 0), n - 1) for f in (np.floor, np.ceil))
    high_weight = pos - np.floor(pos)
    low_weight = np.float32(1.0) - high_weight
    if lo >= n // 2:  # ranks lo..n-1 are the n - lo largest, in descending order
        top = torch.topk(flat, n - lo, sorted=True).values
        v_lo, v_hi = top[-1], top[-1 - (hi - lo)]
    else:
        low = torch.topk(flat, hi + 1, largest=False, sorted=True).values
        v_lo, v_hi = low[lo], low[hi]
    return v_lo * float(low_weight) + v_hi * float(high_weight)


def eligible_convs(model: torch.nn.Module, exclude: Sequence[str] = DEFAULT_EXCLUDE):
    """[(quant_path, conv)] of the model's convs that quantize."""
    from zs3_tpu_torch.models.layers import Conv

    return [
        (m.quant_path, m) for m in model.modules()
        if isinstance(m, Conv) and quantizable(m) and not path_excluded(m.quant_path, exclude)
    ]


def calibrate(
    model: torch.nn.Module,
    batches: Iterable[torch.Tensor],
    *,
    forward: Optional[Callable] = None,
    exclude: Sequence[str] = DEFAULT_EXCLUDE,
    percentile: Optional[float] = None,
) -> Scales:
    """Run `batches` through the float model (forward(model, x), default
    model(x); the caller sets eval mode) and return {conv path: input
    absmax} for every eligible conv, `exclude` dropped.

    A forward pre-hook records each conv input's max |x| in f32, or with
    `percentile` (e.g. 99.99) that percentile of |x|, per batch, and keeps
    the max across batches.  The statistics stay on the device and are
    read back once, at the end."""
    forward = forward or (lambda m, x: m(x))
    stats: Dict[str, torch.Tensor] = {}

    def recorder(path):
        def hook(module, args):
            mag = args[0].float().abs()
            stat = mag.amax() if percentile is None else percentile_of(mag, percentile)
            prev = stats.get(path)
            stats[path] = stat if prev is None else torch.maximum(prev, stat)

        return hook

    handles = [conv.register_forward_pre_hook(recorder(path))
               for path, conv in eligible_convs(model, exclude)]
    try:
        with torch.inference_mode():
            for batch in batches:
                forward(model, batch)
    finally:
        for handle in handles:
            handle.remove()
    if not stats:
        return {}
    paths = list(stats)
    values = torch.stack([stats[p] for p in paths]).cpu().tolist()
    return dict(zip(paths, (float(v) for v in values)))


def calibrate_from_batches(
    model: torch.nn.Module,
    batch_iter: Iterable[torch.Tensor],
    *,
    n_batches: int = 2,
    forward: Optional[Callable] = None,
    percentile: Optional[float] = None,
) -> Scales:
    """calibrate() on the first `n_batches` of `batch_iter` (the trainers'
    int8 evaluation calibrates on their first val batches)."""
    batches = list(itertools.islice(iter(batch_iter), n_batches))
    if not batches:
        raise ValueError("int8 calibration: loader yielded no batches")
    return calibrate(model, batches, forward=forward, percentile=percentile)


def default_conv_scales(
    model: torch.nn.Module, absmax: float = 6.0, exclude: Sequence[str] = DEFAULT_EXCLUDE
) -> Scales:
    """Every eligible conv -> one constant absmax: a stand-in calibration
    for throughput and compile checks, where the values do not matter.
    The same eligibility as calibrate()."""
    return {path: float(absmax) for path, _ in eligible_convs(model, exclude)}


def scales_to_json(scales: Scales) -> str:
    return json.dumps(dict(sorted(scales.items())), indent=1)


def scales_from_json(text: str) -> Scales:
    return {k: float(v) for k, v in json.loads(text).items()}
