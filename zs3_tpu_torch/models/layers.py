"""Shared NN building blocks (port of zs3_tpu.models.layers).

These modules take and return NCHW tensors; the model's public methods
permute from and to NHWC, and with torch.channels_last the permute is a
view, so cuDNN runs its NHWC kernels without copies.  Convolutions use
torch's symmetric integer padding, which zs3_tpu reproduces explicitly.
Parameters stay f32; a conv runs in the compute dtype it was built with
(zs3_tpu.models.layers._ConvImpl casts input and kernel the same way).

BatchNorm keeps torch's parameter names (weight, bias, running_mean,
running_var).  Momentum follows torch: flax's 0.9 is torch's 0.1.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


# From this dilation on, a "same" conv runs as space-to-batch.  cuDNN's
# bf16 NHWC engines on an H100 take a 3x3 conv up to dilation 10; from 11
# on cuDNN falls back to a direct kernel some 300x slower (about 55 ms
# against 0.18 ms for the os16 ASPP branch at 4x33x33x2048 -> 256;
# chip_smoke.py times both, PERF.md has the numbers).
SPACE_TO_BATCH_MIN_DILATION = 11


def conv2d_space_to_batch(
    x: torch.Tensor, weight: torch.Tensor, bias, dilation: int
) -> torch.Tensor:
    """A stride-1 conv with dilation d and "same" padding d*(k-1)/2, as a
    dilation-1 conv over the d*d residue classes of the input grid.

    Output pixel (i, j) reads inputs (i + a*d, j + b*d), all of residue
    (i mod d, j mod d), so each residue class is an ordinary conv with
    padding (k-1)/2; zero-padding H and W up to multiples of d adds only
    zeros the dilated conv would also read.  The products and their sums
    are those of the dilated conv.  NCHW in (channels_last), NCHW out
    (channels_last).
    """
    d = dilation
    b, c, h, w = x.shape
    hq, wq = -(-h // d), -(-w // d)
    xh = F.pad(x.permute(0, 2, 3, 1), (0, 0, 0, wq * d - w, 0, hq * d - h))
    xs = xh.reshape(b, hq, d, wq, d, c).permute(0, 2, 4, 1, 3, 5)
    xs = xs.reshape(b * d * d, hq, wq, c).permute(0, 3, 1, 2)
    y = F.conv2d(xs, weight, bias, 1, (weight.shape[-1] - 1) // 2)
    co = y.shape[1]
    y = y.permute(0, 2, 3, 1).reshape(b, d, d, hq, wq, co).permute(0, 3, 1, 4, 2, 5)
    y = y.reshape(b, hq * d, wq * d, co)[:, :h, :w]
    return y.contiguous().permute(0, 3, 1, 2)


class Conv(nn.Conv2d):
    """2-D conv with torch-style integer padding that runs in `dtype`.

    A "same" conv of large dilation runs as `conv2d_space_to_batch`."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        dilation: int = 1,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(
            in_channels, features, kernel_size, stride=stride, padding=padding,
            dilation=dilation, bias=use_bias,
        )
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        weight = self.weight.to(self.compute_dtype)
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        d, k = self.dilation[0], self.kernel_size[0]
        if (
            d >= SPACE_TO_BATCH_MIN_DILATION
            and self.stride == (1, 1)
            and self.dilation == (d, d)
            and self.kernel_size == (k, k)
            and self.padding == (d * (k - 1) // 2,) * 2
        ):
            return conv2d_space_to_batch(x, weight, bias, d)
        return F.conv2d(x, weight, bias, self.stride, self.padding, self.dilation)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d whose output keeps the input's (compute) dtype; its
    parameters and running statistics stay f32."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__(features, eps=epsilon, momentum=1.0 - momentum)


class ConvBN(nn.Module):
    """conv -> BN -> optional ReLU, the workhorse block."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        dilation: int = 1,
        relu: bool = True,
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.conv = Conv(
            in_channels, features, kernel_size, stride, padding, dilation, dtype=dtype
        )
        self.bn = BatchNorm(features, bn_momentum, bn_epsilon)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def stem_conv(in_channels: int = 3, features: int = 64, dtype=torch.float32) -> Conv:
    """7x7/2 pad-3 stem conv (zs3_tpu's StemConv with s2d=False)."""
    return Conv(in_channels, features, 7, stride=2, padding=3, dtype=dtype)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1)."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC11 global average pool (AdaptiveAvgPool2d(1))."""
    return x.mean(dim=(2, 3), keepdim=True)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)
