"""MobileNetV2 backbone, width 1.0 (port of zs3_tpu.models.mobilenet).

The stride->dilation rewrite starts once the configured output_stride is
reached: the converting stage keeps the rate from before the
multiplication (its convs still read the pre-stride grid), later stages
take the doubled taps.  forward takes NHWC images and returns NHWC
(high: 320ch, low_level: 24ch at os4, after stage 1).

Module names are the upstream checkpoint's (tests/torch_oracle_backbones.py
TorchMobileNetV2): ``features.0`` is the stem Sequential(conv, BN, ReLU6)
and ``features.N`` (N >= 1) block N-1, whose ``conv`` Sequential holds
(expand conv, BN, ReLU6,) depthwise conv, BN, ReLU6, project conv, BN.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from zs3_tpu_torch.models.layers import BatchNorm, Conv, to_nchw, to_nhwc

# (expansion t, channels c, repeats n, stride s): MobileNetV2 table 2.
CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    """(1x1 expand ->) 3x3 depthwise -> 1x1 project, + x where stride is 1
    and the widths match."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, expand: int = 6,
                 dilation: int = 1, bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = in_channels * expand
        self.use_res = stride == 1 and in_channels == features
        bn = lambda c: BatchNorm(c, bn_momentum, bn_epsilon)
        layers: List[nn.Module] = []
        if expand != 1:
            layers += [Conv(in_channels, hidden, 1, dtype=dtype), bn(hidden), nn.ReLU6()]
        layers += [
            Conv(hidden, hidden, 3, stride=stride, padding=dilation, dilation=dilation,
                 dtype=dtype, groups=hidden),
            bn(hidden), nn.ReLU6(),
            Conv(hidden, features, 1, dtype=dtype), bn(features),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


def block_plan(output_stride: int) -> List[Tuple[int, int, int, int, int]]:
    """(stage, expansion, channels, stride, dilation) of every block."""
    plan = []
    current_stride, rate = 2, 1
    for stage, (t, c, n, s) in enumerate(CFG):
        if current_stride >= output_stride:
            stage_stride, dilation = 1, rate
            rate *= s
        else:
            stage_stride, dilation = s, 1
            current_stride *= s
        for i in range(n):
            plan.append((stage, t, c, stage_stride if i == 0 else 1, dilation))
    return plan


class MobileNetV2Backbone(nn.Module):
    def __init__(self, output_stride: int = 16, bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        if output_stride not in (8, 16):
            raise ValueError(f"output_stride must be 8 or 16, got {output_stride}")
        self.compute_dtype = dtype
        features: List[nn.Module] = [nn.Sequential(
            Conv(3, 32, 3, stride=2, padding=1, dtype=dtype),
            BatchNorm(32, bn_momentum, bn_epsilon), nn.ReLU6(),
        )]
        cin = 32
        for stage, t, c, stride, dilation in block_plan(output_stride):
            features.append(InvertedResidual(cin, c, stride, t, dilation, bn_momentum,
                                             bn_epsilon, dtype))
            cin = c
            if stage == 1:
                self.low_index = len(features) - 1  # 24ch @ os4
        self.features = nn.Sequential(*features)

    def forward_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.compute_dtype)
        low_level = self.features[: self.low_index + 1](x)
        return self.features[self.low_index + 1:](low_level), low_level

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        high, low = self.forward_nchw(to_nchw(x))
        return to_nhwc(high), to_nhwc(low)
