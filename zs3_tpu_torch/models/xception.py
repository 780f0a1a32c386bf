"""Aligned Xception backbone, DeepLabv3+ variant (port of zs3_tpu.models.xception).

Entry flow with three strided blocks, 16 middle-flow blocks, an exit
flow of separable convs to 2048 channels; every max-pool is a strided
separable conv.  The stride->dilation plan per output_stride: os16 gives
entry block3 stride 2 and exit dilations (1, 2); os8 gives entry stride
1, middle dilation 2 and exit dilations (2, 4).  forward takes NHWC
images and returns NHWC (high: 2048ch, low_level: 128ch at os4, tapped
after the ReLU that follows block1).

Module names are the upstream checkpoint's (tests/torch_oracle_backbones.py
TorchAlignedXception): conv1/bn1/conv2/bn2; blockN.skip/skipbn and
blockN.rep, a Sequential of [ReLU, SeparableConv(conv1, bn, pointwise),
BatchNorm] per unit with the leading ReLU dropped when the block does not
start with one; conv3..5 with bn3..5.  zs3_tpu's SeparableConv holds the
trailing BN itself (bn_point): here it is the next entry of `rep`, or bnK.
The ReLU that opens a unit after the first is the BN's that ends the
unit before (BatchNorm(relu=True), an nn.Identity in the ReLU's place),
as the stem and the exit flow's BNs take theirs, so train mode runs it
inside the BN's kernels; the modules' names and the state_dict keys stay
as they are.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from zs3_tpu_torch.models.layers import BatchNorm, Conv, to_nchw, to_nhwc


def xception_plan(output_stride: int) -> Tuple[int, int, Tuple[int, int]]:
    """(entry block3 stride, middle dilation, exit dilations)."""
    if output_stride == 16:
        return 2, 1, (1, 2)
    if output_stride == 8:
        return 1, 2, (2, 4)
    raise ValueError(f"output_stride must be 8 or 16, got {output_stride}")


class SeparableConv(nn.Module):
    """depthwise 3x3 (conv1) -> BN (bn) -> pointwise 1x1 (pointwise)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dilation: int = 1, bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(in_channels, in_channels, 3, stride=stride, padding=dilation,
                          dilation=dilation, dtype=dtype, groups=in_channels)
        self.bn = BatchNorm(in_channels, bn_momentum, bn_epsilon)
        self.pointwise = Conv(in_channels, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.bn(self.conv1(x)))


def block_units(in_channels: int, planes: int, reps: int, stride: int, dilation: int,
                grow_first: bool, is_last: bool) -> List[Tuple[int, int, int, int]]:
    """The separable units of a block: (in, out, stride, dilation) each.

    A grow-first (or grow-last) chain of `reps` units at the block's
    dilation, then an extra unit at dilation 1 that carries the stride, or
    for a stride-1 block marked is_last an extra stride-1 unit, so the unit
    count does not depend on the stride."""
    units = []
    width = in_channels
    if grow_first:
        units.append((in_channels, planes, 1, dilation))
        width = planes
    for _ in range(reps - 1):
        units.append((width, width, 1, dilation))
    if not grow_first:
        units.append((in_channels, planes, 1, dilation))
    if stride != 1:
        units.append((planes, planes, stride, 1))
    elif is_last:
        units.append((planes, planes, 1, 1))
    return units


class XceptionBlock(nn.Module):
    def __init__(self, in_channels: int, planes: int, reps: int, stride: int = 1,
                 dilation: int = 1, start_with_relu: bool = True, grow_first: bool = True,
                 is_last: bool = False, bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bn_kw = dict(bn_momentum=bn_momentum, bn_epsilon=bn_epsilon)
        if planes != in_channels or stride != 1:
            self.skip = Conv(in_channels, planes, 1, stride=stride, dtype=dtype)
            self.skipbn = BatchNorm(planes, bn_momentum, bn_epsilon)
        else:
            self.skip = None
        rep: List[nn.Module] = []
        units = block_units(in_channels, planes, reps, stride, dilation, grow_first, is_last)
        for k, (cin, cout, s, d) in enumerate(units):  # a unit's BN takes the next one's ReLU
            rep += [nn.Identity() if k else nn.ReLU(),
                    SeparableConv(cin, cout, s, d, dtype=dtype, **bn_kw),
                    BatchNorm(cout, bn_momentum, bn_epsilon, relu=k + 1 < len(units))]
        if not start_with_relu:
            rep = rep[1:]
        self.rep = nn.Sequential(*rep)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return self.rep(x) + skip


class AlignedXception(nn.Module):
    def __init__(self, output_stride: int = 16, bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        entry3_stride, middle_dil, exit_dil = xception_plan(output_stride)
        self.compute_dtype = dtype
        kw = dict(bn_momentum=bn_momentum, bn_epsilon=bn_epsilon, dtype=dtype)
        bn = lambda c: BatchNorm(c, bn_momentum, bn_epsilon)
        self.conv1 = Conv(3, 32, 3, stride=2, padding=1, dtype=dtype)
        self.bn1 = bn(32)
        self.conv2 = Conv(32, 64, 3, padding=1, dtype=dtype)
        self.bn2 = bn(64)
        self.block1 = XceptionBlock(64, 128, 2, stride=2, start_with_relu=False, **kw)
        self.block2 = XceptionBlock(128, 256, 2, stride=2, **kw)
        self.block3 = XceptionBlock(256, 728, 2, stride=entry3_stride, is_last=True, **kw)
        for i in range(4, 20):
            setattr(self, f"block{i}", XceptionBlock(728, 728, 3, dilation=middle_dil, **kw))
        self.block20 = XceptionBlock(728, 1024, 2, dilation=exit_dil[0], grow_first=False,
                                     is_last=True, **kw)
        self.conv3 = SeparableConv(1024, 1536, dilation=exit_dil[1], **kw)
        self.bn3 = bn(1536)
        self.conv4 = SeparableConv(1536, 1536, dilation=exit_dil[1], **kw)
        self.bn4 = bn(1536)
        self.conv5 = SeparableConv(1536, 2048, dilation=exit_dil[1], **kw)
        self.bn5 = bn(2048)

    def forward_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.compute_dtype)
        x = self.bn1(self.conv1(x), relu=True)
        x = self.bn2(self.conv2(x), relu=True)
        low_level = F.relu(self.block1(x))  # 128ch @ os4
        x = self.block3(self.block2(low_level))
        for i in range(4, 21):
            x = getattr(self, f"block{i}")(x)
        x = F.relu(x)
        for k in (3, 4, 5):
            x = getattr(self, f"bn{k}")(getattr(self, f"conv{k}")(x), relu=True)
        return x, low_level

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        high, low = self.forward_nchw(to_nchw(x))
        return to_nhwc(high), to_nhwc(low)
