"""ResNeSt-101 (split-attention networks, arXiv:2004.08955) as a dilated
DeepLab backbone, as mmsegmentation's `ResNeSt` runs it under DeepLabv3+
(configs/resnest, deeplabv3plus_s101-d8).  A backbone of the port only:
zs3_tpu has none.

Stem: conv3x3(3->64, s2), BN, ReLU, conv3x3(64->64), BN, ReLU,
conv3x3(64->128), BN, ReLU, then maxpool 3x3 s2.  Four stages of [3, 4,
23, 3] split-attention bottlenecks of planes 64/128/256/512 (expansion
4), strides and dilations from resnet.stage_plan (os 8: strides (1, 2, 1,
1), dilations (1, 1, 2, 4)); the first block of a dilated stage takes
half its dilation (mmsegmentation's contract_dilation).  A block, with
width = planes:

    o = ReLU(BN(conv1x1(x)))
    o = SplAt(o)                           (stride 1)
    o = AvgPool3x3(stride s, pad 1)(o)     where the block strides
    y = ReLU(BN(conv1x1(o -> 4 planes)) + shortcut)

the shortcut, where the shape changes, AvgPool(k=s, s=s, ceil_mode,
count_include_pad=False) (none at s = 1), conv1x1, BN.  SplAt (radix 2,
cardinality 1, reduction 4): u = ReLU(BN(conv3x3(o -> 2C, groups 2,
dilation d))), g = mean_hw(u_0 + u_1), z = fc2(ReLU(BN(fc1(g)))) with
fc1 C -> max(C/2, 32) and fc2 -> 2C, both with bias, and out = sum_r
softmax_r(z) u_r: ops/splat_kernels.py's `split_attention`, its kernel
pair on the card.  Returns (x: 2048ch at os8/os16, low_level: the first
stage's 256ch at os4).

Module names are mmsegmentation's, so that its checkpoint maps onto the
port: ``stem.{0,1,3,4,6,7}``, ``layerL.B.conv1``, ``bn1``,
``conv2.{conv,bn0,fc1,bn1,fc2}``, ``conv3``, ``bn3`` and
``downsample.{1,2}`` (index 0 the shortcut's parameterless pool).  Where
mmsegmentation departs from the paper's text the port follows it: the
split-attention norms are ``bn0``/``bn1`` (mmcv's build_norm_layer
names), the block's 3x3 average pool counts its zero padding (torch's
default, count_include_pad=True), and every stage's first block has a
shortcut conv (the stem gives 128 channels, not 256).

BatchNorm and ReLU go through models/layers.py's BatchNorm, so every
train-mode BN, the gate's (N, C/2, 1, 1) one too, takes the BN kernels on
the card.  Under spatial sharding the split attention's mean would need
the whole level: the backbone refuses it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from zs3_tpu_torch.models.layers import BatchNorm, Conv, max_pool_3x3_s2, to_nchw, to_nhwc
from zs3_tpu_torch.models.resnet import RematBlock, stage_plan
from zs3_tpu_torch.ops.splat_kernels import split_attention
from zs3_tpu_torch.parallel import spatial

RADIX = 2
REDUCTION = 4
STEM_WIDTH = 128


class SplitAttentionConv(nn.Module):
    """mmsegmentation's SplitAttentionConv2d at radix 2 and cardinality 1,
    stride 1: the grouped 3x3 conv, its BN and ReLU, and the split
    attention over its two halves with the gate fc1 -> BN -> ReLU -> fc2.

    The gate runs in f32 at least (N x C values: nothing to the step's
    time), its fc1 and fc2 as full-f32 matrix products on their conv
    weights (cuDNN's 1x1 conv would take TF32): its BN normalises N
    global means that differ little from image to image, which magnifies
    whatever rounding reaches them.  Measured on an H100 against the f32
    reference, the first gradient's median leaf moved 0.020-0.041 with
    the gate in f32 and 0.030-0.049 with it in TF32 on the same three
    seeds.  So fc1 and fc2 take neither the int8 nor the QAT route."""

    def __init__(self, channels: int, dilation: int, bn_momentum: float = 0.9,
                 bn_epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        inter = max(channels * RADIX // REDUCTION, 32)
        self.gate_dtype = torch.promote_types(dtype, torch.float32)
        self.conv = Conv(channels, channels * RADIX, 3, padding=dilation, dilation=dilation,
                         dtype=dtype, groups=RADIX)
        self.bn0 = BatchNorm(channels * RADIX, bn_momentum, bn_epsilon)
        self.fc1 = Conv(channels, inter, 1, use_bias=True, dtype=self.gate_dtype)
        self.bn1 = BatchNorm(inter, bn_momentum, bn_epsilon)
        self.fc2 = Conv(inter, channels * RADIX, 1, use_bias=True, dtype=self.gate_dtype)

    def gate(self, g: torch.Tensor) -> torch.Tensor:
        """(N, C, 1, 1) mean -> (N, 2C, 1, 1) logits."""
        def linear(conv, x):
            w, b = (t.to(self.gate_dtype) for t in (conv.weight, conv.bias))
            return F.linear(x.flatten(1).to(self.gate_dtype), w.flatten(1), b)[:, :, None, None]

        return linear(self.fc2, self.bn1(linear(self.fc1, g), relu=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return split_attention(self.bn0(self.conv(x), relu=True), self.gate)


class SplitAttentionBottleneck(RematBlock):
    """mmsegmentation's ResNeSt Bottleneck (groups 1, so width = planes,
    avg_down_stride): 1x1 -> SplAt -> 3x3 average pool where it strides
    -> 1x1 expand (4x), plus the average-pool shortcut.  `remat` as
    RematBlock's."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.stride = stride
        bn = lambda c: BatchNorm(c, bn_momentum, bn_epsilon)
        self.conv1 = Conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = bn(planes)
        self.conv2 = SplitAttentionConv(planes, dilation, bn_momentum, bn_epsilon, dtype)
        self.conv3 = Conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = bn(planes * 4)
        self.downsample = (
            nn.Sequential(
                nn.AvgPool2d(stride, stride, ceil_mode=True, count_include_pad=False)
                if stride > 1 else nn.Identity(),
                Conv(inplanes, planes * 4, 1, dtype=dtype),
                bn(planes * 4),
            )
            if downsample
            else None
        )

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.conv2(self.bn1(self.conv1(x), relu=True))
        if self.stride > 1:
            y = avg_pool_3x3(y, self.stride)
        y = self.bn3(self.conv3(y))
        return F.relu(y + identity)


def avg_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(3, stride, padding=1) (its zero padding counted), in x's
    memory format, computed on a contiguous (NCHW) copy: torch 2.11's CUDA
    backward of this pool on a channels_last tensor gives a wrong gradient
    (0.79-0.94 off in f64 at 16x16 to 128x128 on an H100, where its NCHW
    backward and the CPU's agree to the last bit)."""
    channels_last = x.is_contiguous(memory_format=torch.channels_last)
    y = F.avg_pool2d(x.contiguous(), 3, stride, 1)
    return y.contiguous(memory_format=torch.channels_last) if channels_last else y


class ResNeSt(nn.Module):
    """ResNeSt with a deep stem and dilated stages for dense prediction;
    forward takes NHWC images and returns NHWC (high, low_level)."""

    def __init__(
        self,
        layers: Sequence[int] = (3, 4, 23, 3),
        output_stride: int = 8,
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        strides, dilations = stage_plan(output_stride)
        self.compute_dtype = dtype
        half = STEM_WIDTH // 2
        stem = []
        for cin, cout, stride in ((3, half, 2), (half, half, 1), (half, STEM_WIDTH, 1)):
            # conv, BN with the ReLU folded in, and the ReLU's own slot.
            stem += [Conv(cin, cout, 3, stride=stride, padding=1, dtype=dtype),
                     BatchNorm(cout, bn_momentum, bn_epsilon, relu=True), nn.Identity()]
        self.stem = nn.Sequential(*stem)
        in_ch = STEM_WIDTH
        for stage, planes in enumerate((64, 128, 256, 512)):
            d = dilations[stage]
            blocks = []
            for block in range(layers[stage]):
                first = block == 0
                blocks.append(SplitAttentionBottleneck(
                    in_ch, planes,
                    stride=strides[stage] if first else 1,
                    dilation=d // 2 if first and d > 1 else d,
                    downsample=first,
                    bn_momentum=bn_momentum, bn_epsilon=bn_epsilon, dtype=dtype, remat=remat,
                ))
                in_ch = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if spatial.active():
            raise NotImplementedError("ResNeSt's split attention takes whole levels: "
                                      "no spatial sharding")
        x = max_pool_3x3_s2(self.stem(x.to(self.compute_dtype)))
        low_level = self.layer1(x)  # 256ch @ os4
        x = self.layer4(self.layer3(self.layer2(low_level)))
        return x, low_level

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        high, low = self.forward_nchw(to_nchw(x))
        return to_nhwc(high), to_nhwc(low)
