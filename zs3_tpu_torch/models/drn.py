"""DRN-D-54, the dilated residual network (port of zs3_tpu.models.drn).

A 7x7 stride-1 stem at full resolution, plain conv levels 1-2 and 7-8,
Bottleneck levels 3-6 (blocks 3, 4, 6, 3; strides 2, 2, 1, 1; dilations
1, 1, 2, 4), levels 7-8 winding the dilation back down (2, then 1).  It
is natively output stride 8, whatever the config says.  forward takes
NHWC images and returns NHWC (high: 512ch at os8, low_level: 256ch at
os4, after level 3).

Module names are fyu/drn's (tests/torch_oracle_backbones.py TorchDRN54):
layer0 = Sequential(conv, BN, ReLU), layer1/2/7/8 = Sequential of [conv,
BN, ReLU] repeats, layer3..6 = Bottlenecks with torchvision names.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from zs3_tpu_torch.models.layers import BatchNorm, Conv, to_nchw, to_nhwc
from zs3_tpu_torch.models.resnet import Bottleneck

# (name, planes, blocks, stride, dilation) of the Bottleneck levels.
RES_LEVELS = (
    ("layer3", 64, 3, 2, 1),   # -> 256ch @ os4
    ("layer4", 128, 4, 2, 1),  # -> 512ch @ os8
    ("layer5", 256, 6, 1, 2),  # -> 1024ch, dilation 2
    ("layer6", 512, 3, 1, 4),  # -> 2048ch, dilation 4
)


def conv_level(in_channels: int, features: int, convs: int = 1, stride: int = 1,
               dilation: int = 1, bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
               dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """zs3_tpu's _ConvLevel: `convs` times 3x3 conv -> BN -> ReLU, the
    stride on the first."""
    layers: List[nn.Module] = []
    for i in range(convs):
        layers += [
            Conv(in_channels if i == 0 else features, features, 3,
                 stride=stride if i == 0 else 1, padding=dilation, dilation=dilation,
                 dtype=dtype),
            BatchNorm(features, bn_momentum, bn_epsilon), nn.ReLU(),
        ]
    return nn.Sequential(*layers)


class DRN54(nn.Module):
    def __init__(self, bn_momentum: float = 0.9, bn_epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        kw = dict(bn_momentum=bn_momentum, bn_epsilon=bn_epsilon, dtype=dtype)
        self.layer0 = nn.Sequential(
            Conv(3, 16, 7, stride=1, padding=3, dtype=dtype),
            BatchNorm(16, bn_momentum, bn_epsilon), nn.ReLU(),
        )
        self.layer1 = conv_level(16, 16, **kw)
        self.layer2 = conv_level(16, 32, stride=2, **kw)
        cin = 32
        for name, planes, blocks, stride, dilation in RES_LEVELS:
            setattr(self, name, nn.Sequential(*[
                Bottleneck(cin if b == 0 else planes * 4, planes,
                           stride=stride if b == 0 else 1, dilation=dilation,
                           downsample=b == 0, **kw)
                for b in range(blocks)
            ]))
            cin = planes * 4
        self.layer7 = conv_level(2048, 512, dilation=2, **kw)
        self.layer8 = conv_level(512, 512, dilation=1, **kw)

    def forward_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.compute_dtype)
        low_level = self.layer3(self.layer2(self.layer1(self.layer0(x))))  # 256ch @ os4
        x = self.layer6(self.layer5(self.layer4(low_level)))
        return self.layer8(self.layer7(x)), low_level

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        high, low = self.forward_nchw(to_nchw(x))
        return to_nhwc(high), to_nhwc(low)
