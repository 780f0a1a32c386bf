"""The plain reference of DeepLabv3+ on ResNeSt-101, in plain PyTorch,
f32, NCHW.

ResNeSt (arXiv:2004.08955) as mmsegmentation's `ResNeSt` runs it under
DeepLabv3+ (configs/resnest, deeplabv3plus_s101-d8): a deep stem (3x3
convs 3->64 s2, 64->64, 64->128, each with BN and ReLU, then a 3x3/2 max
pool), stages of [3, 4, 23, 3] split-attention bottlenecks (radix 2,
cardinality 1, reduction 4, expansion 4), a 3x3/s average pool after the
split attention of a strided block, and an average-pool shortcut (k = s,
ceil_mode, count_include_pad=False) before its 1x1 conv.  At output
stride 8 the strides are (1, 2, 1, 1) and the dilations (1, 1, 2, 4), the
first block of a dilated stage at half its dilation.  The state_dict
names are mmsegmentation's under ``backbone.`` (``stem.{0,1,3,4,6,7}``,
``layerL.B.conv2.{conv,bn0,fc1,bn1,fc2}``, ``downsample.{1,2}``, ...).

The split attention is written in the obvious torch ops: split, sum,
adaptive_avg_pool2d, the gate, softmax over the two splits, multiply-add.

The head is reference/deeplab.py's DeepLabV3Plus, imported and not
copied: its ASPP (rates 12/24/36 at os 8), decoder, classifier and
dropout draws, on this backbone's widths (2048/256, ResNet's).  With
`save_memory` each block's activations are recomputed in the backward.

Imports torch and the reference alone: nothing of the program.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.deeplab import DeepLabV3Plus, run

RADIX = 2
REDUCTION = 4
STEM_WIDTH = 128


class SplitAttentionConv2d(nn.Module):
    def __init__(self, channels: int, dilation: int):
        super().__init__()
        inter = max(channels * RADIX // REDUCTION, 32)
        self.conv = nn.Conv2d(channels, channels * RADIX, 3, padding=dilation,
                              dilation=dilation, groups=RADIX, bias=False)
        self.bn0 = nn.BatchNorm2d(channels * RADIX)
        self.fc1 = nn.Conv2d(channels, inter, 1)
        self.bn1 = nn.BatchNorm2d(inter)
        self.fc2 = nn.Conv2d(inter, channels * RADIX, 1)

    def forward(self, x):
        u = F.relu(self.bn0(self.conv(x)))
        splits = torch.split(u, u.shape[1] // RADIX, dim=1)
        gap = F.adaptive_avg_pool2d(sum(splits), 1)
        z = self.fc2(F.relu(self.bn1(self.fc1(gap))))
        a = F.softmax(z.view(z.shape[0], RADIX, -1), dim=1)
        return sum(a[:, r, :, None, None] * splits[r] for r in range(RADIX))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = SplitAttentionConv2d(planes, dilation)
        self.avd_layer = nn.AvgPool2d(3, stride, padding=1) if stride > 1 else None
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = self.conv2(F.relu(self.bn1(self.conv1(x))))
        if self.avd_layer is not None:
            out = self.avd_layer(out)
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNeSt(nn.Module):
    def __init__(self, layers=(3, 4, 23, 3), output_stride=8):
        super().__init__()
        if output_stride == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        elif output_stride == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        else:
            raise ValueError(output_stride)
        half = STEM_WIDTH // 2
        self.stem = nn.Sequential(
            nn.Conv2d(3, half, 3, stride=2, padding=1, bias=False), nn.BatchNorm2d(half),
            nn.ReLU(),
            nn.Conv2d(half, half, 3, padding=1, bias=False), nn.BatchNorm2d(half), nn.ReLU(),
            nn.Conv2d(half, STEM_WIDTH, 3, padding=1, bias=False), nn.BatchNorm2d(STEM_WIDTH),
            nn.ReLU(),
        )
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.inplanes = STEM_WIDTH
        for i, planes in enumerate((64, 128, 256, 512)):
            setattr(self, f"layer{i + 1}",
                    self._make_layer(planes, layers[i], strides[i], dilations[i]))
        self.save_memory = False

    def _make_layer(self, planes, blocks, stride, dilation):
        downsample = nn.Sequential(
            nn.AvgPool2d(stride, stride, ceil_mode=True, count_include_pad=False)
            if stride > 1 else nn.Identity(),
            nn.Conv2d(self.inplanes, planes * 4, 1, bias=False),
            nn.BatchNorm2d(planes * 4),
        )
        first = dilation // 2 if dilation > 1 else dilation
        layers = [Bottleneck(self.inplanes, planes, stride, first, downsample)]
        self.inplanes = planes * 4
        layers += [Bottleneck(self.inplanes, planes, 1, dilation) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        low = None
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = run(block, x, self.save_memory)
            low = x if low is None else low
        return x, low


class ResNeStDeepLab(DeepLabV3Plus):
    """reference/deeplab.py's DeepLabV3Plus on a ResNeSt backbone: the head
    is built for a ResNet's widths (which ResNeSt shares) on a one-block
    ResNet, whose backbone is then replaced."""

    def __init__(self, num_classes: int = 59, output_stride: int = 8,
                 layers: Optional[Sequence[int]] = None, feature_dim: int = 256,
                 low_level_dim: int = 48, dropout: bool = True):
        super().__init__("resnet101", num_classes, output_stride, (1, 1, 1, 1), feature_dim,
                         low_level_dim, dropout)
        self.backbone = ResNeSt(tuple(layers or (3, 4, 23, 3)), output_stride)


def build(config: dict) -> ResNeStDeepLab:
    """The reference of a configuration file's model (benchmark/configs)."""
    m = config["model"]
    if m["backbone"] != "resnest101":
        raise ValueError(f"no ResNeSt reference for backbone {m['backbone']!r}")
    return ResNeStDeepLab(m["num_classes"], m["output_stride"], m.get("layers"),
                          m["feature_dim"], m["low_level_dim"], m["dropout"])
