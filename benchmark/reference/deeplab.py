"""The plain reference of DeepLabv3+ (ResNet-101 or aligned Xception-65),
in plain PyTorch, f32, NCHW.

A frozen copy of the repository's torch oracles (tests/torch_oracle.py,
tests/torch_oracle_backbones.py), with the state_dict names of the port:
the backbone's upstream checkpoint keys under ``backbone.``, then
``aspp1..4``, ``global_pool``, ``project``, ``low_proj``, ``fuse1``,
``fuse2`` and ``classifier``.  Departures from the oracles:

* the head takes the backbone's widths (2048/256 for ResNet, 2048/128
  for Xception) instead of ResNet's alone;
* the three dropouts of DeepLabv3+ (0.5 after the ASPP projection, 0.5
  and 0.1 after the two decoder convs) are here.  In train mode their
  uniform draws come from `dropout_generator`, drawn in that order, each
  over an NHWC-shaped f32 tensor (the memory order of the channels_last
  activations they mask), kept where u < 1 - rate and scaled by
  1 / (1 - rate);
* BatchNorm is torch's; in train mode it normalises with the batch's
  biased variance, as every DeepLabv3+ does.  Its running statistics are
  not read by anything the benchmark compares;
* with `save_memory` on a backbone, each residual or Xception block's
  activations are recomputed in the backward (torch.utils.checkpoint), so
  the f32 reference of a large training batch fits beside nothing else.

Imports torch alone: nothing of the program.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def run(block: nn.Module, x: torch.Tensor, save_memory: bool) -> torch.Tensor:
    """block(x); with `save_memory` under autograd, recomputed in the backward."""
    if save_memory and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)


class ResNetAtrous(nn.Module):
    def __init__(self, layers=(3, 4, 23, 3), output_stride=16, multi_grid=(1, 2, 4)):
        super().__init__()
        if output_stride == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        elif output_stride == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        else:
            raise ValueError(output_stride)
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(64, layers[0], strides[0], dilations[0])
        self.layer2 = self._make_layer(128, layers[1], strides[1], dilations[1])
        self.layer3 = self._make_layer(256, layers[2], strides[2], dilations[2])
        self.layer4 = self._make_layer(512, layers[3], strides[3], dilations[3], multi_grid)
        self.save_memory = False

    def _make_layer(self, planes, blocks, stride, dilation, multi_grid=None):
        downsample = nn.Sequential(
            nn.Conv2d(self.inplanes, planes * 4, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes * 4),
        )
        grids = multi_grid or (1,) * blocks
        layers = [Bottleneck(self.inplanes, planes, stride, dilation * grids[0], downsample)]
        self.inplanes = planes * 4
        for i in range(1, blocks):
            g = grids[min(i, len(grids) - 1)]
            layers.append(Bottleneck(self.inplanes, planes, 1, dilation * g))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        low = None
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = run(block, x, self.save_memory)
            low = x if low is None else low
        return x, low


class SeparableConv2d(nn.Module):
    def __init__(self, cin, cout, stride=1, dilation=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, 3, stride=stride, padding=dilation,
                               dilation=dilation, groups=cin, bias=False)
        self.bn = nn.BatchNorm2d(cin)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x):
        return self.pointwise(self.bn(self.conv1(x)))


class XBlock(nn.Module):
    def __init__(self, inplanes, planes, reps, stride=1, dilation=1,
                 start_with_relu=True, grow_first=True, is_last=False):
        super().__init__()
        if planes != inplanes or stride != 1:
            self.skip = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
            self.skipbn = nn.BatchNorm2d(planes)
        else:
            self.skip = None
        rep = []
        filters = inplanes
        if grow_first:
            rep += [nn.ReLU(inplace=False), SeparableConv2d(inplanes, planes, 1, dilation),
                    nn.BatchNorm2d(planes)]
            filters = planes
        for _ in range(reps - 1):
            rep += [nn.ReLU(inplace=False), SeparableConv2d(filters, filters, 1, dilation),
                    nn.BatchNorm2d(filters)]
        if not grow_first:
            rep += [nn.ReLU(inplace=False), SeparableConv2d(inplanes, planes, 1, dilation),
                    nn.BatchNorm2d(planes)]
        if stride != 1:
            rep += [nn.ReLU(inplace=False), SeparableConv2d(planes, planes, stride, 1),
                    nn.BatchNorm2d(planes)]
        elif is_last:
            rep += [nn.ReLU(inplace=False), SeparableConv2d(planes, planes, 1, 1),
                    nn.BatchNorm2d(planes)]
        if not start_with_relu:
            rep = rep[1:]
        self.rep = nn.Sequential(*rep)

    def forward(self, x):
        out = self.rep(x)
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return out + skip


class AlignedXception(nn.Module):
    def __init__(self, output_stride=16):
        super().__init__()
        if output_stride == 16:
            entry3_stride, middle_dil, exit_dil = 2, 1, (1, 2)
        elif output_stride == 8:
            entry3_stride, middle_dil, exit_dil = 1, 2, (2, 4)
        else:
            raise ValueError(output_stride)
        self.relu = nn.ReLU(inplace=False)
        self.conv1 = nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.block1 = XBlock(64, 128, 2, stride=2, start_with_relu=False)
        self.block2 = XBlock(128, 256, 2, stride=2)
        self.block3 = XBlock(256, 728, 2, stride=entry3_stride, is_last=True)
        for i in range(4, 20):
            setattr(self, f"block{i}", XBlock(728, 728, 3, dilation=middle_dil))
        self.block20 = XBlock(728, 1024, 2, stride=1, dilation=exit_dil[0],
                              grow_first=False, is_last=True)
        self.conv3 = SeparableConv2d(1024, 1536, 1, exit_dil[1])
        self.bn3 = nn.BatchNorm2d(1536)
        self.conv4 = SeparableConv2d(1536, 1536, 1, exit_dil[1])
        self.bn4 = nn.BatchNorm2d(1536)
        self.conv5 = SeparableConv2d(1536, 2048, 1, exit_dil[1])
        self.bn5 = nn.BatchNorm2d(2048)
        self.save_memory = False

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        x = self.relu(run(self.block1, x, self.save_memory))
        low = x
        for i in range(2, 20):
            x = run(getattr(self, f"block{i}"), x, self.save_memory)
        x = self.relu(run(self.block20, x, self.save_memory))
        x = self.relu(self.bn3(self.conv3(x)))
        x = self.relu(self.bn4(self.conv4(x)))
        x = self.relu(self.bn5(self.conv5(x)))
        return x, low


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, padding=0, dilation=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=padding, dilation=dilation, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


# backbone -> (high-level width, low-level width)
WIDTHS = {"resnet101": (2048, 256), "xception": (2048, 128)}


class DeepLabV3Plus(nn.Module):
    """backbone -> ASPP (with image pooling) -> decoder, with the ZS3 split
    classifier.  `features` gives the 256-d embedding at os4, `forward`
    the f32 logits at the input's size (align-corners bilinear)."""

    def __init__(self, backbone: str = "resnet101", num_classes: int = 21,
                 output_stride: int = 16, layers: Optional[Sequence[int]] = None,
                 feature_dim: int = 256, low_level_dim: int = 48, dropout: bool = True):
        super().__init__()
        if backbone == "resnet101":
            self.backbone = ResNetAtrous(tuple(layers or (3, 4, 23, 3)), output_stride)
        elif backbone == "xception":
            self.backbone = AlignedXception(output_stride)
        else:
            raise ValueError(f"no reference for backbone {backbone!r}")
        high, low = WIDTHS[backbone]
        d = (1, 6, 12, 18) if output_stride == 16 else (1, 12, 24, 36)
        f = feature_dim
        self.aspp1 = ConvBN(high, f, 1)
        self.aspp2 = ConvBN(high, f, 3, padding=d[1], dilation=d[1])
        self.aspp3 = ConvBN(high, f, 3, padding=d[2], dilation=d[2])
        self.aspp4 = ConvBN(high, f, 3, padding=d[3], dilation=d[3])
        self.global_pool = ConvBN(high, f, 1)
        self.project = ConvBN(5 * f, f, 1)
        self.low_proj = ConvBN(low, low_level_dim, 1)
        self.fuse1 = ConvBN(f + low_level_dim, f, 3, padding=1)
        self.fuse2 = ConvBN(f, f, 3, padding=1)
        self.classifier = nn.Conv2d(f, num_classes, 1)
        self.dropout = dropout
        self.dropout_generator: Optional[torch.Generator] = None

    def drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if not (self.training and self.dropout):
            return x
        b, c, h, w = x.shape
        u = torch.empty((b, h, w, c), dtype=torch.float32, device=x.device)
        u = u.uniform_(generator=self.dropout_generator).permute(0, 3, 1, 2)
        keep = 1.0 - rate
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        high, low = self.backbone(x)
        branches = [self.aspp1(high), self.aspp2(high), self.aspp3(high), self.aspp4(high)]
        pooled = self.global_pool(F.adaptive_avg_pool2d(high, 1)).expand(-1, -1, *high.shape[2:])
        y = self.drop(self.project(torch.cat(branches + [pooled], dim=1)), 0.5)
        y = F.interpolate(y, size=low.shape[2:], mode="bilinear", align_corners=True)
        y = self.drop(self.fuse1(torch.cat([y, self.low_proj(low)], dim=1)), 0.5)
        return self.drop(self.fuse2(y), 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.classifier(self.features(x))
        return F.interpolate(logits, size=x.shape[2:], mode="bilinear", align_corners=True)


def build(config: dict) -> DeepLabV3Plus:
    """The reference of a configuration file's model (benchmark/configs)."""
    m = config["model"]
    return DeepLabV3Plus(m["backbone"], m["num_classes"], m["output_stride"], m.get("layers"),
                         m["feature_dim"], m["low_level_dim"], m["dropout"])
