"""Atrous ResNet backbones, DeepLab variant (port of zs3_tpu.models.resnet).

ResNet-50/101 with the stride->dilation rewrite in layer3/layer4 set by
output_stride and multi-grid (1, 2, 4) in layer4, returning (x: 2048ch
at os16/os8, low_level: 256ch at os4).  Module names follow torchvision
(conv1, bn1, layerL.B.convN, layerL.B.downsample.{0,1}), so a
torchvision state_dict loads as it is.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from zs3_tpu_torch import quant
from zs3_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    max_pool_3x3_s2,
    stem_conv,
    to_nchw,
    to_nhwc,
)
from zs3_tpu_torch.parallel import spatial


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride/dilation) -> 1x1 expand(4x) + skip.

    The stride sits on the 3x3 conv2, as in zs3_tpu and torchvision v1.5.
    With `remat`, a train-mode forward that records a graph runs under
    torch.utils.checkpoint (non-reentrant): the block keeps only its input
    and recomputes the rest in the backward, with its BN running
    statistics held still during the recompute (zs3_tpu's nn.remat).
    """

    def __init__(
        self,
        in_channels: int,
        planes: int,
        stride: int = 1,
        dilation: int = 1,
        downsample: bool = False,
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        bn = lambda c: BatchNorm(c, bn_momentum, bn_epsilon)
        self.conv1 = Conv(in_channels, planes, 1, dtype=dtype)
        self.bn1 = bn(planes)
        self.conv2 = Conv(
            planes, planes, 3, stride=stride, padding=dilation,
            dilation=dilation, dtype=dtype,
        )
        self.bn2 = bn(planes)
        self.conv3 = Conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = bn(planes * 4)
        self.downsample = (
            nn.Sequential(
                Conv(in_channels, planes * 4, 1, stride=stride, dtype=dtype),
                bn(planes * 4),
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            # The recompute runs in the backward (on CUDA, on autograd's
            # thread): it re-enters the forward's quantization state and
            # its place in a spatial sharding's plan.
            state = quant.current(), spatial.current()
            return checkpoint(self._forward, x, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  self._recomputing(*state)))
        return self._forward(x)

    @contextlib.contextmanager
    def _recomputing(self, quant_state, space_state):
        bns = [m for m in self.modules() if isinstance(m, BatchNorm)]
        for bn in bns:
            bn.update_stats = False
        try:
            with quant.restored(quant_state), spatial.restored(space_state):
                yield
        finally:
            for bn in bns:
                bn.update_stats = True

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


def stage_plan(output_stride: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(strides, dilations) of the four stages."""
    if output_stride == 16:
        return (1, 2, 2, 1), (1, 1, 1, 2)
    if output_stride == 8:
        return (1, 2, 1, 1), (1, 1, 2, 4)
    raise ValueError(f"output_stride must be 8 or 16, got {output_stride}")


class ResNetAtrous(nn.Module):
    """ResNet-50/101 with atrous layer3/4 for dense prediction.

    output_stride=16: strides (1,2,2,1), dilations (1,1,1,2), and the
    grid scales the layer4 dilation by (1,2,4).  output_stride=8:
    strides (1,2,1,1), dilations (1,1,2,4).  forward takes NHWC images
    and returns NHWC (high, low_level).
    """

    def __init__(
        self,
        layers: Sequence[int] = (3, 4, 23, 3),
        output_stride: int = 16,
        multi_grid: Sequence[int] = (1, 2, 4),
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        dtype: torch.dtype = torch.float32,
        stem_width: int = 64,
        remat: bool = False,
    ):
        super().__init__()
        strides, dilations = stage_plan(output_stride)
        self.compute_dtype = dtype
        self.conv1 = stem_conv(3, stem_width, dtype)
        self.bn1 = BatchNorm(stem_width, bn_momentum, bn_epsilon)
        in_ch = stem_width
        for stage, planes in enumerate((64, 128, 256, 512)):
            blocks = []
            for block in range(layers[stage]):
                if stage == 3:
                    # multi-grid in layer4 (reference: ResNet._make_MG_unit)
                    grid = multi_grid[min(block, len(multi_grid) - 1)]
                    dilation = dilations[stage] * grid
                else:
                    dilation = dilations[stage]
                first = block == 0
                blocks.append(
                    Bottleneck(
                        in_ch, planes,
                        stride=strides[stage] if first else 1,
                        dilation=dilation,
                        downsample=first,  # channel change at every stage entry
                        bn_momentum=bn_momentum,
                        bn_epsilon=bn_epsilon,
                        dtype=dtype,
                        remat=remat,
                    )
                )
                in_ch = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.compute_dtype)
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        low_level = self.layer1(x)  # 256ch @ os4
        x = self.layer4(self.layer3(self.layer2(low_level)))
        return x, low_level

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        high, low = self.forward_nchw(to_nchw(x))
        return to_nhwc(high), to_nhwc(low)


def ResNet101(**kw) -> ResNetAtrous:
    return ResNetAtrous(layers=(3, 4, 23, 3), **kw)


def ResNet50(**kw) -> ResNetAtrous:
    return ResNetAtrous(layers=(3, 4, 6, 3), **kw)
