"""ASPP — Atrous Spatial Pyramid Pooling (port of zs3_tpu.models.aspp).

Four parallel conv branches (1x1 + three 3x3 atrous at dilations
[6,12,18] for os16 / [12,24,36] for os8) plus an image-level
global-average-pool branch; concat -> 1x1 to 256ch -> BN -> ReLU ->
dropout(0.5), which is off in eval mode.  The pooled branch's
"upsample" is a broadcast (bilinear of a 1x1 map), not a resize.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zs3_tpu_torch.models.layers import ConvBN, Dropout, global_avg_pool, to_nchw, to_nhwc


def aspp_dilations(output_stride: int):
    if output_stride == 16:
        return (1, 6, 12, 18)
    if output_stride == 8:
        return (1, 12, 24, 36)
    raise ValueError(f"output_stride must be 8 or 16, got {output_stride}")


class ASPP(nn.Module):
    def __init__(
        self,
        in_channels: int = 2048,
        output_stride: int = 16,
        features: int = 256,
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        dropout: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        bn_kw = dict(bn_momentum=bn_momentum, bn_epsilon=bn_epsilon, dtype=dtype)
        for i, d in enumerate(aspp_dilations(output_stride)):
            k = 1 if d == 1 else 3
            setattr(
                self, f"aspp{i + 1}",
                ConvBN(in_channels, features, k, padding=0 if k == 1 else d,
                       dilation=d, **bn_kw),
            )
        self.global_pool = ConvBN(in_channels, features, 1, **bn_kw)
        self.project = ConvBN(5 * features, features, 1, **bn_kw)
        self.dropout = Dropout(0.5) if dropout else nn.Identity()

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        branches = [
            getattr(self, f"aspp{i}")(x) for i in range(1, 5)
        ]
        # Image-level branch: GAP -> 1x1 conv -> BN -> ReLU -> broadcast.
        pooled = self.global_pool(global_avg_pool(x))
        branches.append(pooled.expand_as(branches[0]))
        # Concatenate along channels in NHWC, so the result is
        # channels_last whatever the branches' strides.
        y = torch.cat([to_nhwc(b) for b in branches], dim=-1)
        return self.dropout(self.project(to_nchw(y)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC (B, h, w, 2048) -> NHWC (B, h, w, features)."""
        return to_nhwc(self.forward_nchw(to_nchw(x)))
