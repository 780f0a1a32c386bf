"""DeepLabv3+ decoder with the feature/classifier split
(port of zs3_tpu.models.decoder).

Low-level features (256ch at os4) project via 1x1 -> 48ch; the ASPP
output upsamples (align_corners bilinear) to that grid and is
concatenated before it, [up, low]; two 3x3 convs (+dropout 0.5/0.1, off
in eval mode) give the 256-d pixel embedding — the ZS3 feature tap —
and a separate 1x1 conv classifies.  `features` and `classify` are
separate methods, as in zs3_tpu.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zs3_tpu_torch.models.layers import Conv, ConvBN, Dropout, to_nchw, to_nhwc
from zs3_tpu_torch.ops.resize import resize_bilinear


class Decoder(nn.Module):
    def __init__(
        self,
        num_classes: int = 21,
        aspp_channels: int = 256,
        low_level_channels: int = 256,
        feature_dim: int = 256,
        low_level_dim: int = 48,
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        dropout: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        bn_kw = dict(bn_momentum=bn_momentum, bn_epsilon=bn_epsilon, dtype=dtype)
        self.low_proj = ConvBN(low_level_channels, low_level_dim, 1, **bn_kw)
        self.fuse1 = ConvBN(
            aspp_channels + low_level_dim, feature_dim, 3, padding=1, **bn_kw
        )
        self.fuse2 = ConvBN(feature_dim, feature_dim, 3, padding=1, **bn_kw)
        self.drop1 = Dropout(0.5) if dropout else nn.Identity()
        self.drop2 = Dropout(0.1) if dropout else nn.Identity()
        self.classifier = Conv(
            feature_dim, num_classes, 1, use_bias=True, dtype=dtype
        )

    def features(self, aspp_out: torch.Tensor, low_level: torch.Tensor) -> torch.Tensor:
        """NHWC ASPP output + NHWC low-level map -> NHWC 256-d embedding
        at the low-level (os4) grid."""
        low = to_nhwc(self.low_proj(to_nchw(low_level)))
        up = resize_bilinear(aspp_out, tuple(low.shape[1:3]), align_corners=True)
        y = torch.cat([up, low.to(up.dtype)], dim=-1)
        y = self.drop1(self.fuse1(to_nchw(y)))
        y = self.drop2(self.fuse2(y))
        return to_nhwc(y)

    def classify(self, feats: torch.Tensor) -> torch.Tensor:
        """The split 1x1 classifier: NHWC features -> NHWC logits."""
        return to_nhwc(self.classifier(to_nchw(feats)))

    def forward(self, aspp_out: torch.Tensor, low_level: torch.Tensor) -> torch.Tensor:
        return self.classify(self.features(aspp_out, low_level))
