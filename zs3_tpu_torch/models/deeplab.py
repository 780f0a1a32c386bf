"""DeepLabv3+ with the ZS3 feature/classifier split
(port of zs3_tpu.models.deeplab).

backbone -> ASPP -> decoder -> bilinear upsample to input resolution
(align_corners=True), with the 1x1 classifier split out so the 256-d
pre-logit pixel embedding is a first-class output.  Methods take and
return NHWC tensors, as in zs3_tpu:

  forward(x)             -> f32 logits at input resolution (N,H,W,C);
                            with fused_tail, in eval mode and at the exact
                            4x geometry, through kernel K4 (ops/tail_kernels.py)
  forward_features(x)    -> 256-d pixel embedding at the os4 grid
  classify(feats)        -> logits at the feature grid
  upsample_logits(l, s)  -> align-corners bilinear to size s

The state_dict follows tests/torch_oracle.py: torchvision ResNet keys
under ``backbone.``, then ``aspp1..4``, ``global_pool``, ``project``,
``low_proj``, ``fuse1``, ``fuse2`` and ``classifier`` at the top level.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from zs3_tpu_torch.core.config import ModelConfig
from zs3_tpu_torch.models.aspp import ASPP
from zs3_tpu_torch.models.decoder import Decoder
from zs3_tpu_torch.models.layers import BatchNorm, Conv
from zs3_tpu_torch.models.resnet import ResNetAtrous
from zs3_tpu_torch.ops import tail_kernels
from zs3_tpu_torch.ops.resize import resize_bilinear

RESNET_LAYERS = {
    "resnet": (3, 4, 23, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet50": (3, 4, 6, 3),
}


class DeepLab(nn.Module):
    def __init__(
        self,
        backbone: str = "resnet101",
        output_stride: int = 16,
        num_classes: int = 21,
        feature_dim: int = 256,
        low_level_dim: int = 48,
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        dropout: bool = True,
        dtype: torch.dtype = torch.float32,
        layers: Optional[Sequence[int]] = None,
        fused_tail: bool = False,
    ):
        super().__init__()
        self.fused_tail = fused_tail
        if layers is None:
            if backbone not in RESNET_LAYERS:
                raise NotImplementedError(
                    f"backbone {backbone!r} is not ported yet; "
                    f"available: {sorted(RESNET_LAYERS)}"
                )
            layers = RESNET_LAYERS[backbone]
        bn_kw = dict(bn_momentum=bn_momentum, bn_epsilon=bn_epsilon)
        self.compute_dtype = dtype
        self.num_classes = num_classes
        self.backbone = ResNetAtrous(
            layers=tuple(layers), output_stride=output_stride, dtype=dtype, **bn_kw
        )
        aspp = ASPP(2048, output_stride, feature_dim, dropout=dropout, dtype=dtype, **bn_kw)
        decoder = Decoder(
            num_classes, feature_dim, 256, feature_dim, low_level_dim,
            dropout=dropout, dtype=dtype, **bn_kw,
        )
        # Adopt the ASPP and decoder blocks as direct children, so the
        # state_dict carries the flat oracle names (aspp1, fuse1, ...);
        # the wrappers share those modules and are kept unregistered.
        for module in (aspp, decoder):
            for name, child in module.named_children():
                self.add_module(name, child)
        object.__setattr__(self, "aspp", aspp)
        object.__setattr__(self, "decoder", decoder)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> NHWC 256-d pixel embedding at the os4 grid (the
        trunk short of the 1x1 classifier)."""
        high, low = self.backbone(x.to(self.compute_dtype))
        return self.decoder.features(self.aspp(high), low)

    def classify(self, feats: torch.Tensor) -> torch.Tensor:
        return self.decoder.classify(feats.to(self.compute_dtype))

    def upsample_logits(
        self, logits: torch.Tensor, size: Tuple[int, int]
    ) -> torch.Tensor:
        return resize_bilinear(logits, size, align_corners=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = tuple(x.shape[1:3])
        feats = self.forward_features(x)
        if (
            self.fused_tail
            and not self.training
            and tail_kernels.supported(tuple(feats.shape[1:3]), size, self.num_classes)
        ):
            conv = self.classifier  # (K, C, 1, 1) -> (C, K)
            w = conv.weight.detach()[:, :, 0, 0].t()
            return tail_kernels.tail_logits(feats, w, conv.bias.detach(), size).float()
        logits = self.classify(feats)
        # Upsample in the compute dtype, output f32 (as zs3_tpu does).
        return self.upsample_logits(logits, size).float()


def build_deeplab(cfg: ModelConfig) -> DeepLab:
    """DeepLab for `cfg` on the CPU with default-initialised weights
    (see init_deeplab for the seeded init)."""
    return DeepLab(
        backbone=cfg.backbone,
        output_stride=cfg.output_stride,
        num_classes=cfg.num_classes,
        feature_dim=cfg.feature_dim,
        low_level_dim=cfg.low_level_dim,
        bn_momentum=cfg.bn_momentum,
        bn_epsilon=cfg.bn_epsilon,
        dropout=cfg.dropout,
        dtype=getattr(torch, cfg.compute_dtype),
        fused_tail=cfg.fused_tail,
    )


@torch.no_grad()
def init_deeplab(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init in place, with the initializers zs3_tpu uses:
    conv kernels lecun-normal (truncated at 2 std), biases 0, BN scale 1,
    shift 0, running mean 0 and variance 1.  torch draws other numbers
    than jax.random from the same seed."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, Conv):
            fan_in = module.weight[0].numel()
            # flax's truncated normal divides by the std of a unit normal
            # truncated to [-2, 2].
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(
                module.weight, 0.0, std, -2 * std, 2 * std, generator=gen
            )
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.reset_parameters()
    return model
