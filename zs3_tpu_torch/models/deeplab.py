"""DeepLabv3+ with the ZS3 feature/classifier split
(port of zs3_tpu.models.deeplab).

backbone -> ASPP -> decoder -> bilinear upsample to input resolution
(align_corners=True), with the 1x1 classifier split out so the 256-d
pre-logit pixel embedding is a first-class output.  Methods take and
return NHWC tensors, as in zs3_tpu:

  forward(x)             -> f32 (or f64) logits at input resolution (N,H,W,C);
                            with fused_tail, in eval mode and at the exact
                            4x geometry, through kernel K4 (ops/tail_kernels.py);
                            under spatial sharding K4 takes the features
                            gathered whole (parallel/spatial.py)
  forward_features(x)    -> 256-d pixel embedding at the os4 grid
  classify(feats)        -> logits at the feature grid
  upsample_logits(l, s)  -> align-corners bilinear to size s

Backbones, as zs3_tpu builds them: ``resnet101`` (or ``resnet``) and
``resnet50`` (ResNetAtrous; `layers=` gives narrow test ResNets),
``xception`` (AlignedXception), ``mobilenet`` (MobileNetV2Backbone) and
``drn`` (DRN54, natively os8: its ASPP takes the os8 rates whatever
`output_stride` says).  `remat` reaches the ResNets only, as in zs3_tpu.

The state_dict follows tests/torch_oracle.py: the backbone's upstream
checkpoint keys under ``backbone.`` (torchvision ResNet, or the names of
tests/torch_oracle_backbones.py), then ``aspp1..4``, ``global_pool``,
``project``, ``low_proj``, ``fuse1``, ``fuse2`` and ``classifier`` at the
top level.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from zs3_tpu_torch.core.config import ModelConfig
from zs3_tpu_torch.models.aspp import ASPP
from zs3_tpu_torch.models.decoder import Decoder
from zs3_tpu_torch.models.drn import DRN54
from zs3_tpu_torch.models.layers import BatchNorm, Conv
from zs3_tpu_torch.models.mobilenet import MobileNetV2Backbone
from zs3_tpu_torch.models.resnet import ResNetAtrous
from zs3_tpu_torch.models.xception import AlignedXception
from zs3_tpu_torch.ops import tail_kernels
from zs3_tpu_torch.ops.resize import resize_bilinear
from zs3_tpu_torch.parallel import spatial

RESNET_LAYERS = {
    "resnet": (3, 4, 23, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet50": (3, 4, 6, 3),
}
# backbone -> (high-level width, low-level width)
BACKBONE_WIDTHS = {
    **{name: (2048, 256) for name in RESNET_LAYERS},
    "xception": (2048, 128),
    "mobilenet": (320, 24),
    "drn": (512, 256),
}


def build_backbone(name: str, output_stride: int, bn_kw, dtype: torch.dtype,
                   layers: Optional[Sequence[int]] = None, remat: bool = False) -> nn.Module:
    """The backbone `name`; `layers` sets a ResNet's depth (the backbone
    name's when None)."""
    if layers is not None and name not in RESNET_LAYERS:
        raise ValueError(f"layers= sets a ResNet's depth, not {name!r}'s")
    if name in RESNET_LAYERS:
        return ResNetAtrous(layers=tuple(layers or RESNET_LAYERS[name]),
                            output_stride=output_stride, dtype=dtype, remat=remat, **bn_kw)
    if name == "xception":
        return AlignedXception(output_stride, dtype=dtype, **bn_kw)
    if name == "mobilenet":
        return MobileNetV2Backbone(output_stride, dtype=dtype, **bn_kw)
    if name == "drn":
        return DRN54(dtype=dtype, **bn_kw)
    raise ValueError(f"unknown backbone {name!r}; available: {sorted(BACKBONE_WIDTHS)}")


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
        remat: bool = False,
    ):
        super().__init__()
        self.fused_tail = fused_tail
        self.backbone_name = backbone
        bn_kw = dict(bn_momentum=bn_momentum, bn_epsilon=bn_epsilon)
        self.compute_dtype = dtype
        self.num_classes = num_classes
        self.backbone = build_backbone(backbone, output_stride, bn_kw, dtype, layers, remat)
        high_ch, low_ch = BACKBONE_WIDTHS[backbone]
        # DRN feeds the ASPP at os8 whatever the config says.
        aspp_os = 8 if backbone == "drn" else output_stride
        aspp = ASPP(high_ch, aspp_os, feature_dim, dropout=dropout, dtype=dtype, **bn_kw)
        decoder = Decoder(
            num_classes, feature_dim, low_ch, feature_dim, low_level_dim,
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
        # Each conv's name for int8 scales (zs3_tpu.quant's module paths).
        for name, module in self.named_modules():
            if isinstance(module, Conv):
                module.quant_path = name

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
        if self.fused_tail and not self.training:
            def supported(grid, image):
                return tail_kernels.supported(grid, image, self.num_classes)

            if spatial.active():  # K4 on the features gathered whole
                logits = spatial.fused_tail(feats, size, supported, self._fused_tail)
                if logits is not None:
                    return logits
            elif supported(tuple(feats.shape[1:3]), size):
                return self._fused_tail(feats, size)
        logits = self.classify(feats)
        # Upsample in the compute dtype, output f32 (as zs3_tpu does), or
        # the compute dtype when that is wider.
        logits = self.upsample_logits(logits, size)
        return logits.to(torch.promote_types(logits.dtype, torch.float32))

    def _fused_tail(self, feats: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        """classify + upsample in one launch of kernel K4 (f32 logits)."""
        conv = self.classifier  # (K, C, 1, 1) -> (C, K)
        w = conv.weight.detach()[:, :, 0, 0].t()
        return tail_kernels.tail_logits(feats, w, conv.bias.detach(), size).float()


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
        remat=cfg.remat,
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
