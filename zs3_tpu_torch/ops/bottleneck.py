"""Fused eval-mode ResNet bottleneck, plain version (port of
zs3_tpu.ops.pallas_bottleneck's math).

A stride-1, identity-skip bottleneck with its BN folded into the convs
(`fold_bn`):

    y1  = relu(x @ w1 + b1)              rounded to x's dtype
    y2  = relu(conv3x3_d(y1, w2) + b2)   rounded to x's dtype
    out = relu(y2 @ w3 + b3 + x)         in x's dtype

x is (B, H, W, C) NHWC; w1 (C, P), w2 (3, 3, P, P) HWIO and w3 (P, C) are
used in x's dtype, the biases in f32 (zs3_tpu's layouts and argument
order).  `fused_bottleneck` and `fused_stage` work the kernel's math out
step by step: the 1x1 convs as matmuls, the dilated 3x3 as nine shifted
tap matmuls over a zero-padded y1, every product accumulated in f32
(operands upcast, so products of bf16 values are exact), the residual
added in f32.  They are the CPU's path and the reference of kernel K5
(ops/bottleneck_kernels.py); `bottleneck_oracle` is the same block as
three convolutions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Block = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def fold_bn(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """Fold an eval-mode BN into the conv before it: kernel (..., Cout),
    BN params (Cout,) -> (kernel', bias') with
    conv(x, kernel') + bias' == bn(conv(x, kernel))."""
    inv = scale / torch.sqrt(var + eps)
    return kernel * inv, bias - mean * inv


def fold_bottleneck(block) -> Block:
    """The K5 parameters (w1, b1, w2, b2, w3, b3) of a models.resnet
    Bottleneck in eval mode: its OIHW conv weights as zs3_tpu's (C, P),
    HWIO and (P, C) kernels with each BN folded in, all f32."""

    def fold(conv, bn):
        kernel = conv.weight.detach().float().permute(2, 3, 1, 0)  # OIHW -> HWIO
        return fold_bn(kernel, bn.weight.detach(), bn.bias.detach(),
                       bn.running_mean, bn.running_var, bn.eps)

    w1, b1 = fold(block.conv1, block.bn1)
    w2, b2 = fold(block.conv2, block.bn2)
    w3, b3 = fold(block.conv3, block.bn3)
    return (w1[0, 0].contiguous(), b1, w2.contiguous(), b2, w3[0, 0].contiguous(), b3)


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, dilation: int = 1) -> torch.Tensor:
    """One block on (B, H, W, C) x, the kernel's arithmetic step by step."""
    dt, d = x.dtype, dilation
    _, h, w, _ = x.shape
    xf = x.float()
    y1 = torch.relu(xf @ w1.to(dt).float() + b1.float()).to(dt)
    y1p = F.pad(y1, (0, 0, d, d, d, d)).float()  # zeros outside the image
    w2 = w2.to(dt).float()
    acc = b2.float().expand(*y1.shape[:3], -1)
    for a in range(3):
        for b in range(3):
            acc = acc + y1p[:, a * d : a * d + h, b * d : b * d + w] @ w2[a, b]
    y2 = torch.relu(acc).to(dt)
    y3 = y2.float() @ w3.to(dt).float() + b3.float()
    return torch.relu(y3 + xf).to(dt)


def fused_stage(x, blocks: Sequence[Block], dilations: Sequence[int]) -> torch.Tensor:
    """Consecutive blocks, each with its dilation."""
    for params, d in zip(blocks, dilations):
        x = fused_bottleneck(x, *params, dilation=d)
    return x


def bottleneck_oracle(x, w1, b1, w2, b2, w3, b3, dilation: int = 1) -> torch.Tensor:
    """The same block as three f32 convolutions (zs3_tpu's bottleneck_oracle)."""
    dt, d = x.dtype, dilation
    xc = x.float().permute(0, 3, 1, 2)
    y = F.conv2d(xc, w1.to(dt).float().t()[:, :, None, None], b1.float())
    y = torch.relu(y).to(dt).float()
    y = F.conv2d(y, w2.to(dt).float().permute(3, 2, 0, 1), b2.float(), padding=d, dilation=d)
    y = torch.relu(y).to(dt).float()
    y = F.conv2d(y, w3.to(dt).float().t()[:, :, None, None], b3.float())
    return torch.relu(y + xc).to(dt).permute(0, 2, 3, 1)
