"""Shared NN building blocks (port of zs3_tpu.models.layers).

These modules take and return NCHW tensors; the model's public methods
permute from and to NHWC, and with torch.channels_last the permute is a
view, so cuDNN runs its NHWC kernels without copies.  Convolutions use
torch's symmetric integer padding, which zs3_tpu reproduces explicitly.
Parameters stay f32; a conv runs in the compute dtype it was built with
(zs3_tpu.models.layers._ConvImpl casts input and kernel the same way).

BatchNorm keeps torch's parameter names (weight, bias, running_mean,
running_var).  Momentum follows torch: flax's 0.9 is torch's 0.1.  In
train mode it updates running_var with the biased batch variance, as
flax does, not torch's unbiased one.  With more than one rank it takes
the global batch's statistics (core/mesh.py).  Dropout draws its masks
from a torch.Generator the train step hands it (`set_dropout_generator`),
never from the global RNG, so a resumed run draws what an uninterrupted
one does, and N ranks draw what one rank draws.

Under spatial sharding (parallel/spatial.py) the ops that read across
rows take this rank's rows of H: Conv and max_pool_3x3_s2 fetch their
window of rows, global_avg_pool sums over the space group, Dropout keeps
its rows of the global mask.  On meta tensors (the sharding's planner)
they compute shapes only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from zs3_tpu_torch import quant
from zs3_tpu_torch.core.mesh import all_reduce_autograd, world_size
from zs3_tpu_torch.ops import bn_kernels
from zs3_tpu_torch.parallel import spatial

# From this dilation on, a "same" conv runs as space-to-batch.  cuDNN's
# bf16 NHWC engines on an H100 take a 3x3 conv up to dilation 10; from 11
# on cuDNN falls back to a direct kernel some 300x slower (about 55 ms
# against 0.18 ms for the os16 ASPP branch at 4x33x33x2048 -> 256;
# chip_smoke.py times both, PERF.md has the numbers).
SPACE_TO_BATCH_MIN_DILATION = 11
# From this dilation on, a depthwise "same" conv runs as space-to-batch too.
# On an H100, cuDNN's bf16 channels_last depthwise 3x3 at dilation 2 or 4
# takes some 45x its bytes bound (0.481 ms for 8x1024x33x33 at d = 2, 0.0202
# at d = 1); space-to-batch takes 0.148 ms forward, and 0.342 against 0.611
# forward and backward (chip_smoke.py::depthwise_routes_ms times the routes,
# PERF.md has the numbers).  A conv of few groups does not: ResNeSt's 3x3
# of 2 groups (24x256x64x64 -> 512 at d = 2, 24x512x64x64 -> 1024 at d = 4)
# takes 1.34 and 3.31 ms forward and backward as conv2d_per_group, 1.66 and
# 3.36 as cuDNN's grouped conv and 2.23 and 4.24 as space-to-batch
# (chip_smoke.py::grouped_conv_routes_ms).
GROUPED_SPACE_TO_BATCH_MIN_DILATION = 2


def conv2d_per_group(x: torch.Tensor, weight: torch.Tensor, bias, stride, padding, dilation,
                     groups: int) -> torch.Tensor:
    """F.conv2d with `groups`, as one ungrouped conv per group on the
    current stream, the outputs concatenated over channels.

    On the card, cuDNN runs a grouped conv that is not depthwise (ResNeSt's
    2-group 3x3) as a channel slice and a conv per group, each group on a
    stream of its own, both forward and backward.  Kernels on two streams
    at once overlap, so their device times no longer add up to the time
    the card was busy, and the step's order is no longer the stream's.
    One conv per group on the current stream does the same slices and
    convs in turn."""
    cin, cout = x.shape[1] // groups, weight.shape[0] // groups
    return torch.cat([
        F.conv2d(x[:, g * cin:(g + 1) * cin], weight[g * cout:(g + 1) * cout],
                 None if bias is None else bias[g * cout:(g + 1) * cout],
                 stride, padding, dilation)
        for g in range(groups)], 1)


def conv2d_space_to_batch(
    x: torch.Tensor, weight: torch.Tensor, bias, dilation: int, groups: int = 1,
    pad_h: Optional[int] = None,
) -> torch.Tensor:
    """A stride-1 conv with dilation d and "same" padding d*(k-1)/2 in W,
    and `pad_h` in H (the same "same" for None; 0 for a window of rows
    fetched whole under spatial sharding), as a dilation-1 conv over the
    d*d residue classes of the input grid.

    Output pixel (i, j) reads inputs (i - pad_h + a*d, j + b*d), all of one
    residue class, so each residue class is an ordinary conv with padding
    pad_h/d in H and (k-1)/2 in W; zero-padding H and W up to multiples of
    d adds only zeros the dilated conv would also read, or rows no kept
    output reads.  The products and their sums are those of the dilated
    conv.  The residue classes only move pixels, never channels, so a
    grouped conv keeps its `groups`.  NCHW in (channels_last), NCHW out
    (channels_last).
    """
    d = dilation
    k = weight.shape[-1]
    pad_h = d * (k - 1) // 2 if pad_h is None else pad_h
    b, c, h, w = x.shape
    hq, wq = -(-h // d), -(-w // d)
    xh = F.pad(x.permute(0, 2, 3, 1), (0, 0, 0, wq * d - w, 0, hq * d - h))
    xs = xh.reshape(b, hq, d, wq, d, c).permute(0, 2, 4, 1, 3, 5)
    xs = xs.reshape(b * d * d, hq, wq, c).permute(0, 3, 1, 2)
    y = F.conv2d(xs, weight, bias, 1, (pad_h // d, (k - 1) // 2), 1, groups)
    co, ho = y.shape[1], y.shape[2]
    y = y.permute(0, 2, 3, 1).reshape(b, d, d, ho, wq, co).permute(0, 3, 1, 4, 2, 5)
    y = y.reshape(b, ho * d, wq * d, co)[:, :h + 2 * pad_h - d * (k - 1), :w]
    return y.contiguous().permute(0, 3, 1, 2)


class Conv(nn.Conv2d):
    """2-D conv with torch-style integer padding that runs in `dtype`;
    `groups` as zs3_tpu's feature_group_count (groups == in_channels is a
    depthwise conv).

    A "same" conv of large dilation (a depthwise one from dilation 2) runs
    as `conv2d_space_to_batch`; on the card a grouped conv that is not
    depthwise runs as `conv2d_per_group`.  As
    zs3_tpu's _ConvImpl: an eligible conv (ungrouped, >= MIN_QUANT_IN_CH
    input channels) whose `quant_path` has a scale under quant.quantized()
    runs as quant.int8_conv; else, under quant.qat() and not excluded, it
    runs the float conv on fake-quantized operands.  `quant_path` is the
    conv's module name in its model (DeepLab sets it when built).  Under
    spatial sharding each route runs on the window of rows this rank's
    output reads, with H padding 0 (fake quantization against the whole
    level's |x| max)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        dilation: int = 1,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        groups: int = 1,
    ):
        super().__init__(
            in_channels, features, kernel_size, stride=stride, padding=padding,
            dilation=dilation, groups=groups, bias=use_bias,
        )
        self.compute_dtype = dtype
        self.quant_path = ""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act_absmax = quant.scale_for(self.quant_path) if quant.quantizable(self) else None
        fake_quant = (act_absmax is None and quant.quantizable(self) and quant.qat_active()
                      and not quant.path_excluded(self.quant_path))
        level_absmax = spatial.max_abs(x) if fake_quant else None
        return spatial.windowed(
            "conv", x, self.kernel_size[0], self.stride[0], self.padding[0], self.dilation[0],
            lambda rows, pad_h: self._run(rows, pad_h, act_absmax, fake_quant, level_absmax))

    def _run(self, x, pad_h, act_absmax, fake_quant, level_absmax) -> torch.Tensor:
        """The conv with H padding `pad_h` (W padding as built)."""
        padding = (pad_h, self.padding[1])
        weight = self.weight
        if x.is_meta:  # the spatial planner's pass: shapes only
            return F.conv2d(x, weight.to("meta"), None, self.stride, padding, self.dilation,
                            self.groups)
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        if act_absmax is not None:
            y = quant.int8_conv(x, weight, act_absmax, self.stride, padding, self.dilation,
                                self.compute_dtype)
            return y if bias is None else y + bias[:, None, None]
        if fake_quant:
            x, weight = quant.fake_quant_conv_operands(x, weight, level_absmax)
        x = x.to(self.compute_dtype)
        weight = weight.to(self.compute_dtype)
        d, k = self.dilation[0], self.kernel_size[0]
        depthwise = self.groups > 1 and self.groups == self.in_channels
        min_dilation = (GROUPED_SPACE_TO_BATCH_MIN_DILATION if depthwise
                        else SPACE_TO_BATCH_MIN_DILATION)
        if (
            d >= min_dilation
            and self.stride == (1, 1)
            and self.dilation == (d, d)
            and self.kernel_size == (k, k)
            and self.padding == (d * (k - 1) // 2,) * 2
        ):
            return conv2d_space_to_batch(x, weight, bias, d, self.groups, pad_h)
        if x.is_cuda and self.groups > 1 and not depthwise:
            return conv2d_per_group(x, weight, bias, self.stride, padding, self.dilation,
                                    self.groups)
        return F.conv2d(x, weight, bias, self.stride, padding, self.dilation, self.groups)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d whose output keeps the input's (compute) dtype; its
    parameters and running statistics stay f32.

    Train mode normalises with the batch mean and biased variance and
    then sets, as flax's BatchNorm does,
        running_mean = m * running_mean + (1 - m) * mean
        running_var  = m * running_var  + (1 - m) * var_biased
    (m = flax's momentum; nn.BatchNorm2d would use the unbiased variance,
    n/(n-1) larger).  On one rank that is ops/bn_kernels.py's
    `batch_norm_train`: on a CUDA tensor two hand-written kernels each
    way, which also update the running statistics; on the CPU the plain
    version, torch.native_batch_norm with the statistics recovered from
    its saved mean and inverse std.  With more than one rank (a process
    group of world size > 1) the statistics are the global batch's:
    `synced_batch_norm`.  While `update_stats` is False (a checkpointed
    block recomputing its forward) the running statistics stay as they
    are.  `relu=True`, at the call or (where the layer sits in an
    nn.Sequential) at construction, applies the ReLU that follows the
    layer where it sits in its model; the kernels fold it into their
    passes.
    """

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 relu: bool = False):
        super().__init__(features, eps=epsilon, momentum=1.0 - momentum)
        self.update_stats = True
        self.relu = relu

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        relu = relu or self.relu
        if x.is_meta:  # the spatial planner's pass: shapes only
            return x
        if self.training and world_size() == 1:
            return bn_kernels.batch_norm_train(
                x, self.weight, self.bias, self.running_mean, self.running_var,
                self.num_batches_tracked, self.eps, self.momentum, relu, self.update_stats)
        if not self.training:
            out = super().forward(x)
        else:
            out, mean, var = synced_batch_norm(x, self.weight, self.bias, self.eps)
            if self.update_stats:
                bn_kernels.update_running_stats(self.running_mean, self.running_var,
                                                self.num_batches_tracked, mean, var,
                                                self.momentum)
        return F.relu(out) if relu else out


def synced_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float):
    """Train-mode BN over the global batch of the default process group:
    (out in x's dtype, mean, biased var), the statistics detached.

    Each rank takes its per-channel mean and biased variance (in f32, f64
    for f64 x) and its count of values; one all-reduce of a zero-filled
    (ranks, 2C + 1) table, each rank filling its own row, gives every rank
    all of them, and the global statistics are the exact combination
        mean = sum_r n_r m_r / n,  var = sum_r n_r (v_r + (m_r - mean)^2) / n
    (the global mean and biased variance that flax's BatchNorm takes under
    pmean; its E[x^2] - E[x]^2 loses f32 digits to cancellation where
    |mean| >> std, and moved a 65x65 two-step f32 loss by 2.4% on an H100).
    Then (x - mean) * (weight * rsqrt(var + eps)) + bias.  The all-reduce
    is differentiable, so the backward sums the statistics' gradients over
    the ranks too.  (nn.SyncBatchNorm takes CUDA tensors only, and keeps
    the unbiased running variance.)  A rank without values (no rows of
    a spatially sharded level) adds count 0 and zero statistics, not the
    NaN of an empty var_mean."""
    c = x.shape[1]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if x.numel():
        var_r, mean_r = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
    else:
        var_r = mean_r = xf.sum(dim=(0, 2, 3))
    count = torch.full((1,), x.numel() // c, dtype=xf.dtype, device=x.device)
    rank, ranks = dist.get_rank(), dist.get_world_size()
    row = torch.cat([mean_r, var_r, count])[None]
    table = torch.cat([row.new_zeros((rank, 2 * c + 1)), row,
                       row.new_zeros((ranks - rank - 1, 2 * c + 1))])
    table = all_reduce_autograd(table)
    means, variances, counts = table[:, :c], table[:, c:2 * c], table[:, 2 * c:]
    n = counts.sum()
    mean = (counts * means).sum(0) / n
    var = (counts * (variances + (means - mean).square())).sum(0) / n
    scale = weight * torch.rsqrt(var + eps)
    out = (xf - mean[None, :, None, None]) * scale[None, :, None, None] + bias[None, :, None, None]
    return out.to(x.dtype), mean.detach(), var.detach()


class Dropout(nn.Module):
    """flax's nn.Dropout: in train mode keep each value with probability
    1 - rate and scale the kept ones by 1 / (1 - rate).  The uniform draws
    come from `generator` (set_dropout_generator), which train mode
    requires; eval mode is the identity.  As rank r of `shard` (rank,
    ranks) it draws the mask of the global batch (ranks times its rows)
    and keeps its own rows, so N ranks draw one rank's masks; under
    spatial sharding the mask is the level's whole H too, of which it
    keeps this rank's rows."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None
        self.shard = (0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        level = spatial.level_rows("dropout", x.shape[2])
        if x.is_meta:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode draws from a generator: call "
                               "set_dropout_generator(model, generator) first")
        rank, ranks = self.shard
        if ranks == 1 and level is None:
            u = torch.empty_like(x, dtype=torch.float32)
        else:  # rows are outermost in both memory formats: a slice of rows
            b, c, _, w = x.shape
            height = x.shape[2] if level is None else level[0]
            channels_last = x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last)
            u = torch.empty((b * ranks, c, height, w), dtype=torch.float32, device=x.device,
                            memory_format=torch.channels_last if channels_last
                            else torch.contiguous_format)
        u = u.uniform_(generator=self.generator)
        if ranks > 1:
            u = u[rank * x.shape[0]:(rank + 1) * x.shape[0]]
        if level is not None:
            u = u[:, :, level[1]:level[2]]
        keep = 1.0 - self.rate
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(model: nn.Module, generator, shard=(0, 1)) -> None:
    """Point every Dropout of `model` at `generator` (or None), drawing as
    rank `shard[0]` of `shard[1]`."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator = generator
            module.shard = shard


class ConvBN(nn.Module):
    """conv -> BN -> optional ReLU, the workhorse block."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        dilation: int = 1,
        relu: bool = True,
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.conv = Conv(
            in_channels, features, kernel_size, stride, padding, dilation, dtype=dtype
        )
        self.bn = BatchNorm(features, bn_momentum, bn_epsilon)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), relu=self.relu)


def stem_conv(in_channels: int = 3, features: int = 64, dtype=torch.float32) -> Conv:
    """7x7/2 pad-3 stem conv (zs3_tpu's StemConv with s2d=False)."""
    return Conv(in_channels, features, 7, stride=2, padding=3, dtype=dtype)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1) (under spatial
    sharding, on the fetched window of rows, -inf outside the image)."""
    return spatial.windowed(
        "pool", x, 3, 2, 1, 1,
        lambda rows, pad_h: F.max_pool2d(rows, kernel_size=3, stride=2, padding=(pad_h, 1)),
        pad=float("-inf"))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC11 global average pool (AdaptiveAvgPool2d(1)); under
    spatial sharding, over the whole level's rows."""
    return spatial.mean_hw(x)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)
