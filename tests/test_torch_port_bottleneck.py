"""K5 in the port: the plain fused bottleneck of zs3_tpu_torch.ops.bottleneck
against zs3_tpu's Pallas kernel (interpret mode) and its oracle, BN
folding, and the kernel wrapper's refusal of CPU tensors.

Inputs and weights come from a numpy seed and go to both packages as the
same arrays (zs3_tpu's layouts: x NHWC, w1 (C, P), w2 (3, 3, P, P) HWIO,
w3 (P, C)).  f32 results agree within the JAX test's atol 1e-5; bf16
within 2 bf16 ulps of the largest output (the f32 sums run in another
order, which can move a rounding of y1 or y2 by one ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs3_tpu.ops import pallas_bottleneck as jax_k5
from zs3_tpu_torch.models.resnet import Bottleneck
from zs3_tpu_torch.ops import bottleneck, bottleneck_kernels

SHAPES = [(2, 12, 10, 32, 16, 1), (1, 12, 10, 32, 16, 2), (2, 9, 11, 16, 8, 1),
          (1, 33, 33, 64, 32, 4)]


def _block(rng, c, p):
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return (mk(c, p), mk(p), mk(3, 3, p, p), mk(p), mk(p, c), mk(c))


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_fused_bottleneck_matches_pallas_and_oracle(shape, rng):
    b, h, w, c, p, d = shape
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    blk = _block(rng, c, p)
    want = np.asarray(jax_k5.fused_bottleneck(
        jnp.asarray(x), *map(jnp.asarray, blk), dilation=d, interpret=True))
    oracle = np.asarray(jax_k5.bottleneck_oracle(jnp.asarray(x), *map(jnp.asarray, blk),
                                                 dilation=d))
    got = bottleneck.fused_bottleneck(torch.from_numpy(x), *_torch(blk), dilation=d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5)
    port_oracle = bottleneck.bottleneck_oracle(torch.from_numpy(x), *_torch(blk), dilation=d)
    np.testing.assert_allclose(port_oracle.numpy(), oracle, atol=1e-5)


def test_plain_fused_stage_chains_blocks(rng):
    b, h, w, c, p = 2, 13, 11, 32, 16
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    dils = [1, 2, 1]
    blocks = [_block(rng, c, p) for _ in dils]
    want = np.asarray(jax_k5.fused_stage(
        jnp.asarray(x), [tuple(map(jnp.asarray, blk)) for blk in blocks], dils,
        interpret=True))
    got = bottleneck.fused_stage(torch.from_numpy(x), [_torch(blk) for blk in blocks], dils)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # The dispatcher takes the plain version for a CPU tensor.
    via = bottleneck_kernels.fused_stage(torch.from_numpy(x), [_torch(blk) for blk in blocks],
                                         dils)
    np.testing.assert_array_equal(via.numpy(), got.numpy())
    assert bottleneck_kernels.fused_bottleneck.launches == 0


def test_plain_fused_bottleneck_bf16_matches_oracle(rng):
    b, h, w, c, p, d = 1, 12, 10, 32, 16, 2
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    blk = _block(rng, c, p)
    w1, b1, w2, b2, w3, b3 = blk
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jax_k5.bottleneck_oracle(
        bf(x), bf(w1), jnp.asarray(b1), bf(w2), jnp.asarray(b2), bf(w3), jnp.asarray(b3),
        dilation=d,
    ).astype(jnp.float32))
    got = bottleneck.fused_bottleneck(torch.from_numpy(x).bfloat16(), *_torch(blk), dilation=d)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * 2.0**-8 * scale)


def test_fold_bn_is_exact(rng):
    """conv + eval BN == conv with folded weights, and the port's folding
    equals zs3_tpu's."""
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 4, 6)) * 0.2).astype(np.float32)
    scale = (rng.standard_normal(6) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(6) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(6) * 0.1).astype(np.float32)
    var = (rng.random(6) + 0.5).astype(np.float32)
    kf, bf = bottleneck.fold_bn(*_torch([k, scale, bias, mean, var]), 1e-5)
    jk, jb = jax_k5.fold_bn(*map(jnp.asarray, (k, scale, bias, mean, var)), 1e-5)
    np.testing.assert_allclose(kf.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)
    conv = lambda x, k: torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    ref = (conv(x, torch.from_numpy(k)) - torch.from_numpy(mean)[:, None, None]) / torch.sqrt(
        torch.from_numpy(var)[:, None, None] + 1e-5) * torch.from_numpy(scale)[:, None, None] \
        + torch.from_numpy(bias)[:, None, None]
    np.testing.assert_allclose((conv(x, kf) + bf[:, None, None]).numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 2])
def test_fold_bottleneck_matches_the_model_block(dilation, rng):
    """The plain fused block on a Bottleneck's folded weights equals the
    block itself in eval mode (the anchor of zs3_tpu's
    test_oracle_matches_model_bottleneck)."""
    planes = 4
    block = Bottleneck(planes * 4, planes, dilation=dilation).eval()
    gen = np.random.default_rng(1)
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.conv3):
            conv.weight.copy_(torch.from_numpy(
                (gen.standard_normal(conv.weight.shape) * 0.3).astype(np.float32)))
        for bn in (block.bn1, block.bn2, block.bn3):
            n = bn.weight.shape[0]
            bn.weight.copy_(torch.from_numpy(gen.uniform(0.5, 1.5, n).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(gen.standard_normal(n).astype(np.float32)))
            bn.running_mean.copy_(torch.from_numpy((0.1 * gen.standard_normal(n)).astype(
                np.float32)))
            bn.running_var.copy_(torch.from_numpy(gen.uniform(0.5, 1.5, n).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, planes * 4)).astype(np.float32))
    with torch.no_grad():
        ref = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = bottleneck.fused_bottleneck(x, *bottleneck.fold_bottleneck(block),
                                          dilation=dilation)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)


def test_kernel_refuses_cpu_tensors(rng):
    x = torch.from_numpy(rng.standard_normal((1, 9, 11, 16)).astype(np.float32))
    blk = _torch(_block(rng, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        bottleneck_kernels.fused_bottleneck(x, *blk, dilation=1)
    assert bottleneck_kernels.fused_bottleneck.launches == 0
