"""Train-mode BatchNorm's kernels (csrc/batch_norm_train.cu, through
zs3_tpu_torch/ops/bn_kernels.py) on the card: against their plain version
at the cells' BN widths, determinism, layouts, refusals, the counters,
and every BN of a train step of each cell's model.  Every test carries
the `card` marker and skips without a CUDA card.  On the card:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_bn_card.py -m card

(--noconftest: tests/conftest.py sets up JAX, which these tests do not
use; this file imports neither JAX nor the other test modules.)
"""

import math

import pytest
import torch

from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.ops.bn_kernels import (
    acc_dtype,
    batch_norm_train,
    batch_norm_train_reference,
)

EPS = 1e-5
MOMENTUM = 0.1  # torch's momentum: flax's 0.9
# The widths of every BN in the two cells' trunks and heads.
CELL_WIDTHS = (32, 48, 64, 128, 256, 512, 728, 1024, 1536, 2048)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_case(shape, dtype, relu, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    n, c = shape[0], shape[1]
    centre = torch.randn((1, c, 1, 1), device=device, generator=gen) * 2.0
    spread = torch.rand((1, c, 1, 1), device=device, generator=gen) * 3.0 + 0.1
    x = (torch.randn(shape, device=device, generator=gen) * spread + centre).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(shape, device=device, generator=gen).to(dtype)
    dy = dy.contiguous(memory_format=torch.channels_last)
    acc = acc_dtype(dtype)
    w = (torch.randn(c, device=device, generator=gen) * 0.5 + 1.0).to(acc)
    b = (torch.randn(c, device=device, generator=gen) * 0.5).to(acc)
    running = (torch.randn(c, device=device, generator=gen).to(acc),
               (torch.rand(c, device=device, generator=gen) + 0.5).to(acc),
               torch.zeros((), dtype=torch.long, device=device))
    return x, dy, w, b, running


def run_route(route, x, dy, w, b, running, relu, update_stats=True):
    """(y, dx, dw, db, running after) of one forward and backward."""
    xa, wa, ba = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    stats = tuple(t.clone() for t in running)
    y = route(xa, wa, ba, *stats, EPS, MOMENTUM, relu, update_stats)
    y.backward(dy)
    return y.detach(), xa.grad, wa.grad, ba.grad, stats


def card_shapes():
    """(N, C, H, W) at the cells' widths: every C at 33x33, the narrower at
    129x129 and 257x257 (the row counts of layer1, the stem and the
    decoder)."""
    out = [(48, c, 33, 33) for c in CELL_WIDTHS]
    out += [(48, c, 129, 129) for c in (48, 64, 128, 256)]
    out += [(48, c, 257, 257) for c in (32, 64)]
    return out


def ulp(t, dtype):
    """One unit in the last place of |t| in dtype (f32 values)."""
    bits = 8 if dtype == torch.bfloat16 else 24
    return torch.ldexp(torch.ones_like(t), torch.frexp(t.abs().clamp(min=1e-30))[1] - bits)


@pytest.mark.card
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", card_shapes(), ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_the_plain_version_on_the_card(card, shape, dtype, relu):
    """Tolerances: y within half an ulp of dtype of a float64 BN of the
    same input, plus 2^-21 of the channel's scale |a|*(|mean| +
    max|x - mean|) + |b| (f32 statistics and the affine form x*a + c:
    a few f32 roundings of its largest intermediate), and within an ulp
    plus 2^-19 of that scale of the plain version's (whose f32 statistics
    err up to ~6 f32 epsilons of the scale where |mean| >> std); where the
    two y differ
    in sign near 0 the ReLU masks differ, so dx is compared where both
    masks agree, the elements that disagree are at most 1e-6 of all, and
    the gradients may differ by what those elements add to their sums;
    dx within 2 ulps plus 1e-4 of max |dx| (f32 sums over N*H*W in another
    order, and the means they subtract); the weight's and bias's
    gradients within 1e-4 of max |g| plus 1e-3 relative; the running
    statistics within 1e-5 relative (f32 sums over N*H*W) and
    num_batches_tracked exact."""
    x, dy, w, b, running = card_case(shape, dtype, relu, card)
    launches = batch_norm_train.launches
    got = run_route(batch_norm_train, x, dy, w, b, running, relu)
    assert batch_norm_train.launches == launches + 1
    want = run_route(batch_norm_train_reference, x, dy, w, b, running, relu)
    torch.cuda.synchronize()
    y, yp = got[0].float(), want[0].float()
    assert y.dtype == yp.dtype and got[0].dtype == dtype
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    var, mean = torch.var_mean(x.double(), dim=(0, 2, 3), correction=0, keepdim=True)
    a = w.double()[None, :, None, None] * torch.rsqrt(var + EPS)
    shift = b.double()[None, :, None, None]
    y64 = (x.double() - mean) * a + shift
    if relu:
        y64 = y64.clamp(min=0)
    scale = a.abs() * (mean.abs() + (x.double() - mean).abs().amax((0, 2, 3), keepdim=True)) \
        + shift.abs()
    assert ((y.double() - y64).abs()
            <= ulp(y64.float(), dtype).double() / 2 + 2.0**-21 * scale).all()
    assert ((y - yp).abs().double() <= ulp(yp, dtype).double() + 2.0**-19 * scale).all()
    agree = (y > 0) == (yp > 0) if relu else torch.ones_like(y, dtype=torch.bool)
    assert (~agree).sum() <= 1e-6 * y.numel()
    dx, dxp = got[1].float(), want[1].float()
    err = (dx - dxp).abs()[agree]
    assert (err <= 2 * ulp(dxp[agree], dtype) + 1e-4 * dxp.abs().max()).all()
    # An element whose masks disagree moves sum(dz) by its dy and
    # sum(dz * xhat) by dy * xhat: the gradients differ by that much more.
    var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0, keepdim=True)
    xhat = (x.float() - mean) * torch.rsqrt(var + EPS)
    flipped = (~agree).float() * dy.float().abs()
    slack = ((flipped * xhat.abs()).sum((0, 2, 3)), flipped.sum((0, 2, 3)))
    for g, gp, extra in ((got[2], want[2], slack[0]), (got[3], want[3], slack[1])):
        assert ((g - gp).abs() <= 1e-4 * gp.abs().max() + 1e-3 * gp.abs() + 1.01 * extra).all()
    for s, sp in zip(got[4][:2], want[4][:2]):
        torch.testing.assert_close(s, sp, rtol=1e-5, atol=1e-6)
    assert int(got[4][2]) == int(want[4][2]) == 1


@pytest.mark.card
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(48, c, 33, 33) for c in CELL_WIDTHS] + [(48, 64, 129, 129)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_the_plain_version_in_float64_on_the_card(card, shape, relu):
    """f64 x accumulates in f64 (the step chip_smoke holds to the CPU's to
    1e-10 runs through it).  Tolerances: y within 2^-36 of the channel's
    scale of a float64 BN computed apart (sums over up to 2^20 rows: at
    most 2^20 f64 epsilons, 2^-33, in the worst order, a few hundred in
    fact; an f32 accumulation would miss by 2^-24), and of the plain
    version's; the ReLU masks agree but where the two y straddle 0; dx
    within 1e-10 of max |dx|, the weight's and bias's gradients within
    1e-10 of max |g| plus what disagreeing masks add, the running
    statistics within 1e-12 relative, num_batches_tracked exact."""
    x, dy, w, b, running = card_case(shape, torch.float64, relu, card)
    got = run_route(batch_norm_train, x, dy, w, b, running, relu)
    want = run_route(batch_norm_train_reference, x, dy, w, b, running, relu)
    torch.cuda.synchronize()
    y, yp = got[0], want[0]
    assert y.dtype == torch.float64 and y.is_contiguous(memory_format=torch.channels_last)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0, keepdim=True)
    a = w[None, :, None, None] * torch.rsqrt(var + EPS)
    shift = b[None, :, None, None]
    y64 = (x - mean) * a + shift
    if relu:
        y64 = y64.clamp(min=0)
    scale = a.abs() * (mean.abs() + (x - mean).abs().amax((0, 2, 3), keepdim=True)) + shift.abs()
    assert ((y - y64).abs() <= 2.0**-36 * scale).all()
    assert ((y - yp).abs() <= 2.0**-36 * scale).all()
    agree = (y > 0) == (yp > 0) if relu else torch.ones_like(y, dtype=torch.bool)
    assert (~agree).sum() <= 1e-6 * y.numel()
    assert ((got[1] - want[1]).abs()[agree] <= 1e-10 * want[1].abs().max()).all()
    xhat = (x - mean) * torch.rsqrt(var + EPS)
    flipped = (~agree).double() * dy.abs()
    slack = ((flipped * xhat.abs()).sum((0, 2, 3)), flipped.sum((0, 2, 3)))
    for g, gp, extra in ((got[2], want[2], slack[0]), (got[3], want[3], slack[1])):
        assert ((g - gp).abs() <= 1e-10 * gp.abs().max() + 1.01 * extra).all()
    for s, sp in zip(got[4][:2], want[4][:2]):
        torch.testing.assert_close(s, sp, rtol=1e-12, atol=1e-14)
    assert int(got[4][2]) == int(want[4][2]) == 1


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_kernels_are_deterministic_and_take_any_layout_on_the_card(card, dtype):
    """Two calls give the same bits (no float atomics; the slabs merge in
    a fixed order); a contiguous NCHW input gives the channels_last
    input's result; update_stats False holds the running statistics."""
    x, dy, w, b, running = card_case((32, 728, 33, 33), dtype, True, card, seed=3)
    first = run_route(batch_norm_train, x, dy, w, b, running, True)
    second = run_route(batch_norm_train, x, dy, w, b, running, True)
    nchw = run_route(batch_norm_train, x.contiguous(), dy.contiguous(), w, b, running, True)
    for a, b2, c in zip(first[:4], second[:4], nchw[:4]):
        assert torch.equal(a, b2) and torch.equal(a, c)
    for a, b2 in zip(first[4], second[4]):
        assert torch.equal(a, b2)
    held = run_route(batch_norm_train, x, dy, w, b, running, True, update_stats=False)
    for a, b2 in zip(held[4], running):
        assert torch.equal(a, b2)
    assert torch.equal(held[0], first[0])


@pytest.mark.card
def test_kernels_refuse_other_dtypes_and_count_fusions_on_the_card(card):
    x, dy, w, b, running = card_case((4, 64, 9, 9), torch.bfloat16, True, card)
    with pytest.raises(TypeError, match="float32, bfloat16 or float64"):
        batch_norm_train(x.half(), w, b, *running, EPS, MOMENTUM, True)
    with pytest.raises(ValueError, match="torch.float64 contiguous per-channel"):
        batch_norm_train(x.double(), w, b, *running, EPS, MOMENTUM, True)
    launches, fused = batch_norm_train.launches, batch_norm_train.relu_fused
    batch_norm_train(x, w, b, *running, EPS, MOMENTUM, True)
    batch_norm_train(x, w, b, *running, EPS, MOMENTUM, False)
    assert batch_norm_train.launches == launches + 2
    assert batch_norm_train.relu_fused == fused + 1


@pytest.mark.card
@pytest.mark.parametrize("backbone, calls, fused", [("resnet101", 113, 76),
                                                    ("xception", 141, 54)])
def test_every_bn_of_a_card_step_takes_the_kernels(card, backbone, calls, fused):
    """One bf16 train step of each cell's model: every BN takes the kernels
    and none reaches torch.native_batch_norm."""
    model = DeepLab(backbone, num_classes=21, dropout=False, dtype=torch.bfloat16)
    model = model.to(card).to(memory_format=torch.channels_last).train()
    x = torch.randn((2, 65, 65, 3), device=card)
    launches, relu_fused = batch_norm_train.launches, batch_norm_train.relu_fused
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(x).float().square().mean().backward()
    torch.cuda.synchronize()
    assert batch_norm_train.launches - launches == calls
    assert batch_norm_train.relu_fused - relu_fused == fused
    assert not [e.name for e in prof.events() if "batch_norm" in e.name]
    assert math.isfinite(float(sum(p.grad.float().sum() for p in model.parameters())))
