"""The split-attention kernels (csrc/split_attention.cu, through
zs3_tpu_torch/ops/splat_kernels.py) on the card: each against its plain
version at the cell's stage shapes and at a ragged one, in bf16, f32 and
f64, forward and backward; determinism; the autograd path against the
CPU's; the counter; the BN kernels on the two shapes ResNeSt brings them
(the gate's (N, C/2, 1, 1) and the 2C channels after the grouped conv);
and a ResNeSt train step on the card against the CPU's in f64.  Every
test carries the `card` marker and skips without a CUDA card.  On the
card:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_splat_card.py -m card

(--noconftest: tests/conftest.py sets up JAX, which these tests do not
use; this file imports neither JAX nor the other test modules.)
"""

import copy

import pytest
import torch

from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.models.resnest import SplitAttentionConv
from zs3_tpu_torch.ops import bn_kernels, splat_kernels
from zs3_tpu_torch.ops.splat_kernels import (
    bwd_reduce_reference,
    combine_reference,
    dx_reference,
    gap_reference,
    split_attention,
)

# u as (N, H, W, 2C): the cell's stage-3 and stage-4 tensors, and a grid
# whose pixels fill no whole tile of rows, with 2C a single channel block.
SHAPES = ((24, 64, 64, 512), (24, 64, 64, 1024), (3, 13, 11, 128))
DTYPES = (torch.bfloat16, torch.float32, torch.float64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def case(shape, dtype, device, seed=0):
    """u (after a ReLU: >= 0), the gate's logits z, dy and dg."""
    n, h, w, c2 = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    acc = bn_kernels.acc_dtype(dtype)
    u = torch.randn((n, c2, h, w), device=device, generator=gen).abs().to(dtype)
    u = u.contiguous(memory_format=torch.channels_last)
    z = (torch.randn((n, c2), device=device, generator=gen) * 2).to(acc)
    dy = torch.randn((n, c2 // 2, h, w), device=device, generator=gen).to(dtype)
    dy = dy.contiguous(memory_format=torch.channels_last)
    dg = torch.randn((n, c2 // 2), device=device, generator=gen).to(acc)
    return u, z, dy, dg


def kernels(u, z, dy, dg):
    """g, (out, a), dz and du from the four kernels, one launch each."""
    n, c2, h, w = u.shape
    acc = bn_kernels.acc_dtype(u.dtype)
    g = u.new_empty((n, c2 // 2), dtype=acc)
    splat_kernels._launch("zs3_splat_gap", u, (u.data_ptr(), g.data_ptr()), reduces=True)
    out = torch.empty_like(dy)
    a = u.new_empty((n, c2), dtype=acc)
    splat_kernels._launch("zs3_splat_combine", u,
                          (u.data_ptr(), z.data_ptr(), out.data_ptr(), a.data_ptr()),
                          reduces=False)
    dz = u.new_empty((n, c2), dtype=acc)
    splat_kernels._launch("zs3_splat_bwd_reduce", u,
                          (dy.data_ptr(), u.data_ptr(), a.data_ptr(), dz.data_ptr()),
                          reduces=True)
    du = torch.empty_like(u)
    splat_kernels._launch("zs3_splat_dx", u,
                          (dy.data_ptr(), a.data_ptr(), dg.data_ptr(), du.data_ptr()),
                          reduces=False)
    return g, out, a, dz, du


def plain(u, dy, dg, a):
    """The plain versions of g, out, dz and du, on the kernels' own
    softmax weights a (out as combine_reference forms it from them)."""
    n, c2 = u.shape[:2]
    acc = bn_kernels.acc_dtype(u.dtype)
    w = a.reshape(n, 2, c2 // 2, 1, 1)
    out = (w[:, 0] * u[:, :c2 // 2].to(acc) + w[:, 1] * u[:, c2 // 2:].to(acc)).to(u.dtype)
    return gap_reference(u), out, bwd_reduce_reference(dy, u, a), dx_reference(dy, a, dg)


def ulp_of(t, dtype):
    """One unit in the last place of dtype at each |t| (float64 values)."""
    bits = {torch.bfloat16: 8, torch.float32: 24, torch.float64: 53}[dtype]
    return torch.ldexp(torch.ones_like(t), torch.frexp(t.abs().clamp(min=1e-300))[1] - bits)


def close(got, want, dtype, what, rel_max, ulps=1, scale=None):
    """|got - want| within `ulps` units of the output dtype's last place of
    `scale` (|want| by default) plus `rel_max` of max |want| (sums in
    another order)."""
    got, want = got.double(), want.double()
    ulp = ulp_of(want if scale is None else scale.double(), dtype)
    err = (got - want).abs() - ulps * ulp - rel_max * want.abs().max()
    assert float(err.max()) <= 0, (what, float((got - want).abs().max()),
                                   float(want.abs().max()))


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_each_kernel_matches_its_plain_version(card, shape, dtype):
    """Tolerances: g and dz, sums over the pixels kept in the accumulation
    type, within an ulp of it plus 1e-5 of the largest value in f32 and
    1e-12 in f64 (sums in another order); out and du within 2 ulps of their terms' magnitude (|a_0 u_0|
    + |a_1 u_1|, |a_r dy| + |dg / HW|: the kernel forms each with one fused
    multiply-add and dg * (1 / HW), the plain version rounds the products,
    the quotient and the sum); a (f32 or f64 softmax weights) within an
    ulp plus 3 epsilons of the accumulation type of torch's softmax.  The
    plain versions of out, dz and du take the kernels' own a, so each
    kernel is held alone."""
    u, z, dy, dg = case(shape, dtype, card)
    got = kernels(u, z, dy, dg)
    g, out, a, dz, du = got
    want = plain(u, dy, dg, a)
    again = kernels(u, z, dy, dg)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again)), "two calls differ"
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    acc = bn_kernels.acc_dtype(dtype)
    close(g, want[0], acc, "g", rel)
    close(out, want[1], dtype, "out", 0.0, ulps=2)
    close(a, combine_reference(u, z)[1], acc, "a", 3 * torch.finfo(acc).eps)
    close(dz, want[2], acc, "dz", rel)
    n, c2, h, w = u.shape
    terms = (a.double().reshape(n, 2, c2 // 2, 1, 1) * dy.double()[:, None]).abs() \
        + (dg.double() / (h * w)).abs().reshape(n, 1, c2 // 2, 1, 1)
    close(du, want[3], dtype, "du", 0.0, ulps=2, scale=terms.reshape(n, c2, h, w))
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert du.is_contiguous(memory_format=torch.channels_last)


@pytest.fixture
def no_tf32():
    """f32 convolutions in full f32 on the card (cuDNN takes TF32 by
    default), as on the CPU."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.card
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 2e-4), (torch.float64, 1e-10)], ids=str)
def test_split_attention_on_the_card_matches_the_cpu(card, no_tf32, dtype, rel):
    """The whole autograd path (the kernels, the gate between them with
    its BN kernels, du written whole by the mean's backward) against the
    CPU's plain path on the same gate: out within `rel` of max |out|, du
    and the gate's gradients within `rel` of the largest of them.  Sums in
    other orders; the gate's BN over the batch's 8 values a channel takes
    out most of the gradient that reaches fc1, so f32 leaves fc1's weight
    gradient 9.1e-5 of the largest apart (measured), held to 2e-4; fc1's
    bias has a gradient of 0 but for rounding."""
    c = 128
    conv = SplitAttentionConv(c, 1, dtype=dtype).to(dtype)
    conv.train()
    twin = copy.deepcopy(conv).to(card)
    u, _, dy, _ = case((8, 17, 19, 2 * c), dtype, card)
    launches = split_attention.launches
    results = []
    for module, device in ((conv, "cpu"), (twin, card)):
        x = u.to(device).detach().requires_grad_(True)
        out = split_attention(x, module.gate)
        gate = [module.fc1.weight, module.fc1.bias, module.bn1.weight, module.bn1.bias,
                module.fc2.weight, module.fc2.bias]
        grads = torch.autograd.grad(out, [x, *gate], dy.to(device))
        results.append([out.cpu().double(), *(g.cpu().double() for g in grads)])
    assert split_attention.launches == launches + 1
    (out, *grads), (want_out, *want) = results[1], results[0]
    assert float((out - want_out).abs().max()) <= rel * float(want_out.abs().max())
    scale = max(float(w.abs().max()) for w in want)
    errs = [float((g - w).abs().max()) for g, w in zip(grads, want)]
    assert max(errs) <= rel * scale, (errs, scale)


@pytest.mark.card
def test_split_attention_refuses_on_the_card(card):
    gate = lambda g: torch.cat([g, g], 1)  # noqa: E731
    with pytest.raises(TypeError):
        split_attention(torch.zeros((2, 64, 4, 4), device=card, dtype=torch.float16), gate)
    with pytest.raises(ValueError):  # C = 4 bf16 values: not 16 bytes
        split_attention(torch.zeros((2, 8, 4, 4), device=card, dtype=torch.bfloat16), gate)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(24, 32, 1, 1), (24, 128, 1, 1), (24, 256, 1, 1),
                                   (24, 512, 64, 64), (24, 1024, 64, 64)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_the_bn_kernels_on_resnest_s_shapes(card, shape, dtype):
    """The gate's BN (N, C/2, 1, 1), ReLU fused, and the grouped conv's
    2C-channel BN, ReLU fused, against the BN's plain version: y and dx
    within an ulp plus 1e-4 of their largest value (f32 statistics summed
    in another order; dx where the two ReLU masks agree), the parameters'
    gradients within 1e-4 of theirs plus 1e-3 relative, plus what the
    elements whose masks differ add to their sums."""
    gen = torch.Generator(device=card).manual_seed(5)
    c = shape[1]
    x = (torch.randn(shape, device=card, generator=gen) * 2 + 1).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(shape, device=card, generator=gen).to(dtype)
    w = torch.rand(c, device=card, generator=gen) + 0.5
    b = torch.randn(c, device=card, generator=gen) * 0.3
    outs = []
    for route in (bn_kernels.batch_norm_train, bn_kernels.batch_norm_train_reference):
        xa, wa, ba = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
        running = (torch.zeros(c, device=card), torch.ones(c, device=card),
                   torch.zeros((), dtype=torch.long, device=card))
        y = route(xa, wa, ba, *running, 1e-5, 0.1, True, True)
        outs.append((y, *torch.autograd.grad(y, (xa, wa, ba), dy), *running))
    got, want = outs
    # y within an ulp plus 1e-4 of max |y|: an element whose ReLU masks
    # differ is one the two put either side of 0 within that.
    close(got[0], want[0], dtype, "y", 1e-4)
    agree = (got[0] > 0) == (want[0] > 0)
    dx, dxp = got[1].float()[agree], want[1].float()[agree]
    assert float((dx - dxp).abs().max()) <= 2**-7 * float(dxp.abs().max()) + 1e-4
    # Where the masks differ, dz is dy on one side and 0 on the other: the
    # sums differ by those elements' |dy| (and |dy * xhat|) more.
    var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0, keepdim=True)
    xhat = (x.float() - mean) * torch.rsqrt(var + 1e-5)
    flipped = (~agree).float() * dy.float().abs()
    slack = ((flipped * xhat.abs()).sum((0, 2, 3)), flipped.sum((0, 2, 3)))
    for g, gp, extra in zip(got[2:4], want[2:4], slack):
        assert ((g - gp).abs() <= 1e-4 * gp.abs().max() + 1e-3 * gp.abs() + 1.01 * extra
                + 1e-5).all()
    torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=1e-6)


@pytest.mark.card
def test_a_resnest_train_step_on_the_card_matches_the_cpu_in_float64(card, no_tf32):
    """One block a stage, f64, 65x65, batch 4: the card's step (split
    attention and BN kernels in f64, cuDNN convs) against the CPU's plain
    path.  The loss within 1e-10 relative, every gradient within 1e-7 of
    max |g| (f64 sums in other orders through train-mode BN)."""
    gen = torch.Generator().manual_seed(3)
    model = DeepLab("resnest101", 8, 21, layers=(1, 1, 1, 1), dropout=False,
                    dtype=torch.float64).double()
    image = torch.randn((4, 65, 65, 3), generator=gen, dtype=torch.float64)
    label = torch.randint(0, 21, (4, 65, 65), generator=gen)
    results = []
    for device in ("cpu", card):
        m = copy.deepcopy(model).to(device).to(memory_format=torch.channels_last).train()
        logits = m(image.to(device))
        loss = torch.nn.functional.cross_entropy(logits.permute(0, 3, 1, 2), label.to(device))
        grads = torch.autograd.grad(loss, list(m.parameters()))
        results.append((float(loss), [g.cpu() for g in grads]))
    (l0, g0), (l1, g1) = results
    assert abs(l1 - l0) <= 1e-10 * abs(l0)
    scale = max(float(g.abs().max()) for g in g0)
    names = [n for n, _ in model.named_parameters()]
    errs = sorted(((float((a - b).abs().max()), n) for n, a, b in zip(names, g1, g0)),
                  reverse=True)
    assert errs[0][0] <= 1e-7 * scale, (errs[:6], scale)


@pytest.mark.card
def test_33_launches_a_forward_and_none_on_other_trunks(card):
    """Full-depth ResNeSt-101: one split attention a block, 33 a forward,
    in train and eval mode; ResNet-101 and Xception-65 take none."""
    for backbone, want in (("resnest101", 33), ("resnet101", 0), ("xception", 0)):
        model = DeepLab(backbone, 8 if backbone == "resnest101" else 16, 21, dropout=False,
                        dtype=torch.bfloat16).to(card).to(memory_format=torch.channels_last)
        x = torch.randn((2, 65, 65, 3), device=card)
        for train in (True, False):
            model.train(train)
            before = split_attention.launches
            with torch.no_grad():
                model(x)
            assert split_attention.launches - before == want, (backbone, train)


@pytest.mark.card
@pytest.mark.parametrize("hw", [16, 17, 128])
def test_the_block_s_average_pool_matches_the_cpu(card, hw):
    """models/resnest.py's avg_pool_3x3 on a channels_last tensor, f64:
    forward and backward as the CPU's to rounding (torch's own CUDA
    channels_last backward of this pool is 0.79-0.94 off here)."""
    from zs3_tpu_torch.models.resnest import avg_pool_3x3

    gen = torch.Generator().manual_seed(hw)
    x = torch.randn((2, 64, hw, hw), generator=gen, dtype=torch.float64)
    x = x.contiguous(memory_format=torch.channels_last)
    results = []
    for device in ("cpu", card):
        xa = x.to(device).requires_grad_(True)
        y = avg_pool_3x3(xa, 2)
        gy = torch.sin(torch.arange(y.numel(), dtype=y.dtype, device=device)).reshape(y.shape)
        (dx,) = torch.autograd.grad(y, xa, gy)
        assert y.is_contiguous(memory_format=torch.channels_last)
        results.append((y.detach().cpu(), dx.cpu()))
    for got, want in zip(results[1], results[0]):
        assert float((got - want).abs().max()) <= 1e-14


@pytest.mark.card
@pytest.mark.parametrize("cin,d", [(256, 2), (512, 4)])
def test_the_grouped_conv_runs_on_one_stream(card, cin, d):
    """SplAt's 2-group 3x3 (models/layers.py's Conv) on the card: every
    kernel of its forward and backward on the current stream (cuDNN's own
    grouped conv puts each group on a stream of its own), and the values
    and gradients of F.conv2d's grouped conv in f32 without TF32."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zs3_tpu_torch.models.layers import Conv

    conv = Conv(cin, 2 * cin, 3, padding=d, dilation=d, groups=2).to(card)
    gen = torch.Generator(device=card).manual_seed(cin)
    x = torch.randn((4, cin, 32, 32), device=card, generator=gen)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    dy = torch.randn((4, 2 * cin, 32, 32), device=card, generator=gen)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv(x).backward(dy)  # warm-up: cuDNN's plans
        x.grad = conv.weight.grad = None
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y = conv(x)
            y.backward(dy)
            torch.cuda.synchronize()
        streams = {e.device_resource_id for e in prof.events() if e.device_type == DeviceType.CUDA}
        assert len(streams) == 1, streams
        xw = x.detach().clone().requires_grad_(True)
        w = conv.weight.detach().clone().requires_grad_(True)
        want = torch.nn.functional.conv2d(xw, w, None, 1, d, d, 2)
        want.backward(dy)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for got, ref in ((y, want), (x.grad, xw.grad), (conv.weight.grad, w.grad)):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
