"""Train-mode BatchNorm (zs3_tpu_torch/ops/bn_kernels.py and
csrc/batch_norm_train.cu).

On the CPU: the plain version against torch.native_batch_norm + F.relu
and a float64 BatchNorm, `plan`, the routing of models/layers.py's
BatchNorm, the counters, which BNs of R101 and Xception-65 fuse their
ReLU, their unchanged state_dict keys, and a replay in torch of the
kernels' arithmetic: the statistics merged by Chan's formula in the
kernel's order, and the forward's and backward's affine forms.

The kernels themselves are held on the card by
tests/test_torch_port_bn_card.py.
"""

import copy
import hashlib

import pytest
import torch
import torch.nn.functional as F

from zs3_tpu_torch.models import layers
from zs3_tpu_torch.models.aspp import ASPP
from zs3_tpu_torch.models.decoder import Decoder
from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.models.layers import BatchNorm
from zs3_tpu_torch.models.resnet import ResNet101
from zs3_tpu_torch.models.xception import AlignedXception
from zs3_tpu_torch.ops import bn_kernels
from zs3_tpu_torch.ops.bn_kernels import (
    CTAS_PER_SM,
    MAX_MERGE,
    THREADS,
    batch_norm_train,
    batch_norm_train_reference,
    dense,
    plan,
)
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

EPS = 1e-5
MOMENTUM = 0.1  # torch's momentum: flax's 0.9
# The widths of every BN in the two cells' trunks and heads.
CELL_WIDTHS = (32, 48, 64, 128, 256, 512, 728, 1024, 1536, 2048)
# N*H*W of the cells' BN inputs: R101 at batch 48, Xception-65 at 32.
CELL_ROWS = tuple(b * s * s for b in (48, 32) for s in (33, 65, 129, 257))


def make_input(shape, dtype, seed=0, mean=2.0, std=3.0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen, dtype=torch.float64) * std + mean
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def make_params(c, seed=1):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(c, generator=gen) * 0.5 + 1.0
    b = torch.randn(c, generator=gen) * 0.5
    stats = (torch.randn(c, generator=gen), torch.rand(c, generator=gen) + 0.5,
             torch.tensor(3, dtype=torch.long))
    return w, b, stats


def reference64(x, w, b, relu):
    """Float64 train-mode BN (+ ReLU): (out, mean, biased var)."""
    xd = x.double()
    var, mean = torch.var_mean(xd, dim=(0, 2, 3), correction=0)
    out = ((xd - mean[None, :, None, None]) * torch.rsqrt(var + EPS)[None, :, None, None]
           * w.double()[None, :, None, None] + b.double()[None, :, None, None])
    return (out.clamp(min=0.0) if relu else out), mean, var


# ---------------------------------------------------------------- the plain version


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("update_stats", [True, False])
def test_plain_version_is_native_batch_norm_then_relu(dtype, relu, update_stats):
    """Output, running statistics and the gradients of x, weight and bias
    equal torch.native_batch_norm + F.relu's with the port's running
    update, bit for bit (the same ops in the same order)."""
    x = make_input((4, 16, 7, 9), dtype)
    w, b, (rm, rv, nbt) = make_params(16)
    dy = make_input((4, 16, 7, 9), dtype, seed=5, mean=0.0, std=1.0)

    xa, wa, ba = (t.clone().requires_grad_(True) for t in (x, w, b))
    running = (rm.clone(), rv.clone(), nbt.clone())
    out = batch_norm_train_reference(xa, wa, ba, *running, EPS, MOMENTUM, relu, update_stats)
    out.backward(dy)

    xb, wb, bb = (t.clone().requires_grad_(True) for t in (x, w, b))
    want, mean, invstd = torch.native_batch_norm(xb, wb, bb, None, None, True, 0.0, EPS)
    if relu:
        want = F.relu(want)
    want.backward(dy)
    var = invstd.float().reciprocal().square() - EPS
    want_rm = rm * (1 - MOMENTUM) + MOMENTUM * mean.float() if update_stats else rm
    want_rv = (rv * (1 - MOMENTUM) + MOMENTUM * var.clamp(min=0.0)) if update_stats else rv

    assert out.dtype == dtype
    assert torch.equal(out, want)
    for got, ref in ((xa.grad, xb.grad), (wa.grad, wb.grad), (ba.grad, bb.grad)):
        assert torch.equal(got, ref)
    # mul_ then add_ with alpha against one expression: a rounding apart
    torch.testing.assert_close(running[0], want_rm, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(running[1], want_rv, rtol=1e-6, atol=1e-7)
    assert int(running[2]) == int(nbt) + int(update_stats)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_version_batch_statistics_against_float64(dtype, relu):
    """With momentum 1 the running statistics are the batch's mean and
    biased variance: within f32 rounding of a float64 var_mean of the same
    (rounded) input, the output within one rounding to `dtype` (f32 sums
    of 4*7*9 values: 1e-5 of the std; bf16: half an ulp, 2^-9 relative)."""
    x = make_input((4, 16, 7, 9), dtype)
    w, b, (rm, rv, nbt) = make_params(16)
    out = batch_norm_train_reference(x, w, b, rm, rv, nbt, EPS, 1.0, relu, True)
    want, mean, var = reference64(x, w, b, relu)
    std = var.sqrt()
    assert ((rm.double() - mean).abs() <= 1e-5 * std).all()
    assert ((rv.double() - var).abs() <= 1e-5 * var).all()
    rel = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    assert ((out.double() - want).abs() <= rel * want.abs() + 1e-5 * want.abs().max()).all()
    if relu:
        assert (out >= 0).all()


@pytest.mark.parametrize("relu", [False, True])
def test_plain_version_keeps_float64_statistics_in_float64(relu):
    """A float64 BN (a model made .double(), as the card's f64 train step
    that is held to the CPU's): the running statistics take the batch's
    mean and biased variance in f64, not rounded through f32 (1e-12
    relative, where an f32 rounding misses by up to 6e-8)."""
    x = make_input((4, 16, 7, 9), torch.float64)
    w, b, (rm, rv, nbt) = make_params(16)
    w, b, rm, rv = (t.double() for t in (w, b, rm, rv))
    out = batch_norm_train_reference(x, w, b, rm, rv, nbt, EPS, 1.0, relu, True)
    want, mean, var = reference64(x, w, b, relu)
    assert out.dtype == rm.dtype == rv.dtype == torch.float64
    assert ((rm - mean).abs() <= 1e-12 * var.sqrt()).all()
    assert ((rv - var).abs() <= 1e-12 * var).all()
    assert ((out - want).abs() <= 1e-12 * want.abs().max()).all()


# ---------------------------------------------------------------- plan


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
@pytest.mark.parametrize("channels", CELL_WIDTHS)
def test_plan_fills_the_card_at_every_cell_width(dtype, channels):
    """16-byte channel groups; at least two CTAs an SM and at most one
    wave; every channel and row covered once; no thread of the last CTA
    merges more than MAX_MERGE partials."""
    for rows in CELL_ROWS:
        p = plan(rows, channels, dtype, 132)
        assert p.vec == 16 // dtype.itemsize
        assert p.tx * p.ty == THREADS and p.tx & (p.tx - 1) == 0
        width = p.tx * p.vec
        assert (p.cblocks - 1) * width < channels <= p.cblocks * width
        assert (p.slabs - 1) * p.rows_per_slab < rows <= p.slabs * p.rows_per_slab
        assert 2 * 132 <= p.cblocks * p.slabs <= CTAS_PER_SM * 132 + p.cblocks
        assert -(-p.slabs // p.ty) <= MAX_MERGE


def test_plan_of_narrow_and_short_matrices():
    assert plan(1000, 36, torch.float32).vec == 4
    assert plan(1000, 34, torch.float64).vec == 2
    small = plan(48, 256, torch.bfloat16)  # the ASPP's pooled branch at batch 48
    assert (small.cblocks, small.slabs, small.rows_per_slab) == (4, 2, 24)


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(TypeError, match="float32, bfloat16 or float64"):
        plan(100, 64, torch.float16)
    with pytest.raises(ValueError, match="multiple of 2"):
        plan(100, 33, torch.float64)
    with pytest.raises(ValueError, match="multiple of 8"):
        plan(100, 36, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        plan(0, 64, torch.bfloat16)


def test_per_channel_values_take_the_accumulation_type():
    """bf16 and f32 x accumulate in f32 with f32 parameters and statistics,
    f64 x in f64; other per-channel types are refused before a launch."""
    assert bn_kernels.acc_dtype(torch.bfloat16) == torch.float32
    assert bn_kernels.acc_dtype(torch.float32) == torch.float32
    assert bn_kernels.acc_dtype(torch.float64) == torch.float64
    x = torch.zeros(2, 4, 3, 3, dtype=torch.float64)
    bn_kernels._check_params(x, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="torch.float64"):
        bn_kernels._check_params(x, torch.zeros(4))
    with pytest.raises(ValueError, match="torch.float32"):
        bn_kernels._check_params(x.float(), torch.zeros(4, dtype=torch.float64))


def test_dense_copies_only_what_the_kernels_cannot_read_in_place():
    """channels_last at a 16-byte aligned address: kept as it is; an NCHW
    tensor, another dtype or a view at an unaligned offset: copied."""
    x = make_input((2, 16, 3, 5), torch.bfloat16)
    assert dense(x, torch.bfloat16) is x
    pixels = x.permute(0, 2, 3, 1).reshape(-1)  # memory order
    shifted = torch.cat([pixels[:1], pixels])[1:].view(2, 3, 5, 16).permute(0, 3, 1, 2)
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    assert shifted.data_ptr() % 16
    for other in (x.contiguous(), x.float(), shifted):
        got = dense(other, torch.bfloat16)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert got.data_ptr() % 16 == 0 and got.dtype == torch.bfloat16
        assert torch.equal(got, x)


# ---------------------------------------------------------------- a replay of the kernels


def _merge(a, b):
    """Chan's merge of (n, mean, m2) b into a, in f32 (the kernel's merge)."""
    n, mean, m2 = a
    nb, mb, m2b = b
    total = n + nb
    if float(total) == 0.0:
        return a
    f = nb / total
    d = mb - mean
    return total, mean + d * f, m2 + m2b + d * (d * (n * f))


def _cta_merge(states, tx):
    """The kernel's block_moments over the TY threads' states: shuffles
    down the lanes that share a channel group, then warp 0 takes the warps
    in order; returns thread (tx, 0)'s state."""
    per_warp = 32 // tx
    off = 16
    while off >= tx:
        step = off // tx
        states = [_merge(s, states[t + step] if t % per_warp + step < per_warp else s)
                  for t, s in enumerate(states)]
        off //= 2
    acc = states[0]
    for w in range(1, len(states) // per_warp):
        acc = _merge(acc, states[w * per_warp])
    return acc


def replay_statistics(x2d, p):
    """The kernels' batch mean and biased variance of an (R, C) f32 matrix
    under plan p: each thread folds its rows four at a time, then single
    rows; each CTA merges its threads; the last CTA merges the slabs, each
    of its threads a ty-strided run of them.  Channels side by side."""
    rows, c = x2d.shape
    zero = lambda: (torch.zeros(()), torch.zeros(c), torch.zeros(c))
    parts = []
    for s in range(p.slabs):
        lo, hi = s * p.rows_per_slab, min(rows, (s + 1) * p.rows_per_slab)
        states = []
        for t in range(p.ty):
            state, own = zero(), x2d[lo + t:hi:p.ty]
            full = len(own) // 4 * 4
            for k in range(0, full, 4):
                chunk = own[k:k + 4]
                m = chunk.sum(0) * 0.25
                state = _merge(state, (torch.tensor(4.0), m, ((chunk - m) ** 2).sum(0)))
            for row in own[full:]:
                state = _merge(state, (torch.tensor(1.0), row, torch.zeros(c)))
            states.append(state)
        parts.append((torch.tensor(float(hi - lo)),) + _cta_merge(states, p.tx)[1:])
    states = []
    for t in range(p.ty):
        state = zero()
        for s in range(t, p.slabs, p.ty):
            state = _merge(state, parts[s])
        states.append(state)
    n, mean, m2 = _cta_merge(states, p.tx)
    return mean, m2 / n


@pytest.mark.parametrize("rows, channels, sms", [(3000, 16, 2), (1300, 24, 9), (200, 8, 1)])
def test_replay_of_the_kernels_statistics_keeps_digits_where_the_mean_dwarfs_the_std(
        rows, channels, sms):
    """|mean| / std = 1000: the kernels' merges keep the variance to 1e-4
    (the f32 rounding of x - mean at |x| = 1000) where E[x^2] - E[x]^2 in
    f32 loses two digits more (the cancellation `synced_batch_norm`
    records), and the mean to f32 rounding."""
    gen = torch.Generator().manual_seed(rows)
    x = (torch.randn(rows, channels, generator=gen, dtype=torch.float64) + 1000.0).float()
    p = plan(rows, channels, torch.float32, sms)
    assert p.slabs > 1
    mean, var = replay_statistics(x, p)
    want_var, want_mean = torch.var_mean(x.double(), dim=0, correction=0)
    assert ((mean.double() - want_mean).abs() <= 1e-6 * want_mean.abs()).all()
    assert ((var.double() - want_var).abs() <= 1e-4 * want_var).all()
    naive = (x * x).mean(0) - x.mean(0) ** 2
    assert ((naive.double() - want_var).abs() > 1e-2 * want_var).any()


def replay_affine(x, w, b, mean, invstd, relu, dtype):
    """The kernels' forward in f32: y = x*a + c, a = w*invstd,
    c = b - mean*a, ReLU, rounded once to dtype; and the mask the backward
    recomputes from x."""
    a = w * invstd
    c = b - mean * a
    y = (x.float() * a + c).to(dtype)
    if relu:
        y = y.clamp(min=0)
    return y, (y.float() > 0) if relu else torch.ones_like(x, dtype=torch.bool)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_replay_of_the_kernels_affine_forward_and_backward(dtype, relu):
    """The kernels' forms against float64 autograd of BN then ReLU: y
    within one rounding to dtype; dx = a*(dz - k) - q*(x - mean),
    k = sum(dz)/n, q = a*invstd*sum(dz*xhat)/n in f32, within one
    rounding of dx plus f32 sums (1e-5 of max |dx|); the weight's and the
    bias's gradients sum(dz*xhat), sum(dz) to 1e-5 of their sums of |.|."""
    c = 24
    x = make_input((6, c, 9, 11), dtype).permute(0, 2, 3, 1).reshape(-1, c)
    dy = make_input((6, c, 9, 11), dtype, seed=9, mean=0.0, std=1.0)
    dy = dy.permute(0, 2, 3, 1).reshape(-1, c)
    w, b, _ = make_params(c)
    var, mean = torch.var_mean(x.double(), dim=0, correction=0)
    mean, var = mean.float(), var.float()
    invstd = 1.0 / torch.sqrt(var + EPS)
    y, mask = replay_affine(x, w, b, mean, invstd, relu, dtype)

    xd = x.double().requires_grad_(True)
    wd, bd = w.double().requires_grad_(True), b.double().requires_grad_(True)
    v, m = torch.var_mean(xd, dim=0, correction=0)
    want = (xd - m) * torch.rsqrt(v + EPS) * wd + bd
    if relu:
        want = want.clamp(min=0)
    rel = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert ((y.double() - want.detach()).abs()
            <= rel * want.detach().abs() + 1e-5 * want.detach().abs().max()).all()
    (want * (dy.double() * mask)).sum().backward()  # the kernel's own mask

    dz = torch.where(mask, dy.float(), torch.zeros(()))
    xm = x.float() - mean
    sum_dz, sum_dz_xhat = dz.sum(0), (dz * xm).sum(0) * invstd
    n = x.shape[0]
    a = w * invstd
    k, q = sum_dz / n, a * invstd * (sum_dz_xhat / n)
    dx = (a * (dz - k) - q * xm).to(dtype)
    scale = xd.grad.abs().max()
    assert ((dx.double() - xd.grad).abs() <= rel * xd.grad.abs() + 1e-5 * scale).all()
    xhat = (x.double() - m.detach()) * torch.rsqrt(v.detach() + EPS)
    for got, ref, terms in ((sum_dz_xhat, wd.grad, (dz.double() * xhat).abs().sum(0)),
                            (sum_dz, bd.grad, dz.double().abs().sum(0))):
        assert ((got.double() - ref).abs() <= 1e-5 * terms + 1e-12).all()


# ---------------------------------------------------------------- routing and counters


def bn_layer(c, seed=1):
    bn = BatchNorm(c)
    w, b, (rm, rv, nbt) = make_params(c, seed)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.copy_(rm)
        bn.running_var.copy_(rv)
        bn.num_batches_tracked.fill_(int(nbt))
    return bn


@pytest.mark.parametrize("relu", [False, True])
def test_cpu_train_mode_takes_the_plain_version_and_counts_nothing(relu):
    bn = bn_layer(8)
    ref = bn_layer(8)
    x = make_input((2, 8, 5, 5), torch.float32)
    launches, fused = batch_norm_train.launches, batch_norm_train.relu_fused
    out = bn(x, relu=relu)
    want = batch_norm_train_reference(x, ref.weight, ref.bias, ref.running_mean,
                                      ref.running_var, ref.num_batches_tracked, EPS, MOMENTUM,
                                      relu, True)
    assert torch.equal(out, want)
    assert torch.equal(bn.running_mean, ref.running_mean)
    assert torch.equal(bn.running_var, ref.running_var)
    assert int(bn.num_batches_tracked) == int(ref.num_batches_tracked) == 4
    assert (batch_norm_train.launches, batch_norm_train.relu_fused) == (launches, fused)
    assert isinstance(batch_norm_train.launches, int)
    assert isinstance(batch_norm_train.relu_fused, int)


def test_update_stats_false_holds_the_running_statistics():
    bn = bn_layer(8)
    before = [t.clone() for t in bn.buffers()]
    bn.update_stats = False
    bn(make_input((2, 8, 5, 5), torch.float32), relu=True)
    assert all(torch.equal(a, b) for a, b in zip(before, bn.buffers()))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("relu", [False, True])
def test_meta_tensors_pass_through(training, relu):
    bn = BatchNorm(8).train(training)
    x = torch.empty((2, 8, 5, 5), device="meta")
    assert bn(x, relu=relu) is x


def test_eval_mode_relu_follows_the_running_statistics():
    bn = bn_layer(8).eval()
    x = make_input((2, 8, 5, 5), torch.float32)
    want = F.relu(F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                               False, 0.0, EPS))
    torch.testing.assert_close(bn(x, relu=True), want, rtol=0, atol=0)


@pytest.mark.parametrize("relu", [False, True])
def test_more_than_one_rank_takes_synced_batch_norm(monkeypatch, relu):
    """world_size() > 1: synced_batch_norm's statistics update the running
    ones, the ReLU follows, and the single-rank route is not taken."""
    calls = []

    def synced(x, weight, bias, eps):
        calls.append(eps)
        return x - 1.0, torch.full((8,), 0.5), torch.full((8,), 2.0)

    def refuse(*args, **kwargs):
        raise AssertionError("the single-rank route was taken")

    monkeypatch.setattr(layers, "world_size", lambda: 2)
    monkeypatch.setattr(layers, "synced_batch_norm", synced)
    monkeypatch.setattr(bn_kernels, "batch_norm_train", refuse)
    bn = bn_layer(8)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    x = make_input((2, 8, 5, 5), torch.float32)
    out = bn(x, relu=relu)
    assert calls == [EPS]
    assert torch.equal(out, F.relu(x - 1.0) if relu else x - 1.0)
    torch.testing.assert_close(bn.running_mean, rm * 0.9 + 0.05)
    torch.testing.assert_close(bn.running_var, rv * 0.9 + 0.2)
    assert int(bn.num_batches_tracked) == 4


def count_bn_calls(monkeypatch, model, x):
    """(train-mode BN calls, those with relu=True) of one forward."""
    seen = []
    plain = bn_kernels.batch_norm_train

    def counting(*args):
        seen.append(bool(args[8]))
        return plain(*args)

    monkeypatch.setattr(bn_kernels, "batch_norm_train", counting)
    model.train()
    with torch.no_grad():
        model(x)
    return len(seen), sum(seen)


@pytest.mark.parametrize("backbone, calls, fused", [("resnet101", 113, 76),
                                                    ("xception", 141, 54)])
def test_which_bns_of_the_cells_fuse_their_relu(monkeypatch, backbone, calls, fused):
    """R101: the stem, bn1 and bn2 of the 33 bottlenecks, the ASPP's five
    ConvBNs and projection, the decoder's three; Xception-65: the stem's
    two, the trailing BN of every unit but a block's last, the exit flow's
    three, and the same nine of the head.  Every BN of the step is one
    call."""
    model = DeepLab(backbone, num_classes=5, dropout=False)
    bns = sum(isinstance(m, BatchNorm) for m in model.modules())
    x = make_input((2, 33, 33, 3), torch.float32).contiguous()
    assert count_bn_calls(monkeypatch, model, x) == (calls, fused)
    assert bns == calls


@pytest.mark.parametrize("training", [True, False])
def test_fused_relu_does_not_change_the_xception_forward(training):
    """rep, whose BNs take the next unit's ReLU (an nn.Identity in its
    place), gives what [ReLU, SeparableConv, BatchNorm] per unit gives,
    running statistics included."""
    torch.manual_seed(0)
    block = AlignedXception().block4.train(training)
    units = list(block.rep)
    assert [type(u).__name__ for u in units[::3]] == ["ReLU", "Identity", "Identity"]
    assert [u.relu for u in units[2::3]] == [True, True, False]
    plain = copy.deepcopy(block)
    for k in (3, 6):
        plain.rep[k] = torch.nn.ReLU()
        plain.rep[k - 1].relu = False
    x = make_input((2, 728, 5, 5), torch.float32)
    torch.testing.assert_close(block(x), plain(x), rtol=0, atol=0)
    for got, want in zip(block.buffers(), plain.buffers()):
        assert torch.equal(got, want)


STATE_DICT_KEYS = {  # (count, sha256 of the keys joined by newlines), as before the kernels
    "resnet101": (624, "747d1acaf4d99992"),
    "xception65": (792, "8fae762ee9dd899a"),
    "aspp": (36, "ce3693a679af0456"),
    "decoder": (20, "45c38c8078eeb23f"),
}


@pytest.mark.parametrize("name", sorted(STATE_DICT_KEYS))
def test_state_dict_keys_do_not_change(name):
    build = {"resnet101": ResNet101, "xception65": AlignedXception, "aspp": ASPP,
             "decoder": Decoder}[name]
    with torch.device("meta"):
        keys = list(build().state_dict().keys())
    digest = hashlib.sha256("\n".join(keys).encode()).hexdigest()[:16]
    assert (len(keys), digest) == STATE_DICT_KEYS[name]
