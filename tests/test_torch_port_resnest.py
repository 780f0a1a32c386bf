"""ResNeSt-101 (models/resnest.py) and its split attention
(ops/splat_kernels.py) on the CPU.

zs3_tpu has no ResNeSt, so the port is held against the benchmark's plain
reference (benchmark/reference/resnest.py: mmsegmentation's equations in
plain torch, NCHW) on the same seeded weights: a narrow-depth (one block
a stage) DeepLabv3+ at 65x65, its forward logits, and the loss and every
parameter's gradient of one `make_train_step` call.  Then the split
attention's plain ops against the reference's SplAt, the CPU path of
`split_attention` and its counter, `plan`, the model's shape plan and the
CLI.  The kernels themselves are held on the card by
tests/test_torch_port_splat_card.py.
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs
from benchmark.reference import resnest as ref
from benchmark.reference import train as ref_train
from zs3_tpu_torch.core.config import Config, OptimConfig
from zs3_tpu_torch.models.deeplab import BACKBONE_WIDTHS, DeepLab, build_backbone
from zs3_tpu_torch.models.resnest import ResNeSt, SplitAttentionConv
from zs3_tpu_torch.ops import splat_kernels
from zs3_tpu_torch.ops.splat_kernels import (
    bwd_reduce_reference,
    combine_reference,
    dx_reference,
    gap_reference,
    plan,
    split_attention,
)
from zs3_tpu_torch.train.seen import make_train_step
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils.losses import build_seg_loss
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

SEED = 2**31 + 2404
NUM_CLASSES = 59
LAYERS = (1, 1, 1, 1)
CONFIG = {"model": {"backbone": "resnest101", "layers": list(LAYERS), "output_stride": 8,
                    "num_classes": NUM_CLASSES, "feature_dim": 256, "low_level_dim": 48,
                    "dropout": True}}
OPTIM = {"lr": 0.01, "momentum": 0.9, "weight_decay": 5e-4, "nesterov": False,
         "schedule": "poly", "poly_power": 0.9, "head_lr_mult": 1.0}
TRAFFIC = {"batch": 2, "crop": 65, "pool_batches": 1, "regions": [2, 4], "ignore_band": 1}


def models(dtype=torch.float32, dropout=True):
    """The port's narrow ResNeSt DeepLab and the reference, on one seeded
    state."""
    port = DeepLab("resnest101", 8, NUM_CLASSES, layers=LAYERS, dropout=dropout, dtype=dtype)
    reference = ref.build({"model": dict(CONFIG["model"], dropout=dropout)})
    state = inputs.seeded_state(port.state_dict(), SEED, "cpu")
    port.load_state_dict(state)
    reference.load_state_dict(state)
    port.to(dtype=dtype, memory_format=torch.channels_last)
    reference.to(dtype)
    return port, reference


def batch(crop=65):
    traffic = dict(TRAFFIC, crop=crop)
    return inputs.make_batches(traffic, NUM_CLASSES, (19, 33), SEED, "cpu")[0]


def test_state_dict_names_and_shapes_are_the_reference_s():
    port, reference = models()
    got, want = port.state_dict(), reference.state_dict()
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape for k in got)
    for key in ("backbone.stem.0.weight", "backbone.stem.7.running_var",
                "backbone.layer1.0.conv2.conv.weight", "backbone.layer1.0.conv2.bn0.weight",
                "backbone.layer1.0.conv2.fc1.bias", "backbone.layer1.0.conv2.bn1.weight",
                "backbone.layer4.0.conv2.fc2.weight", "backbone.layer2.0.downsample.1.weight",
                "backbone.layer2.0.downsample.2.running_mean", "aspp1.conv.weight"):
        assert key in got
    # fc1: C -> max(C/2, 32) with bias; the grouped conv: 2 groups.
    assert got["backbone.layer1.0.conv2.fc1.weight"].shape == (32, 64, 1, 1)
    assert got["backbone.layer4.0.conv2.fc1.weight"].shape == (256, 512, 1, 1)
    assert got["backbone.layer3.0.conv2.conv.weight"].shape == (512, 128, 3, 3)


def test_forward_logits_match_the_reference():
    """f32, train mode (batch statistics), dropout off.  The two run the
    same equations with other reduction orders (NHWC against NCHW convs,
    the mean over the splits summed in another order, the gate as matrix
    products against 1x1 convs); measured 2.1e-5 of the largest logit,
    held to 1e-4."""
    port, reference = models(dropout=False)
    x = batch()["image"]
    port.train()
    reference.train()
    with torch.no_grad():
        got = port(x)
        want = reference(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 65, 65, NUM_CLASSES) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def reference_step(reference, data, seed):
    """The reference's loss and per-parameter gradients of step 0, with the
    dropout draws the port's step makes (reference/train.py's rule)."""
    reference.train()
    reference.dropout_generator = ref_train.step_generator(seed, 0, "cpu")
    logits = reference(data["image"].permute(0, 3, 1, 2))
    loss = F.cross_entropy(logits, data["label"].long(), ignore_index=255)
    names = [n for n, _ in reference.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in reference.named_parameters()])
    return float(loss.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("dtype,crop,loss_tol,grad_tol", [
    # f32: train-mode BN over the few pixels of the os8 grid at 65x65 (9x9,
    # batch 2) and the gate's BN over 2 values a channel amplify round-off
    # (PERF.md: f32 gradients of such steps part by percents of a leaf);
    # measured 0 of the loss and 1.3e-3 of max|g|, held to 1e-4 and 2e-2.
    (torch.float32, 65, 1e-4, 2e-2),
    # f64 (at 33x33, for time): the two differ only where the port's head
    # resizes with f32 interpolation weights, 1e-7 of the logits; measured
    # 2.8e-10 of the loss and 9.1e-8 of max|g|, held to 1e-9 and 1e-6.
    (torch.float64, 33, 1e-9, 1e-6),
])
def test_train_step_loss_and_gradients_match_the_reference(dtype, crop, loss_tol, grad_tol):
    port, reference = models(dtype)
    data = batch(crop)
    data = {"image": data["image"].to(dtype), "label": data["label"]}
    optimizer = SegOptimizer(port, Config(optim=OptimConfig(**OPTIM)), 100)
    step = make_train_step(build_seg_loss("ce", 255), "full", seed=SEED)
    loss = float(step(port, optimizer, data)["loss"])
    want_loss, want = reference_step(reference, data, SEED)
    assert abs(loss - want_loss) <= loss_tol * want_loss
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    worst = max(float((got[n] - want[n]).abs().max()) for n in want)
    assert worst <= grad_tol * scale, worst / scale


def splat_case(dtype, n=3, c=32, hw=(7, 5), seed=0):
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn((n, 2 * c, *hw), generator=gen).abs().to(dtype)
    dy = torch.randn((n, c, *hw), generator=gen).to(dtype)
    return u, dy


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
def test_plain_ops_match_the_reference_splat(dtype, tol):
    """gap, combine, bwd_reduce and dx, with the gate's backward between,
    give the reference SplitAttentionConv2d's output and gradient of its
    input; each split's channels in the reference's order."""
    c = 32
    block = ref.SplitAttentionConv2d(c, 1).to(dtype)
    block.train()
    u, dy = splat_case(dtype, c=c)
    u = u.requires_grad_(True)
    # The reference's SplAt after its conv, BN and ReLU (given u directly).
    splits = torch.split(u, c, dim=1)
    gap = F.adaptive_avg_pool2d(sum(splits), 1)
    z = block.fc2(F.relu(block.bn1(block.fc1(gap))))
    a = F.softmax(z.view(z.shape[0], 2, -1), dim=1)
    want = sum(a[:, r, :, None, None] * splits[r] for r in range(2))
    (want_du,) = torch.autograd.grad(want, u, dy)

    with torch.no_grad():
        g = gap_reference(u)
    g = g.reshape(-1, c, 1, 1).requires_grad_(True)
    z = block.fc2(F.relu(block.bn1(block.fc1(g))))
    out, weights = combine_reference(u.detach(), z.detach())
    dz = bwd_reduce_reference(dy, u.detach(), weights)
    (dg,) = torch.autograd.grad(z, g, dz.reshape(z.shape))
    du = dx_reference(dy, weights, dg)
    assert float((out - want).abs().max()) <= tol * float(want.abs().max())
    assert float((du - want_du).abs().max()) <= tol * float(want_du.abs().max())


def test_split_attention_on_the_cpu_is_the_plain_autograd_and_counts_nothing():
    """The CPU path (the two autograd functions on the plain ops, du
    written whole by the mean's backward) against autograd through the
    plain equations, in f64: output, du and the gate's gradients."""
    c = 32
    conv = SplitAttentionConv(c, 1, dtype=torch.float64).double()
    conv.train()
    twin = copy.deepcopy(conv)
    u, dy = splat_case(torch.float64, c=c)
    before = split_attention.launches
    ua = u.clone().requires_grad_(True)
    out = split_attention(ua, conv.gate)
    got = torch.autograd.grad(out, [ua, *conv.parameters()], dy, allow_unused=True)

    ub = u.clone().requires_grad_(True)
    u0, u1 = ub[:, :c], ub[:, c:]
    z = twin.gate((u0 + u1).mean((2, 3), keepdim=True))
    a = torch.softmax(z.reshape(-1, 2, c, 1, 1), dim=1)
    plain = a[:, 0] * u0 + a[:, 1] * u1
    want = torch.autograd.grad(plain, [ub, *twin.parameters()], dy, allow_unused=True)
    assert torch.allclose(out, plain, rtol=1e-12, atol=1e-12)
    for g, w in zip(got, want):  # the conv and bn0 before u take no part
        assert (g is None) == (w is None)
        assert w is None or torch.allclose(g, w, rtol=1e-10, atol=1e-12)
    assert split_attention.launches == before


def test_split_attention_with_an_unused_output_gives_the_mean_s_gradient():
    """When only g's path is differentiated (the combine's backward never
    runs), du is dg / HW in both splits."""
    c = 32
    u, _ = splat_case(torch.float64, c=c)
    u = u.requires_grad_(True)
    kept = {}

    def gate(g):
        kept["g"] = g
        return torch.zeros((g.shape[0], 2 * c, 1, 1), dtype=g.dtype)

    split_attention(u, gate)
    (du,) = torch.autograd.grad(kept["g"].sum(), u)
    assert torch.allclose(du, torch.full_like(u, 1.0 / 35))


def test_split_attention_refuses_what_it_does_not_take():
    gate = lambda g: torch.cat([g, g], 1)  # noqa: E731
    with pytest.raises(ValueError):
        split_attention(torch.zeros((2, 3, 4, 4)), gate)
    with pytest.raises(ValueError):
        split_attention(torch.zeros((2, 4, 4)), gate)
    with pytest.raises(ValueError):
        split_attention(torch.zeros((2, 4, 4, 4), device="meta"), gate)


@pytest.mark.parametrize("n,pixels,c,dtype", [
    (24, 128 * 128, 64, torch.bfloat16), (24, 128 * 128, 128, torch.bfloat16),
    (24, 64 * 64, 128, torch.bfloat16), (24, 64 * 64, 256, torch.bfloat16),
    (24, 64 * 64, 512, torch.bfloat16), (24, 64 * 64, 512, torch.float32),
    (24, 63 * 61, 256, torch.float64), (2, 9 * 9, 64, torch.float32),
])
def test_plan_covers_every_value_once(n, pixels, c, dtype):
    p = plan(n, pixels, c, dtype)
    assert p.vec * dtype.itemsize == 16 and p.tx * p.ty == splat_kernels.THREADS
    assert p.cblocks * p.tx * p.vec >= c > (p.cblocks - 1) * p.tx * p.vec
    assert p.slabs * p.rows_per_slab >= pixels > (p.slabs - 1) * p.rows_per_slab
    assert p.slabs <= splat_kernels.MAX_MERGE * p.ty
    ctas = p.cblocks * p.slabs * n
    one_wave = splat_kernels.CTAS_PER_SM * 132
    assert ctas <= max(one_wave, n * p.cblocks)  # one wave, or a slab an image
    assert ctas > one_wave - n * p.cblocks or p.slabs * p.ty >= pixels


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        plan(2, 16, 64, torch.float16)
    with pytest.raises(ValueError):
        plan(2, 16, 12, torch.bfloat16)  # not a multiple of 8 bf16 channels
    with pytest.raises(ValueError):
        plan(0, 16, 64, torch.float32)


def test_the_trunk_s_plan_at_output_stride_8():
    """33 split-attention blocks at full depth; strides (1, 2, 1, 1),
    dilations (1, 1, 2, 4) with each dilated stage's first block at half;
    the block's average pool only where it strides."""
    with torch.device("meta"):
        trunk = ResNeSt((3, 4, 23, 3), 8)
    blocks = [m for m in trunk.modules() if isinstance(m, SplitAttentionConv)]
    assert len(blocks) == 33
    dilations = [[b.conv2.conv.dilation[0] for b in getattr(trunk, f"layer{i}")]
                 for i in range(1, 5)]
    assert dilations == [[1] * 3, [1] * 4, [1] + [2] * 22, [2, 4, 4]]
    strides = [b.stride for i in range(1, 5) for b in getattr(trunk, f"layer{i}")]
    assert strides.count(2) == 1 and trunk.layer2[0].stride == 2
    assert all(b.conv.stride == (1, 1) for b in blocks)
    assert all(getattr(trunk, f"layer{i}")[0].downsample is not None for i in range(1, 5))


def test_backbone_widths_layers_and_shapes():
    assert BACKBONE_WIDTHS["resnest101"] == (2048, 256)
    trunk = build_backbone("resnest101", 8, {}, torch.float32, LAYERS)
    trunk.train()
    high, low = trunk(torch.randn(2, 65, 65, 3))
    assert high.shape == (2, 9, 9, 2048) and low.shape == (2, 17, 17, 256)
    trunk16 = build_backbone("resnest101", 16, {}, torch.float32, LAYERS).train()
    assert trunk16(torch.randn(2, 65, 65, 3))[0].shape == (2, 5, 5, 2048)


def test_remat_gives_the_same_step():
    """Block recompute in the backward (RematBlock, shared with the
    ResNets) recomputes the same values, so the step is bit for bit the
    same, the BN running statistics included."""
    results = []
    for remat in (False, True):
        port = DeepLab("resnest101", 8, NUM_CLASSES, layers=LAYERS, remat=remat)
        port.load_state_dict(inputs.seeded_state(port.state_dict(), SEED, "cpu"))
        port.to(memory_format=torch.channels_last)
        optimizer = SegOptimizer(port, Config(optim=OptimConfig(**OPTIM)), 100)
        loss = make_train_step(build_seg_loss("ce", 255), "full", seed=SEED)(
            port, optimizer, batch())["loss"]
        results.append((loss, list(port.state_dict().values())))
    (l0, s0), (l1, s1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_train_seen_and_evaluate_on_context_through_the_cli(tmp_path):
    """`train-seen --backbone resnest101 --out-stride 8 --dataset context`
    on a fabricated Pascal-Context tree, then `evaluate` of its checkpoint
    (full depth, f32, 33x33 crops on the CPU)."""
    from zs3_tpu_torch import cli
    from zs3_tpu_torch.data import fabricate

    root = str(tmp_path / "data")
    fabricate.fabricate_context_tree(root, 4, 2, sizes=((40, 48),))
    common = ["--backbone", "resnest101", "--out-stride", "8", "--dataset", "context",
              "--data-root", root, "--unseen-split", "2", "--crop-size", "33",
              "--base-size", "33", "--compute-dtype", "float32", "--device", "cpu",
              "--checkpoint-dir", str(tmp_path / "run")]
    result, _ = cli.run(["train-seen", *common, "--batch-size", "2", "--eval-batch-size", "2",
                         "--epochs", "1", "--steps-per-epoch", "1", "--no-val"])
    assert result is not None
    evaluated, _ = cli.run(["evaluate", *common, "--eval-batch-size", "2", "--auto-resume"])
    assert 0.0 <= evaluated["miou"] <= 1.0


def test_the_block_s_average_pool_keeps_the_layout_and_the_values():
    """avg_pool_3x3 (computed on an NCHW copy) is AvgPool2d(3, s, 1) with
    its padding counted, in the input's memory format, values and
    gradient alike."""
    from zs3_tpu_torch.models.resnest import avg_pool_3x3

    x = torch.randn((2, 8, 17, 17), dtype=torch.float64)
    for layout in (torch.contiguous_format, torch.channels_last):
        xa = x.contiguous(memory_format=layout).requires_grad_(True)
        y = avg_pool_3x3(xa, 2)
        assert y.is_contiguous(memory_format=layout) and y.shape == (2, 8, 9, 9)
        xb = x.clone().requires_grad_(True)
        want = torch.nn.AvgPool2d(3, 2, 1)(xb)
        assert torch.equal(y, want)
        gy = torch.randn_like(want)
        assert torch.equal(torch.autograd.grad(y, xa, gy)[0], torch.autograd.grad(want, xb, gy)[0])


@pytest.mark.parametrize("groups,stride,dilation", [(2, 1, 2), (2, 2, 1), (4, 1, 4)])
def test_conv_per_group_is_the_grouped_conv(groups, stride, dilation):
    """models/layers.py's conv2d_per_group (the card's route for a grouped
    conv that is not depthwise) gives F.conv2d's grouped values and
    gradients, in the input's memory format: the same products and sums
    per group, so equal in f64 to rounding."""
    from zs3_tpu_torch.models.layers import conv2d_per_group

    gen = torch.Generator().manual_seed(groups * 10 + dilation)
    x = torch.randn((2, 8, 13, 11), generator=gen, dtype=torch.float64)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    w = torch.randn((16, 8 // groups, 3, 3), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn((16,), generator=gen, dtype=torch.float64, requires_grad=True)
    got = conv2d_per_group(x, w, b, stride, dilation, dilation, groups)
    want = F.conv2d(x, w, b, stride, dilation, dilation, groups)
    assert got.shape == want.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert float((got - want).abs().max()) <= 1e-12
    gy = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    for a, c in zip(torch.autograd.grad(got, (x, w, b), gy), torch.autograd.grad(want, (x, w, b), gy)):
        assert float((a - c).abs().max()) <= 1e-12
