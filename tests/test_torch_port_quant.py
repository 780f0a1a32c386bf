"""int8 quantization of the port (zs3_tpu_torch.quant) against zs3_tpu.quant.

Inputs come from a seeded numpy generator and go through both packages
on the CPU; zs3_tpu runs as tests/test_quant.py runs it.

* `int8_conv` equals zs3_tpu's exactly (zero difference) in f32 and bf16
  for every conv form the DeepLab has: 1x1, 1x1 stride 2, 3x3 stride 2,
  dilation 2, dilation 12 (the space-to-batch geometry of the float
  path) and a 1x1 on a 1x1 map (M <= 16 rows, the ASPP's image pool).
  Both quantize with the same f32 divisions, round half to even, sum
  exactly and dequantize with one f32 product.  The card's route (im2col
  + `torch._int_mm`) equals the plain float64 conv on the CPU too.
* `fake_quant_conv_operands`: the values exactly, and the gradients of
  the straight-through estimator equal `jax.grad`'s exactly.
* `calibrate` on a ResNet-50 DeepLab at 33x33 (tests/test_quant.py's
  `_tiny_model`), the port's weights carried into zs3_tpu by
  convert_deeplab_state_dict: the same conv set, one to one through
  `scales_from_flax`, absmax and percentile 99.99 within rel 1e-5 (the two
  trunks' f32 convolutions sum in another order).
* The quantized forward under the same scales: labels agree on >= 99% of
  pixels.  An upstream f32 difference of one ulp moves a value across a
  rounding boundary of the int8 grid now and then, and the flip carries
  to the logits, so near-ties of the argmax may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs3_tpu import quant as jax_quant
from zs3_tpu.models.deeplab import DeepLab as JaxDeepLab
from zs3_tpu.utils.torch_convert import convert_deeplab_state_dict
from zs3_tpu_torch import quant
from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
from zs3_tpu_torch.models.layers import Conv
from zs3_tpu_torch.utils.convert import scales_from_flax

from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

# zs3_tpu compiled as its ops read: XLA's algebraic simplifier rewrites the
# int8 grid math's divisions, which moves zs3_tpu's jitted int8 and QAT
# results off its own op-by-op ones (tests/test_torch_port_quant_paths.py).
OP_BY_OP = {"xla_disable_hlo_passes": "algsimp"}



# name: (batch, in channels, height, width, out channels, kernel, stride, padding, dilation)
FORMS = {
    "1x1": (2, 32, 9, 9, 16, 1, 1, 0, 1),
    "1x1 stride 2": (2, 32, 9, 9, 16, 1, 2, 0, 1),
    "3x3 stride 2": (2, 16, 11, 11, 24, 3, 2, 1, 1),
    "3x3 dilation 2": (2, 24, 9, 9, 16, 3, 1, 2, 2),
    "3x3 dilation 12": (1, 16, 13, 13, 8, 3, 1, 12, 12),
    "1x1 on 1x1, M <= 16": (3, 64, 1, 1, 16, 1, 1, 0, 1),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(form, seed=0):
    """(x NHWC f32, kernel HWIO f32, absmax below |x|'s max: some clip)."""
    b, c, h, w, o, k = FORMS[form][:6]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, c)) * 2.0).astype(np.float32)
    kernel = (rng.standard_normal((k, k, c, o)) * 0.1).astype(np.float32)
    return x, kernel, 0.8 * float(np.abs(x).max())


def _geometry(form):
    s, p, d = FORMS[form][6:]
    return (s, s), (p, p), (d, d)


def _nchw(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _oihw(kernel_hwio):
    return torch.from_numpy(np.ascontiguousarray(kernel_hwio.transpose(3, 2, 0, 1)))


def _bits(a):
    """An array's values as comparable f32 (bf16 widens exactly)."""
    return np.asarray(a, dtype=np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_int8_conv_equals_zs3_tpu(form, dtype):
    x, kernel, absmax = _operands(form)
    (s, p, d), (jdt, tdt) = _geometry(form), DTYPES[dtype]
    conv = jax.jit(lambda a, k: jax_quant.int8_conv(a, k, absmax, s, (p, p), d, jdt))
    args = (jnp.asarray(x).astype(jdt), jnp.asarray(kernel))
    want = conv.lower(*args).compile(compiler_options=OP_BY_OP)(*args)
    got = quant.int8_conv(_nchw(x).to(tdt), _oihw(kernel), absmax, s, p, d, tdt)
    assert got.dtype == tdt
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, _bits(want))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_int8_route_equals_plain(form):
    """im2col + torch._int_mm, the card's route, gives the plain version's
    int32 sums on the CPU (M <= 16 padded with zero rows)."""
    b, c, h, w, o, k = FORMS[form][:6]
    gen = torch.Generator().manual_seed(1)
    xq = torch.randint(-127, 128, (b, c, h, w), generator=gen, dtype=torch.int8)
    xq = xq.contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (o, c, k, k), generator=gen, dtype=torch.int8)
    s, p, d = _geometry(form)
    got = quant.int8_conv_route(xq, wq, s, p, d)
    want = quant.int8_conv_plain(xq, wq, s, p, d)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


def test_int8_conv_counts_no_launch_on_the_cpu():
    x, kernel, absmax = _operands("1x1")
    before = quant.int8_conv.launches
    quant.int8_conv(_nchw(x), _oihw(kernel), absmax, (1, 1), (0, 0), (1, 1), torch.float32)
    assert quant.int8_conv.launches == before


def test_fake_quant_values_and_straight_through_gradients():
    x, kernel, absmax = _operands("3x3 dilation 2", seed=3)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    gk = np.random.default_rng(5).standard_normal(kernel.shape).astype(np.float32)
    for given in (None, absmax):
        jx, jk = jax_quant.fake_quant_conv_operands(jnp.asarray(x), jnp.asarray(kernel), given)

        def jax_loss(a, b):
            xf, kf = jax_quant.fake_quant_conv_operands(a, b, given)
            return jnp.sum(xf * g) + jnp.sum(kf * gk)

        jgx, jgk = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(kernel))
        tx = _nchw(x).clone().requires_grad_(True)
        tk = _oihw(kernel).requires_grad_(True)
        x_fq, w_fq = quant.fake_quant_conv_operands(tx, tk, given)
        np.testing.assert_array_equal(x_fq.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jx))
        np.testing.assert_array_equal(w_fq.detach().permute(2, 3, 1, 0).numpy(), np.asarray(jk))
        ((x_fq * _nchw(g)).sum() + (w_fq * _oihw(gk)).sum()).backward()
        np.testing.assert_array_equal(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx))
        np.testing.assert_array_equal(tk.grad.permute(2, 3, 1, 0).numpy(), np.asarray(jgk))


def test_conv_module_dispatch():
    """Conv runs int8 under a scale for its path, fake-quant under qat(),
    float otherwise; the 3-channel stem stays float under both."""
    torch.manual_seed(0)
    conv = Conv(16, 8, 3, padding=1)
    stem = Conv(3, 8, 3, padding=1)
    conv.quant_path, stem.quant_path = "a.conv", "stem"
    x16, x3 = torch.randn(1, 16, 7, 7), torch.randn(1, 3, 7, 7)
    with torch.no_grad():
        y16, y3 = conv(x16), stem(x3)
        with quant.quantized({"a.conv": 3.0, "stem": 3.0}):
            q16, q3 = conv(x16), stem(x3)
        want = quant.int8_conv(x16, conv.weight, 3.0, (1, 1), (1, 1), (1, 1), torch.float32)
        assert torch.equal(q16, want) and torch.equal(q3, y3) and not torch.equal(q16, y16)
        with quant.qat():
            f16, f3 = conv(x16), stem(x3)
        xf, wf = quant.fake_quant_conv_operands(x16, conv.weight)
        assert torch.equal(f16, torch.nn.functional.conv2d(xf, wf, None, 1, 1))
        assert torch.equal(f3, y3)
        conv.quant_path = "decoder.classifier"
        with quant.quantized({"decoder.classifier": 3.0}):  # dropped on entry
            assert torch.equal(conv(x16), y16)
        with quant.qat():
            assert torch.equal(conv(x16), y16)


def test_scale_names_json_and_exclusion():
    scales = {"backbone.layer1.0.conv1": 1.5, "classifier": 2.0, "aspp1.conv": 0.25}
    assert quant.scales_from_json(quant.scales_to_json(scales)) == scales
    assert quant.filter_excluded(scales, quant.DEFAULT_EXCLUDE) == {
        "backbone.layer1.0.conv1": 1.5, "aspp1.conv": 0.25}
    assert quant.path_excluded(("decoder", "classifier", "conv"))
    assert not quant.path_excluded("decoder.fuse1.conv")
    with quant.quantized({("aspp1", "conv"): 1.0, "classifier": 2.0}):
        assert quant.scale_for("aspp1.conv") == 1.0
        assert quant.scale_for("classifier") is None
    assert quant.scale_for("aspp1.conv") is None
    assert scales_from_flax(jax_quant.scales_to_json({
        ("encoder", "layer3_block5", "downsample_conv", "conv"): 1.0,
        ("aspp", "global_pool", "conv", "conv"): 2.0,
        ("decoder", "fuse1", "conv", "conv"): 3.0,
    })) == {"backbone.layer3.5.downsample.0": 1.0, "global_pool.conv": 2.0, "fuse1.conv": 3.0}


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4099])
@pytest.mark.parametrize("q", [0.0, 37.5, 50.0, 99.0, 99.99, 100.0])
def test_percentile_of_matches_numpy(n, q):
    values = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = float(quant.percentile_of(torch.from_numpy(values), q))
    np.testing.assert_allclose(got, np.percentile(values, q), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, float(jnp.percentile(jnp.asarray(values), q)),
                               rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def r50_pair():
    """A ResNet-50 DeepLab at 33x33 (tests/test_quant.py's _tiny_model) in
    both packages on the port's seeded weights, two calibration batches,
    and zs3_tpu's absmax calibration on them."""
    model = init_deeplab(DeepLab(backbone="resnet50", num_classes=4, dropout=False), 0).eval()
    params, stats = convert_deeplab_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()
         if not k.endswith("num_batches_tracked")})
    variables = {"params": params, "batch_stats": stats}
    jmodel = JaxDeepLab(backbone="resnet50", num_classes=4, dropout=False, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((2, 33, 33, 3)).astype(np.float32) for _ in range(2)]
    jax_scales = jax_quant.calibrate(jmodel.apply, variables, batches,
                                     apply_kwargs={"train": False})
    return model, jmodel, variables, batches, jax_scales


@pytest.mark.parametrize("percentile", [None, 99.99])
def test_calibrate_matches_zs3_tpu(r50_pair, percentile):
    model, jmodel, variables, batches, jax_absmax = r50_pair
    jax_scales = jax_absmax if percentile is None else jax_quant.calibrate(
        jmodel.apply, variables, batches, apply_kwargs={"train": False}, percentile=percentile)
    got = quant.calibrate(model, [torch.from_numpy(b) for b in batches], percentile=percentile)
    want = scales_from_flax(jax_scales)
    assert len(want) == len(jax_scales)  # one to one
    # 48 block convs, 4 downsamples, 6 of the ASPP, 3 of the decoder
    assert set(got) == set(want) and len(got) == 61
    names = sorted(got)
    np.testing.assert_allclose([got[k] for k in names], [want[k] for k in names], rtol=1e-5)
    assert not any("classifier" in k or k == "backbone.conv1" for k in got)
    assert set(quant.default_conv_scales(model)) == set(got)
    assert len(jax_quant.default_conv_scales(variables["params"])) == len(got)


def test_quantized_forward_matches_zs3_tpu(r50_pair):
    model, jmodel, variables, batches, jax_scales = r50_pair
    x = np.random.default_rng(9).standard_normal((2, 33, 33, 3)).astype(np.float32)
    with jax_quant.quantized(jax_scales):
        want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    scales = scales_from_flax(jax_scales)
    with torch.no_grad():
        float_logits = model(torch.from_numpy(x))
        with quant.quantized(scales):
            got = model(torch.from_numpy(x))
    assert not torch.equal(got, float_logits)  # the int8 convs ran
    agree = float((got.argmax(-1).numpy() == np.asarray(want).argmax(-1)).mean())
    assert agree >= 0.99, agree


def test_r101_quantized_conv_count():
    """The full-width model's int8 conv set (chip_smoke.py checks 112 on
    the card) is zs3_tpu's: the same paths as its default_conv_scales on
    the ResNet-101 DeepLab's parameter shapes."""
    jmodel = JaxDeepLab(backbone="resnet101", num_classes=21, dropout=False)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 33, 33, 3)),
                                                train=False))
    want = scales_from_flax(jax_quant.default_conv_scales(shapes["params"]))
    got = quant.default_conv_scales(DeepLab(backbone="resnet101", num_classes=21))
    assert got == want and len(got) == 112
