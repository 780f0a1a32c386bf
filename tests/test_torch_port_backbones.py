"""The Xception-65, MobileNetV2 and DRN-D-54 backbones of the port against
zs3_tpu's, and their upstream checkpoint names.

JAX weights (with randomized BN statistics) reach the port through
zs3_tpu_torch.utils.convert.state_dict_from_flax; inputs come from a
seeded numpy generator; everything runs in f32 on the CPU.  Tolerances
are those of tests/test_backbone_parity.py (zs3_tpu against the upstream
torch oracles): the os4 low-level map within 1e-4, the high-level map
within 1e-3 for MobileNetV2 and 5e-3 for Xception and DRN; a whole
DeepLab's logits within 5e-3 (tests/test_torch_port_models.py) and its
labels, through K1's plain version, equal away from near-ties.

A whole zs3_tpu backbone takes seconds to compile, so each configuration
compiles once per module (`jax_deeplab`): one jit of the whole DeepLab
returns the encoder's two maps and the logits, and the upstream-name
tests run their converted weights through the same executable.  Weights
are drawn with numpy onto the shapes `jax.eval_shape` gives
(`random_variables`): compiling flax's init of a full-depth DeepLab takes
some 20 s, four times its forward.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_parity import _randomize_bn_stats
from tests.test_torch_port_models import randomize_bn, t
from tests.test_torch_port_ops import assert_labels_match
from zs3_tpu.models import drn as jax_drn
from zs3_tpu.models import mobilenet as jax_mobilenet
from zs3_tpu.models import xception as jax_xception
from zs3_tpu.models.deeplab import DeepLab as JaxDeepLab
from zs3_tpu.utils.torch_convert import convert_backbone, graft_encoder
from zs3_tpu_torch.models import drn, mobilenet, xception
from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.models.layers import BatchNorm, conv2d_space_to_batch
from zs3_tpu_torch.ops.eval_kernels import predict_labels
from zs3_tpu_torch.utils.convert import (
    backbone_kind,
    load_pretrained_backbone,
    scales_from_flax,
    state_dict_from_flax,
)
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

HW = 33
NUM_CLASSES = 5
# backbone -> (low-level atol, high-level atol), tests/test_backbone_parity.py's
ATOL = {"xception": (1e-4, 5e-3), "mobilenet": (1e-4, 1e-3), "drn": (1e-4, 5e-3)}
CONFIGS = [("xception", 16), ("xception", 8), ("mobilenet", 16), ("mobilenet", 8), ("drn", 8)]
DEEPLABS = [("xception", 16), ("mobilenet", 16), ("drn", 8)]  # one per backbone


def random_variables(jmodel, input_shape, seed):
    """{"params", "batch_stats"} of a zs3_tpu model, drawn with numpy on the
    shapes its init gives: conv kernels normal with variance 1 / fan_in
    (lecun's), biases 0, then randomize_bn's BN parameters and statistics."""
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.zeros(input_shape)),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(shapes)
    drawn = {}
    for path, leaf in flat.items():
        if path[-1] == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            drawn[path] = (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            drawn[path] = np.zeros(leaf.shape, np.float32)
    return randomize_bn(flax.traverse_util.unflatten_dict(drawn), seed=seed)


def _block_weights(jmodule, x, name, seed, siblings=None):
    """(zs3_tpu variables, the port's state_dict of that module) for a
    zs3_tpu module placed at encoder/`name`, beside `siblings` (variables
    of other encoder modules: state_dict_from_flax tells the backbone by
    its module names)."""
    variables = randomize_bn(jmodule.init(jax.random.key(seed), jnp.asarray(x)), seed=seed)
    nested = {col: {"encoder": {**(siblings or {}).get(col, {}), name: tree}}
              for col, tree in variables.items()}
    sd = state_dict_from_flax(nested)
    return variables, sd


def _load(module, sd, prefix):
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    return module.eval()


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _apply(jmodule, variables, x):
    return np.asarray(jmodule.apply(variables, jnp.asarray(x), train=False))


# ---- blocks ----------------------------------------------------------------------

def test_separable_conv_matches_zs3_tpu(rng):
    """BN sits between the depthwise and the pointwise conv; zs3_tpu's
    trailing BN (bn_point) is the port's bn3 at the exit flow."""
    x = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)
    jmod = jax_xception.SeparableConv(24, stride=2, dilation=2)
    variables, sd = _block_weights(jmod, x, "conv3", seed=1)
    sep = _load(xception.SeparableConv(16, 24, stride=2, dilation=2), sd, "backbone.conv3.")
    bn = _load(BatchNorm(24), sd, "backbone.bn3.")
    with torch.no_grad():
        got = bn(sep(_nchw(x))).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, _apply(jmod, variables, x), atol=1e-5)


@pytest.mark.parametrize("kind", ["grow-first strided", "grow-last is_last", "middle d=2"])
def test_xception_block_matches_zs3_tpu(kind, rng):
    cin, planes, reps, kw, name = {
        # block1: no leading ReLU
        "grow-first strided": (16, 24, 2, dict(stride=2, start_with_relu=False), "block1"),
        "grow-last is_last": (16, 24, 2, dict(grow_first=False, is_last=True), "block20"),
        "middle d=2": (16, 16, 3, dict(dilation=2), "block7"),
    }[kind]
    x = rng.standard_normal((2, 9, 9, cin)).astype(np.float32)
    jmod = jax_xception.XceptionBlock(planes, reps, **kw)
    variables, sd = _block_weights(jmod, x, name, seed=2)
    block = _load(xception.XceptionBlock(cin, planes, reps, **kw), sd, f"backbone.{name}.")
    assert len(block.rep) == 9 - (not kw.get("start_with_relu", True))  # always 3 units
    with torch.no_grad():
        got = block(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, _apply(jmod, variables, x), atol=1e-5)


@pytest.mark.parametrize("kind", ["no expansion", "expansion, strided", "expansion, residual d=2"])
def test_inverted_residual_matches_zs3_tpu(kind, rng):
    cin, cout, stride, expand, dilation, name = {
        "no expansion": (32, 16, 1, 1, 1, "block0"),
        "expansion, strided": (16, 24, 2, 6, 1, "block1"),
        "expansion, residual d=2": (24, 24, 1, 6, 2, "block2"),
    }[kind]
    x = rng.standard_normal((2, 9, 9, cin)).astype(np.float32) * 3
    jmod = jax_mobilenet.InvertedResidual(cout, stride=stride, expand=expand, dilation=dilation)
    # MobileNetV2 is the backbone whose blocks start at block0.
    block0 = jax_mobilenet.InvertedResidual(16, expand=1).init(jax.random.key(0),
                                                                jnp.zeros((1, 9, 9, 32)))
    siblings = {col: {"block0": tree} for col, tree in block0.items()}
    variables, sd = _block_weights(jmod, x, name, seed=3, siblings=siblings)
    n = int(name[5:])
    block = _load(mobilenet.InvertedResidual(cin, cout, stride, expand, dilation), sd,
                  f"backbone.features.{n + 1}.")
    assert block.use_res == (kind == "expansion, residual d=2")
    with torch.no_grad():
        got = block(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, _apply(jmod, variables, x), atol=1e-5)


def test_drn_conv_level_matches_zs3_tpu(rng):
    x = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)
    jmod = jax_drn._ConvLevel(24, convs=2, stride=2, dilation=2)
    variables, sd = _block_weights(jmod, x, "level7", seed=4)
    level = _load(drn.conv_level(16, 24, convs=2, stride=2, dilation=2), sd, "backbone.layer7.")
    assert [type(m).__name__ for m in level] == ["Conv", "BatchNorm", "ReLU"] * 2
    with torch.no_grad():
        got = level(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, _apply(jmod, variables, x), atol=1e-5)


@pytest.mark.parametrize("d", [2, 12])
def test_space_to_batch_carries_groups(d, rng):
    """A grouped "same" conv through the space-to-batch schedule is the
    dilated grouped conv (depthwise and two channels a group)."""
    x = _nchw(rng.standard_normal((2, 13, 11, 8)).astype(np.float32))
    for groups in (8, 4):
        w = t(rng.standard_normal((8, 8 // groups, 3, 3)).astype(np.float32))
        want = F.conv2d(x, w, None, 1, d, d, groups)
        got = conv2d_space_to_batch(x, w, None, d, groups)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_conv_routes_dilated_grouped_convs_through_space_to_batch(rng, monkeypatch):
    """Conv takes space-to-batch for a depthwise "same" conv from dilation 2
    and for a dense one, or one of fewer groups than channels (ResNeSt's 2,
    which cuDNN runs faster), from dilation 11, and F.conv2d's result
    either way."""
    from zs3_tpu_torch.models import layers

    taken = []
    plain = layers.conv2d_space_to_batch
    monkeypatch.setattr(layers, "conv2d_space_to_batch",
                        lambda *args: taken.append(args[3]) or plain(*args))
    x = _nchw(rng.standard_normal((2, 13, 13, 8)).astype(np.float32))
    for d, groups, routed in ((1, 8, False), (2, 8, True), (4, 8, True), (4, 4, False),
                              (2, 2, False), (12, 2, True), (2, 1, False), (12, 1, True)):
        conv = layers.Conv(8, 8, 3, padding=d, dilation=d, groups=groups)
        taken.clear()
        with torch.no_grad():
            got = conv(x)
            want = F.conv2d(x, conv.weight, None, 1, d, d, groups)
        assert taken == ([d] if routed else []), (d, groups)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ---- whole backbones and DeepLabs ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_deeplab():
    """(backbone, os) -> (zs3_tpu DeepLab, variables, input, jitted
    function of (variables, x) -> (high, low, logits)), built once each."""
    cache = {}

    def get(backbone, output_stride):
        key = (backbone, output_stride)
        if key not in cache:
            rng = np.random.default_rng(7)
            x = rng.standard_normal((2, HW, HW, 3)).astype(np.float32)
            jmodel = JaxDeepLab(backbone=backbone, output_stride=output_stride,
                                num_classes=NUM_CLASSES, dropout=False)
            variables = random_variables(jmodel, (1, HW, HW, 3), seed=5)

            def outputs(m, a):
                high, low = m.encoder(a, train=False)
                return high, low, m(a, train=False)

            fn = jax.jit(lambda v, a: jmodel.apply(v, a, method=outputs))
            cache[key] = (jmodel, variables, x, fn)
        return cache[key]

    return get


def _port(backbone, output_stride, variables):
    model = DeepLab(backbone=backbone, output_stride=output_stride, num_classes=NUM_CLASSES,
                    dropout=False)
    model.load_state_dict(state_dict_from_flax(variables))
    return model.eval()


@pytest.mark.parametrize("backbone,output_stride", CONFIGS)
def test_backbone_matches_zs3_tpu(backbone, output_stride, jax_deeplab):
    _, variables, x, fn = jax_deeplab(backbone, output_stride)
    j_high, j_low, _ = fn(variables, jnp.asarray(x))
    model = _port(backbone, output_stride, variables)
    with torch.no_grad():
        high, low = model.backbone(t(x))
    grid = {16: 3, 8: 5}[8 if backbone == "drn" else output_stride]
    assert high.shape == (2, grid, grid, {"xception": 2048, "mobilenet": 320, "drn": 512}[backbone])
    assert low.shape[1:3] == (9, 9)
    atol_low, atol_high = ATOL[backbone]
    np.testing.assert_allclose(low.numpy(), np.asarray(j_low), atol=atol_low)
    np.testing.assert_allclose(high.numpy(), np.asarray(j_high), atol=atol_high)


@pytest.mark.parametrize("backbone,output_stride", DEEPLABS)
def test_deeplab_logits_and_labels_match_zs3_tpu(backbone, output_stride, jax_deeplab):
    """The eval path: logits at the os4 grid, then K1's plain version."""
    _, variables, x, fn = jax_deeplab(backbone, output_stride)
    _, _, j_logits = fn(variables, jnp.asarray(x))
    j_logits = np.asarray(j_logits)
    model = _port(backbone, output_stride, variables)
    with torch.no_grad():
        out = model(t(x)).numpy()
        grid_logits = model.classify(model.forward_features(t(x)))
        labels = predict_labels(grid_logits, (HW, HW)).numpy()
    assert out.shape == (2, HW, HW, NUM_CLASSES) and np.isfinite(out).all()
    np.testing.assert_allclose(out, j_logits, atol=5e-3)
    assert_labels_match(labels, j_logits.argmax(-1), grid_logits.numpy(), (HW, HW))


def test_deeplab_widths_and_drn_rates():
    """The ASPP takes the backbone's high-level width, the decoder its
    low-level width; DRN's ASPP runs at the os8 rates whatever the config."""
    for backbone, high, low in [("xception", 2048, 128), ("mobilenet", 320, 24),
                                ("drn", 512, 256), ("resnet50", 2048, 256)]:
        model = DeepLab(backbone=backbone, num_classes=NUM_CLASSES, output_stride=16)
        assert model.aspp1.conv.in_channels == model.global_pool.conv.in_channels == high
        assert model.low_proj.conv.in_channels == low
        assert model.aspp4.conv.dilation == ((36, 36) if backbone == "drn" else (18, 18))
    with pytest.raises(ValueError, match="ResNet"):
        DeepLab(backbone="xception", layers=(2, 2, 2, 2))
    with pytest.raises(ValueError, match="unknown backbone"):
        DeepLab(backbone="vgg")


@pytest.mark.parametrize("backbone", ["xception", "mobilenet", "drn"])
def test_state_dict_and_scales_cover_every_module(backbone, jax_deeplab):
    """Every port tensor comes from a zs3_tpu variable; every eligible
    conv's int8 scale path maps to a conv of the port."""
    from zs3_tpu import quant as jax_quant

    output_stride = 8 if backbone == "drn" else 16
    _, variables, x, _ = jax_deeplab(backbone, output_stride)
    model = DeepLab(backbone=backbone, output_stride=output_stride, num_classes=NUM_CLASSES,
                    dropout=False)
    sd = state_dict_from_flax(variables)
    assert {k: v.shape for k, v in sd.items()} == {k: v.shape
                                                   for k, v in model.state_dict().items()}
    jax_scales = jax_quant.default_conv_scales(variables["params"])
    ours = scales_from_flax({"/".join(p): v for p, v in jax_scales.items()})
    from zs3_tpu_torch import quant

    assert ours.keys() == quant.default_conv_scales(model).keys()


def test_backbone_kind():
    assert backbone_kind(["stem_conv", "layer1_block0"]) == "resnet"
    assert backbone_kind(["conv1", "block1", "block20", "conv3"]) == "xception"
    assert backbone_kind(["conv3"]) == backbone_kind(["block7"]) == "xception"
    assert backbone_kind(["stem_conv", "block0", "block16"]) == "mobilenet"
    assert backbone_kind(["stem_conv", "level1", "level3_block0"]) == "drn"
    with pytest.raises(ValueError):
        backbone_kind(["aspp1"])


# ---- upstream names: load_pretrained_backbone -----------------------------------------

def _oracle(backbone, output_stride):
    from tests.torch_oracle_backbones import TorchAlignedXception, TorchDRN54, TorchMobileNetV2

    torch.manual_seed({"xception": 11, "mobilenet": 10, "drn": 12}[backbone])
    oracle = {"xception": lambda: TorchAlignedXception(output_stride),
              "mobilenet": lambda: TorchMobileNetV2(output_stride),
              "drn": TorchDRN54}[backbone]()
    with torch.no_grad():
        _randomize_bn_stats(oracle, seed=3)
    return oracle.eval()


@pytest.mark.parametrize("backbone,output_stride", DEEPLABS)
def test_upstream_pth_loads_and_gives_the_oracles_outputs(backbone, output_stride, tmp_path,
                                                          jax_deeplab):
    """An upstream-named .pth (with a classifier head, wrapped in
    {"state_dict": ...}) loads into the port's backbone and gives the
    oracle's outputs; zs3_tpu's converter takes the same file to the same
    outputs."""
    oracle = _oracle(backbone, output_stride)
    head = {"fc.weight": torch.zeros(10, 4)} if backbone != "mobilenet" else {
        "classifier.1.weight": torch.zeros(10, 4)}
    pth = tmp_path / f"{backbone}.pth"
    torch.save({"state_dict": {**oracle.state_dict(), **head}}, pth)
    model = DeepLab(backbone=backbone, output_stride=output_stride, num_classes=NUM_CLASSES,
                    dropout=False)
    load_pretrained_backbone(model, str(pth), backbone)
    model.eval()
    _, variables, x, fn = jax_deeplab(backbone, output_stride)
    with torch.no_grad():
        want_high, want_low = oracle(_nchw(x))
        high, low = model.backbone(t(x))
    want_high = want_high.permute(0, 2, 3, 1).numpy()
    want_low = want_low.permute(0, 2, 3, 1).numpy()
    atol_low, atol_high = ATOL[backbone]
    np.testing.assert_allclose(low.numpy(), want_low, atol=atol_low)
    np.testing.assert_allclose(high.numpy(), want_high, atol=atol_high)

    params, stats = convert_backbone(backbone, {**oracle.state_dict(), **head})
    j_high, j_low, _ = fn(graft_encoder(variables, params, stats), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(j_low), want_low, atol=atol_low)
    np.testing.assert_allclose(np.asarray(j_high), want_high, atol=atol_high)


def test_load_pretrained_backbone_refuses_by_name(tmp_path):
    oracle = _oracle("mobilenet", 16)
    model = DeepLab(backbone="mobilenet", num_classes=NUM_CLASSES, dropout=False)
    sd = oracle.state_dict()
    cases = {
        "missing": ({k: v for k, v in sd.items() if k != "features.3.conv.0.weight"},
                    "missing.*features.3.conv.0.weight"),
        "extra": ({**sd, "features.99.weight": torch.zeros(1)}, "unexpected.*features.99.weight"),
        "shape": ({**sd, "features.5.conv.3.weight": torch.zeros(192, 1, 5, 5)},
                  r"features.5.conv.3.weight.*\(192, 1, 5, 5\)"),
    }
    before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    for name, (state, match) in cases.items():
        pth = tmp_path / f"{name}.pth"
        torch.save(state, pth)
        with pytest.raises(ValueError, match=match):
            load_pretrained_backbone(model, str(pth), "mobilenet")
    for key, value in model.backbone.state_dict().items():  # nothing half-loaded
        assert torch.equal(value, before[key]), key
    with pytest.raises(ValueError, match="backbone"):
        load_pretrained_backbone(model, str(tmp_path / "shape.pth"), "drn")
