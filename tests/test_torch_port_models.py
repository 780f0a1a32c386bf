"""Port parity: zs3_tpu_torch models against zs3_tpu on the same weights.

JAX weights (with randomized BN statistics) are carried into the port by
zs3_tpu_torch.utils.convert.state_dict_from_flax; inputs come from a
seeded numpy generator; everything runs in f32 on the CPU.  Tolerances
follow tests/test_torch_parity.py (the JAX package against the torch
oracle): 2e-4 at os4, 2e-3 at os16/os8, 5e-3 on logits, argmax
agreement above 0.999.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zs3_tpu.models.aspp import ASPP as JaxASPP
from zs3_tpu.models.decoder import Decoder as JaxDecoder
from zs3_tpu.models.deeplab import DeepLab as JaxDeepLab
from zs3_tpu.models.resnet import ResNetAtrous as JaxResNet
from zs3_tpu.utils.torch_convert import convert_deeplab_state_dict
from zs3_tpu_torch.models.aspp import ASPP
from zs3_tpu_torch.models.decoder import Decoder
from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.models.layers import conv2d_space_to_batch
from zs3_tpu_torch.models.resnet import ResNetAtrous
from zs3_tpu_torch.utils.convert import state_dict_from_flax
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

LAYERS = (2, 2, 2, 2)


def randomize_bn(variables, seed=0):
    """Random BN scale/shift/mean/var, so every affine term is exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for col in ("params", "batch_stats"):
        flat = flax.traverse_util.flatten_dict(jax.device_get(variables[col]))
        new = {}
        for path, v in flat.items():
            v = np.asarray(v, np.float32)
            if path[-2] == "bn":
                draw = {
                    "scale": lambda s: rng.standard_normal(s) * 0.2 + 1.0,
                    "bias": lambda s: rng.standard_normal(s) * 0.1,
                    "mean": lambda s: rng.standard_normal(s) * 0.1,
                    "var": lambda s: rng.random(s) + 0.5,
                }[path[-1]]
                v = draw(v.shape).astype(np.float32)
            new[path] = v
        out[col] = flax.traverse_util.unflatten_dict(new)
    return out


def under(prefix, variables):
    """Nest a submodule's variables under `prefix` of a DeepLab tree."""
    return {col: {prefix: tree} for col, tree in variables.items()}


def load_sub(module, state_dict, prefix=""):
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    module.load_state_dict(sd)
    return module.eval()


def t(x):
    return torch.from_numpy(np.array(x))


class TinyJaxDeepLab(JaxDeepLab):
    """zs3_tpu's DeepLab with a (2, 2, 2, 2) ResNet encoder."""

    def setup(self):
        bn_kw = dict(bn_momentum=self.bn_momentum, bn_epsilon=self.bn_epsilon)
        self.encoder = JaxResNet(
            layers=LAYERS, output_stride=self.output_stride, dtype=self.dtype, **bn_kw
        )
        self.aspp = JaxASPP(
            output_stride=self.output_stride, dropout=False, dtype=self.dtype, **bn_kw
        )
        self.decoder = JaxDecoder(
            num_classes=self.num_classes, dropout=False, dtype=self.dtype, **bn_kw
        )


@pytest.mark.parametrize("output_stride", [16, 8])
def test_resnet_parity(output_stride, rng):
    x = rng.standard_normal((2, 65, 65, 3)).astype(np.float32)
    jmodel = JaxResNet(layers=LAYERS, output_stride=output_stride)
    variables = randomize_bn(jmodel.init(jax.random.key(0), jnp.asarray(x)), seed=1)
    j_high, j_low = jmodel.apply(variables, jnp.asarray(x), train=False)

    sd = state_dict_from_flax(under("encoder", variables))
    tmodel = load_sub(ResNetAtrous(layers=LAYERS, output_stride=output_stride), sd, "backbone.")
    with torch.no_grad():
        t_high, t_low = tmodel(t(x))
    assert t_low.shape == j_low.shape and t_high.shape == j_high.shape
    np.testing.assert_allclose(t_low.numpy(), np.asarray(j_low), atol=2e-4)
    np.testing.assert_allclose(t_high.numpy(), np.asarray(j_high), atol=2e-3)


@pytest.mark.parametrize("hw", [5, 27])  # 27: the dilated taps land inside
def test_aspp_parity(hw, rng):
    x = rng.standard_normal((2, hw, hw, 64)).astype(np.float32)
    jmodel = JaxASPP(output_stride=16, features=32, dropout=False)
    variables = randomize_bn(jmodel.init(jax.random.key(1), jnp.asarray(x)), seed=2)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))

    sd = state_dict_from_flax(under("aspp", variables))
    tmodel = load_sub(ASPP(64, 16, 32, dropout=False), sd)
    with torch.no_grad():
        got = tmodel(t(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.mark.parametrize(
    "hw,d,k", [((33, 33), 12, 3), ((5, 7), 18, 3), ((9, 9), 2, 3), ((33, 31), 6, 3), ((10, 12), 3, 5)]
)
def test_conv_space_to_batch_is_the_dilated_conv(hw, d, k, rng):
    """The schedule Conv takes from SPACE_TO_BATCH_MIN_DILATION on."""
    x = t(rng.standard_normal((2, *hw, 8)).astype(np.float32)).permute(0, 3, 1, 2)
    w = t(rng.standard_normal((5, 8, k, k)).astype(np.float32))
    b = t(rng.standard_normal(5).astype(np.float32))
    want = F.conv2d(x, w, b, 1, d * (k - 1) // 2, d)
    got = conv2d_space_to_batch(x, w, b, d)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_decoder_features_and_classify_parity(rng):
    aspp_out = rng.standard_normal((2, 5, 5, 256)).astype(np.float32)
    low = rng.standard_normal((2, 17, 17, 256)).astype(np.float32)
    jmodel = JaxDecoder(num_classes=7, dropout=False)
    variables = randomize_bn(
        jmodel.init(jax.random.key(2), jnp.asarray(aspp_out), jnp.asarray(low)), seed=3
    )
    j_feats = jmodel.apply(
        variables, jnp.asarray(aspp_out), jnp.asarray(low), method="features"
    )
    j_logits = jmodel.apply(variables, j_feats, method="classify")

    sd = state_dict_from_flax(under("decoder", variables))
    tmodel = load_sub(Decoder(num_classes=7, dropout=False), sd)
    with torch.no_grad():
        t_feats = tmodel.features(t(aspp_out), t(low))
        t_logits = tmodel.classify(t(np.asarray(j_feats)))
    np.testing.assert_allclose(t_feats.numpy(), np.asarray(j_feats), atol=2e-4)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=2e-4)


@pytest.fixture(scope="module")
def deeplab_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 65, 65, 3)).astype(np.float32)
    jmodel = TinyJaxDeepLab(num_classes=7, dropout=False)
    variables = randomize_bn(jmodel.init(jax.random.key(3), jnp.asarray(x)), seed=4)
    tmodel = DeepLab(num_classes=7, dropout=False, layers=LAYERS)
    tmodel.load_state_dict(state_dict_from_flax(variables))
    return x, jmodel, variables, tmodel.eval()


def test_deeplab_parity(deeplab_pair):
    x, jmodel, variables, tmodel = deeplab_pair
    j_feats = jmodel.apply(variables, jnp.asarray(x), method="forward_features")
    j_logits = jmodel.apply(variables, j_feats, method="classify")
    j_out = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        t_feats = tmodel.forward_features(t(x))
        t_logits = tmodel.classify(t(np.asarray(j_feats)))
        t_out = tmodel(t(x)).numpy()
    assert t_feats.shape == (2, 17, 17, 256)
    np.testing.assert_allclose(t_feats.numpy(), np.asarray(j_feats), atol=2e-4)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=2e-4)
    assert t_out.shape == (2, 65, 65, 7) and t_out.dtype == np.float32
    np.testing.assert_allclose(t_out, j_out, atol=5e-3)
    assert (t_out.argmax(-1) == j_out.argmax(-1)).mean() > 0.999


def test_state_dict_round_trip(deeplab_pair):
    """port state_dict -> zs3_tpu's converter -> the original variables."""
    _, _, variables, tmodel = deeplab_pair
    params, stats = convert_deeplab_state_dict(tmodel.state_dict())
    want = {"params": params, "batch_stats": stats}
    for col in ("params", "batch_stats"):
        a = flax.traverse_util.flatten_dict(want[col])
        b = flax.traverse_util.flatten_dict(variables[col])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_state_dict_names_follow_the_oracle(deeplab_pair):
    """The port's names are the torch oracle's (tests/torch_oracle.py)."""
    from tests.torch_oracle import TorchDeepLab

    oracle = TorchDeepLab(num_classes=7, output_stride=16, layers=LAYERS)
    _, _, _, tmodel = deeplab_pair
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in oracle.state_dict().items()}
    assert got == want
