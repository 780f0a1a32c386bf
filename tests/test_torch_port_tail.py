"""Kernel K4's plain version, the fused-tail DeepLab, ms+flip TTA and the
evaluate paths that honour it, against zs3_tpu on the CPU.

K4's plain version (`classify_resize_reference`) is held against
zs3_tpu's Pallas kernel run in interpret mode at the shapes of
tests/test_pallas_tail.py (f32 to rtol/atol 1e-5, bf16 to its 0.05).
The models are ResNet-50 (or a 2-2-2-2 ResNet) at 33x33 in f32 on
weights carried by `state_dict_from_flax`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.core.config import TrainConfig as JaxTrainConfig
from zs3_tpu.data.loader import make_data_loader
from zs3_tpu.metrics.evaluator import Evaluator as JaxEvaluator
from zs3_tpu.metrics.tta import make_tta_eval_step as jax_make_tta_eval_step
from zs3_tpu.metrics.tta import tta_probs as jax_tta_probs
from zs3_tpu.models.deeplab import build_deeplab as jax_build_deeplab
from zs3_tpu.ops import pallas_tail
from zs3_tpu.train.seen import make_eval_step as jax_make_eval_step
from zs3_tpu.train.state import create_seg_state
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.data.loader import make_val_loader
from zs3_tpu_torch.metrics import tta
from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.ops import tail_kernels
from zs3_tpu_torch.train.seen import device_batch, evaluate, select_eval_step
from zs3_tpu_torch.utils.convert import state_dict_from_flax

from tests.test_torch_port_models import LAYERS, TinyJaxDeepLab, randomize_bn
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)


def _tail_inputs(seed, bsz, hw, c, k, dtype=np.float32):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((bsz, hw, hw, c)).astype(np.float32)
    w = (rng.standard_normal((c, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((k,)) * 0.1).astype(np.float32)
    return feats, w, b


@pytest.mark.parametrize(
    "bsz,hw,c,k",
    [
        (2, 17, 16, 5),    # crop-65 geometry, odd class count
        (1, 9, 8, 21),     # one band and the clamped last row
        (3, 17, 32, 128),  # K = 128
    ],
)
def test_plain_version_matches_pallas_kernel_f32(bsz, hw, c, k):
    feats, w, b = _tail_inputs(0, bsz, hw, c, k)
    size = (4 * (hw - 1) + 1,) * 2
    assert tail_kernels.supported((hw, hw), size, k)
    want = pallas_tail.classify_resize_fused(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(b), size, interpret=True
    )
    got = tail_kernels.classify_resize_reference(
        torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(b), size
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (bsz, *size, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_version_matches_pallas_kernel_bf16():
    """bf16 features: the output stays bf16; tolerance at bf16 grain, as
    tests/test_pallas_tail.py states it (0.05)."""
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 17, 17, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 7)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((7,)) * 0.1).astype(np.float32)
    jfeats, jw = jnp.asarray(feats, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = pallas_tail.classify_resize_fused(
        jfeats, jw, jnp.asarray(b), (65, 65), interpret=True
    )
    tfeats = torch.from_numpy(np.array(jfeats.astype(jnp.float32))).to(torch.bfloat16)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(torch.bfloat16)
    got = tail_kernels.classify_resize_reference(tfeats, tw, torch.from_numpy(b), (65, 65))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=0.05, atol=0.05
    )


@pytest.mark.parametrize(
    "in_hw,out_hw,k",
    [
        ((129, 129), (513, 513), 21),
        ((129, 129), (513, 512), 21),   # not exact 4x
        ((128, 128), (509, 509), 21),   # (h-1) % 8 != 0
        ((129, 129), (513, 513), 129),  # K > 128
        ((5, 5), (17, 17), 21),         # h <= band
    ],
)
def test_supported_matches_zs3_tpu(in_hw, out_hw, k):
    assert tail_kernels.supported(in_hw, out_hw, k) == pallas_tail.supported(in_hw, out_hw, k)


def test_dispatch_takes_the_plain_version_on_cpu():
    feats, w, b = (torch.from_numpy(a) for a in _tail_inputs(2, 1, 9, 8, 3))
    want = tail_kernels.classify_resize_reference(feats, w, b, (33, 33))
    np.testing.assert_array_equal(
        tail_kernels.tail_logits(feats, w, b, (33, 33)).numpy(), want.numpy()
    )
    with pytest.raises(ValueError, match="CUDA"):
        tail_kernels.classify_resize(feats, w, b, (33, 33))
    assert tail_kernels.classify_resize.launches == 0


# ---- K4's launch layout (the kernel runs only on the card) -----------------------

# chip_smoke.py::phase_tail's shapes (its batch is replaced by 1, 4 and 8).
PHASE_TAIL_SHAPES = [
    ((129, 129, 256, 21), torch.bfloat16), ((129, 129, 256, 21), torch.float32),
    ((97, 97, 256, 21), torch.bfloat16), ((161, 161, 256, 21), torch.bfloat16),
    ((17, 17, 16, 5), torch.float32), ((9, 9, 8, 21), torch.float32),
    ((17, 17, 32, 128), torch.float32), ((17, 23, 30, 21), torch.float32),
    ((17, 17, 16, 7), torch.bfloat16), ((17, 23, 30, 21), torch.bfloat16),
]


def _decode(item, lay, w):
    """The kernel's decode(): (image, first source row, first source
    column, source columns held, output columns written) of an item."""
    per_image = lay["bands"] * lay["tiles"]
    b, rem = divmod(item, per_image)
    t, u = divmod(rem, lay["tiles"])
    tc = lay["tile_cols"]
    ncs = min(tc, w - 1 - u * tc) + 1
    ncols = 4 * (ncs - 1) + 1 if u == lay["tiles"] - 1 else 4 * tc
    return b, 8 * t, u * tc, ncs, ncols


def _walk(shape, k, lay):
    """(CTA, item, rows): each CTA's items in its order, each item's output
    rows as (warp, image, output row, first output column, output
    columns); warp w of the CTA writes rows w, w + 8, ... of the item."""
    _, h, w, _ = shape
    for cta in range(lay["grid"]):
        for item in range(cta, lay["items"], lay["grid"]):
            b, r0, c0, _, ncols = _decode(item, lay, w)
            n_rows = 33 if r0 + 8 == h - 1 else 32
            yield cta, item, [(r % 8, b, 4 * r0 + r, 4 * c0, ncols) for r in range(n_rows)]


def _split(start, run, esize):
    """A run of `run` elements at flat element `start` of an output whose
    base is 16-byte aligned: (head, 16-byte vectors, tail)."""
    vec = 16 // esize
    head = min(run, (16 - start * esize % 16) % 16 // esize)
    nv = (run - head) // vec
    return head, nv, run - head - nv * vec


@pytest.mark.parametrize("bsz", [1, 4, 8])
@pytest.mark.parametrize("hwck,dtype", PHASE_TAIL_SHAPES)
def test_k4_layout_writes_every_output_once(hwck, dtype, bsz):
    """Each item is walked by one CTA, each output row run is written by
    one item, the runs tile the output exactly, and each run's head, 16-byte
    vectors and tail cover it with the vectors on aligned addresses."""
    h, w, c, k = hwck
    shape = (bsz, h, w, c)
    lay = tail_kernels.plan(shape, k, dtype)
    assert lay["tile_cols"] in (4, 8, 16) and 1 <= lay["grid"] <= lay["items"]
    assert lay["smem_bytes"] <= tail_kernels.MAX_SHARED_BYTES
    ho, wo = 4 * (h - 1) + 1, 4 * (w - 1) + 1
    esize = 2 if dtype == torch.bfloat16 else 4
    items, runs = [], []
    for _, item, rows in _walk(shape, k, lay):
        items.append(item)
        for _, b, row, col, ncols in rows:
            start, run = ((b * ho + row) * wo + col) * k, ncols * k
            head, nv, tail = _split(start, run, esize)
            assert head + nv * (16 // esize) + tail == run and tail < 16 // esize
            assert head == run or (start + head) * esize % 16 == 0
            runs.append((start, run))
    assert sorted(items) == list(range(lay["items"]))
    runs.sort()
    ends = np.cumsum([0] + [n for _, n in runs])
    assert [s for s, _ in runs] == list(ends[:-1])
    assert ends[-1] == bsz * ho * wo * k


@pytest.mark.parametrize(
    "shape,k,ctas,want",
    [
        ((8, 129, 129, 256), 21, {16: 2, 8: 3}, 16),  # the main path: 1024 items
        ((1, 129, 129, 256), 21, {16: 2, 8: 3}, 8),   # one request: 128 items of 16
        ((4, 97, 97, 256), 21, {16: 2, 8: 3}, 8),     # TTA 0.75: 288 items of 16
        ((4, 161, 161, 256), 21, {16: 2, 8: 3}, 16),  # TTA 1.25: 800 items of 16
        ((4, 161, 161, 256), 21, {16: 4, 8: 3}, 8),   # a card with more room
        ((8, 129, 129, 256), 64, {8: 2, 4: 3}, 8),    # the staged rows grow with K
        ((8, 129, 129, 256), 128, {4: 1}, 4),
    ],
)
def test_k4_tile_cols(shape, k, ctas, want):
    """The widest tile the classes allow, halved when its items fill the
    grid less than twice."""
    assert tail_kernels.tile_cols(shape, k, 132, ctas) == want
    lay = tail_kernels.plan(shape, k, torch.bfloat16, 132, ctas)
    assert lay["tile_cols"] == want
    assert lay["grid"] == min(lay["items"], 132 * ctas[want])


def test_k4_plan_refuses():
    with pytest.raises(ValueError, match="geometry"):
        tail_kernels.plan((1, 16, 16, 8), 21, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        tail_kernels.plan((1, 17, 17, 2048), 128, torch.bfloat16)
    with pytest.raises(TypeError):
        tail_kernels.plan((1, 17, 17, 8), 21, torch.float16)
    assert tail_kernels.plan((8, 129, 129, 256), 21, torch.bfloat16)["route"] == "tma"
    assert tail_kernels.plan((2, 17, 23, 30), 21, torch.bfloat16)["route"] == "loads"
    assert tail_kernels.plan((2, 17, 23, 30), 21, torch.float32)["route"] == "fma"


def _emulate_k4(feats, w, b, lay):
    """The kernel's work in torch: per item, the source logits in f32 (the
    bf16 route rounds w and b first); per output row 4q + p, each (source
    column cq, class k) pair blends rows q and q + 1 (H), then writes its
    up to four output columns 4cq + s (W) into a staged copy of the row
    at the row's address modulo 16, copied out as head, 16-byte vectors
    and tail.  Returns the output and how many times each element was
    written."""
    bsz, h, wi, c = feats.shape
    k = w.shape[1]
    ho, wo = 4 * (h - 1) + 1, 4 * (wi - 1) + 1
    dtype = feats.dtype
    esize = feats.element_size()
    vec = 16 // esize
    w32, b32 = w.to(dtype).float(), b.to(dtype).float()
    out = torch.full((bsz * ho * wo * k,), float("nan"), dtype=dtype)
    writes = torch.zeros(out.shape, dtype=torch.int32)
    tc = lay["tile_cols"]
    for _, item, rows in _walk(tuple(feats.shape), k, lay):
        bi, r0, c0, ncs, ncols = _decode(item, lay, wi)
        src = torch.zeros(9, tc + 1, c)
        src[:, :ncs] = feats[bi, r0:r0 + 9, c0:c0 + ncs].float()
        logits = src @ w32 + b32  # L (9, tc + 1, K)
        pair = torch.arange((ncols + 3) // 4 * k)
        cq, kk = pair // k, pair % k
        ns = (ncols - 4 * cq).clamp(max=4)
        for _, _, row, col, _ in rows:
            q, p = divmod(row - 4 * r0, 4)
            lo, hi = logits[q], logits[min(q + 1, 8)]
            cr = (cq + 1).clamp(max=tc)
            ha = (1 - p / 4) * lo[cq, kk] + (p / 4) * hi[cq, kk] if p else lo[cq, kk]
            hb = (1 - p / 4) * lo[cr, kk] + (p / 4) * hi[cr, kk] if p else lo[cr, kk]
            start = ((bi * ho + row) * wo + col) * k
            phase = start * esize % 16 // esize
            staged = torch.zeros(phase + ncols * k, dtype=dtype)
            for sw in range(4):
                on = ns > sw
                v = (1 - sw / 4) * ha + (sw / 4) * hb if sw else ha
                staged[phase + ((4 * cq + sw) * k + kk)[on]] = v[on].to(dtype)
            head, nv, tail = _split(start, ncols * k, esize)
            for a, z in [(0, head), (head, head + nv * vec), (head + nv * vec, ncols * k)]:
                out[start + a:start + z] = staged[phase + a:phase + z]
                writes[start + a:start + z] += 1
    return out.view(bsz, ho, wo, k), writes


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((2, 17, 17, 16, 5), torch.float32),
        ((1, 9, 9, 8, 21), torch.float32),
        ((2, 17, 23, 30, 21), torch.float32),
        ((2, 17, 17, 16, 7), torch.bfloat16),
        ((2, 17, 23, 30, 21), torch.bfloat16),
    ],
)
def test_k4_emulated_layout_matches_plain_version(shape, dtype):
    """The kernel's mapping emulated in torch writes every element once
    and equals the plain version: f32 to 1e-5; bf16 to one bf16 rounding
    of the f32 result (the plain version rounds after each product)."""
    bsz, h, wi, c, k = shape
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal((bsz, h, wi, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, k)) * 0.2).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(k) * 0.1).astype(np.float32))
    feats = feats.to(dtype)
    lay = tail_kernels.plan(feats.shape, k, dtype, 4, {tc: 1 for tc in tail_kernels.TILE_COLS})
    got, writes = _emulate_k4(feats, w, b, lay)
    assert bool((writes == 1).all())
    size = (4 * (h - 1) + 1, 4 * (wi - 1) + 1)
    want = tail_kernels.classify_resize_reference(
        feats.float(), w.to(dtype).float(), b.to(dtype).float(), size)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want.to(dtype).float().numpy(),
                                   rtol=2 ** -7, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 33, 33, 3)).astype(np.float32)
    jmodel = TinyJaxDeepLab(num_classes=6, dropout=False, fused_tail=True)
    variables = randomize_bn(jmodel.init(jax.random.key(5), jnp.asarray(x)), seed=6)
    sd = state_dict_from_flax(variables)
    fused = DeepLab(num_classes=6, dropout=False, layers=LAYERS, fused_tail=True)
    standard = DeepLab(num_classes=6, dropout=False, layers=LAYERS)
    fused.load_state_dict(sd)
    standard.load_state_dict(sd)
    return x, jmodel, variables, fused.eval(), standard.eval()


def test_fused_tail_deeplab_matches_zs3_tpu_and_the_standard_tail(tiny_pair):
    """33x33 input -> 9x9 features: the exact-4x geometry, so the fused
    tail is taken (its plain version on the CPU); logits within 5e-3 of
    zs3_tpu's fused-tail model (tests/test_torch_port_models.py's
    tolerance) and within 1e-5 of the port's standard tail."""
    x, jmodel, variables, fused, standard = tiny_pair
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = fused(torch.from_numpy(x)).numpy()
        base = standard(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 33, 33, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999
    np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-5)
    assert tail_kernels.classify_resize.launches == 0


def test_fused_tail_keeps_the_standard_tail_in_training(tiny_pair):
    """Training mode and unsupported geometries take the standard,
    differentiable tail, as zs3_tpu's __call__ does."""
    import copy

    _, _, _, fused, standard = tiny_pair
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 29, 29, 3)))
    with torch.no_grad():  # 29x29 -> 8x8 features: not 8-row bands
        np.testing.assert_array_equal(fused(x.float()).numpy(), standard(x.float()).numpy())
    model = copy.deepcopy(fused).train()  # training updates the BN statistics
    model(torch.ones((2, 33, 33, 3))).square().sum().backward()
    assert model.classifier.weight.grad is not None


def test_tta_probs_match_zs3_tpu(tiny_pair):
    x, jmodel, variables, fused, _ = tiny_pair
    want = jax_tta_probs(
        lambda v, xx: jmodel.apply(v, xx), variables, jnp.asarray(x),
        scales=(0.75, 1.0), flip=True,
    )
    with torch.no_grad():
        got = tta.tta_probs(fused, torch.from_numpy(x), (0.75, 1.0), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def r50_tta(tmp_path_factory):
    """zs3_tpu's R50 (randomized BN) at 33x33 with its weights saved as a
    port state_dict, and a TTA config both packages read."""
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="resnet50", compute_dtype="float32", dropout=False),
        data=JaxDataConfig(
            dataset="synthetic", crop_size=33, base_size=33, eval_batch_size=8,
            unseen_classes=(10, 14), num_workers=1,
        ),
        train=JaxTrainConfig(eval_scales=(0.75, 1.0), eval_flip=True),
    )
    jmodel = jax_build_deeplab(jcfg.model)
    state = create_seg_state(jmodel, jcfg, jax.random.key(0), (1, 33, 33, 3), 1)
    variables = randomize_bn(state.eval_variables(), seed=7)
    path = tmp_path_factory.mktemp("r50") / "r50.pt"
    torch.save(state_dict_from_flax(variables), path)
    cfg = Config.from_json(jcfg.to_json())
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, resume=str(path), checkpoint_dir=str(tmp_path_factory.mktemp("run"))))
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    return jcfg, jmodel, state, variables, cfg


@pytest.fixture(scope="module")
def jax_confusions(r50_tta):
    """(classes, TTA confusions, single-scale confusions) of zs3_tpu over
    the val set."""
    jcfg, jmodel, state, variables, _ = r50_tta
    _, jax_val, n = make_data_loader(jcfg.data)
    jax_tta = jax_make_tta_eval_step(
        lambda v, xx: jmodel.apply(v, xx, train=False), n, 255, (0.75, 1.0), True
    )
    jax_single = jax_make_eval_step(n, 255)
    tta_conf = [np.asarray(jax_tta(variables, b)).astype(np.int64) for b in jax_val]
    single = [np.asarray(jax_single(state, b)).astype(np.int64) for b in jax_val]
    return n, tta_conf, single


def test_evaluate_honours_eval_scales_and_eval_flip(r50_tta, jax_confusions):
    """The port's evaluate runs ms+flip TTA when the config asks for it
    (zs3_tpu/train/seen.py:311-325): its metrics are those of zs3_tpu's
    make_tta_eval_step over the same val batches, which differ from the
    single-scale ones it reported before."""
    jcfg, _, _, _, cfg = r50_tta
    n, tta_conf, single = jax_confusions
    want_eval = JaxEvaluator(n, 255, jcfg.data.unseen_classes)
    single_eval = JaxEvaluator(n, 255, jcfg.data.unseen_classes)
    for a, b in zip(tta_conf, single):
        want_eval.add_confusion(a)
        single_eval.add_confusion(b)
    want = want_eval.compute().as_dict()
    assert want != single_eval.compute().as_dict()
    got = evaluate(cfg, device="cpu")
    assert got.keys() == want.keys() and "harmonic_miou" in got
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-9, key


def test_tta_eval_step_confusions_match_zs3_tpu(r50_tta, jax_confusions):
    """Batch by batch, the TTA step `select_eval_step` gives for that
    config yields zs3_tpu's confusion matrices exactly."""
    _, _, _, _, cfg = r50_tta
    n, tta_conf, _ = jax_confusions
    val, _ = make_val_loader(cfg.data)
    step = select_eval_step(n, 255, cfg.train)
    model = DeepLab(backbone="resnet50", num_classes=n, dropout=False)
    model.load_state_dict(torch.load(cfg.train.resume, weights_only=True))
    model.eval()
    for batch, want in zip(val, tta_conf):
        np.testing.assert_array_equal(step(model, device_batch(batch, "cpu")).numpy(), want)


def test_evaluate_refuses_int8_eval(r50_tta):
    """int8_eval was refused until the port had quantization.  Now the
    eval step refuses it only without calibrated scales (it never runs
    in float), and `evaluate` (single-scale here: the TTA step runs int8
    in test_gmmn_trainer_validates_under_tta) calibrates once on the
    first 2 val batches and validates under those scales."""
    from zs3_tpu_torch.train.seen import SeenTrainer, calibrate_on_val

    _, _, _, _, cfg = r50_tta
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, int8_eval=True, eval_scales=(1.0,),
                                                eval_flip=False),
                      data=dataclasses.replace(cfg.data, eval_batch_size=2))
    with pytest.raises(ValueError, match="int8_eval"):
        select_eval_step(21, 255, cfg.train)
    trainer = SeenTrainer(cfg, device="cpu")
    report = trainer.validate(epoch=0)
    scales = trainer.int8_scales()
    assert len(scales) == 61 and trainer.int8_scales() is scales  # calibrated once
    assert calibrate_on_val(trainer.model, trainer.val_loader, torch.device("cpu")) == scales
    assert np.isfinite(report["miou"]) and 0.0 <= report["pixel_accuracy"] <= 1.0


def test_gmmn_trainer_validates_under_tta(r50_tta):
    """GMMNTrainer no longer refuses TTA: its validation runs the TTA step
    on the spliced classifier (zs3_tpu/train/gmmn.py:495-505), whose
    confusion equals the TTA step on the model itself."""
    from zs3_tpu_torch.train.gmmn import GMMNTrainer

    _, _, _, _, cfg = r50_tta
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=4))
    trainer = GMMNTrainer(cfg, device="cpu")
    batch = device_batch(next(iter(trainer.val_loader)), "cpu")
    want = tta.make_tta_eval_step(trainer.num_classes, 255, (0.75, 1.0), True)(
        trainer.model, batch
    )
    got = trainer.eval_fn(trainer.model, trainer.step.cls, batch)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # int8_eval, refused here until the port had quantization: the TTA step
    # runs under the trunk's scales.
    from zs3_tpu_torch import quant

    int8 = GMMNTrainer(cfg.replace(train=dataclasses.replace(cfg.train, int8_eval=True),
                                   data=dataclasses.replace(cfg.data, eval_batch_size=2)),
                       device="cpu")
    scales = int8.trunk_int8_scales()
    batch = {k: v[:2] for k, v in batch.items()}
    with quant.quantized(scales):
        want = tta.make_tta_eval_step(int8.num_classes, 255, (0.75, 1.0), True)(
            int8.model, batch)
    got = int8.eval_fn(int8.model, int8.step.cls, batch)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
