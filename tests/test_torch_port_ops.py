"""Port parity of the ops and metrics: resize, K1's plain version and its
tap tables, confusion_matrix and Evaluator, against zs3_tpu on the same
seeded numpy inputs.

K1's labels must equal zs3_tpu's interpreted Pallas kernel except at
near-ties: pixels where the top two upsampled logits differ by less than
1e-5 * max(1, |top|), since products taken in another order (FMA or
not) can flip a one-ulp tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs3_tpu.metrics.evaluator import Evaluator as JaxEvaluator
from zs3_tpu.ops.confusion import confusion_matrix as jax_confusion_matrix
from zs3_tpu.ops.pallas_eval import upsample_argmax as jax_upsample_argmax
from zs3_tpu.ops.resize import _linear_matrix_np as jax_linear_matrix
from zs3_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from zs3_tpu.ops.resize import resize_nearest as jax_resize_nearest
from zs3_tpu_torch.metrics.evaluator import Evaluator
from zs3_tpu_torch.ops.confusion import confusion_matrix
from zs3_tpu_torch.ops.eval_kernels import (
    predict_labels,
    tap_table,
    upsample_argmax_reference,
)
from zs3_tpu_torch.ops.resize import _linear_matrix_np, resize_bilinear, resize_nearest
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)


def near_tie_mask(up: np.ndarray) -> np.ndarray:
    """Pixels whose top-2 upsampled logits are within 1e-5*max(1,|top|)."""
    top2 = np.sort(up, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    return gap < 1e-5 * np.maximum(1.0, np.abs(top2[..., 1]))


def assert_labels_match(got, want, logits, size):
    up = resize_bilinear(torch.from_numpy(logits), size).numpy()
    diff = np.asarray(got) != np.asarray(want)
    assert not (diff & ~near_tie_mask(up)).any(), f"{diff.sum()} labels differ"


def emulate_k1(logits: np.ndarray, size) -> np.ndarray:
    """numpy replay of csrc/upsample_argmax.cu's arithmetic from the tap
    tables: blend along H, then along W, each tap fl(fl(w*a) + fl(w*b)),
    then a strict-greater argmax over classes."""
    _, hi, wi, _ = logits.shape
    (h_idx, h_w), (w_idx, w_w) = tap_table(hi, size[0], True), tap_table(wi, size[1], True)
    rows = h_w[0][None, :, None, None] * logits[:, h_idx[0]] \
        + h_w[1][None, :, None, None] * logits[:, h_idx[1]]
    up = w_w[0][None, None, :, None] * rows[:, :, w_idx[0]] \
        + w_w[1][None, None, :, None] * rows[:, :, w_idx[1]]
    return up.argmax(-1).astype(np.int32)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize(
    "shape,size", [((2, 9, 11, 5), (33, 45)), ((1, 17, 17, 3), (65, 65)),
                   ((2, 33, 21, 4), (9, 7)), ((1, 1, 5, 2), (4, 5))]
)
def test_resize_bilinear_parity(shape, size, align_corners, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_resize_bilinear(jnp.asarray(x), size, align_corners))
    got = resize_bilinear(torch.from_numpy(x), size, align_corners).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(
        _linear_matrix_np(shape[1], size[0], align_corners),
        jax_linear_matrix(shape[1], size[0], align_corners),
    )
    hwc = resize_bilinear(torch.from_numpy(x[0]), size, align_corners).numpy()
    np.testing.assert_allclose(hwc, want[0], atol=1e-6)


@pytest.mark.parametrize("shape,size", [((2, 9, 11), (33, 45)), ((3, 20, 20, 2), (7, 5))])
def test_resize_nearest_parity(shape, size, rng):
    x = rng.integers(0, 21, shape).astype(np.int32)
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), size))
    got = resize_nearest(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_size,out_size", [(129, 513), (17, 65), (11, 45), (1, 4), (9, 9), (33, 9)])
def test_tap_table_rebuilds_the_matrix(in_size, out_size):
    """K1 reads compact tap tables; they must encode the dense matrix."""
    idx, w = tap_table(in_size, out_size, True)
    dense = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(dense, (rows, idx[0]), w[0])
    np.add.at(dense, (rows, idx[1]), w[1])
    np.testing.assert_array_equal(dense, jax_linear_matrix(in_size, out_size, True))


@pytest.mark.parametrize(
    "bsz,in_hw,out_hw,c",
    [(2, (17, 17), (65, 65), 21), (2, (9, 11), (33, 45), 7),
     (2, (16, 16), (64, 64), 5), (1, (17, 17), (65, 65), 3),
     (17, (9, 9), (33, 33), 5), (23, (9, 9), (33, 33), 5)],
)
def test_k1_plain_and_taps_match_jax_kernel(bsz, in_hw, out_hw, c, rng):
    """Shapes of tests/test_pallas_eval.py: rows that do not divide the
    Pallas tile (65), and batches of 17 and 23 that it chunks."""
    logits = rng.standard_normal((bsz, *in_hw, c)).astype(np.float32)
    want = np.asarray(jax_upsample_argmax(jnp.asarray(logits), out_hw, interpret=True))
    got = upsample_argmax_reference(torch.from_numpy(logits), out_hw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (bsz, *out_hw)
    assert_labels_match(got.numpy(), want, logits, out_hw)
    assert_labels_match(emulate_k1(logits, out_hw), want, logits, out_hw)


def test_k1_tie_breaking():
    """Equal logits everywhere -> the first class wins, as in jnp.argmax."""
    logits = np.zeros((1, 8, 8, 4), np.float32)
    want = np.asarray(jax_upsample_argmax(jnp.asarray(logits), (16, 16), interpret=True))
    np.testing.assert_array_equal(want, 0)
    np.testing.assert_array_equal(predict_labels(torch.from_numpy(logits), (16, 16)).numpy(), 0)
    np.testing.assert_array_equal(emulate_k1(logits, (16, 16)), 0)


def _labels(rng, shape, num_classes):
    gt = rng.integers(0, num_classes, shape).astype(np.int32)
    gt[rng.random(shape) < 0.1] = 255
    gt[rng.random(shape) < 0.02] = num_classes + 3  # out of range: dropped
    pred = rng.integers(-2, num_classes + 2, shape).astype(np.int32)  # clipped
    return gt, pred


def test_confusion_matrix_exact(rng):
    gt, pred = _labels(rng, (3, 37, 41), 21)
    want = np.asarray(jax_confusion_matrix(jnp.asarray(gt), jnp.asarray(pred), 21, 255))
    got = confusion_matrix(torch.from_numpy(gt), torch.from_numpy(pred), 21, 255)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.sum() == ((gt != 255) & (gt < 21)).sum()
    with pytest.raises(ValueError):
        confusion_matrix(torch.from_numpy(gt), torch.from_numpy(pred[:1]), 21)


@pytest.mark.parametrize("unseen", [(), (10, 14)])
def test_evaluator_parity(unseen, rng):
    ref = JaxEvaluator(21, 255, unseen)
    port = Evaluator(21, 255, unseen)
    for _ in range(3):
        gt, pred = _labels(rng, (2, 33, 33), 21)
        hit = rng.random(pred.shape) < 0.5  # make the IoUs non-trivial
        pred[hit] = gt.clip(0, 20)[hit]
        ref.add_batch(jnp.asarray(gt), jnp.asarray(pred))
        port.add_batch(torch.from_numpy(gt), torch.from_numpy(pred))
    np.testing.assert_array_equal(port.confusion, ref.confusion.astype(np.int64))
    want, got = ref.compute().as_dict(), port.compute().as_dict()
    assert want.keys() == got.keys()
    assert ("harmonic_miou" in got) == bool(unseen)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-9, key
