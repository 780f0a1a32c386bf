"""K1's host side and arithmetic on the CPU: `axis_runs` and `plan`
(zs3_tpu_torch/ops/eval_kernels.py), the kernel's walk over bands and
tiles, its staging and label stores, and a numpy replay of its
arithmetic (csrc/upsample_argmax.cu) against the tap-table replay
`emulate_k1`, the plain version and zs3_tpu's interpreted Pallas kernel.

The kernel blends each output on a pair of source positions (base,
base + 1) of its run, with weight 0 on the one a single-tap output does
not use; the tap-table replay blends on (lo, hi).  For finite logits the
two differ at most in the sign of a zero, so their labels are equal bit
for bit.  Against the plain version and the Pallas kernel, whose dense
products may round in another order, labels may differ only at near-ties
(1e-5 * max(1, |top|), tests/test_torch_port_ops.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_ops import assert_labels_match, emulate_k1
from zs3_tpu.ops.pallas_eval import upsample_argmax as jax_upsample_argmax
from zs3_tpu.ops.resize import _linear_matrix_np as jax_linear_matrix
from zs3_tpu_torch.ops import eval_kernels
from zs3_tpu_torch.ops.eval_kernels import (
    COL_RUN,
    MAX_SHARED_BYTES,
    ROW_GROUP,
    THREADS,
    axis_runs,
    plan,
    predict_labels,
    tap_table,
    upsample_argmax_reference,
)
from zs3_tpu_torch.ops.resize import resize_bilinear
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

AXES = [(129, 513), (9, 33), (11, 45), (33, 9), (1, 4), (17, 65), (4, 4)]


def kernel_values(x: np.ndarray, size, align_corners=True) -> np.ndarray:
    """numpy replay of the kernel's arithmetic: (B, HO, WO, C) f32 values.

    Each output row blends source rows (base, min(base + 1, HI - 1)) of
    its group with its pair weights, for the two source columns of its
    column run; then each output column blends those two with its own.
    Every product and sum is one f32 operation, as __fmul_rn/__fadd_rn."""
    x = np.asarray(x, np.float32)
    _, hi, wi, _ = x.shape
    rows = axis_runs(hi, size[0], align_corners, ROW_GROUP)
    cols = axis_runs(wi, size[1], align_corners, COL_RUN)
    r0 = np.repeat(rows.base, rows.counts)
    r1 = np.minimum(r0 + 1, hi - 1)
    c0 = np.repeat(cols.base, cols.counts)
    c1 = np.minimum(c0 + 1, wi - 1)
    wra, wrb = (rows.weights[:, i][None, :, None, None] for i in (0, 1))
    wca, wcb = (cols.weights[:, i][None, None, :, None] for i in (0, 1))
    top, bottom = x[:, r0], x[:, r1]
    ha = wra * top[:, :, c0] + wrb * bottom[:, :, c0]
    hb = wra * top[:, :, c1] + wrb * bottom[:, :, c1]
    return wca * ha + wcb * hb


def emulate_kernel(x, size, align_corners=True) -> np.ndarray:
    """The kernel's labels: the first maximum of kernel_values."""
    return kernel_values(x, size, align_corners).argmax(-1).astype(np.int32)


def stage_ends(head: int, rows: int, row_bytes: int):
    """The kernel's copy stages of a span starting `head` bytes past a
    16-byte boundary: stage k ends where row k ends, rounded up."""
    ends = [-(-(head + (k + 1) * row_bytes) // 16) * 16 for k in range(rows)]
    return list(np.maximum.accumulate(ends))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_size,out_size", AXES)
def test_axis_runs_rebuild_the_taps(in_size, out_size, align_corners):
    """Runs cover every output once, within their cap; each output's taps
    lie on its run's pair, and its pair weights rebuild the dense matrix."""
    for cap in (ROW_GROUP, COL_RUN):
        runs = axis_runs(in_size, out_size, align_corners, cap)
        assert runs.starts[0] == 0 and (runs.counts >= 1).all() and (runs.counts <= cap).all()
        np.testing.assert_array_equal(runs.starts[1:], np.cumsum(runs.counts)[:-1])
        assert runs.counts.sum() == out_size
        base = np.repeat(runs.base, runs.counts)
        idx, w = tap_table(in_size, out_size, align_corners)
        assert ((idx[0] >= base) & (idx[1] <= base + 1)).all()
        dense = np.zeros((out_size, in_size), np.float32)
        rows = np.arange(out_size)
        np.add.at(dense, (rows, base), runs.weights[:, 0])
        np.add.at(dense, (rows, np.minimum(base + 1, in_size - 1)), runs.weights[:, 1])
        np.testing.assert_array_equal(dense, jax_linear_matrix(in_size, out_size, align_corners))


def test_axis_runs_at_exact_4x():
    """129 -> 513: 128 column runs (the first of 5 columns, then 4 each) and
    257 row groups of 2 (the last, row 512, alone)."""
    cols = axis_runs(129, 513, True, COL_RUN)
    assert len(cols.starts) == 128 and cols.counts[0] == 5 and (cols.counts[1:] == 4).all()
    np.testing.assert_array_equal(cols.base, np.arange(128))
    np.testing.assert_array_equal(cols.weights[:5], [[1, 0], [.75, .25], [.5, .5], [.25, .75],
                                                     [0, 1]])
    rows = axis_runs(129, 513, True, ROW_GROUP)
    assert len(rows.starts) == 257 and rows.counts[-1] == 1 and (rows.counts[:-1] == 2).all()
    np.testing.assert_array_equal(rows.base[:-1], np.arange(256) // 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_size,out_size", AXES)
def test_plan_bands_and_stages(in_size, out_size, align_corners, dtype):
    """Every output row falls in one band; a band stages every source row
    its rows' taps name; its copy stages make rows 0..k whole once stages
    0..k land, in 16-byte units inside the span's allocation; the labels'
    vector stores fit theirs."""
    for bsz, c in ((1, 21), (4, 21), (16, 5), (4, 59)):  # 59: Pascal-Context
        shape, size = (bsz, in_size, 7, c), (out_size, 9)
        layout = plan(shape, size, align_corners, dtype)
        rows = layout["rows"]
        ngroups, per_band = len(rows.starts), layout["groups_per_band"]
        assert layout["bands"] == -(-ngroups // per_band) and layout["ctas"] == bsz * layout["bands"]
        assert layout["threads"] % 32 == 0 and layout["threads"] <= THREADS
        assert layout["smem_bytes"] <= MAX_SHARED_BYTES
        idx, _ = tap_table(in_size, out_size, align_corners)
        row_bytes = 7 * c * (2 if dtype == torch.bfloat16 else 4)
        seen = np.zeros(out_size, int)
        for band in range(layout["bands"]):
            g = np.arange(band * per_band, min((band + 1) * per_band, ngroups))
            first_row, last_row = rows.starts[g[0]], rows.starts[g[-1]] + rows.counts[g[-1]]
            seen[first_row:last_row] += 1
            lo, hi = rows.base[g[0]], min(rows.base[g[-1]] + 1, in_size - 1)
            assert hi - lo + 1 <= layout["staged_rows"]
            assert last_row - first_row <= layout["band_rows"]
            assert lo <= idx[:, first_row:last_row].min() and idx[:, first_row:last_row].max() <= hi
            for head in range(0, 16, 2 if dtype == torch.bfloat16 else 4):
                ends = stage_ends(head, hi - lo + 1, row_bytes)
                assert all(e % 16 == 0 for e in ends)
                assert all(e >= head + (k + 1) * row_bytes for k, e in enumerate(ends))
                assert ends[-1] <= layout["off_lab"] - layout["off_src"]
            for sh in range(4):
                vectors = -(-(sh + (last_row - first_row) * 9) // 4)
                assert layout["off_lab"] + 16 * vectors <= layout["smem_bytes"]
        np.testing.assert_array_equal(seen, 1)


def test_plan_fills_the_card_at_the_eval_batches():
    """At the main path's 129 -> 513: bands of 8 output rows from 3 staged
    source rows, 512 threads, 65 CTAs an image (260 at B=4: two an SM)."""
    for bsz, dtype, smem in ((4, torch.float32, 49_008), (16, torch.float32, 49_008),
                             (4, torch.bfloat16, 32_752)):
        layout = plan((bsz, 129, 129, 21), (513, 513), True, dtype, sm_count=132)
        assert layout["groups_per_band"] == 4 and layout["band_rows"] == 8
        assert layout["staged_rows"] == 3 and layout["threads"] == THREADS
        assert layout["ctas"] == 65 * bsz and layout["smem_bytes"] == smem


@pytest.mark.parametrize(
    "shape,size",
    [((1, 129, 129, 21), (513, 513)), ((1, 129, 129, 59), (513, 513)),
     ((4, 17, 17, 21), (65, 65)), ((2, 9, 11, 7), (33, 45)),
     ((2, 33, 33, 5), (9, 9)), ((1, 1, 5, 3), (4, 5)), ((1, 33, 129, 128), (65, 513))],
)
def test_kernel_walk_writes_every_label_once(shape, size):
    """The kernel's walk: CTA (image, band), thread t -> (group t / runs,
    run (t % runs + 32 group) % runs), a tile of at most 2 x 5 labels at
    lab[sh + row * WO + col]; every label is written once, and each tile's
    source rows are staged before it reads them."""
    bsz, hi, _, _ = shape
    layout = plan(shape, size, True, torch.float32)
    rows, cols = layout["rows"], layout["cols"]
    ngroups, nruns, per_band = len(rows.starts), len(cols.starts), layout["groups_per_band"]
    written = np.zeros((bsz, *size), int)
    for b in range(bsz):
        for band in range(layout["bands"]):
            g0 = band * per_band
            gn = min(per_band, ngroups - g0)
            r0 = rows.base[g0]
            staged = min(rows.base[g0 + gn - 1] + 1, hi - 1) - r0 + 1
            for t in range(gn * nruns):
                g, r = g0 + t // nruns, (t % nruns + 32 * (t // nruns)) % nruns
                assert 0 <= rows.base[g] - r0 and min(rows.base[g] + 1, hi - 1) - r0 < staged
                o, j = rows.starts[g], cols.starts[r]
                written[b, o:o + rows.counts[g], j:j + cols.counts[r]] += 1
    np.testing.assert_array_equal(written, 1)


@pytest.mark.parametrize(
    "bsz,in_hw,out_hw,c",
    [(2, (17, 17), (65, 65), 21), (2, (9, 11), (33, 45), 7), (2, (16, 16), (64, 64), 5),
     (1, (33, 33), (9, 9), 21), (3, (1, 5), (4, 17), 3), (1, (33, 65), (65, 257), 9)],
)
def test_kernel_arithmetic_matches_taps_and_pallas(bsz, in_hw, out_hw, c, rng):
    """The replay of the kernel equals emulate_k1 bit for bit, and zs3_tpu's
    interpreted Pallas kernel and the plain version except at near-ties."""
    logits = rng.standard_normal((bsz, *in_hw, c)).astype(np.float32)
    got = emulate_kernel(logits, out_hw)
    np.testing.assert_array_equal(got, emulate_k1(logits, out_hw))
    want = np.asarray(jax_upsample_argmax(jnp.asarray(logits), out_hw, interpret=True))
    assert_labels_match(got, want, logits, out_hw)
    plain = upsample_argmax_reference(torch.from_numpy(logits), out_hw).numpy()
    assert_labels_match(got, plain, logits, out_hw)


@pytest.mark.parametrize("shape,size", [((2, 9, 11, 7), (33, 45)), ((1, 33, 33, 5), (9, 9))])
def test_kernel_arithmetic_without_align_corners(shape, size, rng):
    logits = rng.standard_normal(shape).astype(np.float32)
    got = emulate_kernel(logits, size, align_corners=False)
    plain = upsample_argmax_reference(torch.from_numpy(logits), size, align_corners=False)
    up = resize_bilinear(torch.from_numpy(logits), size, align_corners=False).numpy()
    top2 = np.sort(up, -1)[..., -2:]
    ties = top2[..., 1] - top2[..., 0] < 1e-5 * np.maximum(1.0, np.abs(top2[..., 1]))
    assert not ((got != plain.numpy()) & ~ties).any()


def test_kernel_first_maximum_wins_across_a_run():
    """All-equal logits give label 0 at every pixel of every tile (runs of
    5 and groups of 4 included), in f32 and from bf16."""
    logits = np.full((2, 17, 17, 6), 0.5, np.float32)
    np.testing.assert_array_equal(emulate_kernel(logits, (65, 65)), 0)
    bf16 = torch.from_numpy(logits).to(torch.bfloat16)
    np.testing.assert_array_equal(predict_labels(bf16, (65, 65)).numpy(), 0)


@pytest.mark.parametrize("shape,size", [((2, 17, 17, 21), (65, 65)), ((2, 9, 11, 7), (33, 45)),
                                        ((1, 33, 33, 5), (9, 9))])
def test_bf16_entry_matches_pallas(shape, size, rng):
    """bf16 logits: predict_labels on the CPU (the plain version, widened
    to f32) and the kernel's replay on the widened values against zs3_tpu's
    interpreted Pallas kernel on the same bf16 values."""
    bf16 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    widened = bf16.float().numpy()
    want = np.asarray(jax_upsample_argmax(jnp.asarray(widened).astype(jnp.bfloat16), size,
                                          interpret=True))
    got = predict_labels(bf16, size)
    assert got.dtype == torch.int32 and tuple(got.shape) == (shape[0], *size)
    assert_labels_match(got.numpy(), want, widened, size)
    np.testing.assert_array_equal(emulate_kernel(widened, size), emulate_k1(widened, size))
    assert_labels_match(emulate_kernel(widened, size), want, widened, size)


@pytest.mark.parametrize("shape,size", [((2, 17, 17, 21), (65, 65)), ((2, 11, 11, 21), (45, 45))])
def test_zs5_restricted_logits(shape, size, rng):
    """ZS5's pseudo-label logits (f32, finfo(float32).min in the classes not
    allowed, zs3_tpu/train/self_training.py:65): the plain version, the
    kernel's replay and the interpreted Pallas kernel choose the same
    allowed classes, and no value overflows to -inf or NaN."""
    allowed = rng.random(shape[-1]) < 0.5
    allowed[0], allowed[-1] = True, False
    logits = rng.standard_normal(shape).astype(np.float32)
    logits[..., ~allowed] = np.finfo(np.float32).min
    values = kernel_values(logits, size)
    assert np.isfinite(values).all()
    got = values.argmax(-1).astype(np.int32)
    assert allowed[got].all()
    np.testing.assert_array_equal(got, emulate_k1(logits, size))
    plain = upsample_argmax_reference(torch.from_numpy(logits), size).numpy()
    assert np.isfinite(resize_bilinear(torch.from_numpy(logits), size).numpy()).all()
    want = np.asarray(jax_upsample_argmax(jnp.asarray(logits), size, interpret=True))
    assert allowed[plain].all() and allowed[want].all()
    assert_labels_match(got, plain, logits, size)
    assert_labels_match(got, want, logits, size)


def test_plan_refuses():
    with pytest.raises(TypeError, match="bfloat16"):
        plan((1, 9, 9, 3), (33, 33), True, torch.float16)
    with pytest.raises(ValueError, match="classes"):
        plan((1, 9, 9, 129), (33, 33))
    with pytest.raises(ValueError, match="shared memory"):
        plan((1, 9, 300, 128), (33, 1197))
    with pytest.raises(ValueError, match="geometry"):
        plan((0, 9, 9, 3), (33, 33))
    assert plan((1, 9, 300, 128), (33, 1197), True, torch.bfloat16)["groups_per_band"] == 1


def test_wrapper_takes_f32_and_bf16_only_on_the_card(rng):
    """On the CPU the wrapper raises for any tensor; predict_labels sends
    f32, bf16 and f16 logits to the plain version (f32 math) and launches
    nothing."""
    logits = torch.from_numpy(rng.standard_normal((1, 5, 5, 3)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = logits.to(dtype)
        with pytest.raises(ValueError, match="CUDA"):
            eval_kernels.upsample_argmax(x, (17, 17))
        np.testing.assert_array_equal(predict_labels(x, (17, 17)).numpy(),
                                      upsample_argmax_reference(x.float(), (17, 17)).numpy())
    assert eval_kernels.upsample_argmax.launches == 0


def test_eval_step_hands_the_model_dtype_to_predict_labels(monkeypatch, rng):
    """The eval step passes the classifier's logits to predict_labels as
    they are (bf16 on the card), with no cast; the confusion is the one
    of their f32 copy."""
    from zs3_tpu_torch.train import seen

    logits = torch.from_numpy(rng.standard_normal((2, 9, 9, 4)).astype(np.float32))

    class Model:
        def __init__(self, dtype):
            self.dtype = dtype

        def forward_features(self, images):
            return images

        def classify(self, feats):
            return logits.to(self.dtype)

    seen_dtypes = []

    def spy(x, size, align_corners=True):
        seen_dtypes.append(x.dtype)
        return predict_labels(x, size, align_corners)

    monkeypatch.setattr(seen, "predict_labels", spy)
    batch = {"image": torch.zeros((2, 33, 33, 3)),
             "label": torch.from_numpy(rng.integers(0, 4, (2, 33, 33)).astype(np.int32))}
    step = seen.make_eval_step(4, 255)
    got = step(Model(torch.bfloat16), batch)
    want = step(Model(torch.float32), {**batch})
    assert seen_dtypes == [torch.bfloat16, torch.float32]
    widened = seen.confusion_matrix(
        batch["label"], predict_labels(logits.to(torch.bfloat16).float(), (33, 33)), 4, 255)
    np.testing.assert_array_equal(got.numpy(), widened.numpy())
    assert got.sum() == want.sum() == 2 * 33 * 33
