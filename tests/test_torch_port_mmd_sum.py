"""K2's host side and its arithmetic, on the CPU.

The CUDA kernel (csrc/mmd_kernel_sum.cu, kernel_sum_3xtf32) runs only on
the card.  What can be held here:

* `sum_plan` and the kernel's walk over it: at every shape chip_smoke.py's
  mmd phase runs and at D = 512, the CTAs of a class take every (x tile,
  y tile) pair once, or under `symmetric` every unordered pair once,
  counted twice off the diagonal; the main path's grid fills the card.
* the 3xTF32 arithmetic: the kernel's x.y^T emulated in plain torch, with
  its rounding of each f32 operand to a TF32 high part and a TF32
  residual, summed in the kernel's two orders (every pair; the pairs
  a <= b of a symmetric call), against zs3_tpu's `_kernel_sum_impl` in
  interpret mode at the rtol chip_smoke.py's `check_k2_k3` holds the
  kernel to.  One TF32 product alone holds the sums there, barely where x
  is y, but not the sqrt-MMD that assembles them.

The kernel reads its tiles with K3's fragment loads and K3's epilogue
pattern (tests/test_torch_port_mmd_grad.py pins their banks); its own
sums go through shuffles and registers, so it adds no shared-memory
pattern to pin.
"""

import numpy as np
import pytest
import torch

from zs3_tpu.ops.pallas_mmd import _kernel_sum_impl, _prepare
from zs3_tpu_torch.ops import mmd_kernels
from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

SIGMAS = DEFAULT_SIGMAS
MMD_SHAPES = [  # chip_smoke.py's phase_mmd, and the widest D the kernel takes
    (21, 128, 128, 256),
    (59, 128, 128, 256),  # a Pascal-Context step
    (21, 512, 512, 256),
    (21, 2048, 2048, 256),
    (3, 50, 70, 16),
    (2, 33, 45, 30),
    (2, 40, 40, 16),
    (4, 96, 96, 64),
    (21, 128, 128, 512),
]
SQUARE = [s for s in MMD_SHAPES if s[1] == s[2]]


def _ids(s):
    return "x".join(map(str, s))


# ---- the plan ---------------------------------------------------------------


def _pair_at(p, ty, sym):
    """The kernel's pair_at: pair p of a class's walk."""
    if not sym:
        return p // ty, p % ty
    a = 0
    while p >= ty - a:
        p -= ty - a
        a += 1
    return a, a + p


def _walk(plan):
    """The kernel's walk as the plan lays it out: for each CTA k of a class,
    the (x tile, y tile) pairs it takes, stepping as next_pair does from
    pair P k / split to P (k + 1) / split."""
    pairs, split, ty, sym = plan["pairs"], plan["split"], plan["y_tiles"], plan["symmetric"]
    for k in range(split):
        p0 = pairs * k // split
        mine = pairs * (k + 1) // split - p0
        a, b = _pair_at(p0, ty, sym)
        taken = []
        for _ in range(mine):
            taken.append((a, b))
            b += 1
            if b == ty:
                a += 1
                b = a if sym else 0
        yield k, taken


@pytest.mark.parametrize("shape", MMD_SHAPES, ids=_ids)
def test_sum_plan_takes_every_pair_once(shape):
    c, n, m, d = shape
    plan = mmd_kernels.sum_plan(c, n, m, d)
    assert plan["grid"] == (plan["split"], c) and plan["ctas"] == plan["split"] * c
    assert plan["smem_bytes"] <= 227 * 1024
    assert plan["ctas_per_sm"] * (plan["smem_bytes"] + 1024) <= 228 * 1024
    count = np.zeros((plan["x_tiles"], plan["y_tiles"]), int)
    longest = 0
    for _, taken in _walk(plan):
        assert taken, "every CTA takes a pair"
        longest = max(longest, len(taken))
        for a, b in taken:
            count[a, b] += 1
    assert (count == 1).all()
    assert longest == plan["pairs_per_cta"]
    # Tiles cover the rows: the last one reaches past n and m, by under a tile.
    assert 0 <= plan["x_tiles"] * plan["rows"] - n < plan["rows"]
    assert 0 <= plan["y_tiles"] * plan["rows"] - m < plan["rows"]


@pytest.mark.parametrize("shape", SQUARE, ids=_ids)
def test_symmetric_plan_takes_every_unordered_pair_once(shape):
    c, n, _, d = shape
    plan = mmd_kernels.sum_plan(c, n, n, d, symmetric=True)
    t = plan["y_tiles"]
    assert plan["pairs"] == t * (t + 1) // 2
    # Each pair the kernel takes, with the weight it gives it (2 off the
    # diagonal), stands for the ordered pairs (a, b) and (b, a).
    weight = np.zeros((t, t), int)
    for _, taken in _walk(plan):
        assert taken
        for a, b in taken:
            assert a <= b
            weight[a, b] += 2 if a != b else 1
    want = 2 * np.triu(np.ones((t, t), int), 1) + np.eye(t, dtype=int)
    np.testing.assert_array_equal(weight, want)


def test_sum_plan_fills_the_card_at_the_main_shape():
    plan = mmd_kernels.sum_plan(21, 128, 128, 256)
    assert plan["ctas"] >= mmd_kernels.SM_COUNT
    assert plan["ctas"] <= mmd_kernels.SM_COUNT * plan["ctas_per_sm"]  # one wave
    assert (plan["split"], plan["pairs_per_cta"], plan["ctas"]) == (8, 2, 168)
    sym = mmd_kernels.sum_plan(21, 128, 128, 256, symmetric=True)
    assert (sym["pairs"], sym["pairs_per_cta"], sym["ctas"]) == (10, 1, 210)
    # Two CTAs an SM by shared memory, as K3's.
    assert plan["ctas_per_sm"] == 2
    assert plan["smem_bytes"] == mmd_kernels.grad_smem_bytes(256) + 4 * 8
    # The budgets fill the card in one wave of runs of equal length.
    for budget in (512, 2048):
        big = mmd_kernels.sum_plan(21, budget, budget, 256)
        assert mmd_kernels.SM_COUNT <= big["ctas"] <= 2 * mmd_kernels.SM_COUNT


@pytest.mark.parametrize(
    "shape, symmetric",
    [((21, 128, 128, 0), False), ((21, 128, 128, 513), False), ((0, 128, 128, 256), False),
     ((21, 128, 96, 256), True)],
    ids=["no features", "D over 512", "no classes", "symmetric with N != M"],
)
def test_sum_plan_refuses(shape, symmetric):
    with pytest.raises(ValueError):
        mmd_kernels.sum_plan(*shape, symmetric=symmetric)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_sum_operands_stay_one_tensor_when_both_sides_are_one(dtype):
    """KernelSum converts its operands to contiguous f32 before K2 sees
    them; the fake-fake and real-real sums pass one tensor for both sides
    (here strided, as sampled features can be) and K2's symmetric call
    needs them to stay one tensor after the conversion."""
    feats = torch.randn(3, 16, 40, dtype=dtype)[:, :, ::2]
    w = torch.ones(3, 16, dtype=dtype)
    x, y, wx, wy = mmd_kernels._operands(feats, feats, w, w, same=True)
    assert y is x and wy is wx
    assert x.dtype == wx.dtype == torch.float32 and x.is_contiguous() and wx.is_contiguous()
    torch.testing.assert_close(x, feats.float())
    other = torch.randn(3, 16, 20, dtype=dtype)
    x, y, wx, wy = mmd_kernels._operands(feats, other, w, w.clone(), same=False)
    assert y is not x and y.dtype == torch.float32 and y.is_contiguous()
    torch.testing.assert_close(y, other.float())


# ---- the 3xTF32 arithmetic -------------------------------------------------------


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: to 10 mantissa bits, to nearest, ties away from zero
    (on the f32 bit pattern: add half of the 13 dropped bits' unit to the
    magnitude, then clear them)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(a):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _product(a, b, terms):
    """a @ b as the kernel's mma.sync computes it: three TF32 products (the
    cross terms, then hi.hi), or one."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_terms(x, y, wx, wy, terms):
    """K2's (C, N, M) terms wx_i wy_j K_ij: exact f32 norms, d2,
    exponentials and weights; x.y^T in TF32 parts."""
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1)[..., None, :]
    d2 = torch.clamp(x2 + y2 - 2.0 * _product(x, y.transpose(-1, -2), terms), min=0.0)
    k = torch.zeros_like(d2)
    for s in SIGMAS:
        k = k + torch.exp(d2 * (-1.0 / (2.0 * s)))
    return (wx[..., :, None] * k) * wy[..., None, :]


def _emulated_sum(x, y, wx, wy, terms, symmetric=False):
    """K2's sums in the kernel's order of tile pairs: every pair, or the
    pairs a <= b of 32 x 32 rows, each off the diagonal twice."""
    if not symmetric:
        return _emulated_terms(x, y, wx, wy, terms).sum((-1, -2))
    n = x.shape[1]
    out = torch.zeros(x.shape[0])
    for a in range(0, n, 32):
        for b in range(a, n, 32):
            t = _emulated_terms(x[:, a:a + 32], y[:, b:b + 32], wx[:, a:a + 32],
                                wy[:, b:b + 32], terms).sum((-1, -2))
            out = out + (2.0 if a != b else 1.0) * t
    return out


def _pallas_sum(x, y, wx, wy):
    return torch.tensor([
        float(_kernel_sum_impl(*_prepare(x[k], y[k], wx[k], wy[k]), SIGMAS, True))
        for k in range(x.shape[0])
    ])


@pytest.fixture(scope="module")
def sums():
    """mmd_inputs-like data at (2, 128, 128, 256) (post-ReLU features, 0/1
    masks) and the interpreted Pallas sums, for x against y and x against
    itself."""
    rng = np.random.default_rng(9)
    c, n, m, d = 2, 128, 128, 256
    x = np.maximum(rng.standard_normal((c, n, d)), 0).astype(np.float32)
    y = np.maximum(rng.standard_normal((c, m, d)) + 0.2, 0).astype(np.float32)
    wx = (rng.random((c, n)) > 0.3).astype(np.float32)
    wy = (rng.random((c, m)) > 0.3).astype(np.float32)
    return {
        "x vs y": ([torch.from_numpy(a) for a in (x, y, wx, wy)], _pallas_sum(x, y, wx, wy)),
        "x is y": ([torch.from_numpy(a) for a in (x, x, wx, wx)], _pallas_sum(x, x, wx, wx)),
    }


@pytest.mark.parametrize(
    "case, symmetric",
    [("x vs y", False), ("x is y", False), ("x is y", True)],
    ids=["x vs y, every pair", "x is y, every pair", "x is y, pairs a <= b"],
)
def test_3xtf32_sums_match_pallas(sums, case, symmetric):
    t, want = sums[case]
    got = _emulated_sum(*t, terms=3, symmetric=symmetric)
    # check_k2_k3's tolerance on the sums, held with room to spare.
    rel = ((got - want).abs() / want.abs()).max()
    assert float(rel) <= 1e-5, float(rel)


def test_one_tf32_term_holds_the_sums_but_not_the_loss(sums):
    """A single TF32 product rounds x_i.x_j by about 2^-11 of |x_i||x_j|:
    where x is y, d2 on and near the diagonal moves against its size, and
    the largest terms with it.  The sums still stay inside rtol 1e-4 here
    (by under 2x, against 300x for three terms), but the sqrt-MMD that
    assembles them cancels: one term moves it outside the rtol 1e-4 that
    chip_smoke.py holds the loss to, three terms stay 100x inside."""
    from zs3_tpu_torch.ops.mmd import assemble_sqrt_mmd

    (x, y, wx, wy), want_xy = sums["x vs y"]
    _, want_xx = sums["x is y"]
    want_yy = _pallas_sum(y.numpy(), y.numpy(), wy.numpy(), wy.numpy())
    want = assemble_sqrt_mmd(want_xx, want_yy, want_xy, wx.sum(-1), wy.sum(-1))
    rel = {}
    for terms in (3, 1):
        xx = _emulated_sum(x, x, wx, wx, terms, symmetric=True)
        yy = _emulated_sum(y, y, wy, wy, terms, symmetric=True)
        xy = _emulated_sum(x, y, wx, wy, terms)
        loss = assemble_sqrt_mmd(xx, yy, xy, wx.sum(-1), wy.sum(-1))
        rel[terms] = {
            "x is y": float(((xx - want_xx).abs() / want_xx).max()),
            "x vs y": float(((xy - want_xy).abs() / want_xy).max()),
            "loss": float(((loss - want).abs() / want).max()),
        }
    assert rel[1]["x is y"] <= 1e-4 and rel[1]["x vs y"] <= 1e-4, rel
    assert rel[1]["x is y"] > 100 * rel[3]["x is y"], rel
    assert rel[1]["loss"] > 1e-4, rel
    assert rel[3]["loss"] <= 1e-5, rel
