"""K3's host side and its arithmetic, on the CPU.

The CUDA kernel (csrc/mmd_kernel_sum.cu, kernel_sum_grad_3xtf32) runs
only on the card.  What can be held here:

* `grad_plan` and the kernel's walk over it: at every shape chip_smoke.py's mmd phase
  runs and at D = 512, every (class, x row) is owned and written once,
  every y row is read once within each cluster, the shared memory fits
  a CTA and the main path's grid fills the card.
* the swizzled tile layout: the fragment loads of both products fall in
  32 distinct banks.
* the 3xTF32 arithmetic: the kernel's two products emulated in plain
  torch, with its rounding of each f32 operand to a TF32 high part and a
  TF32 residual, against zs3_tpu's `_grad_x_impl` in interpret mode at
  the tolerances chip_smoke.py's `check_k2_k3` holds the kernel to; one
  TF32 product alone falls outside them, which is why there are three.
"""

import numpy as np
import pytest
import torch

from zs3_tpu.ops.pallas_mmd import _grad_x_impl, _prepare
from zs3_tpu_torch.ops import mmd_kernels
from zs3_tpu_torch.ops.mmd import DEFAULT_SIGMAS, pairwise_sq_dists

SIGMAS = DEFAULT_SIGMAS
MMD_SHAPES = [  # chip_smoke.py's phase_mmd, and the widest D the kernel takes
    (21, 128, 128, 256),
    (59, 128, 128, 256),  # a Pascal-Context step
    (21, 512, 512, 256),
    (21, 2048, 2048, 256),
    (3, 50, 70, 16),
    (2, 33, 45, 30),
    (4, 96, 96, 64),
    (21, 128, 128, 512),
]


# ---- the plan ---------------------------------------------------------------


def _walk(plan, n, m):
    """The kernel's walk as the plan lays it out: for each CTA (x tile,
    cluster rank) of a class, the x rows it owns (blockIdx.x / cluster), the
    y rows it reads (tiles rank, rank + cluster, ...) and the x rows whose
    dx and dwx it writes (32 / cluster of them), clipped to n and m."""
    rows, cl = plan["rows"], plan["cluster"]
    for xt in range(plan["x_tiles"]):
        x0 = xt * rows
        for rank in range(cl):
            y_rows = [range(t * rows, min(m, (t + 1) * rows))
                      for t in range(rank, plan["y_tiles"], cl)]
            per = rows // cl
            writes = range(x0 + rank * per, min(n, x0 + (rank + 1) * per))
            yield {"x_tile": xt, "rank": rank, "x_rows": range(x0, min(n, x0 + rows)),
                   "y_rows": y_rows, "writes": writes}


@pytest.mark.parametrize("shape", MMD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grad_plan_covers_every_row_once(shape):
    c, n, m, d = shape
    plan = mmd_kernels.grad_plan(c, n, m, d)
    assert plan["grid"] == (plan["x_tiles"] * plan["cluster"], c)
    assert plan["ctas"] == plan["grid"][0] * c
    assert plan["smem_bytes"] <= 227 * 1024
    assert 64 * plan["col_tiles_per_warp"] >= plan["d_pad"] >= d
    owned, written = np.zeros(n, int), np.zeros(n, int)
    y_read = {}
    for cta in _walk(plan, n, m):
        if cta["rank"] == 0:
            owned[list(cta["x_rows"])] += 1
        written[list(cta["writes"])] += 1
        seen = y_read.setdefault(cta["x_tile"], np.zeros(m, int))
        for rows in cta["y_rows"]:
            seen[list(rows)] += 1
    assert (owned == 1).all() and (written == 1).all()
    assert len(y_read) == plan["x_tiles"]
    assert all((seen == 1).all() for seen in y_read.values())


def test_grad_plan_fills_the_card_at_the_main_shape():
    plan = mmd_kernels.grad_plan(21, 128, 128, 256)
    assert plan["cluster"] == 2 and plan["ctas"] == 168 >= mmd_kernels.SM_COUNT
    # Two CTAs an SM by shared memory (the SM's 228 KB, 1 KB reserved each).
    assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
    # Large budgets need no cluster: the x tiles alone fill the card.
    assert mmd_kernels.grad_plan(21, 512, 512, 256)["cluster"] == 1


@pytest.mark.parametrize(
    "shape",
    [(21, 128, 128, 0), (21, 128, 128, 513), (0, 128, 128, 256)],
    ids=["no features", "D over 512", "no classes"],
)
def test_grad_plan_refuses(shape):
    with pytest.raises(ValueError):
        mmd_kernels.grad_plan(*shape)


# ---- the swizzled tiles -------------------------------------------------------


def _swz(r, k):
    """The kernel's `swz`: (row, feature) of a tile of 32-feature panels of
    32 rows, each row's 16-byte chunks XORed with the row mod 8 (the TMA's
    128-byte swizzle)."""
    return ((k >> 5) << 10) + (r << 5) + ((k & 31) ^ ((r & 7) << 2))


LANES = [(lane >> 2, lane & 3) for lane in range(32)]  # (group, thread in group)


@pytest.mark.parametrize(
    "pattern",
    ["x.y^T A: x rows, depth t and t + 4", "x.y^T B: y rows, depth t and t + 4",
     "C.y B: y rows 2t and 2t + 1, column g"],
)
def test_fragment_loads_hit_32_banks(pattern):
    for base_row in (0, 8, 16, 24):
        for k0 in range(0, 64, 8):
            for second in (0, 1):
                if pattern.startswith("C.y"):
                    offs = [_swz(k0 % 32 + 2 * t + second, 8 * base_row + g) for g, t in LANES]
                else:
                    offs = [_swz(base_row + g, k0 + t + 4 * second) for g, t in LANES]
                assert len({o % 32 for o in offs}) == 32, (pattern, base_row, k0, second)
    # The layout is a bijection of each panel.
    assert sorted(_swz(r, k) for r in range(32) for k in range(32)) == list(range(1024))


def test_c_tile_loads_and_stores_are_conflict_free():
    pitch = mmd_kernels.GRAD_RED_PITCH
    for m in (0, 1):
        for j0 in (0, 8, 16, 24):
            # C.y's A fragment: an 8-byte load a lane, served 16 lanes at a time.
            for half in (LANES[:16], LANES[16:]):
                words = set()
                for g, t in half:
                    at = (16 * m + g) * pitch + j0 + 2 * t
                    words |= {at % 32, (at + 1) % 32}
                assert len(words) == 32
    # The epilogue: thread i = tid / 8, column tid % 8 + 8 q.
    for warp in range(8):
        for q in range(4):
            banks = {((32 * warp + lane) // 8 * pitch + lane % 8 + 8 * q) % 32
                     for lane in range(32)}
            assert len(banks) == 32


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


def _emulated_grad(x, y, wx, wy, terms):
    """K3's arithmetic: exact f32 norms, d2, exponentials, C and K; both
    products in TF32 parts."""
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1)[..., None, :]
    d2 = torch.clamp(x2 + y2 - 2.0 * _product(x, y.transpose(-1, -2), terms), min=0.0)
    k = torch.zeros_like(d2)
    c = torch.zeros_like(d2)
    for s in SIGMAS:
        e = torch.exp(d2 * (-1.0 / (2.0 * s)))
        k = k + e
        c = c + e * (1.0 / s)
    cw = (wx[..., :, None] * c) * wy[..., None, :]
    dx = _product(cw, y, terms) - cw.sum(-1, keepdim=True) * x
    return dx, (k * wy[..., None, :]).sum(-1)


def _term_magnitude(x, y, wx, wy):
    """chip_smoke.py's grad_term_magnitude: sum_j |C_ij||y_j| + |rowsum_i||x_i|."""
    d2 = pairwise_sq_dists(x, y)
    c = sum(torch.exp(d2 * (-1.0 / (2.0 * s))) / s for s in SIGMAS)
    cw = wx[..., :, None] * c * wy[..., None, :]
    return cw.abs() @ y.abs() + cw.sum(-1, keepdim=True).abs() * x.abs()


def test_3xtf32_matches_pallas_and_one_tf32_term_does_not():
    rng = np.random.default_rng(8)
    c, n, m, d = 2, 128, 128, 256
    # Post-ReLU features and 0/1 masks, as chip_smoke.py's mmd_inputs.
    x = np.maximum(rng.standard_normal((c, n, d)), 0).astype(np.float32)
    y = np.maximum(rng.standard_normal((c, m, d)) + 0.2, 0).astype(np.float32)
    wx = (rng.random((c, n)) > 0.3).astype(np.float32)
    wy = (rng.random((c, m)) > 0.3).astype(np.float32)
    want_dx = np.empty_like(x)
    want_dwx = np.empty_like(wx)
    for k in range(c):
        xp, yp, wxp, wyp = _prepare(x[k], y[k], wx[k], wy[k])
        got_dx, got_dwx = _grad_x_impl(xp, yp, wxp, wyp, SIGMAS, True)
        want_dx[k], want_dwx[k] = np.asarray(got_dx)[:n, :d], np.asarray(got_dwx)[0, :n]
    t = [torch.from_numpy(a) for a in (x, y, wx, wy)]
    want_dx, want_dwx = torch.from_numpy(want_dx), torch.from_numpy(want_dwx)
    # check_k2_k3's dx tolerance.
    tol = 1e-6 + 1e-3 * want_dx.abs() + 1e-5 * _term_magnitude(*t)

    dx, dwx = _emulated_grad(*t, terms=3)
    assert bool(((dx - want_dx).abs() <= tol).all()), float((dx - want_dx).abs().max())
    torch.testing.assert_close(dwx, want_dwx, rtol=1e-3, atol=1e-6)
    # Three terms stay well inside the tolerance.
    assert float(((dx - want_dx).abs() / tol).max()) < 0.1

    dx1, _ = _emulated_grad(*t, terms=1)
    outside = int(((dx1 - want_dx).abs() > tol).sum())
    assert outside > 100, outside
