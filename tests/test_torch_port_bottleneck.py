"""K5 in the port: the plain fused bottleneck of zs3_tpu_torch.ops.bottleneck
against zs3_tpu's Pallas kernel (interpret mode) and its oracle, BN
folding, and the kernel wrapper's refusal of CPU tensors.

Inputs and weights come from a numpy seed and go to both packages as the
same arrays (zs3_tpu's layouts: x NHWC, w1 (C, P), w2 (3, 3, P, P) HWIO,
w3 (P, C)).  f32 results agree within the JAX test's atol 1e-5; bf16
within 2 bf16 ulps of the largest output (the f32 sums run in another
order, which can move a rounding of y1 or y2 by one ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs3_tpu.ops import pallas_bottleneck as jax_k5
from zs3_tpu_torch.models.resnet import Bottleneck
from zs3_tpu_torch.ops import bottleneck, bottleneck_kernels

SHAPES = [(2, 12, 10, 32, 16, 1), (1, 12, 10, 32, 16, 2), (2, 9, 11, 16, 8, 1),
          (1, 33, 33, 64, 32, 4)]


def _block(rng, c, p):
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return (mk(c, p), mk(p), mk(3, 3, p, p), mk(p), mk(p, c), mk(c))


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_fused_bottleneck_matches_pallas_and_oracle(shape, rng):
    b, h, w, c, p, d = shape
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    blk = _block(rng, c, p)
    want = np.asarray(jax_k5.fused_bottleneck(
        jnp.asarray(x), *map(jnp.asarray, blk), dilation=d, interpret=True))
    oracle = np.asarray(jax_k5.bottleneck_oracle(jnp.asarray(x), *map(jnp.asarray, blk),
                                                 dilation=d))
    got = bottleneck.fused_bottleneck(torch.from_numpy(x), *_torch(blk), dilation=d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5)
    port_oracle = bottleneck.bottleneck_oracle(torch.from_numpy(x), *_torch(blk), dilation=d)
    np.testing.assert_allclose(port_oracle.numpy(), oracle, atol=1e-5)


def test_plain_fused_stage_chains_blocks(rng):
    b, h, w, c, p = 2, 13, 11, 32, 16
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    dils = [1, 2, 1]
    blocks = [_block(rng, c, p) for _ in dils]
    want = np.asarray(jax_k5.fused_stage(
        jnp.asarray(x), [tuple(map(jnp.asarray, blk)) for blk in blocks], dils,
        interpret=True))
    got = bottleneck.fused_stage(torch.from_numpy(x), [_torch(blk) for blk in blocks], dils)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # The dispatcher takes the plain version for a CPU tensor.
    via = bottleneck_kernels.fused_stage(torch.from_numpy(x), [_torch(blk) for blk in blocks],
                                         dils)
    np.testing.assert_array_equal(via.numpy(), got.numpy())
    assert bottleneck_kernels.fused_bottleneck.launches == 0


def test_plain_fused_bottleneck_bf16_matches_oracle(rng):
    b, h, w, c, p, d = 1, 12, 10, 32, 16, 2
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    blk = _block(rng, c, p)
    w1, b1, w2, b2, w3, b3 = blk
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jax_k5.bottleneck_oracle(
        bf(x), bf(w1), jnp.asarray(b1), bf(w2), jnp.asarray(b2), bf(w3), jnp.asarray(b3),
        dilation=d,
    ).astype(jnp.float32))
    got = bottleneck.fused_bottleneck(torch.from_numpy(x).bfloat16(), *_torch(blk), dilation=d)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * 2.0**-8 * scale)


def test_fold_bn_is_exact(rng):
    """conv + eval BN == conv with folded weights, and the port's folding
    equals zs3_tpu's."""
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 4, 6)) * 0.2).astype(np.float32)
    scale = (rng.standard_normal(6) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(6) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(6) * 0.1).astype(np.float32)
    var = (rng.random(6) + 0.5).astype(np.float32)
    kf, bf = bottleneck.fold_bn(*_torch([k, scale, bias, mean, var]), 1e-5)
    jk, jb = jax_k5.fold_bn(*map(jnp.asarray, (k, scale, bias, mean, var)), 1e-5)
    np.testing.assert_allclose(kf.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)
    conv = lambda x, k: torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    ref = (conv(x, torch.from_numpy(k)) - torch.from_numpy(mean)[:, None, None]) / torch.sqrt(
        torch.from_numpy(var)[:, None, None] + 1e-5) * torch.from_numpy(scale)[:, None, None] \
        + torch.from_numpy(bias)[:, None, None]
    np.testing.assert_allclose((conv(x, kf) + bf[:, None, None]).numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 2])
def test_fold_bottleneck_matches_the_model_block(dilation, rng):
    """The plain fused block on a Bottleneck's folded weights equals the
    block itself in eval mode (the anchor of zs3_tpu's
    test_oracle_matches_model_bottleneck)."""
    planes = 4
    block = Bottleneck(planes * 4, planes, dilation=dilation).eval()
    gen = np.random.default_rng(1)
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.conv3):
            conv.weight.copy_(torch.from_numpy(
                (gen.standard_normal(conv.weight.shape) * 0.3).astype(np.float32)))
        for bn in (block.bn1, block.bn2, block.bn3):
            n = bn.weight.shape[0]
            bn.weight.copy_(torch.from_numpy(gen.uniform(0.5, 1.5, n).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(gen.standard_normal(n).astype(np.float32)))
            bn.running_mean.copy_(torch.from_numpy((0.1 * gen.standard_normal(n)).astype(
                np.float32)))
            bn.running_var.copy_(torch.from_numpy(gen.uniform(0.5, 1.5, n).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, planes * 4)).astype(np.float32))
    with torch.no_grad():
        ref = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = bottleneck.fused_bottleneck(x, *bottleneck.fold_bottleneck(block),
                                          dilation=dilation)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)


def test_kernel_refuses_cpu_tensors(rng):
    x = torch.from_numpy(rng.standard_normal((1, 9, 11, 16)).astype(np.float32))
    blk = _torch(_block(rng, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        bottleneck_kernels.fused_bottleneck(x, *blk, dilation=1)
    assert bottleneck_kernels.fused_bottleneck.launches == 0


# The R101 stages' identity-block inputs at os16 (batch, then H, W, C, P and
# the dilations their blocks take).
R101_STAGES = [((129, 129, 256), 64, (1,)), ((65, 65, 512), 128, (1,)),
               ((33, 33, 1024), 256, (1, 2)), ((33, 33, 2048), 512, (2, 4, 8))]


def _item_pixels(pl: dict, phase: str, m_tile: int) -> torch.Tensor:
    """The image pixels (flat over B, H, W) that the `bm` rows of M tile
    `m_tile` of a bf16 plan's phase write, -1 for a row that is dropped:
    past the last pixel, or (phase B) a raster position in the pad.  The
    kernel's epilogue maps rows the same way."""
    b, h, w, _ = pl["shape"]
    d = pl["dilation"]
    rows = torch.arange(pl["bm"]) + m_tile * pl["bm"]
    if phase != "B":
        return torch.where(rows < b * h * w, rows, -1)
    tiles_img = pl["tiles_per_image"]
    img = m_tile // tiles_img
    local = d * pl["row_width"] + rows - img * tiles_img * pl["bm"]
    r, c = local // pl["row_width"] - d, local % pl["row_width"] - d
    inside = (r < h) & (c >= 0) & (c < w)
    return torch.where(inside, (img * h + r) * w + c, -1)


def test_pack_block_round_trips(rng):
    blk = _torch(_block(rng, 128, 64))
    packed = bottleneck_kernels.pack_block(blk, torch.bfloat16)
    assert packed.w1.shape == (64, 128) and packed.w2.shape == (9 * 64, 64)
    assert packed.w3.shape == (128, 64) and packed.planes == 64 and packed.channels == 128
    assert all(t.is_contiguous() for t in (packed.w1, packed.w2, packed.w3))
    back = bottleneck_kernels.unpack_block(packed)
    for i in (0, 2, 4):  # w1, w2, w3: exactly the bf16 cast
        assert back[i].dtype == torch.bfloat16
        torch.testing.assert_close(back[i], blk[i].to(torch.bfloat16), rtol=0, atol=0)
    for i in (1, 3, 5):  # the biases stay f32
        torch.testing.assert_close(back[i], blk[i], rtol=0, atol=0)
    # The K-major layout: w2t[(3a + b) P + n, k] == w2[a, b, k, n].
    torch.testing.assert_close(packed.w2[(3 * 2 + 1) * 64 + 5, 7],
                               blk[2][2, 1, 7, 5].to(torch.bfloat16), rtol=0, atol=0)
    f32 = bottleneck_kernels.pack_block(blk, torch.float32)
    for got, want in zip(bottleneck_kernels.unpack_block(f32), blk):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("stage", range(len(R101_STAGES)))
def test_plan_covers_every_output_once(stage, batch):
    (h, w, c), p, dilations = R101_STAGES[stage]
    for d in dilations:
        pl = bottleneck_kernels.plan((batch, h, w, c), p, d, torch.bfloat16)
        assert pl["route"] == "wgmma" and pl["bm"] % 64 == 0
        assert pl["smem_bytes"] <= 232448 and pl["ctas_per_sm"] >= 1
        assert pl["row_width"] == w + 2 * d and pl["pad_rows"] == h + 2 * d
        for phase, n_out in (("A", p), ("B", p), ("C", c)):
            ph = pl["phases"][phase]
            assert ph["n_tiles"] * pl["bn"] == n_out
            assert ph["items"] == ph["m_tiles"] * ph["n_tiles"]
            pix = torch.cat([_item_pixels(pl, phase, m)
                             for m in range(ph["m_tiles"])])
            pix = pix[pix >= 0]
            # Each pixel once over the M tiles; each N tile covers its own
            # bn channels, so every (pixel, channel) is written once.
            counts = torch.bincount(pix, minlength=batch * h * w)
            assert counts.numel() == batch * h * w and bool((counts == 1).all()), phase
        k_in = {"A": c, "B": 9 * p, "C": p}
        assert all(pl["phases"][k]["k_chunks"] * 64 == k_in[k] for k in k_in)


@pytest.mark.parametrize("shape, planes, d, sms, bn", [
    ((4, 33, 33, 1024), 256, 1, 132, 64),  # phase B: 152 items of 128 for 264 CTAs
    ((16, 33, 33, 1024), 256, 1, 132, 128),
    ((4, 33, 33, 1024), 256, 1, 60, 128),
    ((4, 33, 33, 2048), 512, 4, 132, 128),
    ((4, 65, 65, 512), 128, 1, 132, 128),
    ((4, 129, 129, 256), 64, 1, 132, 64),
])
def test_plan_picks_the_n_tile_that_fills_the_grid(shape, planes, d, sms, bn):
    assert bottleneck_kernels.plan(shape, planes, d, torch.bfloat16, sm_count=sms)["bn"] == bn


@pytest.mark.parametrize("ctas_per_sm, bn, grid", [
    (None, 64, 396),  # the H100's occupancy: 152 items of 128 for 264 CTAs
    ({64: 3, 128: 1}, 128, 132),  # one CTA an SM at N = 128: 152 items fill 132
    ({64: 2, 128: 2}, 64, 264),
])
def test_plan_takes_the_n_tile_from_the_occupancy(ctas_per_sm, bn, grid):
    """Layer3 at eval batch 4 on 132 SMs: the grid the N tile is held to is
    the SMs times the CTAs an SM holds at N = 128, as the card reports it."""
    pl = bottleneck_kernels.plan((4, 33, 33, 1024), 256, 1, torch.bfloat16, 132, ctas_per_sm)
    assert pl["bn"] == bn and pl["grid"] == grid
    assert pl["ring"] == bottleneck_kernels.RING == 4
    assert pl["smem_bytes"] == bottleneck_kernels.ring_bytes(bn) == {64: 66624, 128: 99392}[bn]
    assert pl["phases"]["A"]["n_tiles"] == 256 // bn and pl["phases"]["C"]["n_tiles"] == 1024 // bn


@pytest.mark.parametrize("c, p", [(96, 64), (256, 48), (200, 64)])
def test_plan_refuses_bf16_widths_off_64(c, p):
    with pytest.raises(ValueError, match="multiples of 64"):
        bottleneck_kernels.plan((1, 9, 9, c), p, 1, torch.bfloat16)


def test_plan_pad_share_and_items_at_layer3():
    """Layer3 at eval batch 4: 69 M tiles of 64 pixels, 2 N tiles of 128 in
    phase A; phase B's raster of 35-wide rows wastes 2/35 (about 6%)."""
    pl = bottleneck_kernels.plan((4, 33, 33, 1024), 256, 1, torch.bfloat16, sm_count=60)
    assert pl["phases"]["A"] == {"m_tiles": 69, "n_tiles": 2, "k_chunks": 16, "items": 138}
    assert pl["phases"]["B"]["m_tiles"] == 4 * 19 and pl["phases"]["C"]["items"] == 69 * 8
    assert abs(pl["pad_share"] - 2 / 35) < 1e-12
    layer4 = bottleneck_kernels.plan((4, 33, 33, 2048), 512, 8, torch.bfloat16)
    assert layer4["pad_share"] == 16 / 49


def test_fused_stage_takes_packed_blocks_on_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((1, 7, 9, 64)).astype(np.float32))
    blocks = [_torch(_block(rng, 64, 64)) for _ in range(2)]
    want = bottleneck.fused_stage(x, blocks, [1, 2])
    packed = [bottleneck_kernels.pack_block(b, torch.float32) for b in blocks]
    got = bottleneck_kernels.fused_stage(x, packed, [1, 2])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    xb = x.bfloat16()
    want_bf = bottleneck.fused_stage(xb, blocks, [1, 2])
    packed_bf = [bottleneck_kernels.pack_block(b, torch.bfloat16) for b in blocks]
    got_bf = bottleneck_kernels.fused_stage(xb, packed_bf, [1, 2])
    np.testing.assert_array_equal(got_bf.float().numpy(), want_bf.float().numpy())
    assert bottleneck_kernels.fused_bottleneck.launches == 0


def test_kernel_refuses_cpu_tensors_with_packed_blocks(rng):
    x = torch.from_numpy(rng.standard_normal((1, 5, 5, 64)).astype(np.float32)).bfloat16()
    packed = bottleneck_kernels.pack_block(_torch(_block(rng, 64, 64)), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        bottleneck_kernels.fused_bottleneck(x, packed, dilation=8)
    assert bottleneck_kernels.fused_bottleneck.launches == 0


def _emulate_plan(x, packed, d):
    """The bf16 kernel's three phases in torch on the CPU, from the plan's
    layout alone: y1 into the row-padded scratch, each tap of phase B as a
    64-row box at a constant row offset (zero past the tensor, as TMA
    fills it), the epilogues through _item_pixels."""
    b, h, w, c = x.shape
    p = packed.planes
    pl = bottleneck_kernels.plan(x.shape, p, d, torch.bfloat16)
    wt, hp, bm = pl["row_width"], pl["pad_rows"], pl["bm"]
    xf = x.reshape(-1, c).float()
    y1 = torch.relu(xf @ packed.w1.float().t() + packed.b1).bfloat16()
    y1p = torch.zeros(b, hp, wt, p, dtype=torch.bfloat16)
    y1p[:, d:d + h, d:d + w] = y1.reshape(b, h, w, p)
    y1p = y1p.reshape(-1, p)
    y2 = torch.full((b * h * w, p), float("nan"), dtype=torch.bfloat16)
    tiles_img = pl["tiles_per_image"]
    for mt in range(pl["phases"]["B"]["m_tiles"]):
        img = mt // tiles_img
        q0 = (img * hp + d) * wt + (mt - img * tiles_img) * bm
        acc = torch.zeros(bm, p)
        for tap in range(9):
            rows = torch.arange(bm) + q0 + ((tap // 3 - 1) * wt + tap % 3 - 1) * d
            ok = (rows >= 0) & (rows < y1p.shape[0])
            box = torch.zeros(bm, p)
            box[ok] = y1p[rows[ok]].float()
            acc += box @ packed.w2[tap * p:(tap + 1) * p].float().t()
        pix = _item_pixels(pl, "B", mt)
        y2[pix[pix >= 0]] = torch.relu(acc + packed.b2)[pix >= 0].bfloat16()
    assert not y2.float().isnan().any()
    out = torch.relu(y2.float() @ packed.w3.float().t() + packed.b3 + xf)
    return out.bfloat16().reshape(b, h, w, c)


@pytest.mark.parametrize("shape", [(2, 7, 9, 128, 64, 1), (1, 5, 5, 128, 64, 8),
                                   (1, 12, 10, 64, 64, 2), (2, 6, 11, 256, 128, 3)])
def test_plan_layout_computes_the_block(shape, rng):
    """The padded raster, the tap offsets and the dropped positions of the
    bf16 plan give the plain version's block (within 2 bf16 ulps of the
    largest output: the f32 sums run in another order)."""
    b, h, w, c, p, d = shape
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).bfloat16()
    blk = _torch(_block(rng, c, p))
    got = _emulate_plan(x, bottleneck_kernels.pack_block(blk, torch.bfloat16), d).float()
    want = bottleneck.fused_bottleneck(x, *blk, dilation=d).float()
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2 * 2.0**-8 * scale)
