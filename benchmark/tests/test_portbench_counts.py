"""The frozen FLOP counts against a count made again and against hand
counts."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, spec

FROZEN = {c["name"]: counts.frozen(c["name"]) for c in spec.Spec().data["configs"]}


@pytest.mark.parametrize("config", sorted(FROZEN))
def test_frozen_flops_count_again(config):
    cfg = spec.Spec().config(config)
    entry = FROZEN[config]
    assert counts.count_forward_flops(cfg, entry["crop"]) == entry["forward_flops"]
    assert counts.count_forward_flops(cfg, entry["crop"], "backbone") == entry["backbone_flops"]
    assert counts.forward_flops(config, entry["crop"]) == entry["forward_flops"]
    assert counts.forward_flops(config, 65) is None


def test_r101_forward_is_185_6_gflop_an_image():
    r101 = FROZEN["deeplabv3plus-r101-os16-voc"]
    assert round(r101["forward_flops"] / 1e9, 1) == 185.6
    assert round(r101["backbone_flops"] / 1e9, 1) == 109.4
    assert round(FROZEN["deeplabv3plus-xception65-os16-voc"]["backbone_flops"] / 1e9, 1) == 97.1


def test_a_conv_counts_as_by_hand():
    """The stem: 7x7x3 -> 64 at stride 2 on 513x513 gives 257x257 outputs,
    2 FLOPs a multiply-add."""
    with torch.device("meta"):
        conv = torch.nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        with FlopCounterMode(display=False) as counter:
            conv(torch.empty(1, 3, 513, 513))
    assert counter.get_total_flops() == 2 * 257 * 257 * 64 * 7 * 7 * 3


def test_the_head_by_hand():
    """ASPP, decoder and classifier of R101 at 513x513 (33x33 and 129x129
    grids): the forward less the backbone."""
    grid, low = 33 * 33, 129 * 129
    aspp = grid * (2048 * 256 + 3 * 9 * 2048 * 256 + 5 * 256 * 256) + 2048 * 256
    decoder = low * (256 * 48 + 9 * 304 * 256 + 9 * 256 * 256 + 256 * 21)
    r101 = FROZEN["deeplabv3plus-r101-os16-voc"]
    assert r101["forward_flops"] - r101["backbone_flops"] == 2 * (aspp + decoder)
