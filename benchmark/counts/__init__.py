"""Frozen operation counts: the forward FLOPs of each configuration
(counts/<config>.json, counted with torch's FlopCounterMode over the
plain reference on the meta device; `count_forward_flops` counts
again)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent


def frozen(config: str) -> dict:
    """counts/<config>.json ({} where the configuration has none)."""
    path = HERE / f"{config}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def forward_flops(config: str, crop: int) -> Optional[float]:
    """The frozen forward FLOPs of one image of `config` at crop² (None
    when none is frozen for them)."""
    entry = frozen(config)
    return entry.get("forward_flops") if entry.get("crop") == crop else None


def count_forward_flops(config: dict, crop: int, part: str = "forward") -> int:
    """FLOPs of one image through the reference ("forward": features and
    classifier; "backbone": the backbone alone), on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.loops import common

    with torch.device("meta"):
        model = common.reference_module(config).build(config).eval()
        x = torch.empty(1, 3, crop, crop)
        with FlopCounterMode(display=False) as counter:
            if part == "backbone":
                model.backbone(x)
            else:
                model(x)
    return counter.get_total_flops()
