"""The bytes a train step of a ResNeSt configuration must move through
HBM in its split-attention kernels (kernels named `splat_*`), for
metrics/splat_roofline.py.

Every split-attention block runs at the grid of its block's input (its
3x3 average pool, where it strides, comes after it) on u = (N, H, W, 2C)
with C its stage's planes; out and dy are (N, H, W, C), du as u.  Per
block, forward 2|u| + |out| (the mean's read of u, the combine's read of
u and write of out), backward |dy| + |u| (the reduce) and |dy| + |du|
(dx).  Re-reads that L2 serves are left out, as chip_smoke.py's
bn_hbm_passes leaves them: where u fits in L2 the combine finds it there
after the mean, and only its write of out must reach HBM; where dy and u
fit together dx finds dy there after the reduce, and only its write of
du must.
"""

from __future__ import annotations

import math
from typing import List, Tuple

L2_BYTES = 50 * 2**20  # H100 SXM
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PLANES = (64, 128, 256, 512)
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def block_shapes(config: dict, traffic: dict) -> List[Tuple[int, int, int, int]]:
    """(N, H, W, 2C) of u in every split-attention block of the trunk, in
    order: the deep stem halves the crop twice (3x3/2 conv, 3x3/2 max pool,
    each size -> ceil(size / 2)), and a block whose stage strides runs at
    its input's grid."""
    m = config["model"]
    if m["output_stride"] == 16:
        strides = (1, 2, 2, 1)
    elif m["output_stride"] == 8:
        strides = (1, 2, 1, 1)
    else:
        raise ValueError(f"output_stride must be 8 or 16, got {m['output_stride']}")
    n, size = traffic["batch"], math.ceil(math.ceil(traffic["crop"] / 2) / 2)
    shapes = []
    for planes, stride, blocks in zip(PLANES, strides, m["layers"]):
        for b in range(blocks):
            shapes.append((n, size, size, 2 * planes))
            if b == 0 and stride > 1:
                size = math.ceil(size / stride)
    return shapes


def kernel_bytes(u_bytes: int, l2_bytes: int = L2_BYTES) -> dict:
    """Each split-attention kernel's bytes through HBM in one block whose u
    takes `u_bytes` (out and dy half of it), less the re-reads L2 serves
    (see the module's docstring)."""
    half = u_bytes // 2
    return {"splat_gap": u_bytes,
            "splat_combine": half if u_bytes <= l2_bytes else u_bytes + half,
            "splat_bwd_reduce": half + u_bytes,
            "splat_dx": u_bytes if half + u_bytes <= l2_bytes else half + u_bytes}


def step_bytes(config: dict, traffic: dict, l2_bytes: int = L2_BYTES) -> int:
    """The bytes a train step's split-attention kernels must move through
    HBM, summed over the blocks (see the module's docstring)."""
    item = ITEMSIZE[config["model"]["compute_dtype"]]
    return sum(sum(kernel_bytes(n * h * w * c2 * item, l2_bytes).values())
               for n, h, w, c2 in block_shapes(config, traffic))
