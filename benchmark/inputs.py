"""The benchmark's inputs, made on the device from --seed: weights and
batches.  The same seed gives the same tensors on the same device, so the
reference is handed what the program was.

`seeded_state` draws every weight of a model at once (one truncated
normal over a flat buffer, then each kernel scaled by its lecun-normal
std), in the f32 the port keeps its parameters in.  `make_batches` is
the one generator of every traffic mix: VOC-like label maps of 2-4
elliptic regions of allowed classes over background, with a band of
ignore (255) pixels along every region edge as VOC draws around objects,
and images whose pixels are a class colour under noise, normalised as
the port's loader leaves them (NHWC f32).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import numpy as np
import torch
import torch.nn.functional as F

IGNORE = 255


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream of one --seed."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(1, np.uint64)[0]
    return int(state) & ((1 << 63) - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


WEIGHTS, DATA = 1, 2  # streams


def seeded_state(template: Dict[str, torch.Tensor], seed: int, device,
                 stream: int = WEIGHTS) -> Dict[str, torch.Tensor]:
    """A state_dict of `template`'s names and shapes: kernels lecun-normal
    (truncated at 2 std, as the port's init), BN scales and running
    variances 1, every other entry 0."""
    names = sorted(n for n, t in template.items() if t.ndim >= 2)
    sizes = [template[n].numel() for n in names]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=generator(seed, stream, device))
    state = {}
    for name, part in zip(names, flat.split(sizes)):
        shape = template[name].shape
        fan_in = math.prod(shape[1:])
        state[name] = part.view(shape).mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)
    for name, t in template.items():
        if name in state:
            continue
        one = name.endswith("running_var") or (name.endswith(".weight") and t.ndim == 1)
        state[name] = torch.full(t.shape, 1 if one else 0, dtype=t.dtype, device=device)
    return state


def allowed_classes(num_classes: int, exclude: Iterable[int]) -> List[int]:
    """The object classes a label map may hold (background 0 aside)."""
    skip = set(exclude)
    return [c for c in range(1, num_classes) if c not in skip]


def make_batches(traffic: dict, num_classes: int, exclude: Iterable[int], seed: int,
                 device, count: int = None) -> List[Dict[str, torch.Tensor]]:
    """`count` (traffic["pool_batches"] by default) distinct batches of
    traffic["batch"] images of traffic["crop"]² pixels: {"image": (B, H, W,
    3) f32, "label": (B, H, W) int32}."""
    count = traffic["pool_batches"] if count is None else count
    b, size = traffic["batch"], traffic["crop"]
    lo, hi = traffic["regions"]
    n = count * b
    gen = generator(seed, DATA, device)
    classes = torch.tensor(allowed_classes(num_classes, exclude), device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    regions = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
    centre, axes = uniform(n, hi, 2), 0.1 + 0.35 * uniform(n, hi, 2)
    cls = classes[torch.randint(len(classes), (n, hi), generator=gen, device=device)]
    colours = torch.randn((num_classes, 3), generator=gen, device=device)
    grid = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) / size
    label = torch.zeros((n, size, size), dtype=torch.int32, device=device)
    for r in range(hi):
        dy = (grid[None, :, None] - centre[:, r, 0, None, None]) / axes[:, r, 0, None, None]
        dx = (grid[None, None, :] - centre[:, r, 1, None, None]) / axes[:, r, 1, None, None]
        inside = (dy.square() + dx.square() <= 1.0) & (r < regions)[:, None, None]
        label = torch.where(inside, cls[:, r, None, None].to(torch.int32), label)
    image = 0.5 * colours[label.long()] + 0.5 * torch.randn(
        (n, size, size, 3), generator=gen, device=device)
    # The ignore band: pixels within traffic["ignore_band"] of an edge.
    lf = label[:, None].float()
    edge = (F.max_pool2d(lf, 3, 1, 1) != -F.max_pool2d(-lf, 3, 1, 1)).float()
    band = traffic["ignore_band"]
    near = F.max_pool2d(edge, 2 * band + 1, 1, band)[:, 0] > 0
    label = torch.where(near, torch.full_like(label, IGNORE), label)
    return [{"image": image[i * b:(i + 1) * b].contiguous(),
             "label": label[i * b:(i + 1) * b].contiguous()} for i in range(count)]
