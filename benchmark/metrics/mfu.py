"""The whole step's share of the card's dense bf16 peak, in percent: the
frozen FLOPs an image (counts/<config>.json; training counts 3x the
forward, no recompute) times the images of the untraced window, over its
seconds and 989e12 FLOP/s.  The result's device.power_limit_w gives the
card's power limit beside it."""


def read(trace):
    if trace.flops_per_image is None:
        return None
    w = trace.untraced
    return 100.0 * trace.flops_per_image * w["images"] / w["seconds"] / trace.peak_flops
