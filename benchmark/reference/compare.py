"""The comparisons that decide `correct`: plain arithmetic on the
program's readings and the reference's."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List

# Leaves whose reference gradient is under this share of the median
# leaf's are nought to rounding (they move by round-off alone): they are
# left out of the gradient and change comparisons.
NOUGHT = 1e-3


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= NOUGHT * median]


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    keep = list(keep)
    median = statistics.median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in keep)


def median_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> float:
    """worst_leaf's gap of the median leaf."""
    keep = list(keep)
    median = statistics.median(ref[n] for n in keep)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], median) for n in keep)


def worst_step(prog: List[float], ref: List[float]) -> float:
    """The largest relative gap of a per-step scalar (a loss)."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))
