"""The seen-class train step of loops/train.py on a trunk whose blocks
gate their branches through a BatchNorm over the batch's global means
(ResNeSt's split attention), with a check that tells bf16 from the fp8
control there.

Each gate's BN normalises the batch's N global means of a channel, which
differ from image to image by a small share of their size.  The error a
bf16 trunk carries into those means is then a large share of what the BN
divides by, and the gradient of every trunk leaf passes back through
some gate, so over the trunk's leaves bf16 drifts from the f32 reference
about as far as fp8 does.  The head's leaves (every leaf outside
`backbone.`: ASPP, decoder, classifier) take their gradient from the
loss through no gate, and their forward input is the trunk's output,
which the gates blur far less; there bf16 stays close to the reference
and fp8 does not.  So the check reads, beside train.py's numbers over
every leaf, the median leaf's first-gradient gap over the head's leaves
alone (`head_grad_median_gap`).
"""

from __future__ import annotations

from benchmark.loops import train
from benchmark.loops.train import ENTRY, REPORTS, reference  # noqa: F401 (loops/__init__.py)
from benchmark.reference import compare

TRUNK = "backbone."


class Loop(train.Loop):
    def check(self) -> dict:
        prog = self.program_readings()
        return compare_readings(prog, reference(self.config, self.traffic, self.seed, self.device))


def head_leaves(ref_grad: dict) -> list:
    """The leaves kept for the comparison (compare.kept_leaves) that lie
    outside the trunk."""
    return [n for n in compare.kept_leaves(ref_grad) if not n.startswith(TRUNK)]


def compare_readings(prog: dict, ref: dict) -> dict:
    head = head_leaves(ref["grad"])
    return dict(train.compare_readings(prog, ref),
                head_grad_median_gap=compare.median_leaf(prog["grad"], ref["grad"], head))
