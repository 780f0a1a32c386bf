"""Device ms a step in the split-attention kernels (ResNeSt's mean,
softmax combine and their backward), matched by the `splat_` their
names start with."""

PREFIX = "splat_"


def read(trace):
    ops = trace.profile["device_ops"]
    seconds = sum(s for name, (s, _) in ops.items() if PREFIX in name)
    return 1e3 * seconds / trace.steps if seconds else None
