"""The split-attention kernels' share of their bytes bound, in percent:
the bytes a step must move through HBM in them (counts/splat.py, from the
cell's configuration and traffic) at 3.35e12 B/s, over their device
seconds a step (kernels whose names hold `splat_`, as
splat_device_ms.py reads them)."""

from benchmark.counts import splat

PREFIX = "splat_"


def read(trace):
    ops = trace.profile["device_ops"]
    seconds = sum(s for name, (s, _) in ops.items() if PREFIX in name)
    if not seconds:
        return None
    bound_s = splat.step_bytes(trace.config, trace.traffic) / splat.HBM_BYTES_PER_S
    return 100.0 * bound_s / (seconds / trace.steps)
