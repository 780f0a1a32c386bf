"""Share of a step's time in which no device op ran, in percent: one
minus the device's busy time a step, from the profiled window (device
ops that are not user annotations, as utils/profiling.py::profile_device
sums them), over the untraced window's time a step, both of one run.
The profiled window's own wall time holds the profiler's host overhead
(about 3x the untraced step on the train loop), so it is not the base."""


def read(trace):
    busy = trace.busy_s / trace.steps
    w = trace.untraced
    return 100.0 * (1.0 - busy / (w["seconds"] / w["steps"]))
