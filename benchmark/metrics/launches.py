"""Device ops (kernels, copies, sets) a step, from the profiler."""


def read(trace):
    return trace.launches / trace.steps
