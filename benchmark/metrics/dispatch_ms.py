"""Host ms to queue one step on an idle card, median of the calls
(devtrace.host_ms, a copy of chip_smoke.py's host_ms)."""


def read(trace):
    return trace.dispatch_ms
