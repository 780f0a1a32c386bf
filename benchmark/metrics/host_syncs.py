"""Times one step makes the host wait for the device, counted by torch's
sync debug mode (devtrace.host_syncs, a copy of chip_smoke.py's)."""


def read(trace):
    return float(trace.syncs)
