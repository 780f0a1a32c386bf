"""Device ms a step in batch-norm kernels (train-mode BN's statistics,
normalisation and their backward), matched by name."""

NAMES = ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_bwd", "bn_fwd")


def read(trace):
    ops = trace.profile["device_ops"]
    seconds = sum(s for name, (s, _) in ops.items() if any(k in name.lower() for k in NAMES))
    return 1e3 * seconds / trace.steps if seconds else None
