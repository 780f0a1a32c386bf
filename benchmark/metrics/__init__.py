"""One reader per per-layer metric, in a file named after the metric:
`read(trace)` returns its value (a metric `<base>.<loop>` with no file
of its own is read by `<base>.py`), or None where the run has nothing for
it to read (the harness then leaves the metric out).  `trace` is
harness.Trace: the profiled window (`profile`: device ops by name with
their seconds and counts, `busy_s`, `window_s`, `steps`, `launches`),
`dispatch_ms`, `syncs`, the untraced window (`untraced`), the frozen FLOPs an image
(`flops_per_image`), the cell's `config` and `traffic`."""
