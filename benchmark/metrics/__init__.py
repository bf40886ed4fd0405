"""Per-layer metrics, one reader per file: ``read(ctx)`` returns the
metric's value, or None where the run gave it nothing to read (the harness
then leaves the metric out). ``ctx`` holds ``trace`` (``devtrace.Trace`` of
the traced frames), ``frame_ms`` (device-timed intervals between the
window's frames), ``wall_per_frame_s`` (the untraced window's wall time per
frame), ``run`` (the driver's run) and ``card`` (the device's name)."""
