"""Host ms per traced frame inside ``step.propagate_and_clone`` (the IMU
loop), as the profiler sees it (its own overhead included)."""


def read(ctx):
    tr = ctx["trace"]
    s = tr.host_s_in("step.propagate_and_clone")
    return 1e3 * s / tr.frames if s > 0 else None
