"""Kernels launched per traced frame inside the filter step's ranges
(``step.*`` of ``models/manager.step``)."""


def read(ctx):
    tr = ctx["trace"]
    n = tr.launches_in("step.")
    return n / tr.frames if n else None
