"""Roofline share of the program's ``ops.kernels.kalman_downdate`` calls in the
traced frames, %: their least time on the card's published peaks (from each
call's shapes, ``roofline.py``) over the device time of every kernel
launched inside the harness's ``bench.kalman_downdate`` range around the calls."""

from roofline import roofline_pct


def read(ctx):
    tr = ctx["trace"]
    return roofline_pct("kalman_downdate", tr.calls.get("kalman_downdate", []), tr.device_s_of("bench.kalman_downdate"), ctx["card"])
