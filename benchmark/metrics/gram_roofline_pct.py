"""Roofline share of the program's ``ops.kernels.gram_reduce`` calls in the
traced frames, %: their least time on the card's published peaks (from each
call's shapes, ``roofline.py``) over the device time of every kernel
launched inside the harness's ``bench.gram_reduce`` range around the calls."""

from roofline import roofline_pct


def read(ctx):
    tr = ctx["trace"]
    return roofline_pct("gram_reduce", tr.calls.get("gram_reduce", []), tr.device_s_of("bench.gram_reduce"), ctx["card"])
