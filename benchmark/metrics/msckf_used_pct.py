"""Share of the tracks entering the MSCKF update that it used, %: 100 ·
the program's counter ``msckf.used`` / ``msckf.selected`` over every stream
of the span phase's frames (``spanphase.py``)."""

import spanphase


def read(ctx):
    return spanphase.share_pct(spanphase.of(ctx), "msckf.used", "msckf.selected")
