"""95th percentile of the window's frame times, ms: the intervals between
CUDA events the harness records after each frame (not a synchronization),
over all the window's frames."""

import statistics


def read(ctx):
    ms = ctx["frame_ms"]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
