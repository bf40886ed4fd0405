"""Share of a frame in which the device runs nothing, %: 1 − (union of the
device's operation intervals per traced frame) / (wall time per frame of the
untraced window stepped before it in the same process)."""


def read(ctx):
    tr = ctx["trace"]
    busy = tr.busy_s() / tr.frames
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx["wall_per_frame_s"])
