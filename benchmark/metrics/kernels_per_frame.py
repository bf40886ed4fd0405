"""Device operations (kernels, copies, fills) per traced frame."""


def read(ctx):
    tr = ctx["trace"]
    return len(tr.kernels) / tr.frames if tr.kernels else None
