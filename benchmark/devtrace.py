"""What the ``--trace 1`` run reads: ``torch.profiler`` over a few frames
after the window, read from the profiler's raw kineto events (building
``prof.events()`` takes minutes at tens of thousands of kernels a frame).

The harness marks each traced frame with a ``bench.frame`` range and each
call of the two hand-written kernels with a ``bench.<kernel>`` range whose
shapes it records itself; the program's own ranges (``step.*``) are
read as they are.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

from torch.profiler import record_function


@dataclass
class Trace:
    frames: int                                     # traced frames
    window_s: float                                 # wall time of the traced frames
    kernels: list = field(default_factory=list)     # (name, start ns, duration ns, correlation id)
    ranges: list = field(default_factory=list)      # host ranges (name, start ns, end ns)
    launches: list = field(default_factory=list)    # host kernel launches (start ns, correlation id)
    calls: dict = field(default_factory=dict)       # kernel wrapper -> [(shape, element bytes)], in call order

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (union of intervals)."""
        return sum(b - a for a, b in _union([(s, s + d) for _, s, d, _ in self.kernels])) / 1e9

    def launches_in(self, prefix: str) -> int:
        """Kernel launches made inside ranges whose name starts with ``prefix``."""
        spans = _union([(a, b) for n, a, b in self.ranges if n.startswith(prefix)])
        starts = [a for a, _ in spans]
        n = 0
        for t, _ in self.launches:
            i = bisect.bisect_right(starts, t) - 1
            n += i >= 0 and t <= spans[i][1]
        return n

    def host_s_in(self, name: str) -> float:
        return sum(b - a for n, a, b in self.ranges if n == name) / 1e9

    def device_s_of(self, range_name: str) -> float:
        """Device seconds of the kernels launched inside ranges ``range_name``
        (linked to their launches by the correlation id)."""
        spans = sorted((a, b) for n, a, b in self.ranges if n == range_name)
        starts = [a for a, _ in spans]
        ids = set()
        for t, cid in self.launches:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                ids.add(cid)
        return sum(d for _, _, d, cid in self.kernels if cid in ids) / 1e9

    def top_device_ops(self, n: int = 10) -> list:
        by = {}
        for name, _, d, _ in self.kernels:
            by[name] = by.get(name, 0) + d
        return [[k[:200], v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Device idle time inside the traced frames, by the innermost host
        range open at each gap's middle (``(none)`` where none is)."""
        frames = _union([(a, b) for name, a, b in self.ranges if name == "bench.frame"])
        if not frames:
            return []
        lo, hi = frames[0][0], frames[-1][1]
        busy = _union([(s, s + d) for _, s, d, _ in self.kernels if s + d > lo and s < hi])
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        inner = sorted(((a, b, name) for name, a, b in self.ranges if name != "bench.frame"), key=lambda r: r[0])
        starts = [a for a, _, _ in inner]
        by = {}
        for a, b in gaps:
            mid = (a + b) // 2
            best = None
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                s, e, name = inner[j]
                if e >= mid and (best is None or e - s < best[1] - best[0]):
                    best = (s, e, name)
                if mid - s > 10_000_000_000:
                    break
            key = best[2] if best else "(none)"
            by[key] = by.get(key, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or name.startswith("cuLaunch") or name == "cudaLaunchCooperativeKernel"


def read(prof, frames: int, window_s: float, calls: dict) -> Trace:
    """The events of a finished ``torch.profiler.profile`` as a :class:`Trace`."""
    events = prof.profiler.kineto_results.events()
    tr = Trace(frames=frames, window_s=window_s, calls=calls)
    cpu_names = set()
    device = []
    for e in events:
        on_device = e.device_type().name == "CUDA"
        name = e.name()
        if on_device:
            device.append((name, e.start_ns(), e.duration_ns(), e.correlation_id()))
            continue
        cpu_names.add(name)
        if e.is_user_annotation():
            tr.ranges.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif _is_launch(name):
            tr.launches.append((e.start_ns(), e.correlation_id()))
    # A host range and its device-side annotation share a name: the device's
    # operations are the device events with other names.
    tr.kernels = [k for k in device if k[0] not in cpu_names]
    tr.launches.sort()
    return tr


@contextlib.contextmanager
def kernel_ranges(calls: dict):
    """Put a ``bench.<kernel>`` range around every call of the program's two
    hand-written kernel wrappers and record each call's (B, M, D) and
    element size in ``calls``; restore the wrappers on exit."""
    from ov_plane_tpu_torch.ops import kernels

    saved = {}
    for name, arg in (("gram_reduce", 0), ("kalman_downdate", 1)):
        fn = getattr(kernels, name)
        saved[name] = fn
        calls.setdefault(name, [])

        def wrapped(*args, _fn=fn, _name=name, _arg=arg):
            x = args[_arg]
            calls[_name].append((tuple(x.shape), x.element_size()))
            with record_function(f"bench.{_name}"):
                return _fn(*args)

        wrapped.launches = fn.launches      # the wrapper counts its calls under its module name
        setattr(kernels, name, wrapped)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)
