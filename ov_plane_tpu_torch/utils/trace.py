"""Spans and counters of the port, kept in memory while tracing is on.

A span is a named stage of the program (``models.manager.step``'s
``step.*`` stages, the fused frontend's ``frontend.*``, the host detector,
the pull). :func:`span` always enters ``torch.profiler.record_function``
under the span's name, so a profiler sees the same ranges whether tracing is
on or off. While tracing is on (:func:`enable`) the span is also recorded:
its name, start and end in Unix-epoch nanoseconds (``perf_counter_ns`` plus
the offset to the wall clock taken at :func:`enable`, the clock
``torch.profiler``'s kineto events use, so spans can be laid over a
profiler trace), its parent span, and its frame: a span opened with
``frame=True`` (``manager.step``) and not inside another such span opens a
new frame, and every span inside it carries that frame's number.

:func:`count` adds a host number or a device tensor (summed over all its
elements, on its device, with no host synchronization) into a named
counter. Counters are read only by :func:`export`, which synchronizes once.

With tracing off, a span costs one flag test beyond its
``record_function`` and a count one call and one flag test; nothing is
stored or computed. One recorder serves the process, as the profiler does.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function


class Recorder:
    """The spans and counters recorded since the last :meth:`reset`."""

    def __init__(self):
        self.on = False
        self.offset_ns = 0
        self.reset()

    def reset(self):
        # [name, start ns, end ns (None while open), parent index, frame, opened the frame]
        self.spans = []
        self.counters = {}      # name -> host number or device tensor
        self.frames = 0
        self._open = []         # indices of the open spans, innermost last
        self._frame = -1        # the frame of the open frame span, -1 outside one

    def enable(self):
        """Start recording; take the offset of ``perf_counter_ns`` to the
        wall clock from the closest-bracketed of a few readings."""
        best = None
        for _ in range(5):
            a = time.perf_counter_ns()
            w = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, w - (a + b) // 2)
        self.offset_ns = best[1]
        self.on = True

    def open(self, name: str, frame: bool) -> list:
        owner = frame and self._frame < 0
        if owner:
            self._frame = self.frames
            self.frames += 1
        parent = self._open[-1] if self._open else -1
        rec = [name, None, None, parent, self._frame, owner]
        self._open.append(len(self.spans))
        self.spans.append(rec)
        rec[1] = time.perf_counter_ns() + self.offset_ns       # last, after what may allocate
        return rec

    def close(self, rec: list):
        rec[2] = time.perf_counter_ns() + self.offset_ns
        # Spans close innermost first; one opened before a reset is no longer
        # among this recording's open spans.
        if self._open and self.spans[self._open[-1]] is rec:
            self._open.pop()
            if rec[5]:
                self._frame = -1

    def count(self, name: str, value):
        if isinstance(value, torch.Tensor):
            value = value.sum()
        prev = self.counters.get(name)
        self.counters[name] = value if prev is None else prev + value

    def export(self) -> dict:
        """The spans in the order they opened (dicts with ``name``,
        ``start_ns``, ``end_ns`` (None while open), ``parent`` (index in the
        list, -1 for none) and ``frame`` (-1 outside a frame)), the counters'
        host values and the frame count. Reads every device counter in one
        transfer per device."""
        by_device: dict = {}
        for name, v in self.counters.items():
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append(name)
        counters = {name: v for name, v in self.counters.items() if not isinstance(v, torch.Tensor)}
        for names in by_device.values():
            vals = torch.stack([self.counters[n].to(torch.float64) for n in names]).tolist()
            counters.update(zip(names, vals))
        spans = [dict(name=s[0], start_ns=s[1], end_ns=s[2], parent=s[3], frame=s[4]) for s in self.spans]
        return dict(spans=spans, counters=counters, frames=self.frames)


RECORDER = Recorder()


class span:
    """``with span(name):`` a ``record_function(name)`` range, recorded as a
    span while tracing is on; ``frame=True`` opens a new frame unless one is
    open."""

    __slots__ = ("_rf", "_name", "_frame", "_rec")

    def __init__(self, name: str, frame: bool = False):
        self._rf = record_function(name)
        self._name = name
        self._frame = frame
        self._rec = None

    # The span reads the clock just outside its record_function: a profiler
    # stamps the range early in the entry and late in the exit, so readings
    # outside lie closest to its own, and the span holds the range.
    def __enter__(self):
        if RECORDER.on:
            self._rec = RECORDER.open(self._name, self._frame)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        out = self._rf.__exit__(*exc)
        if self._rec is not None:
            RECORDER.close(self._rec)
            self._rec = None
        return out


def count(name: str, value):
    """Add ``value`` (a number, or a tensor summed on its device) to the
    counter ``name`` while tracing is on."""
    if RECORDER.on:
        RECORDER.count(name, value)


def enable():
    """Record spans and counters from now on (what is recorded stays until
    :func:`reset`)."""
    RECORDER.enable()


def disable():
    RECORDER.on = False


def reset():
    """Forget every span, counter and frame recorded."""
    RECORDER.reset()


def export() -> dict:
    """What was recorded since the last :func:`reset` (``Recorder.export``)."""
    return RECORDER.export()
