"""Spans of the port's host work, recorded in memory while a window is open.

The serving engine, the design flow and the training driver mark their
host work with ``span(name, **attrs)``.  Recording is off unless a window
is open, and then ``span`` hands back one shared no-op object: its whole
cost is the check of a module-level flag.  An operator opens a window
around the work to be seen::

    from repro_torch import tracing

    with tracing.recording() as spans:
        engine.infer(batch)
    for s in spans:
        print(s.name, (s.t1 - s.t0) / 1e6, "ms")

While recording, a span notes its name, its start and end on
``time.perf_counter_ns()``, its own id, the id of the span open around it
on the same thread (its parent), the thread's native id and its attrs.
``record`` notes an interval whose start was taken earlier, such as a
request's time in a queue; such a span is a wait by default, and a wait
never names what the host was doing while the device idled.  While a
window is open, each collection of Python's garbage collector is a span
too, ``python.gc``, on the thread it stopped, inside whatever span was
open there.

There is one window at a time.  Spans that end after it has closed are
dropped; a span that was open when it opened has no record, so its
children carry the parent it had on the stack, if any.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from typing import NamedTuple, Optional

_on = False              # the one switch: True inside ``recording()``
_spans: list = []        # the open window's spans
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    name: str
    t0: int                  # perf_counter_ns at its start
    t1: int                  # and at its end
    id: int
    parent: Optional[int]    # the span that caused it, or None
    thread: int              # threading.get_native_id()
    attrs: dict
    wait: bool = False       # time spent waiting, not working


class _Off:
    """What ``span`` hands back with recording off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


def _here() -> tuple:
    """This thread's stack of open span ids and its native id."""
    here = getattr(_local, "here", None)
    if here is None:
        here = _local.here = ([], threading.get_native_id())
    return here


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "stack", "thread")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.stack, self.thread = _here()
        self.parent = self.stack[-1] if self.stack else None
        self.id = next(_ids)
        self.stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.stack.pop()
        if _on:
            _spans.append(Span(self.name, self.t0, t1, self.id, self.parent,
                               self.thread, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add attrs known only once the span is open."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around host work named ``name``."""
    if not _on:
        return OFF
    return _Open(name, attrs)


def is_on() -> bool:
    """Whether a window is open: guards work done only to feed ``record``."""
    return _on


def record(name: str, t0: int, t1: int, parent: Optional[int] = None,
           wait: bool = True, **attrs) -> None:
    """Record an interval noted earlier (``perf_counter_ns`` readings)."""
    if _on:
        _spans.append(Span(name, int(t0), int(t1), next(_ids), parent,
                           _here()[1], attrs, wait))


def _collected(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection as a ``python.gc`` span."""
    if phase == "start":
        _local.gc_t0 = time.perf_counter_ns()
        return
    t0 = getattr(_local, "gc_t0", None)
    if _on and t0 is not None:
        stack, thread = _here()
        _spans.append(Span("python.gc", t0, time.perf_counter_ns(),
                           next(_ids), stack[-1] if stack else None, thread,
                           {"generation": info["generation"]}))


@contextlib.contextmanager
def recording():
    """Open a window: clear the buffer, record, and yield the list that the
    window's spans go into.  Recording stops on exit."""
    global _on, _spans
    if _on:
        raise RuntimeError("a tracing window is already open")
    _spans = []
    _on = True
    gc.callbacks.append(_collected)
    try:
        yield _spans
    finally:
        _on = False
        gc.callbacks.remove(_collected)
