"""Spans and counters inside the port, kept in memory.

The one tracer of the package.  A span is a ``with`` block at a call site::

    with trace.span("engine.decode_frame", frame.frame_id):
        ...

and a counter a call ``trace.count("engine.scan_rounds", rounds)``.  Both
record only while tracing is on:

* while :func:`enable` is in effect (an operator's switch), or
* while a ``torch.profiler`` records (PyTorch's own flag for fast Python
  checks, ``torch.autograd.profiler._is_profiler_enabled``, is true between
  a profiler's start and stop).

Off, :func:`span` reads those two flags and returns one shared no-op
object: no allocation, no clock read.  On, a span appends one record to a
bounded in-memory buffer as it closes: its name, the span open around it on
the same thread (its parent), the frame it belongs to, the thread, its start
and end on ``time.perf_counter_ns`` and the thread's CPU nanoseconds over it
(``time.thread_time_ns``; a span opened with ``cpu=False`` leaves it out).
Wall time less CPU time is the time the thread did not run: waiting for the
interpreter lock, a device sync or the OS.  The thread-CPU reads are system
calls, and on a busy host most of what a span costs: a span whose CPU time
nothing reads is opened with ``cpu=False``.

A frame's spans share its id: :func:`new_frame` draws one in
``host.parser.parse``, the planner and the engine pass it on
(``ParsedJpeg.frame_id``), and a span given no id takes the one its thread
last named.

Each transition from off to on starts a new session: the records and
counters are cleared and a fresh pair of clock readings is taken.
:func:`snapshot` returns the last session, each span also on the
profiler's clock (``time.time_ns``'s epoch, which is what
``torch.profiler``'s CPU events carry): ``perf_counter_ns`` plus the
pair's offset.  A profiler that stops and starts again with no span or
counter call in between continues the session it left.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler

# Spans a session keeps at most; later spans are counted in ``dropped``.
MAX_RECORDS = 1 << 20


class _Session:
    def __init__(self):
        self.limit = MAX_RECORDS
        # Closed spans, appended as they close: (order opened, name, parent's
        # order opened, frame, thread, start ns, end ns, cpu ns).  Tuples of
        # ints and a str, which the garbage collector stops tracking.
        self.closed: List[tuple] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.opened = itertools.count()
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        self.offset_ns = t - (a + b) // 2


_enabled = 0                     # depth of enable() blocks in effect
_live = False                    # a session is recording
_session = _Session()
_lock = threading.Lock()
_local = threading.local()
_frames = itertools.count(1)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Thread:
    __slots__ = ("stack", "frame", "tid")

    def __init__(self):
        self.stack: List["_Span"] = []
        self.frame = 0
        self.tid = threading.get_native_id()


def _thread() -> _Thread:
    th = getattr(_local, "th", None)
    if th is None:
        th = _local.th = _Thread()
    return th


def _start() -> _Session:
    """The live session, a new one if none is live."""
    global _session, _live
    with _lock:
        if not _live:
            _session = _Session()
            _live = True
        return _session


class _Span:
    __slots__ = ("_name", "_frame", "_cpu", "_session", "_order", "_parent", "_th", "_start")

    def __init__(self, name: str, frame: Optional[int], cpu: bool):
        self._name, self._frame, self._cpu = name, frame, cpu

    def __enter__(self):
        s = _session if _live else _start()
        th = _thread()
        if self._frame is None:
            self._frame = th.frame
        else:
            th.frame = self._frame
        top = th.stack[-1] if th.stack else None
        self._parent = top._order if top is not None and top._session is s else -1
        self._session, self._order, self._th = s, next(s.opened), th
        th.stack.append(self)
        self._start = time.perf_counter_ns()
        self._cpu = time.thread_time_ns() if self._cpu else None
        return self

    def __exit__(self, *exc):
        cpu = None if self._cpu is None else time.thread_time_ns() - self._cpu
        end = time.perf_counter_ns()
        th, s = self._th, self._session
        th.stack.pop()
        # One append, atomic under the interpreter lock; threads closing spans
        # at the bound at once may keep a few past it.
        if len(s.closed) < s.limit:
            s.closed.append((self._order, self._name, self._parent, self._frame, th.tid,
                             self._start, end, cpu))
        else:
            with _lock:
                s.dropped += 1
        return False


def span(name: str, frame: Optional[int] = None, cpu: bool = True):
    """A context manager that records the block as span ``name`` of frame
    ``frame`` (None: the frame this thread last named), with the thread's CPU
    time over it unless ``cpu`` is false, while tracing is on, and a shared
    no-op object while it is off."""
    global _live
    if _enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(name, frame, cpu)
    _live = False
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    global _live
    if _enabled or _autograd_profiler._is_profiler_enabled:
        s = _session if _live else _start()
        with _lock:
            s.counters[name] = s.counters.get(name, 0) + n
    else:
        _live = False


def new_frame() -> int:
    """A fresh frame id (from 1)."""
    return next(_frames)


@contextlib.contextmanager
def enable() -> Iterator[None]:
    """Tracing on for the block.  Entered while off, it starts a new session
    (at most ``MAX_RECORDS`` spans); :func:`snapshot` reads the session after
    the block."""
    global _enabled, _live
    with _lock:
        _enabled += 1
    if _enabled == 1 and not _autograd_profiler._is_profiler_enabled:
        _live = False
    _start()
    try:
        yield
    finally:
        with _lock:
            _enabled -= 1
            if not _enabled and not _autograd_profiler._is_profiler_enabled:
                _live = False


class Span(NamedTuple):
    """A closed span of a snapshot.  ``parent`` is the index in
    ``Snapshot.spans`` of the span open around it on its thread, -1 for none;
    ``thread`` the OS thread id; ``start_ns``/``end_ns`` on
    ``time.perf_counter_ns``, ``clock_start_ns``/``clock_end_ns`` the same on
    the profiler's clock; ``cpu_ns`` the thread's CPU time over the span, None
    for a span opened with ``cpu=False``."""

    name: str
    parent: int
    frame: int
    thread: int
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]
    clock_start_ns: int
    clock_end_ns: int

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass(frozen=True)
class Snapshot:
    spans: Tuple[Span, ...]        # closed spans, in the order they opened
    counters: Dict[str, int]
    offset_ns: int                 # the profiler's clock less perf_counter_ns
    dropped: int                   # spans past the session's bound, not kept


def snapshot() -> Snapshot:
    """The last session's closed spans and its counters (a span still open
    is left out, and a child of it has parent -1)."""
    s = _session
    with _lock:
        closed = sorted(s.closed)
        counters = dict(s.counters)
        dropped = s.dropped
    index = {r[0]: i for i, r in enumerate(closed)}
    off = s.offset_ns
    spans = tuple(Span(name, index.get(parent, -1), frame, thread, start, end, cpu,
                       start + off, end + off)
                  for _, name, parent, frame, thread, start, end, cpu in closed)
    return Snapshot(spans, counters, off, dropped)
