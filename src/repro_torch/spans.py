"""Spans of the program's work, live only while ``torch.profiler`` records.

``span(name, **attrs)`` marks one call of a layer: ``repro_torch.<name>``.
With no profiler recording it returns one shared null context and does
nothing else: no ``record_function``, no CUDA event, no tensor op, no host
sync.  There is no option: tracing is on exactly while a profiler is on.

While one is, a span enters ``record_function`` (so the profiler holds its
host range, and on the card its device range, on the trace's own clock)
and appends a :class:`Record`: its name, its parent, the id of its root
span (the step), host start and end from ``time.time_ns()`` (the clock of
the profiler's host events), its attributes, and on the card a pair of
CUDA events on the current stream.  An attribute that is a tensor is held
by reference, to be read after the window: it must be one the program has
computed and does not write in place later.  One that is callable is
called once, when the span opens (attributes that cost host time to
gather).  Spans nest last in, first out, whichever thread opens them
(autograd's thread recomputes a remat'd forward while the step's thread
waits).

:func:`records` returns the current or last session's records, and reads
what they hold once, after a synchronize: each record's device time and
its held tensors (a 0-d one as a Python number, others on the CPU), and
every ``torch.dtype`` as its name.  Call it after the traced window: its
reads are device operations.  The first span that opens while a profiler
records, after a span found none recording or after :func:`records` was
called with none recording, starts a new session.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

PREFIX = "repro_torch."


def live() -> bool:
    """Whether a profiler is recording (the flag ``torch.profiler`` sets,
    in torch 2.11 and later)."""
    return _autograd_profiler._is_profiler_enabled


_NULL = contextlib.nullcontext()


class Record:
    """One span's call.  ``parent`` and ``step`` index :func:`records`'
    list and count roots; ``device_ms`` is ``None`` off the card."""
    __slots__ = ("name", "parent", "step", "t0", "t1", "attrs",
                 "device_ms", "_events", "_read")

    def __init__(self, name: str, parent: Optional[int], step: int,
                 attrs: Dict[str, Any], t0: int = 0, t1: int = 0,
                 device_ms: Optional[float] = None):
        self.name, self.parent, self.step = name, parent, step
        self.attrs, self.t0, self.t1 = attrs, t0, t1
        self.device_ms, self._events, self._read = device_ms, None, False

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, parent={self.parent}, "
                f"step={self.step}, attrs={self.attrs})")


class _Session:
    def __init__(self, open: bool = True):
        self.records: List[Record] = []
        self.roots = 0
        self.open = open
        self.stack: List[int] = []      # open spans, innermost last


_session = _Session(open=False)


def _current() -> _Session:
    global _session
    if not _session.open:
        _session = _Session()
    return _session


class _Span:
    __slots__ = ("name", "attrs", "session", "rec", "mark")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = PREFIX + name, attrs

    def __enter__(self):
        s = self.session = _current()
        attrs = {k: v() if callable(v) else v for k, v in self.attrs.items()}
        if s.stack:
            parent = s.stack[-1]
            step = s.records[parent].step
        else:
            parent, step = None, s.roots
            s.roots += 1
        rec = self.rec = Record(self.name, parent, step, attrs)
        s.stack.append(len(s.records))
        s.records.append(rec)
        rec.t0 = time.time_ns()
        self.mark = record_function(self.name)
        self.mark.__enter__()
        if torch.cuda.is_initialized():
            rec._events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            rec._events[0].record()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec._events is not None:
            rec._events[1].record()
        self.mark.__exit__(*exc)
        rec.t1 = time.time_ns()
        self.session.stack.pop()
        return False


def span(name: str, **attrs):
    """A context marking one call of ``repro_torch.<name>``, recorded while
    a profiler records and a shared null context otherwise."""
    if not live():
        _session.open = False
        return _NULL
    return _Span(name, attrs)


def _plain(value, seen: Dict[int, Any]):
    if isinstance(value, torch.Tensor):
        if id(value) not in seen:
            seen[id(value)] = value.item() if value.dim() == 0 \
                else value.detach().cpu()
        return seen[id(value)]
    if isinstance(value, torch.dtype):
        return str(value).rsplit(".", 1)[-1]
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v, seen) for v in value)
    return value


def records() -> List[Record]:
    """The records of the current or last session, each read once (after
    the traced window)."""
    s = _session
    if not live():
        s.open = False
    done = [r for r in s.records if r.t1 and not r._read]
    if any(r._events is not None for r in done):
        torch.cuda.synchronize()
    seen: Dict[int, Any] = {}
    for r in done:
        if r._events is not None:
            r.device_ms = r._events[0].elapsed_time(r._events[1])
            r._events = None
        r.attrs = {k: _plain(v, seen) for k, v in r.attrs.items()}
        r._read = True
    return list(s.records)
