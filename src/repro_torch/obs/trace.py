"""Port of ``repro/obs/trace.py``: the ``span`` API and ``Span``.

Structured trace spans over a bounded per-process ring buffer.  The data
path (store read -> blob parse -> entropy/residual decode -> spatial
convert -> batched detect) emits *spans*: named intervals with a parent
link and a small dict of scalar attributes.  Spans form per-thread stacks
(``threading.local``) so nesting needs no plumbing, and finished spans
land in a fixed-capacity ring.

Disabled cost is one attribute read plus a shared no-op context manager:
``span()`` returns the ``_NOOP`` singleton without allocating.  Span times
are host clock times; on the card they cover the enqueue of device work,
not its execution, unless the caller synchronises inside the span.

Remote contexts, ``start_span``/``finish``, ``take``/``absorb`` and the
Chrome trace export belong to the observability and cluster slices and are
not ported yet.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque


class Span:
    """One finished interval.  ``t0`` is ``time.perf_counter()`` seconds;
    ids are 64-bit ints (32-bit per-process salt << 32 | counter)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "dur",
                 "pid", "tid", "attrs")

    def __init__(self, name, trace_id, span_id, parent_id, t0, dur,
                 pid, tid, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.dur = dur
        self.pid = pid
        self.tid = tid
        self.attrs = attrs

    def to_wire(self) -> dict:
        """Msgpack-safe dict (short keys; attrs coerced to scalars)."""
        return {"n": self.name, "t": self.trace_id, "s": self.span_id,
                "p": self.parent_id, "t0": self.t0, "d": self.dur,
                "pid": self.pid, "tid": self.tid,
                "a": {k: (v if isinstance(v, (str, int, float, bool))
                          else str(v))
                      for k, v in self.attrs.items()}}

    @staticmethod
    def from_wire(d: dict) -> "Span":
        return Span(d["n"], int(d["t"]), int(d["s"]), int(d["p"]),
                    float(d["t0"]), float(d["d"]), int(d["pid"]),
                    int(d["tid"]), dict(d.get("a") or {}))


class _Noop:
    """Shared do-nothing span handle (the disabled-path return value)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _Noop()


class _SpanCM:
    """Live span handle: resolves its parent from the thread's span stack
    on enter and records into the tracer's ring on exit.  ``set`` adds
    attributes discovered mid-span."""

    __slots__ = ("_tr", "name", "attrs", "trace_id", "span_id",
                 "parent_id", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tr = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tr = self._tr
        tls = tr._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        if stack:
            self.trace_id, self.parent_id = stack[-1]
        else:
            self.trace_id, self.parent_id = tr.new_id(), 0
        self.span_id = tr.new_id()
        stack.append((self.trace_id, self.span_id))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tr
        # pop up to and including our own entry, so an exception deeper in
        # cannot leave orphaned entries for a reused thread
        stack = tr._tls.stack
        while stack:
            if stack.pop()[1] == self.span_id:
                break
        tr.record(Span(self.name, self.trace_id, self.span_id,
                       self.parent_id, self._t0, t1 - self._t0, tr.pid,
                       threading.get_ident(), self.attrs))
        return False


class Tracer:
    """Per-process span collector.  All public methods are thread-safe;
    ``enabled`` is a plain attribute read on the hot path."""

    def __init__(self, capacity: int = 16384):
        self.enabled = False
        self.capacity = int(capacity)
        self.pid = os.getpid()
        self._mu = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=self.capacity)  # guarded-by: _mu
        self._tls = threading.local()
        # ids unique across processes without coordination: a random
        # 32-bit per-process salt above a monotone counter
        self._salt = int.from_bytes(os.urandom(4), "big") | 1
        self._ids = itertools.count(1)

    def new_id(self) -> int:
        return (self._salt << 32) | (next(self._ids) & 0xFFFFFFFF)

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NOOP
        return _SpanCM(self, name, attrs)

    def record(self, span: Span) -> None:
        with self._mu:
            self._spans.append(span)

    def drain(self) -> list[Span]:
        with self._mu:
            out = list(self._spans)
            self._spans.clear()
        return out


#: process-wide default tracer; instrumentation goes through ``span``
TRACER = Tracer()


def span(name: str, **attrs):
    if not TRACER.enabled:
        return _NOOP
    return _SpanCM(TRACER, name, attrs)


def enable(on: bool = True) -> None:
    TRACER.enabled = on
