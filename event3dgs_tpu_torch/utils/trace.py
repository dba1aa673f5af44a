"""Spans and a host-sync counter for the port's host layers.

A span is a named interval of host time: ``with span("train.chunk", n=k):``.
Each span that closes appends ``(id, parent id, name, start_ns, end_ns, n)``
to an in-memory record, the parent being the innermost span open when it
began (-1 at the top) and ``n`` -1 where the caller gave none (it may be set
while the span is open).  The stamps are ``time.perf_counter_ns()``;
:func:`epoch_offset_ns` puts them on the clock of ``torch.profiler``'s
events.  The record keeps the newest ``LIMIT`` spans and counts those it
dropped (:func:`dropped`); :func:`clear` empties it, so a reader can take a
window.  While a ``torch.profiler`` runs, a span is also a host event of the
profiler's, named as the span, so it shows on the profiler's timeline.  That
event is an operator's range (``_RecordFunctionFast``), not
``record_function``'s user annotation: the profiler mirrors a user
annotation on the device's timeline over the kernels launched inside it,
which would count as device time.  A span closes when an exception leaves
it.

``host_syncs`` counts the host's waits on the device in the training loop
and the fused steps, as the package's other counters count, one at each
site that :func:`synced` marks (a span that adds one to it): each instance
probe's read, the fused steps' table upload (a copy from pageable memory,
which waits for the stream), their losses' readback and their capture, the
log tick's metric reads, the eager step's loss read and the loop's final
synchronize.  The densify branch's waits are not counted.

Spans are opened and closed from one thread.
"""

from __future__ import annotations

import collections
import time

import torch

LIMIT = 1 << 16  # spans kept; older ones are dropped and counted

host_syncs = 0

_kept: collections.deque = collections.deque(maxlen=LIMIT)
_dropped = 0
_begun = 0  # spans begun so far: the next span's id
_open: list = []  # ids of the open spans, innermost last


class Span:
    """One span; its record is appended when it closes."""

    __slots__ = ("name", "n", "id", "parent", "start_ns", "end_ns", "_marker")

    def __init__(self, name: str, n=None):
        self.name, self.n = name, -1 if n is None else int(n)
        self.id = self.parent = -1
        self.start_ns = self.end_ns = 0
        self._marker = None

    def __enter__(self):
        global _begun
        self.start_ns = time.perf_counter_ns()
        self.id, _begun = _begun, _begun + 1
        self.parent = _open[-1] if _open else -1
        _open.append(self.id)
        if torch.autograd.profiler._is_profiler_enabled:
            self._marker = torch._C._profiler._RecordFunctionFast(self.name)
            self._marker.__enter__()
        return self

    def __exit__(self, *exc):
        global _dropped
        if self._marker is not None:
            self._marker.__exit__(*exc)
            self._marker = None
        self.end_ns = time.perf_counter_ns()
        _open.remove(self.id)
        if len(_kept) == LIMIT:
            _dropped += 1
        _kept.append((self.id, self.parent, self.name, self.start_ns,
                      self.end_ns, self.n))
        return False

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


def span(name: str, n=None) -> Span:
    """A span named ``name`` (``n``: a count it covers, such as steps)."""
    return Span(name, n)


def synced(what: str) -> Span:
    """A span around one host wait on the device; adds one to
    ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    return Span(what)


def spans() -> list:
    """The kept spans, oldest first."""
    return list(_kept)


def clear() -> None:
    """Forget the kept spans and the count of dropped ones."""
    global _dropped
    _kept.clear()
    _dropped = 0


def dropped() -> int:
    return _dropped


def begun() -> int:
    """Spans begun so far: the id the next one gets."""
    return _begun


def _read_offset() -> int:
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return wall - (a + b) // 2


_OFFSET_NS = _read_offset()


def epoch_offset_ns() -> int:
    """What to add to a span's stamps to put them on ``torch.profiler``'s
    clock (nanoseconds since the epoch): read once, at import."""
    return _OFFSET_NS
