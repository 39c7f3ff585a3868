"""Spans of the program's own work, on the clock of torch's profiler.

    with tracing.span("predict.encode"):
        ...

A span records only while a torch.profiler session runs in this process:
starting a profiler is the switch, as it is for torch's own
`record_function`. With none running, `span()` returns one shared no-op
context: no span is made and no clock is read. While recording, each span
also enters `torch.profiler.record_function(name)`, so a profile with CPU
activity names it in its timeline.

A span holds its name, `start_ns` and `end_ns` from `time.time_ns()` (the
base of the profiler's event timestamps), its `span_id`, the `parent_id`
of the span open on this thread when it began, the `request_id` of its
root span (the root's own id), and keyword attributes. Spans stay in
memory, oldest first: `spans()` reads them, `clear()` empties them; the
program never writes them anywhere.
"""

import contextlib
import dataclasses
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_NOOP = contextlib.nullcontext()
_ids = itertools.count(1)
_recorded = []


class _Open(threading.local):
    def __init__(self):
        self.stack = []


_open = _Open()


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: int | None
    request_id: int
    attrs: dict
    start_ns: int = 0
    end_ns: int | None = None


@contextlib.contextmanager
def _record(name, attrs):
    stack = _open.stack
    span_id = next(_ids)
    if stack:
        s = Span(name, span_id, stack[-1].span_id, stack[-1].request_id, attrs)
    else:
        s = Span(name, span_id, None, span_id, attrs)
    with torch.profiler.record_function(name):
        stack.append(s)
        _recorded.append(s)
        s.start_ns = time.time_ns()
        try:
            yield s
        finally:
            s.end_ns = time.time_ns()
            stack.pop()


def span(name, **attrs):
    """A context manager that records span `name` with `attrs` while a
    torch.profiler session runs; otherwise the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _record(name, attrs)


def spans():
    """The closed spans, oldest first."""
    return [s for s in _recorded if s.end_ns is not None]


def clear():
    _recorded.clear()
