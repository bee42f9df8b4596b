"""The program's tracer: spans and counters, and ``torch.profiler`` traces.

Counterpart of ``gcm_tpu/utils/profiling.py``. The layers of the port mark
their work with :func:`span` (a named interval on the host) and
:func:`count` (a number computed from shapes or move lists, never read
from the device). Both do nothing until :func:`recording` turns the tracer
on: :func:`span` then reads one module global and returns one shared no-op
object, and :func:`count` reads the same global and returns.

While a recording is on, each span keeps its name, its start and end
(``time.perf_counter_ns``), the span it was opened in and its step: a
span given no ``step`` takes its parent's, so the spans of one engine step
share the step's number. Where a ``torch.profiler`` session is active
the span also enters ``torch.profiler.record_function``, so it is a host
event on the profiler's own clock, in the same event list as the kernels.
The tracer keeps one stack of open spans: spans are opened and closed on
one thread.

:func:`trace` (``python -m gcm_tpu_torch run --profile``) traces the host
and the card into ``trace.json`` with the spans among the events, and
writes the record's summary to ``spans.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

#: raw spans (and raw counts) a record keeps; later ones are only counted
MAX_EVENTS = 1 << 17


class Record:
    """What one recording saw.

    - ``stats``: for each span name ``[calls, total ns, self ns]``, self
      time being the total less what the span's children cover;
    - ``counters``: each counter's total;
    - ``spans``: raw spans ``(id, name, start_ns, end_ns, parent id or -1,
      step or None)`` in the order they closed, and ``counts``: raw counts
      ``(name, n, step or None)``, each up to :data:`MAX_EVENTS` entries;
      ``dropped`` counts those past it (``stats`` and ``counters`` stay
      whole).
    """

    def __init__(self):
        self.cap = MAX_EVENTS
        self.stats: Dict[str, List[int]] = {}
        self.counters: Dict[str, int] = {}
        self.spans: List[Tuple[int, str, int, int, int, Optional[int]]] = []
        self.counts: List[Tuple[str, int, Optional[int]]] = []
        self.dropped = 0
        self._open: List[_Span] = []
        self._ids = 0

    def summary(self) -> Dict:
        """For each span its calls, total ms and self ms; the counters; the
        raw events dropped past the cap."""
        return {"spans": {name: {"calls": c, "total_ms": t / 1e6,
                                 "self_ms": s / 1e6}
                          for name, (c, t, s) in self.stats.items()},
                "counters": dict(self.counters),
                "dropped": self.dropped}


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()

#: the record of the recording that is on (None: the tracer is off)
_record: Optional[Record] = None


class _Span:
    __slots__ = ("rec", "name", "step", "id", "parent", "t0", "inner", "rf")

    def __init__(self, rec: Record, name: str, step: Optional[int]):
        self.rec, self.name, self.step = rec, name, step

    def __enter__(self):
        rec = self.rec
        top = rec._open[-1] if rec._open else None
        self.parent = -1 if top is None else top.id
        if self.step is None and top is not None:
            self.step = top.step
        self.id = rec._ids
        rec._ids += 1
        self.inner = 0
        rec._open.append(self)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        rec._open.pop()
        ns = t1 - self.t0
        if rec._open:
            rec._open[-1].inner += ns
        st = rec.stats.get(self.name)
        if st is None:
            st = rec.stats[self.name] = [0, 0, 0]
        st[0] += 1
        st[1] += ns
        st[2] += ns - self.inner
        if len(rec.spans) < rec.cap:
            rec.spans.append((self.id, self.name, self.t0, t1, self.parent,
                              self.step))
        else:
            rec.dropped += 1
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager marking ``name`` (with ``step``, or its parent's)
    while a recording is on; the shared no-op object while it is off."""
    rec = _record
    if rec is None:
        return _OFF
    return _Span(rec, name, step)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a recording is on, at the step of
    the innermost open span."""
    rec = _record
    if rec is None:
        return
    rec.counters[name] = rec.counters.get(name, 0) + n
    if len(rec.counts) < rec.cap:
        rec.counts.append((name, n, rec._open[-1].step if rec._open
                           else None))
    else:
        rec.dropped += 1


def enabled() -> bool:
    """Whether a recording is on: callers skip the arithmetic of a count
    while it is off."""
    return _record is not None


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Turn the tracer on; yields the :class:`Record` it fills. The record
    stays in memory; nothing is written. The recording that was on before,
    if any, is on again after."""
    global _record
    saved = _record
    rec = _record = Record()
    try:
        yield rec
    finally:
        _record = saved


@contextlib.contextmanager
def trace(outdir: Optional[str]) -> Iterator[None]:
    """Trace the CPU and, where torch sees one, the CUDA device into
    ``<outdir>/trace.json`` with a recording on, so its spans are among the
    events, and write the record's :meth:`Record.summary` to
    ``<outdir>/spans.json`` (a no-op when ``outdir`` is None)."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=activities) as prof, recording() as rec:
        yield
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
    with open(os.path.join(outdir, "spans.json"), "w") as f:
        json.dump(rec.summary(), f, indent=1)
