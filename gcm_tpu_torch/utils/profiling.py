"""Tracing and profiling hooks.

Counterpart of ``gcm_tpu/utils/profiling.py``: ``torch.profiler`` traces
of the host and the card (a Chrome trace, viewable in Perfetto or
``chrome://tracing``), named regions in them, and a throughput meter that
reports grid points per second per run section.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(outdir: Optional[str]) -> Iterator[None]:
    """Trace the CPU and, where torch sees one, the CUDA device into
    ``<outdir>/trace.json`` (a no-op when ``outdir`` is None)."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))


class ThroughputMeter:
    """Accumulates (points, steps, seconds) and reports points/s."""

    def __init__(self, npoints: int):
        self.npoints = npoints
        self.steps = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def section(self, nsteps: int) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.steps += nsteps

    @property
    def points_per_second(self) -> float:
        return self.npoints * self.steps / max(self.seconds, 1e-12)

    def report(self) -> str:
        return json.dumps({
            "steps": self.steps,
            "seconds": round(self.seconds, 4),
            "points_per_second": round(self.points_per_second, 1),
        })


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the trace."""
    with torch.profiler.record_function(name):
        yield
