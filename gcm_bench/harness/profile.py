"""The traced stretch of a run: ``torch.profiler`` over a few steps, reduced
in memory to what the per-layer metrics read (nothing is written to disk).

- each card's busy time: the union of its kernel, copy and set events,
  overlaps counted once;
- each card's device events, counted;
- the device operations that took most time, by the profiler's names;
- the longest idle gaps of the busiest card, each named by what the host
  was doing meanwhile: the innermost host operation, other than a CUDA
  runtime call, that spans the gap's middle.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

#: the longest idle gaps that are named (the rest are shorter)
_LABELLED_GAPS = 500


def union_s(spans: Sequence[Tuple[float, float]]) -> float:
    """Seconds that the intervals ``spans`` (profiler microseconds) cover,
    overlaps counted once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def merged(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.strip()[:200]


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


class Traced:
    """A profiler session, started and stopped between steps with every
    card synchronised by the caller."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.window_s = None

    def start(self) -> None:
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def reduce(self, cards: Sequence[int]) -> Dict:
        """Busy seconds and event counts by card, the top device
        operations and the longest idle gaps by what the host did."""
        events = list(self._prof.events())
        dev: Dict[int, List] = {c: [] for c in cards}
        host = []
        for e in events:
            span = (e.time_range.start, e.time_range.end)
            if _is_device(e):
                dev.setdefault(e.device_index, []).append(
                    (span, short_name(e.name)))
            elif not e.name.startswith("cuda"):
                host.append((span, e.name))
        busy = {c: union_s([s for s, _ in ev]) for c, ev in dev.items()}
        by_op: Dict[str, float] = {}
        for ev in dev.values():
            for (a, b), name in ev:
                by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps: Dict[str, float] = {}
        if busy and any(dev.values()):
            card = max(busy, key=busy.get)
            spans = merged([s for s, _ in dev[card]])
            holes = sorted(((b - a, 0.5 * (a + b)) for (_, a), (b, _)
                            in zip(spans, spans[1:])), reverse=True)
            starts = np.array([s for (s, _), _ in host], dtype=np.float64)
            ends = np.array([e for (_, e), _ in host], dtype=np.float64)
            names = [n for _, n in host]
            for width, mid in holes[:_LABELLED_GAPS]:
                inside = np.flatnonzero((starts <= mid) & (ends >= mid))
                name = ("host: no operation" if inside.size == 0 else
                        names[inside[np.argmin(ends[inside]
                                               - starts[inside])]])
                gaps[name] = gaps.get(name, 0.0) + width / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "events": {c: len(ev) for c, ev in
                                           dev.items()},
                "window_s": self.window_s,
                "breakdown": {"device_ops": [[n, s] for n, s in top],
                              "idle_gaps": [[n, s] for n, s in idle]}}


def warm_profiler() -> None:
    """Start the profiler's device tracing once, so that the traced stretch
    does not pay its first start."""
    t = Traced()
    t.start()
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    t.stop()
