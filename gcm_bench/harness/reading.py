"""What the per-layer readers (``metrics/<name>.py``) share: each takes the
run's context (``cell.execute``: the configuration, the reduced trace of
the traced stretch, its steps, the window's steps, the host ms of the timed
functions, the cards) and returns a number, or None where the run has
nothing to read."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from gcm_bench.harness.roofline import least_step_s


def roofline_share(ctx: Dict) -> Optional[float]:
    """% of the step's least time (its bytes at the published rate) in the
    busiest card's busy time a step."""
    trace = ctx.get("trace")
    if not trace or not any(trace["busy_s"].values()):
        return None
    busy = max(trace["busy_s"].values()) / ctx["traced_steps"]
    return 100.0 * least_step_s(ctx["config"]) / busy


def idle_share(ctx: Dict) -> Optional[float]:
    """% of a step in which a card runs nothing, the mean over the cards:
    1 - a traced step's busy time over a step's wall time in the untraced
    window. The profiler slows the host's steps, not the card's, so the
    traced stretch's own wall would count the profiler's work as idle."""
    trace = ctx.get("trace")
    if not trace or not ctx["window_s"] or not ctx["window_steps"]:
        return None
    busy = [trace["busy_s"].get(c, 0.0) for c in ctx["cards"]]
    if not any(busy):
        return None
    step_s = ctx["window_s"] / ctx["window_steps"]
    busy_step = sum(busy) / len(busy) / ctx["traced_steps"]
    return 100.0 * (1.0 - busy_step / step_s)


def launches(ctx: Dict) -> Optional[float]:
    """Device kernels, copies and sets a traced step, the mean over the
    cards."""
    trace = ctx.get("trace")
    if not trace:
        return None
    counts = [trace["events"].get(c, 0) for c in ctx["cards"]]
    if not any(counts):
        return None
    return sum(counts) / len(counts) / ctx["traced_steps"]


def host_ms_per_step(ctx: Dict, targets: Sequence[str]) -> Optional[float]:
    """Host ms a window step inside the timed functions ``targets``."""
    total = sum(ctx["timed_ms"].get(t, 0.0) for t in targets)
    if not total or not ctx["window_steps"]:
        return None
    return total / ctx["window_steps"]
