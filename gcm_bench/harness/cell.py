"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch and the checks that decide ``correct``.

1. Set-up builds the engine from the configuration and the seed's draws,
   with room for the traffic's ``max_steps`` of source amplitudes.
2. The warm-up is the run's first ``warmup_steps`` steps from rest, through
   ``run()``: it loads the kernels, warms every shape of the cell, and its
   steps after the second give the step time. Its callback at the last
   step copies the ``start`` check's box around the source from the device
   state and stops ``run()`` there, before ``run()`` would gather the
   whole state to the host: no user's set-up pays that gather.
3. The window continues the same run (``start_step``) for ``N`` steps, ``N``
   even and as many as fill ``--seconds`` at the warm-up's step time: one
   ``run()`` whose callback, at the window's last step, synchronises every
   card and reads the clock. The rate (every metric in points/s) is every
   body's points times ``N`` over the seconds from the ``run()`` call to
   that clock. The callback then copies the state to the host, and
   ``run()`` goes on for the ``check_steps`` that the reference follows,
   then gathers the state (timed apart, outside the window: a real job
   amortises it).
4. With ``trace``, the functions the cell's per-layer metrics name are
   timed for the window's steps, and ``traced_steps`` more run under the
   profiler before the copy. The profiler's device tracing is first
   started after the window: once started, it slows every later launch
   from the host, and the window's wall time a step is what
   ``device_idle_share`` divides by.
5. After ``run()`` returns, the peak memory is read, the engine is freed,
   and the reference (``gcm_bench.reference``) judges the program's
   output.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gcm_bench.harness import program
from gcm_bench.harness.draws import draw
from gcm_bench.harness.profile import Traced, warm_profiler
from gcm_bench.harness.spec import Spec
from gcm_bench.reference.problem import Problem


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class _WarmedUp(Exception):
    """Raised by the warm-up's callback at its last step to leave
    ``run()`` before its final gather."""


def judge(readings: Dict[str, Dict[str, float]], limits: Dict,
          who: str = "program") -> Tuple[Dict, list]:
    """The checks of ``who``'s readings (``"program"`` or ``"control"``),
    each its value beside the configuration's limit, and the names of
    those that fail: no limit, a value that is not finite, or one above
    its limit."""
    checks = {name: {"value": r[who], "limit": limits.get(name)}
              for name, r in readings.items()}
    failed = [n for n, c in checks.items()
              if c["limit"] is None or not np.isfinite(c["value"])
              or c["value"] > c["limit"]]
    return checks, failed


def execute(spec: Spec, cell: Dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: Optional[float] = None,
            control: bool = False) -> Dict:
    """The result of one run, as the last line of ``run.py`` prints it;
    with ``control``, ``"control"`` holds the verdict of the same checks
    on the control (the reference in bfloat16 in the program's place):
    ``correct``, ``failed`` and its ``checks``."""
    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = spec.config(cell), spec.traffic(cell)
    draws = draw(config, traffic, seed)
    W, k = int(traffic["warmup_steps"]), int(traffic["check_steps"])
    T = int(traffic["traced_steps"]) if trace else 0
    readers = ({m["name"]: spec.reader(m) for m in spec.per_layer(cell)}
               if trace else {})
    cuda = torch.device(device).type == "cuda"
    built = None
    if cuda:
        from gcm_tpu_torch.ops import _build

        built = not _build.library_path().exists()
    t0 = time.perf_counter()
    eng = program.build(config, draws, device, int(traffic["max_steps"]))
    devs = program.engine_devices(eng)
    npts = program.points(eng)
    t_built = time.perf_counter()

    # the warm-up: the run's first W steps
    eng.nsteps = W
    clock: Dict[int, float] = {}
    box = Problem(config, draws).start_box(W)
    sb = draws["source"]["body"]
    warm: Dict[str, np.ndarray] = {}

    def warm_cb(step: int, u) -> None:
        if step in (2, W):
            program.sync(devs)
            clock[step] = time.perf_counter()
        if step == W:
            warm["box"] = program.box_of(eng, u, sb, box)
            raise _WarmedUp

    try:
        program.run(eng, warm_cb, 2)
    except _WarmedUp:
        pass
    step_s = (clock[W] - clock[2]) / (W - 2)
    t_warm = time.perf_counter()
    N = max(2, 2 * int(seconds / step_s / 2))
    _log(f"set-up: imports and the cards {t0 - t_start:.3f} s; "
         f"kernels built in this run {built}; engine "
         f"{t_built - t0:.3f} s, warm-up {t_warm - t_built:.3f} s; "
         f"{npts} points, {step_s * 1e3:.4f} ms a step -> {N} window steps")

    # the window, then the traced stretch, then the copy for the checks
    end, stop = W + N, W + N + T
    eng.start_step = W
    eng.nsteps = stop + k
    timed = program.Timed([w for r in readers.values()
                           for w in getattr(r, "WRAP", ())])
    traced = Traced() if trace else None
    got: Dict[str, object] = {}

    def capture() -> None:
        t = time.perf_counter()
        got["before"] = program.host_state(eng, eng.state_dict())
        got["capture_s"] = time.perf_counter() - t

    def window_cb(step: int, u) -> None:
        if step == end:
            program.sync(devs)
            got["t_end"] = time.perf_counter()
            timed.remove()
            if traced is None:
                capture()
            else:
                if cuda:
                    warm_profiler()
                traced.start()
        if traced is not None and step == stop:
            program.sync(devs)
            traced.stop()
            capture()

    timed.install()
    t_window = time.perf_counter()
    try:
        res = program.run(eng, window_cb, end if traced is None else 2)
    finally:
        timed.remove()
    t_ret = time.perf_counter()
    window_s = got["t_end"] - t_window
    after = program.result_state(eng, res)
    peak = program.peak_bytes(devs)
    cards = sorted({d.index or 0 for d in devs})
    reduced = traced.reduce(cards) if traced is not None else None
    _log(f"window: {N} steps in {window_s:.6f} s; copy for the checks "
         f"{got['capture_s']:.3f} s; {k} more steps and the final gather "
         f"{t_ret - got['t_end'] - got['capture_s']:.3f} s")
    del eng, res
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the checks
    t_ref = time.perf_counter()
    ref = Problem(config, draws, torch.float64, devs[0])
    ctl = Problem(config, draws, torch.bfloat16, devs[0]) if control \
        else None
    n0 = stop
    tr = after["traces"]
    after["traces"] = None if tr is None else np.asarray(tr)[-k:]
    readings = {"start": ref.start_error(warm["box"], W, ctl)}
    readings.update(ref.end_errors(got["before"], after, n0, k, ctl))
    _log(f"reference: {time.perf_counter() - t_ref:.3f} s; bonds intact "
         + ", ".join(f"{float(np.mean(m > 0.5)):.6f}"
                     for m in after["bonded"].values()))
    checks, failed = judge(readings, config["limits"])
    out: Dict = {"correct": not failed, "attempted": len(checks),
                 "failed": len(failed)}
    if trace:
        ctx = {"config": config, "cell": cell, "trace": reduced,
               "traced_steps": T, "window_steps": N,
               "window_s": window_s, "timed_ms": timed.total_ms,
               "cards": cards}
        metrics = {}
        for m in spec.per_layer(cell):
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        value = {"peak_device_gib": None if peak is None else peak / 2 ** 30,
                 "setup_s": t_window - t_start}
        metrics = {}
        for m in spec.end_to_end(cell):
            # every metric in points/s is the window's rate, whatever
            # cells it is named for
            v = (npts * N / window_s if m["unit"] == "points/s"
                 else value[m["name"]])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = {"count": len(cards), "memory_peak_bytes": peak}
    if reduced is not None:
        busy = [reduced["busy_s"].get(c, 0.0) for c in cards]
        out["device"].update(busy_s=sum(busy) / len(busy),
                             window_s=reduced["window_s"])
        out["breakdown"] = reduced["breakdown"]
    out["checks"] = checks
    if control:
        cchecks, cfailed = judge(readings, config["limits"], "control")
        out["control"] = {"correct": not cfailed, "failed": len(cfailed),
                          "checks": cchecks}
    return out
