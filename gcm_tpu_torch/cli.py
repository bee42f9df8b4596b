"""Command-line launcher: ``python -m gcm_tpu_torch <command> ...``.

Commands:
  list
  run <scenario> [--n N] [--nsteps K]
                 [--kernel auto|torch|fused|sweep|simplex] [--device cuda|cpu]

``run`` prints one JSON summary line: the resolved kernel, points per
second, steps, dt, grid shape (``npoints`` for a simplex mesh) and device.
Scenarios whose name starts with ``simplex`` run on
``engine_simplex.SimplexEngine``, with the kernels ``auto``, ``torch`` and
``simplex``.
"""

from __future__ import annotations

import argparse
import json


def _build_parser():
    p = argparse.ArgumentParser(prog="gcm_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list available scenarios")
    r = sub.add_parser("run", help="run a named scenario")
    r.add_argument("scenario")
    r.add_argument("--n", type=int, default=None, help="grid resolution")
    r.add_argument("--nsteps", type=int, default=None)
    r.add_argument("--kernel", default=None,
                   choices=["auto", "torch", "fused", "sweep", "simplex"],
                   help="compute path (default: the task's 'auto' = the "
                        "fused CUDA kernel for 2D and 3D on a CUDA device, "
                        "the simplex sweep kernel for a simplex scenario "
                        "there; 'sweep' = one per-sweep kernel launch per "
                        "axis)")
    r.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    from gcm_tpu_torch.scenarios import get_scenario, list_scenarios

    if args.cmd == "list":
        for name in list_scenarios():
            print(name)
        return 0

    import dataclasses

    from gcm_tpu_torch.engine import Engine

    kw = {k: v for k, v in (("n", args.n), ("nsteps", args.nsteps))
          if v is not None}
    task = get_scenario(args.scenario, **kw)
    if args.kernel is not None:
        task = dataclasses.replace(task, kernel=args.kernel)
    if args.scenario.startswith("simplex"):
        return _run_simplex(task, args.device)
    res = Engine(task, device=args.device).run()
    print(json.dumps({
        "scenario": task.name,
        "kernel": res.kernel,
        "points_per_second": res.points_per_second,
        "nsteps": res.nsteps,
        "dt": res.dt,
        "shape": list(task.grid.shape),
        "device": args.device,
        "wall_seconds": res.wall_seconds,
    }))
    return 0


def _run_simplex(task, device) -> int:
    from gcm_tpu_torch.engine_simplex import SimplexEngine

    eng = SimplexEngine.from_task(task, device=device)
    res = eng.run()
    print(json.dumps({
        "scenario": task.name,
        "kernel": res.kernel,
        "points_per_second": res.points_per_second,
        "nsteps": res.nsteps,
        "dt": res.dt,
        "npoints": eng.grid.npoints,
        "device": device,
        "wall_seconds": res.wall_seconds,
    }))
    return 0
