"""Command-line launcher: ``python -m gcm_tpu_torch <command> ...``.

Commands:
  list
  run <scenario> [--n N] [--nsteps K]
                 [--kernel auto|torch|fused|sweep|simplex] [--device cuda|cpu]
                 [--mesh NX[,NY]]

``run`` prints one JSON summary line: the resolved kernel, points per
second, steps, dt, grid shape (``npoints`` for a simplex mesh) and device.
Scenarios whose name starts with ``simplex`` run on
``engine_simplex.SimplexEngine``, with the kernels ``auto``, ``torch`` and
``simplex``. ``--mesh NX[,NY]`` splits the grid over NX (x) by NY (y, 3D
only) shards on the first NX*NY visible cards (raising if there are fewer),
or, with ``--device cpu``, co-resident on the CPU.
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
    r.add_argument("--mesh", default=None, metavar="NX[,NY]",
                   help="split the grid over NX x NY shards, one per card "
                        "(all on the CPU with --device cpu)")
    return p


def _mesh(spec: str, dim: int, device: str):
    """The DomainMesh of ``--mesh NX[,NY]``."""
    import math

    import torch

    from gcm_tpu_torch.parallel.sharding import domain_mesh

    shape = tuple(int(v) for v in spec.split(","))
    if len(shape) > (2 if dim == 3 else 1):
        raise SystemExit(f"--mesh {spec}: a {dim}D grid splits "
                         f"{'x and y' if dim == 3 else 'x'} only")
    n = math.prod(shape)
    if torch.device(device).type == "cpu":
        devices = ["cpu"] * n
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise SystemExit(f"--mesh {spec} needs {n} CUDA devices, torch "
                             f"sees {count}")
        devices = [torch.device("cuda", i) for i in range(n)]
    if dim == 3:
        return domain_mesh(3, devices, shape + (1,) * (2 - len(shape)))
    return domain_mesh(dim, devices)


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
        if args.mesh:
            raise SystemExit("--mesh runs structured scenarios only")
        return _run_simplex(task, args.device)
    if args.mesh:
        res = Engine(task, mesh=_mesh(args.mesh, task.grid.dim,
                                      args.device)).run()
    else:
        res = Engine(task, device=args.device).run()
    print(json.dumps({
        "scenario": task.name,
        "kernel": res.kernel,
        "points_per_second": res.points_per_second,
        "nsteps": res.nsteps,
        "dt": res.dt,
        "shape": list(task.grid.shape),
        "device": args.device,
        "mesh": args.mesh,
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
