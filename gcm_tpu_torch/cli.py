"""Command-line launcher: ``python -m gcm_tpu_torch <command> ...``.

Commands:
  list
  run <scenario> [--n N] [--nsteps K]
                 [--kernel auto|torch|fused|sweep|simplex] [--device cuda|cpu]
                 [--mesh NX[,NY]] [--canonical-layout|--no-canonical-layout]
                 [--outdir DIR] [--snapshot-every S] [--checkpoint-every C]
                 [--resume] [--profile]
  bench [--shape 256,256,128] [--path torch|sweep|fused|best]
        [--device cuda|cpu]

``run`` writes its artifacts under ``--outdir`` (default ``out``):
snapshots every S steps in ``snapshots/`` (``<scenario>_<step>.vti``, a
simplex mesh's ``.vtu``, a ``.pvd`` collection of them), the seismograms
``<scenario>.npz|.bin|.json`` where the scenario has receivers, and
checkpoints every C steps in ``checkpoints/step_<n>.npz``; cadences are
rounded up to the symmetrization period. ``--resume`` continues from the
newest checkpoint there, ``--profile`` writes a ``torch.profiler`` trace to
``trace/trace.json``, the program's ``gcm.*`` spans among its events, and
each span's calls, total and self ms and the program's counters to
``trace/spans.json``. A simplex run ends with ``<scenario>_final.vtu``, a
contact run with each body's ``<body>_final.vti`` and its bond masks as
``.npy``.

``bench`` is the benchmark of record (``gcm_tpu_torch/bench.py``, the
port of the JAX package's ``bench.py``): it times each compute path on the
card and prints one JSON line of grid points a second; ``--path
torch|sweep|fused`` times that structured path alone. On the CPU only
``--path torch`` runs.

``run`` prints one JSON summary line: the resolved kernel, points per
second, steps, dt, grid shape (``npoints`` for a simplex mesh), device,
``outdir`` and ``resumed_from`` (the checkpoint's step, or null).
Scenarios whose name starts with ``simplex`` run on
``engine_simplex.SimplexEngine``, with the kernels ``auto``, ``torch`` and
``simplex``. ``--mesh NX[,NY]`` splits the grid over NX (x) by NY (y, 3D
only) shards on the first NX*NY visible cards (raising if there are fewer),
or, with ``--device cpu``, co-resident on the CPU.

The multi-body contact scenarios (``elastic3d_contact``,
``elastic2d_basin_refined``) run on ``engine_multi.MultiBodyEngine``, in the
canonical splitting order unless ``--no-canonical-layout`` (as the JAX
CLI; a mesh of two axes keeps the default order, as in JAX); ``--mesh``
splits every body as above, by the bodies' dimension (a 2D body over x
only). Their summary names the resolved multi-body path (``_spmd`` on a
mesh), the kernel launches of the run, the mean of each bond mask, the
material stack's type and the mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


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
    r.add_argument("--canonical-layout", action="store_true", default=None,
                   help="the JAX package's canonical splitting order "
                        "(Task.canonical_layout); default: on for the "
                        "multi-body contact scenarios, off elsewhere")
    r.add_argument("--no-canonical-layout", dest="canonical_layout",
                   action="store_false", help="the default splitting order")
    r.add_argument("--outdir", default="out",
                   help="directory of the run's artifacts (default: out)")
    r.add_argument("--snapshot-every", type=int, default=None,
                   help="write a snapshot every S steps")
    r.add_argument("--checkpoint-every", type=int, default=0,
                   help="write a checkpoint every C steps")
    r.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in outdir")
    r.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace to "
                        "<outdir>/trace/trace.json and the spans' and "
                        "counters' totals to <outdir>/trace/spans.json")
    from gcm_tpu_torch import bench

    bench.add_arguments(sub.add_parser(
        "bench", help="time the compute paths (the benchmark of record)"))
    return p


def _mesh(spec: str, dim: int, device: str):
    """The DomainMesh of ``--mesh NX[,NY]``: with ``--device cuda`` one
    card a shard (cuda:0, cuda:1, ... in mesh order), as the JAX CLI puts
    one device a shard (``gcm_tpu/cli.py:130-139, 206-217``); a single
    count is factored near-square on a 3D grid (``--mesh 4``: 2x2), as
    there."""
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
        return domain_mesh(3, devices, shape if len(shape) > 1 else None)
    return domain_mesh(dim, devices)


def _resume(eng, args):
    """Load the newest checkpoint under ``--outdir`` into ``eng`` when
    ``--resume`` asks for it; its step, or None."""
    from gcm_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint

    ckdir = os.path.join(args.outdir, "checkpoints")
    step = latest_step(ckdir) if args.resume else None
    if step is not None:
        eng.load_state(restore_checkpoint(ckdir, step=step))
        print(f"resumed from step {step}", file=sys.stderr)
    return step


def _trace(args):
    from gcm_tpu_torch.utils.profiling import trace

    return trace(os.path.join(args.outdir, "trace") if args.profile else None)


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "bench":
        from gcm_tpu_torch import bench

        bench.main(bench.parse_shape(args.shape), args.path, args.device)
        return 0
    from gcm_tpu_torch.scenarios import get_scenario, list_scenarios

    if args.cmd == "list":
        from gcm_tpu_torch.scenarios import MULTI_SCENARIOS

        for name in list_scenarios():
            print(name)
        for name in sorted(MULTI_SCENARIOS):
            print(f"{name}  (multi-body; via gcm_tpu_torch.engine_multi)")
        return 0

    import dataclasses

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.task import SnapshotSpec

    kw = {k: v for k, v in (("n", args.n), ("nsteps", args.nsteps))
          if v is not None}
    from gcm_tpu_torch.scenarios import MULTI_SCENARIOS

    if args.scenario in MULTI_SCENARIOS:
        return _run_contact(args, kw)
    task = get_scenario(args.scenario, **kw)
    if args.kernel is not None:
        task = dataclasses.replace(task, kernel=args.kernel)
    if args.canonical_layout:
        task = dataclasses.replace(task, canonical_layout=True)
    if args.snapshot_every is not None:
        task = dataclasses.replace(
            task, snapshots=SnapshotSpec(every=args.snapshot_every))
    if args.scenario.startswith("simplex"):
        if args.mesh:
            raise SystemExit("--mesh runs structured scenarios only")
        return _run_simplex(task, args)
    with _trace(args):
        if args.mesh:
            eng = Engine(task, mesh=_mesh(args.mesh, task.grid.dim,
                                          args.device))
        else:
            eng = Engine(task, device=args.device)
        resumed = _resume(eng, args)
        res = eng.run_with_outputs(args.outdir,
                                   checkpoint_every=args.checkpoint_every)
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
        "outdir": args.outdir,
        "resumed_from": resumed,
    }))
    return 0


def _launch_counters():
    from gcm_tpu_torch.ops.fused import (
        fused_step, fused_step_2d, fused_step_slab)
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_interior, fused_spmd_ring)
    from gcm_tpu_torch.ops.sweep import sweep_stage

    return {f.__name__: f for f in (fused_step, fused_step_slab,
                                    fused_step_2d, sweep_stage,
                                    fused_spmd_interior, fused_spmd_ring)}


def _run_contact(args, kw) -> int:
    import dataclasses

    from gcm_tpu_torch.engine_multi import (
        MultiBodyEngine, write_body_snapshots)
    from gcm_tpu_torch.scenarios import MULTI_SCENARIOS

    bodies, contacts = MULTI_SCENARIOS[args.scenario](**kw)
    if args.kernel is not None:
        bodies = {k: dataclasses.replace(t, kernel=args.kernel)
                  for k, t in bodies.items()}
    canon = args.canonical_layout if args.canonical_layout is not None \
        else True
    mesh = None
    if args.mesh:
        dim = next(iter(bodies.values())).grid.dim
        mesh = _mesh(args.mesh, dim, args.device)
    with _trace(args):
        eng = MultiBodyEngine(bodies, contacts,
                              device=None if mesh else args.device,
                              canonical_layout=canon, mesh=mesh)
        resumed = _resume(eng, args)
        counters = _launch_counters()
        before = {k: f.launches for k, f in counters.items()}
        res = eng.run_with_outputs(args.outdir,
                                   snapshot_every=args.snapshot_every or 0,
                                   checkpoint_every=args.checkpoint_every)
    launched = {k: f.launches - before[k] for k, f in counters.items()}
    write_body_snapshots(args.outdir, "final", eng.tasks, eng.model,
                         res.bodies, res.bonded)

    def mean(m):
        if isinstance(m, dict):
            return {s: float(v.mean()) for s, v in m.items()}
        return float(m.mean())

    print(json.dumps({
        "scenario": args.scenario,
        "path": res.path,
        "kernel": eng.kernel,
        "launches": {k: v for k, v in launched.items() if v},
        "points_per_second": res.points_per_second,
        "nsteps": res.nsteps,
        "dt": res.dt,
        "shapes": {k: list(t.grid.shape) for k, t in bodies.items()},
        "bonded_mean": {str(k): mean(v) for k, v in res.bonded.items()},
        "mat_dtype": sorted({t.mat_dtype for t in bodies.values()}),
        "device": args.device,
        "mesh": args.mesh,
        "wall_seconds": res.wall_seconds,
        "outdir": args.outdir,
        "resumed_from": resumed,
    }))
    return 0


def _run_simplex(task, args) -> int:
    from gcm_tpu_torch.engine_simplex import SimplexEngine

    eng = SimplexEngine.from_task(task, device=args.device)
    resumed = _resume(eng, args)
    with _trace(args):
        res = eng.run_with_outputs(args.outdir,
                                   checkpoint_every=args.checkpoint_every)
    eng.write_snapshot(os.path.join(args.outdir,
                                    f"{args.scenario}_final.vtu"))
    print(json.dumps({
        "scenario": task.name,
        "kernel": res.kernel,
        "points_per_second": res.points_per_second,
        "nsteps": res.nsteps,
        "dt": res.dt,
        "npoints": eng.grid.npoints,
        "device": args.device,
        "wall_seconds": res.wall_seconds,
        "outdir": args.outdir,
        "resumed_from": resumed,
    }))
    return 0
