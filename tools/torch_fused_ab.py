#!/usr/bin/env python3
"""Time the fused 3D and 2D launches of the PyTorch/CUDA port of several
checkouts on one CUDA card, interleaved: the A/B comparison of two commits
on the same card.

    python3 tools/torch_fused_ab.py ROOT [ROOT ...] [--rounds 2] [--reps 50]
        [--path-runs 1] [--keys KEY,KEY,...]

Each ROOT is a checkout holding ``gcm_tpu_torch``. Round r runs every ROOT
in turn (in reverse order on odd rounds, so two roots run A B B A), each in
a process of its own, since the checkouts' packages share a name. A process
builds its checkout's kernels, runs ``elastic3d_explosion`` at n=256
(256x256x128, the shape of one body of the contact path) for 20 steps on
the fused path, and times with CUDA events, each the median of 5 batches
of REPS launches queued behind a spin kernel (device time, not the host's
enqueueing), on that state:

- ``fused_step``: ``fused_step`` in the sweep order (0, 1, 2);
- ``slab_f32``, ``slab_bf16``: ``fused_step_slab``, one step in the
  canonical contact order (2, 0, 1), on the float32 stack and on it
  rounded to bf16;
- ``pair_f32``, ``pair_bf16``: ``fused_step_slab``, one pass of two steps
  in the canonical contact pair (2, 0, 1) + (1, 0, 2), on the same stacks;
- ``sweep_x``, ``sweep_y``, ``sweep_z``: ``sweep_stage`` along each axis,
  on the engine's material views;
- ``interior``, ``ring``: the same scenario on a 2x2 mesh of four
  co-resident shards of 128^3, 20 steps, then ``fused_spmd_interior`` and
  ``fused_spmd_ring`` on shard 0 (sweep order (0, 1, 2));
- ``fused_2d_f32``, ``fused_2d_bf16``, ``pair_2d``: on the state of 20
  steps of ``elastic2d_viscoelastic`` at n=2048 (2048x2048, the 2D path),
  ``fused_step_2d`` in the sweep order (0, 1) on the float32 stack and on
  it rounded to bf16, and one two-step pass (0, 1) + (1, 0) on the float32
  stack;
- ``spmd_2d_interior``, ``spmd_2d_ring``: the same scenario on sx = 4
  co-resident shards of 512x2048, 20 steps, then ``fused_spmd_2d`` on
  shard 1 in each mode;
- ``host_spmd_2d_interior``, ``host_spmd_2d_ring``: the host's ms a call
  of those two wrappers (parameters, checks and the launch, with the card
  kept busy behind a spin kernel, so no call waits on it): the host work
  a launch adds to the host-paced sharded path;
- ``simplex``: ``simplex_sweep`` on the state of 20 steps of
  ``simplex3d_layered`` at n=65 (274,625 nodes, the simplex path's mesh),
  the mean over the three axes of each axis's median (the host builds the
  mesh and its foot tables first, about a minute a process);
- ``path_simplex``: wall ms a step of ``SimplexEngine.run()`` on that mesh
  and its tables over the simplex path's 0.08 s of simulated time (422
  steps, 3 sweeps a step; host clock, warmed up), with ``--path-runs N``
  the median of N runs;
- ``path_fused``, ``path_sharded``, ``path_pair``, ``path_sweep``,
  ``path_2d``, ``path_2d_sharded``, ``path_pair_2d``: wall ms a step of
  ``Engine.run()`` (host clock, the card synchronised before and after,
  warmed up) over 100 steps of the 3D fused path (``elastic3d_explosion``
  n=256 with its receivers) and of the same on a 2x2 mesh of four
  co-resident shards of cuda:0, of the pair-fused path
  (``elastic3d_layered`` n=256, no receivers, ``temporal_block=True``: 50
  two-step passes) and of the per-sweep path (``elastic3d_explosion``
  n=256, ``kernel="sweep"``), over 300 steps of
  the 2D path (``elastic2d_viscoelastic`` n=2048) and of the same on sx = 4
  shards of cuda:0, and over 100 steps of the 2D pair-fused path
  (``elastic2d_ps`` n=2048, no receivers, ``temporal_block=True``: 50
  two-step passes); ``path_contact``: wall ms a step of
  ``MultiBodyEngine.run()`` on the canonical contact path
  (``elastic3d_contact`` n=256, two bodies of 256x256x128) over 100 steps;
  with ``--path-runs N`` the median of N runs in the process.

A checkout that has orthotropic media also times the kernel keys with
every layer made orthotropic (c33 = lam+2mu, c11 = 1.3 c33, c22 = 1.1 c33,
off-diagonals lam, c44 = mu, c55 = 1.15 mu, c66 = 1.3 mu), as
``ortho_<key>``. ``--keys`` times only the keys it names (all by default).
Prints the card's name and power limit, one JSON line a process, and the
medians per ROOT and key.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

KEYS = ("fused_step", "slab_f32", "slab_bf16", "pair_f32", "pair_bf16",
        "sweep_x", "sweep_y", "sweep_z", "interior", "ring")
KEYS_2D = ("fused_2d_f32", "fused_2d_bf16", "pair_2d", "spmd_2d_interior",
           "spmd_2d_ring")
HOST_KEYS = ("host_spmd_2d_interior", "host_spmd_2d_ring")
PATH_KEYS = ("path_fused", "path_sharded", "path_pair", "path_sweep",
             "path_2d", "path_2d_sharded", "path_pair_2d", "path_contact")
#: the canonical contact order and the pair of steps a two-step pass runs
CANON = (2, 0, 1)
PAIR = (CANON, (1, 0, 2))
ALL_KEYS = (KEYS + KEYS_2D + tuple(f"ortho_{k}" for k in KEYS + KEYS_2D)
            + HOST_KEYS + ("simplex", "path_simplex") + PATH_KEYS)


def _orthotropic(m, cls):
    c33 = m.lam + 2.0 * m.mu
    return cls(rho=m.rho, c11=1.3 * c33, c12=m.lam, c13=m.lam, c22=1.1 * c33,
               c23=m.lam, c33=c33, c44=m.mu, c55=1.15 * m.mu, c66=1.3 * m.mu)


def _median_ms(fn, reps, host=False):
    """Median ms a call of 5 batches of ``reps`` calls, after one warm-up;
    each batch is queued behind a spin kernel that outlasts its
    enqueueing, so the card's time (CUDA events) leaves the wrapper's host
    time off the clock, and the host's (``host``: the host clock around
    the enqueueing) leaves off any wait on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batches = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (1.5 * reps * wall + 2e-3)))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        stop.record()
        torch.cuda.synchronize()
        batches.append((t1 - t0) * 1e3 / reps if host
                       else start.elapsed_time(stop) / reps)
    return statistics.median(batches)


def _time_all(task, reps, keys):
    """The timings of ``keys`` on the state of 20 steps of ``task``."""
    import torch

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.ops.fused import fused_step, fused_step_slab
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_interior, fused_spmd_ring)
    from gcm_tpu_torch.ops.sweep import sweep_stage
    from gcm_tpu_torch.parallel.fused_spmd import exchange_slabs, face_flags
    from gcm_tpu_torch.parallel.sharding import domain_mesh

    eng = Engine(task, device="cuda")
    eng.run()
    h, order, bc = task.grid.h, task.order, task.borders
    a = (eng.model, eng.u, eng._mstack, eng.dt, h, order, bc)
    a16 = a[:2] + (eng._mstack.to(torch.bfloat16),) + a[3:]
    calls = {
        "fused_step": lambda: fused_step(*a, (0, 1, 2)),
        "slab_f32": lambda: fused_step_slab(*a, axes_seq=(CANON,)),
        "slab_bf16": lambda: fused_step_slab(*a16, axes_seq=(CANON,)),
        "pair_f32": lambda: fused_step_slab(*a, axes_seq=PAIR),
        "pair_bf16": lambda: fused_step_slab(*a16, axes_seq=PAIR),
    }
    for axis, key in enumerate(("sweep_x", "sweep_y", "sweep_z")):
        calls[key] = (lambda ax: lambda: sweep_stage(
            eng.model, eng.u, eng._sweep_mat, eng.dt, h, ax, order, bc))(axis)
    out = {k: _median_ms(f, reps) for k, f in calls.items() if k in keys}
    del eng, a, a16, calls
    if "interior" not in keys and "ring" not in keys:
        return out
    dev = torch.device("cuda", 0)
    mesh = domain_mesh(3, [dev] * 4, (2, 2))
    eng = Engine(task, mesh=mesh)
    eng.run()
    u0, m0 = eng.u[0], eng._carry[0]
    slabs = exchange_slabs(eng.u, mesh, 2 if order >= 3 else 1)
    base = torch.zeros_like(u0)
    rest = (eng.dt, h, order, bc, (0, 1, 2))
    out["interior"] = _median_ms(lambda: fused_spmd_interior(
        eng.model, u0, m0, *rest, out=base), reps)
    out["ring"] = _median_ms(lambda: fused_spmd_ring(
        eng.model, u0, m0, slabs[0], face_flags(mesh, 0), base, *rest), reps)
    out["nm"] = int(m0.shape[0])
    return out


def _time_2d(task, reps, keys):
    """The 2D timings of ``keys`` on the state of 20 steps of ``task``."""
    import torch

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.ops.fused import fused_step_2d
    from gcm_tpu_torch.ops.fused_spmd import fused_spmd_2d
    from gcm_tpu_torch.parallel.fused_spmd import exchange_slabs, face_flags
    from gcm_tpu_torch.parallel.sharding import domain_mesh

    eng = Engine(task, device="cuda")
    eng.run()
    h, order, bc = task.grid.h, task.order, task.borders
    a = (eng.model, eng.u, eng._mstack, eng.dt, h, order, bc)
    a16 = a[:2] + (eng._mstack.to(torch.bfloat16),) + a[3:]
    calls = {
        "fused_2d_f32": lambda: fused_step_2d(*a, (0, 1)),
        "fused_2d_bf16": lambda: fused_step_2d(*a16, (0, 1)),
        "pair_2d": lambda: fused_step_2d(*a, axes_seq=((0, 1), (1, 0))),
    }
    out = {k: _median_ms(f, reps) for k, f in calls.items() if k in keys}
    del eng, a, a16, calls
    spmd = {"spmd_2d_interior", "spmd_2d_ring"} | set(HOST_KEYS)
    if not spmd & keys:
        return out
    dev = torch.device("cuda", 0)
    mesh = domain_mesh(2, [dev] * 4)
    eng = Engine(task, mesh=mesh)
    eng.run()
    u1, m1 = eng.u[1], eng._carry[1]
    slabs = exchange_slabs(eng.u, mesh, 2 if order >= 3 else 1, dim=2)[1]
    base = torch.zeros_like(u1)
    a = (eng.model, u1, m1, eng.dt, h, order, bc, (0, 1))
    flags = face_flags(mesh, 1)[:2]
    for w in ("interior", "ring"):
        for pre, host in (("", False), ("host_", True)):
            if f"{pre}spmd_2d_{w}" in keys:
                out[f"{pre}spmd_2d_{w}"] = _median_ms(
                    lambda w=w: fused_spmd_2d(*a, w, slabs, flags, base),
                    reps, host)
    return out


def _orthoize(task, cls):
    return dataclasses.replace(
        task, default_material=_orthotropic(task.default_material, cls),
        materials=tuple(dataclasses.replace(
            r, material=_orthotropic(r.material, cls))
            for r in task.materials))


def child(root, reps, keys, path_runs):
    sys.path.insert(0, root)
    from gcm_tpu_torch import materials
    from gcm_tpu_torch.ops import _build
    from gcm_tpu_torch.scenarios import get_scenario

    _build.build()
    _build.load()
    task = get_scenario("elastic3d_explosion", n=256, nsteps=20)
    task2 = get_scenario("elastic2d_viscoelastic", n=2048, nsteps=20)
    out = {"root": root}
    if set(KEYS) & keys:
        out.update(_time_all(task, reps, keys))
    if (set(KEYS_2D) | set(HOST_KEYS)) & keys:
        out.update(_time_2d(task2, reps, keys))
    cls = getattr(materials, "OrthotropicMaterial", None)
    okeys = {k[len("ortho_"):] for k in keys if k.startswith("ortho_")}
    if cls is not None and set(KEYS) & okeys:
        out.update({f"ortho_{k}": v for k, v in _time_all(
            _orthoize(task, cls), reps, okeys).items()})
    if cls is not None and set(KEYS_2D) & okeys:
        out.update({f"ortho_{k}": v for k, v in _time_2d(
            _orthoize(task2, cls), reps, okeys).items()})
    if {"simplex", "path_simplex"} & keys:
        out.update(_time_simplex(reps, keys, path_runs))
    out.update(_time_paths(keys, path_runs))
    print(json.dumps(out), flush=True)


def _time_simplex(reps, keys, runs):
    """``simplex``: the simplex sweep on the 65^3 path's state;
    ``path_simplex``: wall ms a step of the simplex path on the same mesh
    and tables, the median of ``runs`` runs."""
    from gcm_tpu_torch.engine_simplex import SimplexEngine
    from gcm_tpu_torch.ops.simplex import simplex_sweep
    from gcm_tpu_torch.scenarios import get_scenario
    from gcm_tpu_torch.task import TimeSpec

    task = get_scenario("simplex3d_layered", n=65, nsteps=20)
    t0 = time.perf_counter()
    eng = SimplexEngine.from_task(task, device="cuda")
    out = {"simplex_setup_s": time.perf_counter() - t0}
    eng.run()
    if "simplex" in keys:
        ms = [_median_ms(lambda a=a: simplex_sweep(eng._plan, eng.u, a),
                         reps) for a in range(3)]
        out.update(simplex=statistics.mean(ms), simplex_by_axis=ms)
    if "path_simplex" in keys:
        def run(time_spec):
            return SimplexEngine.from_task(
                dataclasses.replace(task, time=time_spec), device="cuda",
                tables=eng.tables).run()

        run(TimeSpec(cfl=task.time.cfl, nsteps=2))
        npts = float(task.grid.npoints)
        out["path_simplex"] = statistics.median(
            npts / run(TimeSpec(cfl=task.time.cfl, t_end=0.08))
            .points_per_second * 1e3 for _ in range(runs))
    return out


def _time_paths(keys, runs):
    """Wall ms a step of the paths in ``keys`` (PATH_KEYS), the median of
    ``runs`` runs."""
    import numpy as np
    import torch

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.parallel.sharding import domain_mesh
    from gcm_tpu_torch.scenarios import get_scenario

    visco2d = get_scenario("elastic2d_viscoelastic", n=2048, nsteps=300)
    explosion = get_scenario("elastic3d_explosion", n=256, nsteps=100)
    tasks = {
        "path_fused": explosion,
        "path_sharded": explosion,
        "path_pair": dataclasses.replace(
            get_scenario("elastic3d_layered", n=256, nsteps=100),
            detectors=None, temporal_block=True),
        "path_sweep": dataclasses.replace(explosion, kernel="sweep"),
        "path_2d": visco2d,
        "path_2d_sharded": visco2d,
        "path_pair_2d": dataclasses.replace(
            get_scenario("elastic2d_ps", n=2048, nsteps=100),
            detectors=None, temporal_block=True),
    }
    out = {}
    for key, task in tasks.items():
        if key not in keys:
            continue
        kw = (dict(mesh=domain_mesh(2 if key == "path_2d_sharded" else 3,
                                    [torch.device("cuda", 0)] * 4))
              if key in ("path_sharded", "path_2d_sharded")
              else dict(device="cuda"))
        Engine(dataclasses.replace(task, time=dataclasses.replace(
            task.time, nsteps=2)), **kw).run()
        npts = float(np.prod(task.grid.shape))
        out[key] = statistics.median(
            npts / Engine(task, **kw).run().points_per_second * 1e3
            for _ in range(runs))
    if "path_contact" in keys:
        out["path_contact"] = _time_contact(runs)
    return out


def _time_contact(runs):
    """Wall ms a step of the canonical contact path, the median of
    ``runs`` runs."""
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.scenarios import elastic3d_contact

    def run(nsteps):
        return MultiBodyEngine(*elastic3d_contact(n=256, nsteps=nsteps),
                               device="cuda", canonical_layout=True).run()

    run(2)
    res = [run(100) for _ in range(runs)]
    return statistics.median(r.wall_seconds / r.nsteps * 1e3 for r in res)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--path-runs", type=int, default=1)
    ap.add_argument("--keys", default=",".join(ALL_KEYS),
                    help="comma-separated keys to time (default: all)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    keys = a.keys.split(",")
    if a.child:
        child(a.roots[0], a.reps, set(keys), a.path_runs)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    roots = [os.path.abspath(r) for r in a.roots]
    runs = {r: [] for r in roots}
    for k in range(a.rounds):
        for root in (roots if k % 2 == 0 else roots[::-1]):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), root, "--child",
                 "--reps", str(a.reps), "--path-runs", str(a.path_runs),
                 "--keys", a.keys], cwd=root,
                capture_output=True, text=True, check=True, timeout=900)
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[root].append(json.loads(line))
    print(json.dumps({root: {
        key: statistics.median([r[key] for r in rs])
        for key in keys if all(key in r for r in rs)}
        for root, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
