#!/usr/bin/env python3
"""Time the fused 3D launches of the PyTorch/CUDA port of several checkouts
on one CUDA card, interleaved: the A/B comparison of two commits on the
same card.

    python3 tools/torch_fused_ab.py ROOT [ROOT ...] [--rounds 2] [--reps 50]
        [--keys KEY,KEY,...]

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
- ``path_pair``, ``path_sweep``: wall ms a step of ``Engine.run()`` (host
  clock, the card synchronised before and after, warmed up) over 100 steps
  of the pair-fused path (``elastic3d_layered`` n=256, no receivers,
  ``temporal_block=True``: 50 two-step passes) and of the per-sweep path
  (``elastic3d_explosion`` n=256, ``kernel="sweep"``).

A checkout that has orthotropic media also times them all with every layer
made orthotropic (c33 = lam+2mu, c11 = 1.3 c33, c22 = 1.1 c33,
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
PATH_KEYS = ("path_pair", "path_sweep")
#: the canonical contact order and the pair of steps a two-step pass runs
CANON = (2, 0, 1)
PAIR = (CANON, (1, 0, 2))
ALL_KEYS = KEYS + tuple(f"ortho_{k}" for k in KEYS) + PATH_KEYS


def _orthotropic(m, cls):
    c33 = m.lam + 2.0 * m.mu
    return cls(rho=m.rho, c11=1.3 * c33, c12=m.lam, c13=m.lam, c22=1.1 * c33,
               c23=m.lam, c33=c33, c44=m.mu, c55=1.15 * m.mu, c66=1.3 * m.mu)


def _median_ms(fn, reps):
    """Median device ms a call of 5 batches of ``reps`` calls, after one
    warm-up; each batch is queued behind a spin kernel that outlasts its
    enqueueing, so the wrapper's host time stays off the clock."""
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
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        batches.append(start.elapsed_time(stop) / reps)
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


def child(root, reps, keys):
    sys.path.insert(0, root)
    from gcm_tpu_torch import materials
    from gcm_tpu_torch.ops import _build
    from gcm_tpu_torch.scenarios import get_scenario

    _build.build()
    _build.load()
    task = get_scenario("elastic3d_explosion", n=256, nsteps=20)
    out = {"root": root, **_time_all(task, reps, keys)}
    cls = getattr(materials, "OrthotropicMaterial", None)
    okeys = {k[len("ortho_"):] for k in keys if k.startswith("ortho_")}
    if cls is not None and okeys:
        ortho = dataclasses.replace(
            task, default_material=_orthotropic(task.default_material, cls),
            materials=tuple(dataclasses.replace(
                r, material=_orthotropic(r.material, cls))
                for r in task.materials))
        out.update({f"ortho_{k}": v
                    for k, v in _time_all(ortho, reps, okeys).items()})
    out.update(_time_paths(keys))
    print(json.dumps(out), flush=True)


def _time_paths(keys):
    """Wall ms a step of the paths in ``keys`` (PATH_KEYS)."""
    import numpy as np

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.scenarios import get_scenario

    tasks = {
        "path_pair": dataclasses.replace(
            get_scenario("elastic3d_layered", n=256, nsteps=100),
            detectors=None, temporal_block=True),
        "path_sweep": dataclasses.replace(
            get_scenario("elastic3d_explosion", n=256, nsteps=100),
            kernel="sweep"),
    }
    out = {}
    for key, task in tasks.items():
        if key not in keys:
            continue
        Engine(dataclasses.replace(task, time=dataclasses.replace(
            task.time, nsteps=2)), device="cuda").run()
        res = Engine(task, device="cuda").run()
        npts = float(np.prod(task.grid.shape))
        out[key] = npts / res.points_per_second * 1e3
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--keys", default=",".join(ALL_KEYS),
                    help="comma-separated keys to time (default: all)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    keys = a.keys.split(",")
    if a.child:
        child(a.roots[0], a.reps, set(keys))
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
                 "--reps", str(a.reps), "--keys", a.keys], cwd=root,
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
