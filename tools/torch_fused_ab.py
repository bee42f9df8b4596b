#!/usr/bin/env python3
"""Time the fused 3D step of the PyTorch/CUDA port (``gcm_tpu_torch.ops.
fused.fused_step``) of several checkouts on one CUDA card, interleaved: the
A/B comparison of two commits on the same card.

    python3 tools/torch_fused_ab.py ROOT [ROOT ...] [--rounds 2] [--reps 50]

Each ROOT is a checkout holding ``gcm_tpu_torch``. Round r runs every ROOT
in turn (in reverse order on odd rounds, so two roots run A B B A), each in
a process of its own, since the checkouts' packages share a name. A process
builds its checkout's kernels, runs ``elastic3d_explosion`` at n=256
(256x256x128) for 20 steps on the fused path, and times ``fused_step`` on
that state with CUDA events: the median of 5 batches of REPS launches. A
checkout that has orthotropic media also times the same step with every
layer made orthotropic (c33 = lam+2mu, c11 = 1.3 c33, c22 = 1.1 c33,
off-diagonals lam, c44 = mu, c55 = 1.15 mu, c66 = 1.3 mu). Prints the card's
name and power limit, one JSON line a process, and the medians per ROOT.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys


def _orthotropic(m, cls):
    c33 = m.lam + 2.0 * m.mu
    return cls(rho=m.rho, c11=1.3 * c33, c12=m.lam, c13=m.lam, c22=1.1 * c33,
               c23=m.lam, c33=c33, c44=m.mu, c55=1.15 * m.mu, c66=1.3 * m.mu)


def _time_step(task, reps):
    """Median ms of ``fused_step`` on the state after 20 steps of ``task``."""
    import torch

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.ops.fused import fused_step

    eng = Engine(task, device="cuda")
    eng.run()
    args = (eng.model, eng.u, eng._mstack, eng.dt, task.grid.h, task.order,
            task.borders, (0, 1, 2))
    fused_step(*args)
    torch.cuda.synchronize()
    batches = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fused_step(*args)
        stop.record()
        torch.cuda.synchronize()
        batches.append(start.elapsed_time(stop) / reps)
    return statistics.median(batches), batches, int(eng._mstack.shape[0])


def child(root, reps):
    sys.path.insert(0, root)
    from gcm_tpu_torch import materials
    from gcm_tpu_torch.ops import _build
    from gcm_tpu_torch.scenarios import get_scenario

    _build.build()
    _build.load()
    task = get_scenario("elastic3d_explosion", n=256, nsteps=20)
    ms, batches, nm = _time_step(task, reps)
    out = {"root": root, "fused_step_ms": ms, "batches": batches, "nm": nm}
    cls = getattr(materials, "OrthotropicMaterial", None)
    if cls is not None:
        ortho = dataclasses.replace(
            task, default_material=_orthotropic(task.default_material, cls),
            materials=tuple(dataclasses.replace(
                r, material=_orthotropic(r.material, cls))
                for r in task.materials))
        out["ortho_ms"], out["ortho_batches"], out["ortho_nm"] = \
            _time_step(ortho, reps)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.roots[0], a.reps)
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
                 "--reps",
                 str(a.reps)], cwd=root, capture_output=True, text=True,
                check=True, timeout=600)
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[root].append(json.loads(line))
    print(json.dumps({root: {
        key: [r[key] for r in rs if key in r]
        for key in ("fused_step_ms", "ortho_ms")} for root, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
