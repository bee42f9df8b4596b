#!/usr/bin/env python3
"""Where the wavefront of the orthotropic explosion stands after a given
simulated time, on the CPU at a reduced size: how ``chip_smoke.py`` chose
the step count of its anisotropy check (``NSTEPS_ANISO``) at n=256.

    python3 tools/torch_aniso_steps.py --n 160 --time 0.2122 0.2222 0.2325

Runs ``elastic3d_explosion`` at ``n`` with every layer made orthotropic as
``chip_smoke.py::_orthotropic`` makes it, on the plain torch path, for the
steps that reach each simulated time (dt follows n). On the source's
horizontal plane it prints how far the region where |v| exceeds 2% of its
largest value reaches along x and along y from the source (the recipe of
tests/test_orthotropic.py), their ratio against sqrt(c11/c22), and the
extent of that region along z and x, so a step count can be picked at which
the ratio shows and no front has reached a face. Reaches in cells scale
with n at a fixed time.
"""

import argparse
import dataclasses
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gcm_tpu_torch.engine import Engine  # noqa: E402
from gcm_tpu_torch.materials import OrthotropicMaterial  # noqa: E402
from gcm_tpu_torch.scenarios import get_scenario  # noqa: E402


def _orthotropic(m):
    c33 = m.lam + 2.0 * m.mu
    return OrthotropicMaterial(
        rho=m.rho, c11=1.3 * c33, c12=m.lam, c13=m.lam, c22=1.1 * c33,
        c23=m.lam, c33=c33, c44=m.mu, c55=1.15 * m.mu, c66=1.3 * m.mu)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--time", type=float, nargs="+", default=[0.2222])
    ap.add_argument("--frac", type=float, default=0.02)
    a = ap.parse_args()
    for t_end in a.time:
        task = get_scenario("elastic3d_explosion", n=a.n, nsteps=1)
        task = dataclasses.replace(
            task, kernel="torch",
            default_material=_orthotropic(task.default_material),
            materials=tuple(dataclasses.replace(
                r, material=_orthotropic(r.material))
                for r in task.materials))
        dt = Engine(task, device="cpu").dt
        nsteps = math.ceil(t_end / dt - 1e-9)
        res = Engine(dataclasses.replace(task, time=dataclasses.replace(
            task.time, nsteps=nsteps)), device="cpu").run()
        i, j, k = task.grid.index_of(task.sources[0].position)
        v = np.sqrt((res.u[:3].astype(np.float64) ** 2).sum(0))
        thresh = a.frac * v[:, :, k].max()
        xs = np.nonzero(v[:, j, k] > thresh)[0]
        ys = np.nonzero(v[i, :, k] > thresh)[0]
        zs = np.nonzero(v[i, j, :] > thresh)[0]
        rx, ry = np.abs(xs - i).max(), np.abs(ys - j).max()
        print(f"n={a.n} {nsteps} steps ({nsteps * dt:.4f} s): reach x {rx}, "
              f"y {ry} cells, ratio {rx / ry:.4f} against sqrt(c11/c22) "
              f"{math.sqrt(1.3 / 1.1):.4f}; above {a.frac} of max along z "
              f"{zs.min()}..{zs.max()} of {task.grid.shape[2]}, along x "
              f"{xs.min()}..{xs.max()} of {task.grid.shape[0]}", flush=True)
    return 0


if __name__ == "__main__":
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    sys.exit(main())
