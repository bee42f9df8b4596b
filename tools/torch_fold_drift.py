#!/usr/bin/env python3
"""How far the folded Maxwell + damage correctors of ``fused_step_2d``
drift from their plain version over chained steps, for several checkouts
of the PyTorch/CUDA port on one CUDA card.

    python3 tools/torch_fold_drift.py ROOT [ROOT ...] [--steps 3] [--seed 0]

Each ROOT is a checkout holding ``gcm_tpu_torch``, run in a process of its
own (the checkouts' packages share a name). The cases are those of the
card tests (``tests/test_torch_gpu.py::card_problem``, seed 0 unless
``--seed`` says otherwise): elastic2d on 64x128 (aligned rows) and 37x61
(unaligned), stencil orders 2 and 4, a random state, the four border
kinds, the sweep order alternating (0, 1), (1, 0), Maxwell with tau =
40 dt and damage with threshold 2e5 and rate 0.5 / dt. For each step it
prints, as one JSON line a case:

- ``chained``: the kernel and ``fused_step_2d_reference`` each from its
  own previous result (the test that failed in this form);
- ``held``: the kernel from the plain version's previous state and damage
  (the form the card tests and ``chip_smoke.py`` hold);
- ``plain64``: the float32 plain version chained against the same plain
  version in float64 (the problem's own sensitivity to rounding);
- ``kernel64``: the kernel, chained, against the float64 plain version.

Each gives the state's per-component normalized max error, the damage's
max abs error, and that error as a share of the card tests' tolerance
(atol 1e-6 + rtol 1e-5 |aux|; over 1 fails). Prints the card's name and
power limit first.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = ((64, 128), (37, 61))
ORDERS = (2, 4)


def _problem(seed, name, shape):
    """The card tests' card_problem(seed, name, shape): the state and the
    material arrays in float64 (both plain versions take them)."""
    import numpy as np

    from gcm_tpu_torch.models.spec import get_model

    rng = np.random.default_rng(seed)
    model = get_model(name)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = rng.standard_normal((model.ncomp,) + shape)
    u0[model.dim:] *= 1e6
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    return model, u0, (rho, lam, mu), dt


def _errs(got, want, gaux, waux):
    c = want.shape[0]
    scale = want.abs().reshape(c, -1).amax(1) + 1e-30
    state = ((got - want).abs().reshape(c, -1).amax(1) / scale).max().item()
    diff = (gaux - waux).abs()
    return {"state": state, "aux": diff.max().item(),
            "aux_share": (diff / (1e-6 + 1e-5 * waux.abs())).max().item()}


def child(root, steps, seed):
    sys.path.insert(0, root)
    import torch

    from gcm_tpu_torch.materials import MaterialFields
    from gcm_tpu_torch.ops.fused import (
        fold_corrector_specs, fused_step_2d, fused_step_2d_reference,
        stack_mats)
    from gcm_tpu_torch.solver.correctors import (
        DamageCorrector, MaxwellCorrector)
    from gcm_tpu_torch.task import BorderSpec

    bc = {(0, 0): BorderSpec("free"), (0, 1): BorderSpec("absorbing"),
          (1, 0): BorderSpec("fixed_force", value=(1e5, 2e5)),
          (1, 1): BorderSpec("fixed_velocity", value=(0.1, -0.2))}
    dev = torch.device("cuda")
    h = (10.0, 11.0)
    for shape in SHAPES:
        model, u0, (rho, lam, mu), dt = _problem(seed, "elastic2d", shape)
        ms = stack_mats(model, MaterialFields.from_arrays(rho, lam, mu,
                                                          device=dev))
        ms64 = stack_mats(model, MaterialFields.from_arrays(
            rho, lam, mu, device=dev, dtype=torch.float64))
        specs, _ = fold_corrector_specs(
            (MaxwellCorrector(tau=40 * dt),
             DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
        for order in ORDERS:
            u = torch.tensor(u0, dtype=torch.float32, device=dev)
            z = torch.zeros((1,) + shape, device=dev)
            kc, kca = u, z            # the kernel, chained
            pc, pca = u, z            # the plain version, chained
            p64, p64a = u.double(), z.double()
            rows = []
            for n in range(steps):
                axes = (0, 1) if n % 2 == 0 else (1, 0)
                rest = (dt, h, order, bc, axes)
                held, helda = fused_step_2d(model, pc, ms, *rest,
                                            correctors=specs, aux=pca)
                kc, kca = fused_step_2d(model, kc, ms, *rest,
                                        correctors=specs, aux=kca)
                pc, pca = fused_step_2d_reference(model, pc, ms, *rest,
                                                  correctors=specs, aux=pca)
                p64, p64a = fused_step_2d_reference(
                    model, p64, ms64, *rest, correctors=specs, aux=p64a)
                torch.cuda.synchronize()
                rows.append({
                    "step": n, "axes": list(axes),
                    "chained": _errs(kc, pc, kca, pca),
                    "held": _errs(held, pc, helda, pca),
                    "plain64": _errs(pc.double(), p64, pca.double(), p64a),
                    "kernel64": _errs(kc.double(), p64, kca.double(), p64a),
                    "damage_max": pca.max().item()})
            print(json.dumps({"root": root, "seed": seed,
                              "shape": list(shape),
                              "order": order, "steps": rows}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.roots[0], a.steps, a.seed)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for root in map(os.path.abspath, a.roots):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--child",
             "--steps", str(a.steps), "--seed", str(a.seed)], cwd=root,
            capture_output=True, text=True, timeout=900)
        sys.stdout.write(res.stdout)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
