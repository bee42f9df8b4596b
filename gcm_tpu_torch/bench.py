"""The benchmark of record on the card: grid points a second of each path.

Counterpart of ``bench.py`` (the JAX package's benchmark of record, metric
"grid-points/s/chip (3D elastic GCM step)"). Each path times the port's own
step function at the widths of the JAX path it ports:

=================  ==========================================  ==============
path               port step it times                          JAX worker
=================  ==========================================  ==============
``torch``          ``solver.gcm.step``, axes (0, 1, 2), K=20   ``"jnp"``
``sweep``          ``ops.sweep.sweep_step`` (3 ``sweep_stage``  ``"pallas"``
                   launches a step), K=20
``fused``          ``ops.fused.fused_step`` on the compact     ``"fused"``
                   stack (1 launch a step), K=20
visco              ``fused_step`` with Maxwell + damage folded ``_run_visco_``
                   (``fold_corrector_specs``), axes (0, 1, 2)  ``worker``
                   then (2, 1, 0), K=10 pairs
contact            ``MultiBodyEngine._one_step`` of            ``_run_contact_``
                   ``elastic3d_contact(n=256)`` in the         ``worker``
                   canonical order (2 ``fused_step_slab``
                   launches a step), K=10 pairs
simplex            the plain ``simplex_stage`` pair against    ``_run_simplex_``
                   the ``simplex_sweep`` plan (3 launches a    ``worker``
                   step) on the jittered unit box at n=33 and
                   n=65, (0, 1, 2) then (2, 1, 0), K=10 pairs;
                   the faster form is reported
simplex contact    ``SimplexMultiEngine._one_step`` of two     ``_run_simplex_``
                   25x49x49 bodies bonded at 5e5 Pa,           ``contact_``
                   ``kernel="torch"`` against ``"simplex"``    ``worker``
                   (6 launches a step), K=10 pairs
=================  ==========================================  ==============

The structured paths run the flagship problem of ``__graft_entry__.py``
(:func:`flagship`) at ``--shape`` (default 256x256x128): a layered z-profile
of rho, cp and cs, ``u0 = 0.01 N(0, 1)`` from ``default_rng(0)``, h = 10 m,
dt = 0.8 h / cp_max, absorbing borders with a free surface at z=0, order 2.

How it measures: every path runs in this process on one device. A timed
call runs K steps (K pairs) in a Python loop between two
``torch.cuda.synchronize()``, on the host clock: a path's wall time a step,
the host's pacing included (not the device time of a kernel alone). Each
path is warmed up by one call outside the window, then timed by 3 calls:
the median and the spread (max - min) / median. The paths of a group are
interleaved round by round: torch / sweep / fused; the two simplex forms;
the two simplex-contact forms. The simplex host setup (mesh, Delaunay, foot
tables) is timed apart from the steps and printed on a line of its own.

What it checks: every state it ends with is finite, and every kernel form
ends where its plain twin ends. The twins of a group start from one state
and make the same calls, so after the timing the ``sweep`` and ``fused``
states are held to the ``torch`` state, each simplex box's kernel state to
its plain state, and the simplex contact kernel engine's bodies and bond
masks to the plain engine's: the normalized error (per component, the
largest difference over the largest plain magnitude) under
:data:`PATH_TOL`, else the run fails. The errors are printed on a line
before the JSON line. The visco and contact paths have no plain twin here.

What it prints: one JSON line with ``bench.py``'s keys (``metric``,
``value``, ``unit``, ``vs_baseline`` = best / the plain torch path,
``path``, ``shape``, ``spread``, ``jnp_points_per_s`` = the torch path,
``pallas_points_per_s`` = the per-sweep path, the visco, contact, simplex
and simplex-contact rates and paths), with the port's names as the values
of ``path`` and ``*_path``, and one key more: ``device``, the card's name
and power limit (``"cpu"`` on the CPU). ``--path torch|sweep|fused`` prints
the one-path line.

What it leaves out of ``bench.py``: the subprocess per path, the retry, the
scalar fetch used as a sync, the ``/tmp`` pickle cache of simplex setups
and the ``*_error`` keys (the JAX package's TPU workarounds). A path that
fails raises and fails the run; nothing falls back to the CPU or to a
plain version. ``bench.py`` times visco at 256x256x128 whatever
``--shape`` says but divides ``--shape``'s points by that time; here visco
runs at the given shape.

The kernel paths need a CUDA card (``--path sweep|fused|best`` on the CPU
raises); only ``--path torch`` runs on the CPU, for tests::

    python -m gcm_tpu_torch.bench [--shape X,Y,Z]
        [--path torch|sweep|fused|best] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

SHAPE = (256, 256, 128)
METRIC = "grid-points/s/chip (3D elastic GCM step)"
#: steps a timed call of a structured path, step pairs a timed call of the
#: visco, contact and simplex paths, timed calls a path (after one warm-up)
K_STEPS, K_PAIRS, REPS = 20, 10, 3
#: the structured paths (bench.py's "jnp", "pallas" and "fused")
PATHS = ("torch", "sweep", "fused")
#: the jittered unit boxes of the simplex path (n^3 lattice nodes), their
#: jitter in lattice steps; the contact size; the simplex contact bodies
#: (n, half: two boxes of half x n x n nodes meeting at x = 0.5)
SIMPLEX_SIZES, SIMPLEX_JITTER = (33, 65), 0.15
CONTACT_N = 256
SIMPLEX_CONTACT = (49, 25)
#: the largest normalized error of a kernel form's end state from its plain
#: twin's
PATH_TOL = 1e-4


# ------------------------------------------------------------------ problems

@dataclasses.dataclass
class Problem:
    """A structured problem: state, fields and step parameters."""

    model: object
    u0: torch.Tensor
    mat: object
    dt: float
    h: Tuple[float, ...]
    borders: Dict
    order: int = 2


def _flagship_borders():
    from gcm_tpu_torch.task import BorderSpec

    borders = {(a, s): BorderSpec("absorbing") for a in range(3)
               for s in (0, 1)}
    borders[(2, 0)] = BorderSpec("free")
    return borders


def flagship(shape, device="cpu", dtype=torch.float32) -> Problem:
    """The flagship problem of ``__graft_entry__._flagship`` at ``shape``
    (BASELINE config 3 style layered medium), its state on ``device``."""
    from gcm_tpu_torch.materials import MaterialFields
    from gcm_tpu_torch.models.spec import get_model

    model = get_model("elastic3d")
    rng = np.random.default_rng(0)
    z = np.linspace(0.0, 1.0, shape[2])[None, None, :]
    rho = (1900.0 + 800.0 * z) * np.ones(shape)
    cp = 2100.0 + 3100.0 * z * np.ones(shape)
    cs = 900.0 + 2100.0 * z * np.ones(shape)
    mu = rho * cs**2
    lam = rho * cp**2 - 2 * mu
    mat = MaterialFields.from_arrays(rho, lam, mu, device=device, dtype=dtype)
    u0 = torch.as_tensor(0.01 * rng.standard_normal((model.ncomp,) + shape),
                         dtype=dtype, device=device)
    h = (10.0, 10.0, 10.0)
    dt = 0.8 * min(h) / float(np.sqrt((lam + 2 * mu) / rho).max())
    return Problem(model, u0, mat, dt, h, _flagship_borders())


def visco_dt(shape) -> float:
    """The visco path's dt, as ``bench.py``'s visco worker computes it."""
    z = np.linspace(0.0, 1.0, shape[2])[None, None, :]
    return 0.8 * 10.0 / float((2100.0 + 3100.0 * z).max())


def visco_correctors(dt: float):
    """The visco path's Maxwell and damage correctors."""
    from gcm_tpu_torch.solver.correctors import (
        DamageCorrector, MaxwellCorrector)

    return (MaxwellCorrector(tau=50 * dt),
            DamageCorrector(threshold=5e5, rate=0.1 / dt))


def rock():
    from gcm_tpu_torch.materials import IsotropicMaterial

    return IsotropicMaterial.from_speeds(rho=2500.0, cp=4000.0, cs=2300.0)


def simplex_box(n: int):
    """The simplex path's mesh: the jittered unit box of n^3 nodes."""
    from gcm_tpu_torch.grids.simplex import SimplexGrid

    return SimplexGrid.box((0, 0, 0), (1.0, 1.0, 1.0), (n, n, n),
                           jitter=SIMPLEX_JITTER)


def simplex_contact_bodies(n: int = SIMPLEX_CONTACT[0],
                           half: int = SIMPLEX_CONTACT[1]):
    """The bodies and contact of ``bench.py``'s simplex contact case: two
    jittered boxes of ``half`` x n x n and (n - half + 1) x n x n nodes
    meeting at x = 0.5, random stresses of 1e5 Pa from ``default_rng(0)``,
    bonded with a 5e5 Pa tensile strength."""
    from gcm_tpu_torch.engine_simplex import SimplexBody
    from gcm_tpu_torch.grids.simplex import SimplexGrid
    from gcm_tpu_torch.solver.simplex_contact import SimplexContactSpec

    rng = np.random.default_rng(0)
    g_a = SimplexGrid.box((0, 0, 0), (0.5, 1, 1), (half, n, n), jitter=0.12)
    g_b = SimplexGrid.box((0.5, 0, 0), (1.0, 1, 1), (n - half + 1, n, n),
                          jitter=0.12)

    def u0_of(g):
        u = np.zeros((9, g.npoints), np.float32)
        u[3:] = 1e5 * rng.standard_normal((6, g.npoints)).astype(np.float32)
        return u

    bodies = {"a": SimplexBody(g_a, rock(), u0=u0_of(g_a)),
              "b": SimplexBody(g_b, rock(), u0=u0_of(g_b))}
    return bodies, [SimplexContactSpec("a", "b", axis=0, kind="bonded",
                                       tensile_strength=5e5)]


# -------------------------------------------------------------------- timing

class _Loop:
    """A timed call: ``calls`` calls of ``fn`` on the state the last call
    left, ``steps`` steps in all."""

    def __init__(self, fn: Callable, state, calls: int, steps: int):
        self.fn, self.state, self.calls, self.steps = fn, state, calls, steps

    def __call__(self) -> None:
        s = self.state
        for _ in range(self.calls):
            s = self.fn(s)
        self.state = s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(loop: _Loop, device: torch.device) -> float:
    """Wall seconds a step of one call of ``loop``."""
    _sync(device)
    t0 = time.perf_counter()
    loop()
    _sync(device)
    return (time.perf_counter() - t0) / loop.steps


def interleaved(loops: Dict[str, _Loop], device: torch.device
                ) -> Dict[str, list]:
    """Warm each loop up once, then ``REPS`` rounds of one timed call of
    each: the seconds a step of every call, by loop."""
    for loop in loops.values():
        loop()
    ts = {name: [] for name in loops}
    for _ in range(REPS):
        for name, loop in loops.items():
            ts[name].append(_timed(loop, device))
    return ts


def median_spread(ts: Sequence[float]) -> Tuple[float, float]:
    """The median, and (max - min) / median rounded as ``bench.py``'s
    ``_repeat_timed`` rounds it."""
    med = float(np.median(ts))
    return med, round((max(ts) - min(ts)) / max(med, 1e-12), 4)


def _finite(tag: str, *tensors) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"bench: the {tag} path's state is not "
                               "finite")


def normalized_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Per component (the first axis), the largest ``|got - want|`` over
    the largest ``|want|``; the largest over the components."""
    c = want.shape[0]
    scale = want.abs().reshape(c, -1).amax(1) + 1e-30
    return ((got - want).abs().reshape(c, -1).amax(1) / scale).max().item()


def hold_to_plain(tag: str, got: Sequence[torch.Tensor],
                  want: Sequence[torch.Tensor]) -> float:
    """The largest normalized error of the kernel form's end states ``got``
    from its plain twin's ``want``; raises above :data:`PATH_TOL`."""
    err = max(normalized_err(g, w) for g, w in zip(got, want, strict=True))
    if not err < PATH_TOL:
        raise RuntimeError(f"bench: the {tag} kernel form ends {err:.3e} "
                           f"from its plain twin (limit {PATH_TOL})")
    return err


def hold_bonds(tag: str, got: Dict, want: Dict) -> None:
    """Raise unless the kernel form's bond masks equal its plain twin's."""
    for ci, w in want.items():
        g = got[ci]
        if (g is None) != (w is None) or (
                w is not None and not torch.equal(g, w)):
            raise RuntimeError(f"bench: the {tag} kernel form's bond mask "
                               f"of contact {ci} differs from its plain "
                               "twin's")


# --------------------------------------------------------------------- paths

def structured_loops(p: Problem, paths: Sequence[str]) -> Dict[str, _Loop]:
    """K_STEPS steps of each structured path from the flagship state."""
    from gcm_tpu_torch.materials import AxisViewCache
    from gcm_tpu_torch.ops.fused import fused_step, stack_mats
    from gcm_tpu_torch.ops.sweep import sweep_step
    from gcm_tpu_torch.solver.gcm import step

    args = (p.dt, p.h, p.order, p.borders)
    fns = {}
    if "torch" in paths:
        fns["torch"] = lambda u: step(p.model, u, p.mat, *args)
    if "sweep" in paths:
        views = AxisViewCache(p.mat)
        fns["sweep"] = lambda u: sweep_step(p.model, u, views, *args)
    if "fused" in paths:
        mstack = stack_mats(p.model, p.mat)
        fns["fused"] = lambda u: fused_step(p.model, u, mstack, *args,
                                            (0, 1, 2))
    return {name: _Loop(fns[name], p.u0, K_STEPS, K_STEPS)
            for name in paths}


def visco_loop(p: Problem) -> _Loop:
    """K_PAIRS step pairs of the fused step with Maxwell and damage folded
    into its epilogue, on the flagship problem at its own shape."""
    from gcm_tpu_torch.ops.fused import (
        fold_corrector_specs, fused_step, stack_mats)

    dt = visco_dt(p.u0.shape[1:])
    specs, naux = fold_corrector_specs(visco_correctors(dt), dt)
    mstack = stack_mats(p.model, p.mat)

    def pair(c):
        u, aux = c
        for axes in ((0, 1, 2), (2, 1, 0)):
            u, aux = fused_step(p.model, u, mstack, dt, p.h, p.order,
                                p.borders, axes, correctors=specs, aux=aux)
        return u, aux

    aux0 = torch.zeros((naux,) + tuple(p.u0.shape[1:]), dtype=p.u0.dtype,
                       device=p.u0.device)
    return _Loop(pair, (p.u0, aux0), K_PAIRS, 2 * K_PAIRS)


def contact_loop(n: int, device) -> Tuple[_Loop, int, str]:
    """K_PAIRS step pairs of ``elastic3d_contact(n)`` on the fused kernel in
    the canonical order: the loop, the points of both bodies, the path."""
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.scenarios import elastic3d_contact

    bodies, contacts = elastic3d_contact(n=n, nsteps=40)
    bodies = {k: dataclasses.replace(t, kernel="fused")
              for k, t in bodies.items()}
    eng = MultiBodyEngine(bodies, contacts, device=device,
                          canonical_layout=True)

    def pair(c):
        us, bonded, auxs = c
        us, bonded, auxs = eng._one_step(us, bonded, auxs, 0)
        return eng._one_step(us, bonded, auxs, 1)

    npts = sum(int(np.prod(t.grid.shape)) for t in bodies.values())
    return (_Loop(pair, (eng.us, eng.bonded, eng.auxs), K_PAIRS,
                  2 * K_PAIRS), npts, eng.path)


def simplex_setup(n: int):
    """The simplex path's host setup at n: ``(grid, tables)`` of the
    jittered unit box and its foot tables for the rock at CFL 0.8."""
    from gcm_tpu_torch.engine_simplex import SimplexEngine

    grid = simplex_box(n)
    eng = SimplexEngine(grid, "elastic3d", rock(), cfl=0.8, kernel="torch",
                        device="cpu")
    return grid, eng.tables


def simplex_loops(grid, tables, u0: np.ndarray, device
                  ) -> Dict[str, _Loop]:
    """K_PAIRS symmetrized step pairs of the plain sweep (``torch``) and of
    the kernel plan (``simplex``) on the same mesh, tables and state."""
    from gcm_tpu_torch.engine_simplex import SimplexEngine

    loops = {}
    for kernel in ("torch", "simplex"):
        eng = SimplexEngine(grid, "elastic3d", rock(), cfl=0.8, u0=u0,
                            kernel=kernel, device=device, tables=tables)

        def pair(u, _eng=eng):
            return _eng._step(_eng._step(u, (0, 1, 2)), (2, 1, 0))

        loops[kernel] = _Loop(pair, eng.u, K_PAIRS, 2 * K_PAIRS)
    return loops


def simplex_contact_loops(bodies, contacts, device, tables=None
                          ) -> Tuple[Dict[str, _Loop], int]:
    """K_PAIRS step pairs of the simplex contact engines, plain and kernel
    (``tables``: each body's foot tables, else built once): the loops and
    the nodes of both bodies."""
    from gcm_tpu_torch.engine_simplex import SimplexMultiEngine

    engines = {}
    for kernel in ("simplex", "torch"):
        engines[kernel] = eng = SimplexMultiEngine(
            bodies, contacts, "elastic3d", cfl=0.8, kernel=kernel,
            device=device, tables=tables)
        tables = eng.tables
    amps = torch.zeros((2, 0), device=device)
    loops = {}
    for kernel in ("torch", "simplex"):
        eng = engines[kernel]

        def pair(c, _eng=eng):
            us, bonded, auxs = _eng._one_step(*c, 0, amps)
            return _eng._one_step(us, bonded, auxs, 1, amps)

        loops[kernel] = _Loop(pair, (eng.us, eng.bonded, eng.auxs), K_PAIRS,
                              2 * K_PAIRS)
    return loops, sum(b.grid.npoints for b in bodies.values())


# ---------------------------------------------------------------------- line

def device_label(device) -> str:
    """The card's name and power limit (as ``nvidia-smi --query-gpu=
    power.limit`` gives it; raises where it cannot), or ``"cpu"``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    power = out.strip().splitlines()[index].strip()
    return f"{torch.cuda.get_device_name(index)}, {power}"


def path_line(shape, path: str, t_step: float, spread: float,
              device: str) -> dict:
    """The one-path line of ``--path torch|sweep|fused``."""
    return {"metric": METRIC, "value": int(np.prod(shape)) / t_step,
            "unit": "points/s", "vs_baseline": 1.0, "path": path,
            "shape": list(shape), "spread": spread, "device": device}


def summary_line(shape, recs: Dict[str, dict], device: str) -> dict:
    """The line of the whole benchmark, with ``bench.py``'s keys, order and
    rounding, from the per-path records: ``recs[path]`` for the structured
    paths and ``"visco"`` holds ``t_step`` (s) and ``spread``;
    ``recs["contact"]`` ``t_step``, ``npoints`` and ``path``;
    ``recs["simplex"]`` ``npoints``, ``t_step``, ``npoints_n65``,
    ``t_step_n65``, ``path_n65`` and ``t_step_n65_torch``;
    ``recs["simplex_contact"]`` ``npoints``, ``t_step`` and ``path``."""
    npoints = int(np.prod(shape))
    rates = {p: npoints / recs[p]["t_step"] for p in PATHS}
    best_name = max(rates, key=rates.get)
    best, base = rates[best_name], rates["torch"]
    sim, sct, con = recs["simplex"], recs["simplex_contact"], recs["contact"]
    extras = {
        "spread": recs[best_name]["spread"],
        "pallas_points_per_s": round(rates["sweep"], 1),
        "simplex_points_per_s": round(sim["npoints"] / sim["t_step"], 1),
        "simplex_points_per_s_n65": round(
            sim["npoints_n65"] / sim["t_step_n65"], 1),
        "simplex_path_n65": sim["path_n65"],
        "simplex_points_per_s_n65_jnp": round(
            sim["npoints_n65"] / sim["t_step_n65_torch"], 1),
        "simplex_contact_points_per_s": round(
            sct["npoints"] / sct["t_step"], 1),
        "simplex_contact_path": sct["path"],
        "contact_points_per_s": round(con["npoints"] / con["t_step"], 1),
        "contact_path": con["path"],
        "visco_points_per_s": round(npoints / recs["visco"]["t_step"], 1),
    }
    return {"metric": METRIC, "value": round(best, 1), "unit": "points/s",
            "vs_baseline": round(best / base, 3), "path": best_name,
            "jnp_points_per_s": round(base, 1), "shape": list(shape),
            **extras, "device": device}


# ---------------------------------------------------------------------- main

def _refuse_without_card(only: Optional[str], device: torch.device) -> None:
    if device.type == "cuda":
        from gcm_tpu_torch.engine import check_device

        check_device(device)
        return
    if only != "torch":
        raise RuntimeError(
            f"bench --path {only or 'best'} runs the CUDA kernels and needs "
            f"a CUDA card (written for the NVIDIA H100), not {device}; only "
            "--path torch runs on the CPU")


def _best_of(ts: Dict[str, list]) -> Tuple[str, Dict[str, float]]:
    med = {name: median_spread(v)[0] for name, v in ts.items()}
    return min(med, key=med.get), med


def main(shape=None, only: Optional[str] = None, device="cuda",
         simplex_sizes: Tuple[int, int] = SIMPLEX_SIZES,
         contact_n: int = CONTACT_N,
         simplex_contact_size: Tuple[int, int] = SIMPLEX_CONTACT,
         simplex_setups: Optional[Dict[int, tuple]] = None,
         simplex_contact_setup: Optional[tuple] = None,
         out=print) -> dict:
    """Run the benchmark; prints (through ``out``) and returns its line.

    ``only``: one of ``"torch"``, ``"sweep"``, ``"fused"`` for the one-path
    line, or None / ``"best"`` for every path. The sizes (the CLI keeps
    ``bench.py``'s; the card tests pass small ones): ``simplex_sizes``, the
    two unit boxes' n (the line's ``simplex_points_per_s`` is the first,
    ``*_n65`` the second); ``contact_n``, ``elastic3d_contact``'s n;
    ``simplex_contact_size``, (n, half) of the simplex contact bodies.
    ``simplex_setups``: prebuilt ``{n: (grid, tables)}`` of
    :func:`simplex_setup`; ``simplex_contact_setup``: prebuilt ``(bodies,
    contacts, tables)`` (each body's foot tables at CFL 0.8)."""
    shape = tuple(shape) if shape is not None else SHAPE
    only = None if only in (None, "best") else only
    if only is not None and only not in PATHS:
        raise ValueError(f"unknown bench path {only!r} (expected one of "
                         f"{PATHS + ('best',)})")
    n_small, n_large = simplex_sizes
    device = torch.device(device)
    _refuse_without_card(only, device)
    label = device_label(device)
    p = flagship(shape, device)

    if only is not None:
        loops = structured_loops(p, (only,))
        t, spread = median_spread(interleaved(loops, device)[only])
        _finite(only, loops[only].state)
        line = path_line(shape, only, t, spread, label)
        out(json.dumps(line))
        return line

    recs, errs = {}, {}
    loops = structured_loops(p, PATHS)
    for name, ts in interleaved(loops, device).items():
        t, spread = median_spread(ts)
        recs[name] = {"t_step": t, "spread": spread}
        _finite(name, loops[name].state)
    for name in ("sweep", "fused"):
        errs[name] = hold_to_plain(name, [loops[name].state],
                                   [loops["torch"].state])
    del loops

    loop = visco_loop(p)
    t, spread = median_spread(interleaved({"visco": loop}, device)["visco"])
    _finite("visco", *loop.state)
    recs["visco"] = {"t_step": t, "spread": spread}
    del loop, p

    loop, npts, path = contact_loop(contact_n, device)
    t, _ = median_spread(interleaved({"contact": loop}, device)["contact"])
    _finite("contact", *loop.state[0].values())
    recs["contact"] = {"t_step": t, "npoints": npts, "path": path}
    del loop

    rng = np.random.default_rng(0)
    sim = {}
    for n in (n_small, n_large):
        if simplex_setups and n in simplex_setups:
            grid, tables = simplex_setups[n]
            out(f"simplex setup n={n}: prebuilt ({grid.npoints} nodes)")
        else:
            t0 = time.perf_counter()
            grid, tables = simplex_setup(n)
            out(f"simplex setup n={n} on the host: "
                f"{time.perf_counter() - t0:.1f} s (jittered unit box, "
                f"Delaunay, foot tables; {grid.npoints} nodes)")
        u0 = 0.01 * rng.standard_normal((9, grid.npoints)).astype(np.float32)
        loops = simplex_loops(grid, tables, u0, device)
        best, med = _best_of(interleaved(loops, device))
        for name, loop in loops.items():
            _finite(f"simplex n={n} {name}", loop.state)
        errs[f"simplex n={n}"] = hold_to_plain(
            f"simplex n={n}", [loops["simplex"].state],
            [loops["torch"].state])
        sim[n] = (med[best], grid.npoints, best, med["torch"])
        del loops
    recs["simplex"] = {"t_step": sim[n_small][0], "npoints": sim[n_small][1],
                       "t_step_n65": sim[n_large][0],
                       "npoints_n65": sim[n_large][1],
                       "path_n65": sim[n_large][2],
                       "t_step_n65_torch": sim[n_large][3]}

    if simplex_contact_setup is not None:
        bodies, contacts, tables = simplex_contact_setup
        out("simplex contact setup: prebuilt")
    else:
        t0 = time.perf_counter()
        bodies, contacts = simplex_contact_bodies(*simplex_contact_size)
        tables = None
    loops, npts = simplex_contact_loops(bodies, contacts, device, tables)
    if simplex_contact_setup is None:
        out(f"simplex contact setup on the host: "
            f"{time.perf_counter() - t0:.1f} s (meshes, foot tables, "
            f"pairing; {npts} nodes)")
    best, med = _best_of(interleaved(loops, device))
    for name, loop in loops.items():
        _finite(f"simplex contact {name}", *loop.state[0].values())
    (ku, kb, _), (pu, pb, _) = loops["simplex"].state, loops["torch"].state
    hold_bonds("simplex contact", kb, pb)
    errs["simplex contact"] = hold_to_plain(
        "simplex contact", [ku[k] for k in pu], list(pu.values()))
    recs["simplex_contact"] = {"t_step": med[best], "npoints": npts,
                               "path": best}
    del loops

    out("kernel forms against their plain twins after the timed calls, "
        "normalized error: " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in errs.items())
        + f" (limit {PATH_TOL}; simplex contact bond masks equal)")
    line = summary_line(shape, recs, label)
    out(json.dumps(line))
    return line


def parse_shape(text: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in text.split(","))


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)),
                    metavar="X,Y,Z", help="grid of the structured paths "
                    "(default: 256,256,128)")
    ap.add_argument("--path", default="best",
                    choices=list(PATHS) + ["best"],
                    help="one structured path, or every path (default: "
                         "best; on the CPU only torch runs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="gcm_tpu_torch.bench",
                                     description=__doc__.split("\n")[0])
    add_arguments(parser)
    args = parser.parse_args()
    main(parse_shape(args.shape), args.path, args.device)
