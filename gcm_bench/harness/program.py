"""The system under test: ``gcm_tpu_torch``'s engines, built from a cell's
configuration and the seed's draws, and driven through their own ``run()``.

The ``Engine`` or ``MultiBodyEngine`` is built from the scenario's ``Task``
as ``python -m gcm_tpu_torch run <scenario> --n N [--mesh NX,NY] --device
cuda`` builds it, with the drawn materials, source and receivers in place of
the scenario's own. Nothing here reaches below the engines' public
attributes (``nsteps``, ``start_step``, ``state_dict``), except the
functions that a per-layer metric asks to have timed.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_FACES = {f"{'xyz'[a]}{s}": (a, s) for a in range(3) for s in (0, 1)}


def _material(m: Dict):
    from gcm_tpu_torch.materials import IsotropicMaterial

    return IsotropicMaterial.from_speeds(rho=m["rho"], cp=m["cp"], cs=m["cs"])


def _body_task(task, name: str, config: Dict, draws: Dict):
    """The scenario's task of body ``name`` with the drawn data in place."""
    from gcm_tpu_torch.task import (
        AreaLayer, DetectorSpec, MaterialRegion, RickerSource,
    )

    body, mats = config["bodies"][name], draws["materials"][name]
    regions = tuple(
        MaterialRegion(AreaLayer(axis=L["axis"], lo=L["lo"], hi=L["hi"]),
                       _material(m))
        for L, m in zip(body.get("layers", ()), mats["layers"]))
    wav = config["source_wavelet"]
    sources = ()
    if draws["source"]["body"] == name:
        sources = (RickerSource(position=tuple(draws["source"]["position"]),
                                components=tuple(wav["components"]),
                                f0=wav["f0"], t0=wav["t0"],
                                amplitude=wav["amplitude"]),)
    rec = draws["receivers"]
    detectors = (DetectorSpec(points=tuple(tuple(p)
                                           for p in rec["positions"]))
                 if rec["body"] == name and rec["positions"] else None)
    task = dataclasses.replace(
        task, default_material=_material(mats["default"]), materials=regions,
        sources=sources, detectors=detectors, kernel=config["kernel"])
    _agree(task, body, config)
    return task


def _agree(task, body: Dict, config: Dict) -> None:
    """Raise unless the scenario's task is the configuration's body."""
    h = tuple(L / (n - 1) for L, n in zip(body["lengths"], body["shape"]))
    borders = {_FACES[k]: v for k, v in body["borders"].items()}
    got = {f: b.kind for f, b in task.borders.items()}
    checks = [(tuple(task.grid.shape), tuple(body["shape"])),
              (tuple(task.grid.origin), tuple(body["origin"])),
              (task.order, config["order"]), (task.time.cfl, config["cfl"]),
              (task.symmetrize_stages, config["symmetrize"]), (got, borders)]
    if not np.allclose(task.grid.h, h, rtol=1e-12, atol=0):
        checks.append((task.grid.h, h))
    for have, want in checks:
        if have != want:
            raise ValueError(f"scenario {config['scenario']!r} at n="
                             f"{config['n']} has {have}, the configuration "
                             f"{want}")


def devices(config: Dict, device: str) -> List[torch.device]:
    """The devices the cell runs on: one a shard of its mesh (cuda:0,
    cuda:1, ... in mesh order; each a CPU shard on the CPU), else one."""
    n = int(np.prod(config["mesh"])) if config.get("mesh") else 1
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", i) for i in range(n)]


def build(config: Dict, draws: Dict, device: str, nsteps: int):
    """The engine of the cell on ``device`` ("cuda" or "cpu"), with room
    for ``nsteps`` steps of source amplitudes."""
    mesh = None
    devs = devices(config, device)
    if config.get("mesh"):
        from gcm_tpu_torch.parallel.sharding import domain_mesh

        mesh = domain_mesh(len(config["sweep_order"]), devs,
                           tuple(config["mesh"]))
    if config["engine"] == "single":
        from gcm_tpu_torch.engine import Engine
        from gcm_tpu_torch.scenarios import get_scenario

        (name,) = config["bodies"]
        task = _body_task(get_scenario(config["scenario"], n=config["n"],
                                       nsteps=nsteps), name, config, draws)
        if mesh is not None:
            return Engine(task, mesh=mesh)
        return Engine(task, device=devs[0])
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.scenarios import MULTI_SCENARIOS

    bodies, contacts = MULTI_SCENARIOS[config["scenario"]](
        n=config["n"], nsteps=nsteps)
    bodies = {k: _body_task(t, k, config, draws) for k, t in bodies.items()}
    want = [(c["body_a"], c["body_b"], c["axis"], c["kind"],
             c.get("tensile_strength"), c.get("broken_kind", "free"))
            for c in config["contacts"]]
    have = [(c.body_a, c.body_b, c.axis, c.kind, c.tensile_strength,
             c.broken_kind) for c in contacts]
    if have != want:
        raise ValueError(f"scenario contacts {have}, configuration {want}")
    return MultiBodyEngine(bodies, contacts,
                           device=None if mesh is not None else devs[0],
                           canonical_layout=config["canonical_layout"],
                           mesh=mesh)


def points(engine) -> int:
    """All bodies' grid points."""
    tasks = getattr(engine, "tasks", None) or {"body": engine.task}
    return sum(int(np.prod(t.grid.shape)) for t in tasks.values())


def engine_devices(engine) -> List[torch.device]:
    mesh = engine.mesh
    return list(mesh.unique_devices()) if mesh is not None else [
        engine.device]


def sync(devs: Sequence[torch.device]) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run(engine, callback: Callable[[int, object], None], every: int):
    """``engine.run()`` with ``callback(step, u)`` after every ``every``-th
    step, ``u`` the state as it lies on the device."""
    if hasattr(engine, "tasks"):
        return engine.run(snapshot_cb=callback, snapshot_every=every)
    return engine.run(snapshot_cb=callback, cb_every=every)


def box_of(engine, u, body: str, box: Sequence[Tuple[int, int]]
           ) -> np.ndarray:
    """Body ``body``'s state in ``box`` (a ``(start, end)`` a spatial axis)
    on the host, cut from ``u``, the device state that a ``run()`` callback
    receives: only the box leaves the cards. On a mesh it is put together
    from the shards it crosses."""
    u = u[body] if isinstance(u, dict) else u
    cut = tuple(slice(s, e) for s, e in box)
    mesh = engine.mesh
    if mesh is None:
        return u[(slice(None),) + cut].cpu().numpy()
    from gcm_tpu_torch.parallel.sharding import block_shape

    tasks = getattr(engine, "tasks", None) or {body: engine.task}
    nb = block_shape(mesh, tasks[body].grid.shape)
    blocks = list(u)
    out = None
    for k in mesh.local:
        at = (mesh.coords(k) + (0,) * len(nb))[:len(nb)]
        lo = [a * n for a, n in zip(at, nb)]
        part = [(max(s, o), min(e, o + n))
                for (s, e), o, n in zip(box, lo, nb)]
        if any(s >= e for s, e in part):
            continue
        vals = blocks[k][(slice(None),) + tuple(
            slice(s - o, e - o) for (s, e), o in zip(part, lo))].cpu().numpy()
        if out is None:
            out = np.empty((vals.shape[0],) + tuple(e - s for s, e in box),
                           vals.dtype)
        out[(slice(None),) + tuple(
            slice(s - b, e - b) for (s, e), (b, _) in zip(part, box))] = vals
    return out


def host_state(engine, state: Dict) -> Dict:
    """A ``state_dict()`` as ``{"us": {body: array}, "bonded": {index:
    mask}, "traces": rows}``, one body named ``"body"`` on a single-body
    engine."""
    if "us" in state:
        tr = state.get("traces") or {}
        return {"us": dict(state["us"]),
                "bonded": {int(k): v for k, v in state["bonded"].items()},
                "traces": next(iter(tr.values())) if tr else None}
    return {"us": {"body": state["u"]}, "bonded": {},
            "traces": state.get("traces")}


def result_state(engine, res) -> Dict:
    """What ``run()`` returned, in :func:`host_state`'s form."""
    if hasattr(res, "bodies"):
        tr = res.traces or {}
        return {"us": dict(res.bodies),
                "bonded": {int(k): v for k, v in res.bonded.items()},
                "traces": next(iter(tr.values())) if tr else None}
    return {"us": {"body": res.u}, "bonded": {}, "traces": res.traces}


class Timed:
    """Host milliseconds spent inside the program functions named
    ``module:Attr.path`` while installed; ``total_ms`` by name."""

    def __init__(self, targets: Sequence[str]):
        self.total_ms: Dict[str, float] = {t: 0.0 for t in targets}
        self._saved: List[Tuple[object, str, object]] = []

    def install(self) -> None:
        for target in self.total_ms:
            mod, path = target.split(":")
            owner = importlib.import_module(mod)
            *heads, attr = path.split(".")
            for h in heads:
                owner = getattr(owner, h)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, target))

    def _wrap(self, fn, target: str):
        totals = self.total_ms

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                totals[target] += (time.perf_counter() - t0) * 1e3
        return timed

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def peak_bytes(devs: Sequence[torch.device]) -> Optional[int]:
    """The allocator's high-water mark on the fullest card (None on the
    CPU)."""
    cards = [d for d in devs if d.type == "cuda"]
    if not cards:
        return None
    return max(int(torch.cuda.max_memory_allocated(d)) for d in set(cards))
