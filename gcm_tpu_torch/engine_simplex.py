"""Engines for simplex meshes: one body, or several coupled by contacts.

Counterpart of ``gcm_tpu/engine_simplex.py`` (``SimplexEngine``,
``SimplexMultiEngine``): builds the static foot tables host-side once, then
runs the symmetrized time loop (axes forward on even steps, reversed on odd
ones) with sources, ODE correctors and detector gathers after each step, in
the JAX engine's order. Its ``lax.scan`` becomes a Python loop.
``kernel="simplex"`` sweeps with the CUDA kernel (``ops/simplex.py``),
``kernel="torch"`` with the plain gather sweep (``solver/simplex_gcm.py``);
``"auto"`` takes the kernel on a CUDA device for isotropic media, whatever
the mesh size. Orthotropic media sweep on the plain path over per-pair foot
tables, as in JAX. ``state_dict``/``load_state`` checkpoint and resume a
run, guarded by the meshes' node fingerprints; ``SimplexEngine.
run_with_outputs`` writes ``.vtu`` snapshots, checkpoints and seismograms.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gcm_tpu_torch.engine import as_tensor, check_device
from gcm_tpu_torch.engine_multi import _to_host
from gcm_tpu_torch.grids.simplex import (
    FootTables, SimplexGrid, build_foot_tables, build_foot_tables_for_model,
)
from gcm_tpu_torch.materials import (
    AxisViewCache, IsotropicMaterial, MaterialFields, OrthotropicMaterial,
    OrthotropicMaterialFields,
)
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.simplex import build_simplex_plan, simplex_sweep
from gcm_tpu_torch.solver import simplex_gcm
from gcm_tpu_torch.solver.simplex_contact import (
    SimplexContactSpec, apply_simplex_contact_nc_post,
    apply_simplex_contact_post, init_simplex_bonded_nc,
    interface_is_conforming, pair_contact_maps, pair_contact_nodes,
)
from gcm_tpu_torch.solver.simplex_gcm import NodeBorders, build_node_borders
from gcm_tpu_torch.snapshot import save_seismograms, write_pvd, write_vtu
from gcm_tpu_torch.task import SIMPLEX_KERNELS, BorderSpec
from gcm_tpu_torch.utils.checkpoint import TraceRecord, output_callback

#: a body's material: constant, or per-node fields (``SimplexTask.
#: material_fields``)
Material = Union[IsotropicMaterial, OrthotropicMaterial, MaterialFields,
                 OrthotropicMaterialFields]
#: the JAX package's names of the simplex compute paths
_JAX_KERNEL_NAMES = {"jnp": "torch", "pallas_simplex": "simplex"}


def resolve_simplex_kernel(kernel: str, device, mat=None) -> str:
    """Resolve ``"auto"``: the simplex sweep kernel on a CUDA device, the
    plain torch sweep elsewhere, and the plain sweep for orthotropic
    material fields ``mat`` (the kernel takes isotropic media only, as in
    JAX); ``"simplex"`` on orthotropic fields raises. There is no minimum
    mesh size. The JAX names ``"jnp"`` and ``"pallas_simplex"`` stand for
    ``"torch"`` and ``"simplex"``."""
    kernel = _JAX_KERNEL_NAMES.get(kernel, kernel)
    if kernel not in SIMPLEX_KERNELS:
        raise ValueError(f"unknown simplex kernel {kernel!r} "
                         f"(expected one of {SIMPLEX_KERNELS})")
    ortho = isinstance(mat, OrthotropicMaterialFields)
    if kernel == "simplex" and ortho:
        raise ValueError("kernel='simplex' takes isotropic media; "
                         "orthotropic media run kernel='torch'")
    if kernel != "auto":
        return kernel
    return ("simplex" if torch.device(device).type == "cuda" and not ortho
            else "torch")


class _Sweeps:
    """One body's sweeps on its device: ``sweeps(u, axis)`` is one
    characteristic sweep through the simplex kernel's plan (``kernel=
    "simplex"``), or through the plain gather sweep on the tables and the
    border, moved to the device once. ``views`` holds the material's
    per-axis views, each computed at its first use."""

    def __init__(self, model, mat, tables, border, kernel: str, device,
                 dtype):
        self.model = model
        self.views = AxisViewCache(mat)
        self.plan = None
        if kernel == "simplex":
            if torch.device(device).type != "cuda" or dtype != torch.float32:
                raise ValueError("kernel='simplex' runs float32 on a CUDA "
                                 "device")
            self.plan = build_simplex_plan(model, mat, tables, border,
                                           device, dtype)
            return
        self.tables = {
            k: FootTables(
                ids=torch.as_tensor(t.ids, device=device).long(),
                weights=torch.as_tensor(t.weights, device=device).to(dtype),
                outside=torch.as_tensor(t.outside, device=device))
            for k, t in tables.items()}
        if isinstance(border, NodeBorders):
            border = NodeBorders(
                kind=torch.as_tensor(border.kind, device=device),
                value=torch.as_tensor(border.value, device=device))
        self.border = border

    def __call__(self, u: torch.Tensor, axis: int) -> torch.Tensor:
        if self.plan is not None:
            return simplex_sweep(self.plan, u, axis)
        return simplex_gcm.simplex_stage(self.model, u, self.views,
                                         self.tables, axis, self.border)


@dataclasses.dataclass
class SimplexRunResult:
    u: np.ndarray                        # final state [ncomp, npoints]
    nsteps: int
    dt: float
    wall_seconds: float
    points_per_second: float
    traces: Optional[np.ndarray]         # [nsteps, npoints_det, ncomp]
    kernel: str                          # resolved compute path


class SimplexEngine:
    """Engine over one simplex body on one device (default: the card;
    ``device="cpu"`` runs the plain versions on the CPU).

    ``border_kind``: one condition for the whole hull (a kind string or a
    task.BorderSpec). ``borders``: per-area conditions instead, a sequence
    of ``(Area-or-node-mask, BorderSpec)`` over ``border_kind`` as the
    default. ``sources`` inject at the node nearest each source position;
    ``detector_points`` record the nearest node's state every step.
    ``tables``: foot tables already built for this grid, material and dt
    (another engine's ``tables``), instead of building them.
    """

    def __init__(
        self,
        grid: SimplexGrid,
        model_name: str,
        material: Material,
        cfl: float = 0.8,
        border_kind: "str | BorderSpec" = "absorbing",
        u0: Optional[np.ndarray] = None,
        dtype=torch.float32,
        borders: Optional[Sequence[Tuple[object, BorderSpec]]] = None,
        sources: Sequence[object] = (),
        detector_points: Optional[Sequence[Sequence[float]]] = None,
        correctors: Sequence[object] = (),
        nsteps: Optional[int] = None,
        name: str = "simplex",
        order: int = 1,
        kernel: str = "auto",
        device="cuda",
        tables: Optional[Dict[Tuple, FootTables]] = None,
    ):
        from scipy.spatial import cKDTree

        self.grid = grid
        self.model = get_model(model_name)
        self.device = check_device(device)
        self.dtype = dtype
        self.name = name
        self.mat = _material_fields(material, grid.npoints, self.device, dtype)
        self.kernel = resolve_simplex_kernel(kernel, self.device, self.mat)
        # characteristic length: minimum nearest-neighbour distance
        tree = cKDTree(grid.points)
        d, _ = tree.query(grid.points, k=2)
        self.dt = cfl * float(d[:, 1].min()) / self.mat.max_cp()
        if borders is not None:
            default = (BorderSpec(border_kind) if isinstance(border_kind, str)
                       else border_kind)
            self.border_kind = build_node_borders(grid, borders, default)
        else:
            self.border_kind = border_kind
        self.tables = (tables if tables is not None else
                       _foot_tables(grid, self.model, self.mat, self.dt,
                                    order))
        self._sweeps = _Sweeps(self.model, self.mat, self.tables,
                               self.border_kind, self.kernel, self.device,
                               dtype)
        #: the simplex kernel's plan (None on the plain path)
        self._plan = self._sweeps.plan
        self.u = torch.as_tensor(
            u0 if u0 is not None
            else np.zeros((self.model.ncomp, grid.npoints)),
            device=self.device).to(dtype)
        # nearest-node sources and detectors, reusing the dt tree
        self._srcs = []
        for src in sources:
            _, node = tree.query(np.asarray(src.position)[None, :], k=1)
            for cname in src.components:
                self._srcs.append((int(node[0]), self.model.comp(cname), src))
        self._src_flat = torch.as_tensor(
            np.asarray([c * grid.npoints + n for n, c, _ in self._srcs],
                       np.int64), device=self.device)
        self._det_idx = None
        if detector_points is not None:
            _, nodes = tree.query(np.asarray(detector_points), k=1)
            self._det_idx = torch.as_tensor(np.asarray(nodes, np.int64),
                                            device=self.device)
        # ODE corrector aux state, updated after each step
        self.correctors = tuple(correctors)
        self.aux: Dict[str, torch.Tensor] = {}
        for corr in self.correctors:
            self.aux.update(corr.init_aux(self.model, (grid.npoints,),
                                          device=self.device))
        self.nsteps = nsteps
        self.task = None
        #: the task's SnapshotSpec (set by from_task)
        self.snapshots = None
        #: the first step run() executes (set by load_state on a resume),
        #: and the steps completed so far
        self.start_step = 0
        self._done_step = 0
        #: the detector record across a resume (None without detectors)
        self._trace = (TraceRecord(len(self._det_idx), self.model.ncomp)
                       if self._det_idx is not None else None)
        #: the completed step at each device-to-host copy of the state
        #: made by state_dict
        self.host_copies: List[int] = []

    @classmethod
    def from_task(cls, task, device="cuda", dtype=torch.float32,
                  tables: Optional[Dict[Tuple, FootTables]] = None
                  ) -> "SimplexEngine":
        """Build from a :class:`gcm_tpu_torch.task.SimplexTask`:
        materials and initial conditions by Area, per-area borders,
        sources, detectors, correctors and the task's step count.
        ``device`` defaults to the card."""
        device = check_device(device)
        model = get_model(task.model)
        eng = cls(
            task.grid, task.model,
            task.material_fields(device=device, dtype=dtype),
            cfl=task.time.cfl,
            border_kind=task.border_default,
            u0=task.initial_state(model),
            dtype=dtype,
            borders=(task.borders or None),
            sources=task.sources,
            detector_points=(task.detectors.points
                             if task.detectors is not None else None),
            correctors=task.correctors,
            name=task.name,
            order=task.order,
            kernel=task.kernel,
            device=device,
            tables=tables,
        )
        eng.nsteps = task.time.steps_for(eng.dt)
        eng.task = task
        eng.snapshots = task.snapshots
        return eng

    def _step(self, u: torch.Tensor, axes) -> torch.Tensor:
        for a in axes:
            u = self._sweeps(u, a)
        return u

    # ----------------------------------------------------------- checkpoint

    def state_dict(self) -> Dict:
        """The restartable state on the host: the fields ``u``, the
        corrector ``aux`` fields, the completed ``step``, the mesh's node
        fingerprint ``points_md5`` (per-node fields mean nothing in another
        node numbering) and, with detectors, the ``traces`` recorded so
        far. One device-to-host copy of the state (``host_copies``)."""
        self.host_copies.append(self._done_step)
        d = {"u": self.u.cpu().numpy(),
             "aux": {k: v.cpu().numpy() for k, v in self.aux.items()},
             "step": self._done_step,
             "points_md5": _points_fingerprint(self.grid)}
        if self._trace is not None:
            d["traces"] = self._trace.assemble()
        return d

    def load_state(self, state: Dict) -> None:
        """Restore a ``state_dict`` (this engine's or the JAX engine's, as
        numpy arrays); raises if it was saved under another node numbering.
        ``run()`` then runs the steps ``step .. nsteps``."""
        _check_points_fingerprint(state.get("points_md5"), self.grid)
        self.u = as_tensor(state["u"], self.device, self.dtype)
        self.aux = {k: as_tensor(v, self.device)
                    for k, v in dict(state.get("aux", {})).items()}
        self.start_step = self._done_step = int(np.asarray(state["step"]))
        if self._trace is not None:
            self._trace.restore(state.get("traces"))

    # ------------------------------------------------------------------ run

    def run(self, nsteps: Optional[int] = None, snapshot_cb=None,
            cb_every: Optional[int] = None) -> SimplexRunResult:
        """Run the steps ``start_step .. nsteps`` (default: the task's).

        ``snapshot_cb(step, u)`` is called after every step that is a
        multiple of ``cb_every`` (default: the task's snapshot cadence),
        rounded up to the symmetrization period of 2, also after a resume
        off that grid; ``u`` is the device state, not a copy.
        """
        nsteps = self.nsteps if nsteps is None else nsteps
        if nsteps is None:
            raise ValueError("nsteps not given and engine has no task")
        model = self.model
        axes_fwd = tuple(range(model.dim))
        start = int(self.start_step)
        if cb_every is None:
            cb_every = self.snapshots.every if self.snapshots else 0
        every = -(-cb_every // 2) * 2 if snapshot_cb and cb_every else 0
        # every step's source amplitudes, in float64, cast once
        times = (np.arange(nsteps, dtype=np.float64) + 1.0) * self.dt
        amps = (np.stack([np.broadcast_to(s.wavelet(times) * self.dt, nsteps)
                          for _, _, s in self._srcs], axis=1)
                if self._srcs else np.zeros((nsteps, 0)))
        amps = torch.as_tensor(amps, device=self.device).to(self.dtype)
        if self._trace is not None:
            self._trace.start([(torch.empty(
                (max(nsteps - start, 0), len(self._det_idx), model.ncomp),
                device=self.device, dtype=self.dtype), slice(None))],
                resumed=start > 0)
        u, aux = self.u, self.aux
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = _time.perf_counter()
        for n in range(start, nsteps):
            u = self._step(u, axes_fwd if n % 2 == 0 else axes_fwd[::-1])
            if len(self._src_flat):
                # sources land after the sweeps, before the correctors
                u.view(-1).index_add_(0, self._src_flat, amps[n])
            for corr in self.correctors:
                u, aux = corr(model, u, aux, self.dt)
            if self._trace is not None:
                self._trace.put(n - start, u[:, self._det_idx].T)
            self.u, self.aux = u, aux
            self._done_step = n + 1
            if every and (n + 1) % every == 0:
                snapshot_cb(n + 1, u)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = _time.perf_counter() - t0
        return SimplexRunResult(
            u=u.cpu().numpy(),
            nsteps=nsteps,
            dt=self.dt,
            wall_seconds=wall,
            points_per_second=(self.grid.npoints * (nsteps - start)
                               / max(wall, 1e-12)),
            traces=self._trace.assemble() if self._trace is not None
            else None,
            kernel=self.kernel,
        )

    # ------------------------------------------------------------- outputs

    def run_with_outputs(self, outdir: str,
                         checkpoint_every: int = 0) -> SimplexRunResult:
        """``run()`` with its artifacts under ``outdir``, as
        ``Engine.run_with_outputs``: a ``.vtu`` snapshot at the snapshot
        cadence, then a ``.pvd`` of them; checkpoints in
        ``<outdir>/checkpoints``; the seismograms at the end. The state is
        copied to the host once at each step where either cadence fires."""
        os.makedirs(outdir, exist_ok=True)
        snap = self.snapshots
        snapdir = os.path.join(outdir, snap.directory if snap is not None
                               else "snapshots")
        series = []

        def snapshot(step: int, state: Dict) -> None:
            fname = f"{self.name}_{step:06d}.vtu"
            os.makedirs(snapdir, exist_ok=True)
            self.write_snapshot(os.path.join(snapdir, fname), state)
            series.append((step * self.dt, fname))

        cb, every = output_callback(
            outdir, 2, snap.every if snap is not None else 0,
            checkpoint_every, self.state_dict, snapshot)
        res = self.run(snapshot_cb=cb, cb_every=every)
        if series:
            write_pvd(os.path.join(snapdir, f"{self.name}.pvd"), series)
        if res.traces is not None and self.task is not None \
                and self.task.detectors is not None:
            save_seismograms(outdir, self.name, res.traces, self.dt,
                             self.task.detectors.points,
                             self.model.comp_names)
        return res

    def write_snapshot(self, path: str, state: Optional[Dict] = None
                       ) -> None:
        """The state as a ``.vtu``: each component, the velocity vector and
        the corrector aux fields; ``state`` is a ``state_dict()`` already
        taken at this step (default: a new one)."""
        state = self.state_dict() if state is None else state
        u = state["u"]
        fields = {n: u[i] for i, n in enumerate(self.model.comp_names)}
        fields["velocity"] = u[self.model.vel_slice]
        fields.update(state["aux"])
        write_vtu(path, self.grid.points, self.grid.cells, fields)


# ------------------------------------------------------------ multi-body

@dataclasses.dataclass
class SimplexBody:
    """One body of a multi-body simplex run: its mesh and material
    (constant, or per-node fields), border conditions (one kind or
    BorderSpec for the hull, ``borders`` by Area over it), initial state
    ``u0 [ncomp, N]``, sources, receivers and ODE correctors."""

    grid: SimplexGrid
    material: Material
    border_kind: "str | BorderSpec" = "absorbing"
    borders: Optional[Sequence[Tuple[object, BorderSpec]]] = None
    u0: Optional[np.ndarray] = None
    sources: Sequence[object] = ()
    detector_points: Optional[Sequence[Sequence[float]]] = None
    correctors: Sequence[object] = ()


@dataclasses.dataclass
class SimplexMultiRunResult:
    bodies: Dict[str, np.ndarray]        # final state per body
    bonded: Dict[int, object]            # bond mask (or per-side dict)
    nsteps: int
    dt: float
    wall_seconds: float
    points_per_second: float             # all bodies' nodes x steps / wall
    traces: Optional[Dict[str, np.ndarray]] = None  # body -> [steps, nd, nc]
    kernels: Optional[Dict[str, str]] = None        # resolved path per body


class SimplexMultiEngine:
    """Simplex bodies coupled by contacts along coordinate planes, on one
    device (default: the card; ``device="cpu"`` runs the plain versions).

    dt is the CFL minimum over the bodies. Each body sweeps through its own
    path (``kernel`` as ``SimplexEngine``'s, resolved per body:
    ``kernels``), with its own tables and border; after the sweep along a
    contact's axis, the contact's fixup couples the two bodies' interface
    nodes (``solver.simplex_contact``): node pair by node pair where the
    interface nodes are collocated, through interpolation maps where the
    bodies are meshed independently. Fracture carries a bond mask per
    contact (per side when non-conforming). Sources, then correctors, act
    after each full step, as in JAX. ``tables``: each body's foot tables
    already built for this engine's dt (another engine's ``tables``).
    """

    def __init__(self, bodies: Dict[str, SimplexBody],
                 contacts: Sequence[SimplexContactSpec],
                 model_name: str = "elastic2d", cfl: float = 0.8,
                 dtype=torch.float32, order: int = 1, kernel: str = "auto",
                 device="cuda",
                 tables: Optional[Dict[str, Dict[Tuple, FootTables]]] = None):
        from scipy.spatial import cKDTree

        self.bodies = bodies
        self.contacts = tuple(contacts)
        self.model = get_model(model_name)
        self.device = check_device(device)
        self.dtype = dtype
        model = self.model

        self.mats: Dict[str, object] = {}
        self.kernels: Dict[str, str] = {}
        trees = {}
        dts = []
        for name, b in bodies.items():
            mat = _material_fields(b.material, b.grid.npoints, self.device,
                                   dtype)
            self.mats[name] = mat
            self.kernels[name] = resolve_simplex_kernel(kernel, self.device,
                                                        mat)
            trees[name] = cKDTree(b.grid.points)
            d, _ = trees[name].query(b.grid.points, k=2)
            dts.append(cfl * float(d[:, 1].min()) / mat.max_cp())
        self.dt = float(min(dts))

        self.tables: Dict[str, Dict[Tuple, FootTables]] = {}
        self.borders: Dict[str, object] = {}
        self._sweeps: Dict[str, _Sweeps] = {}
        self.us: Dict[str, torch.Tensor] = {}
        for name, b in bodies.items():
            mat = self.mats[name]
            self.tables[name] = (
                tables[name] if tables is not None else
                _foot_tables(b.grid, model, mat, self.dt, order))
            if b.borders is not None:
                default = (BorderSpec(b.border_kind)
                           if isinstance(b.border_kind, str)
                           else b.border_kind)
                self.borders[name] = build_node_borders(b.grid, b.borders,
                                                        default)
            else:
                self.borders[name] = b.border_kind
            self._sweeps[name] = _Sweeps(model, mat, self.tables[name],
                                         self.borders[name],
                                         self.kernels[name], self.device,
                                         dtype)
            self.us[name] = as_tensor(
                b.u0 if b.u0 is not None
                else np.zeros((model.ncomp, b.grid.npoints)),
                self.device, dtype)

        # per contact: the node pairing where the whole interface is
        # collocated (shared corner nodes alone do not count), else the
        # interface maps; bond masks where fracture is on
        self._pairs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._ncmaps: Dict[int, object] = {}
        self.bonded: Dict[int, object] = {}
        for ci, c in enumerate(self.contacts):
            ga, gb = bodies[c.body_a].grid, bodies[c.body_b].grid
            maps = pair_contact_maps(ga, gb, c.axis)
            if interface_is_conforming(maps, ga, gb):
                ia, ib = (torch.as_tensor(i, device=self.device).long()
                          for i in pair_contact_nodes(ga, gb))
                self._pairs[ci] = (ia, ib)
                if c.tensile_strength is not None:
                    self.bonded[ci] = torch.ones(len(ia), dtype=dtype,
                                                 device=self.device)
            else:
                self.set_interface_maps(ci, maps)
                if c.tensile_strength is not None:
                    self.bonded[ci] = init_simplex_bonded_nc(
                        maps, dtype, self.device)

        # nearest-node sources and receivers, correctors' aux per body
        self._srcs: List[Tuple[str, int, int, object]] = []
        self._det_idx: Dict[str, torch.Tensor] = {}
        self.auxs: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, b in bodies.items():
            for src in b.sources:
                _, node = trees[name].query(
                    np.asarray(src.position)[None, :], k=1)
                for cname in src.components:
                    self._srcs.append((name, int(node[0]),
                                       model.comp(cname), src))
            if b.detector_points is not None:
                _, nodes = trees[name].query(np.asarray(b.detector_points),
                                             k=1)
                self._det_idx[name] = torch.as_tensor(
                    np.asarray(nodes, np.int64), device=self.device)
            aux: Dict[str, torch.Tensor] = {}
            for corr in b.correctors:
                aux.update(corr.init_aux(model, (b.grid.npoints,),
                                         device=self.device))
            self.auxs[name] = aux

        #: the first step run() executes (set by load_state on a resume),
        #: and the steps completed so far
        self.start_step = 0
        self._done_step = 0
        #: the detector record across a resume, per body with receivers
        self._traces = {name: TraceRecord(len(idx), model.ncomp)
                        for name, idx in self._det_idx.items()}
        #: the completed step at each device-to-host copy of the state made
        #: by state_dict
        self.host_copies: List[int] = []

    def set_interface_maps(self, ci: int, maps) -> None:
        """Couple contact ``ci`` through the non-conforming interface
        ``maps`` (a ``SimplexInterfaceMaps`` of host arrays, kept on the
        device), also where the interface is collocated; its bond mask is
        not changed."""
        self._pairs.pop(ci, None)
        dev = self.device
        self._ncmaps[ci] = dataclasses.replace(maps, **{
            f: torch.as_tensor(getattr(maps, f), device=dev).long()
            for f in ("idx_a", "idx_b", "nbr_a", "nbr_b")}, **{
            f: torch.as_tensor(getattr(maps, f), device=dev).to(self.dtype)
            for f in ("w_a", "w_b")})

    # ------------------------------------------------------------------ step

    def _one_step(self, us, bonded, auxs, n: int, amps):
        """Step ``n``: each axis (forward on even steps, reversed on odd
        ones) sweeps every body, then the fixups of the contacts on that
        axis; then the sources, then each body's correctors."""
        model = self.model
        axes = tuple(range(model.dim))
        if n % 2:
            axes = axes[::-1]
        for axis in axes:
            olds = us
            us = {name: self._sweeps[name](u, axis) for name, u in us.items()}
            bonded = dict(bonded)
            st = model.stage(axis)
            for ci, c in enumerate(self.contacts):
                if c.axis != axis:
                    continue
                va = self._sweeps[c.body_a].views.axis_view(axis, st)
                vb = self._sweeps[c.body_b].views.axis_view(axis, st)
                if ci in self._ncmaps:
                    ua, ub, nb = apply_simplex_contact_nc_post(
                        c, model, self._ncmaps[ci], olds[c.body_a],
                        us[c.body_a], olds[c.body_b], us[c.body_b], va, vb,
                        bonded.get(ci))
                else:
                    ia, ib = self._pairs[ci]
                    ua, ub, nb = apply_simplex_contact_post(
                        c, model, olds[c.body_a], us[c.body_a],
                        olds[c.body_b], us[c.body_b], va, vb, ia, ib,
                        bonded.get(ci))
                us[c.body_a], us[c.body_b] = ua, ub
                if nb is not None:
                    bonded[ci] = nb
        for k, (name, node, comp, _) in enumerate(self._srcs):
            # the step's fresh output, written in place
            us[name][comp, node] += amps[n, k]
        new_auxs = {}
        for name, b in self.bodies.items():
            u, aux = us[name], auxs[name]
            for corr in b.correctors:
                u, aux = corr(model, u, aux, self.dt)
            us[name] = u
            new_auxs[name] = aux
        return us, bonded, new_auxs

    # ----------------------------------------------------------- checkpoint

    def state_dict(self) -> Dict:
        """The restartable state on the host, in the JAX engine's layout:
        per-body fields ``us``, the bond masks ``bonded`` (string keys; a
        non-conforming contact's per-side dict), per-body corrector
        ``aux``, the completed ``step``, per-body node fingerprints
        ``points_md5`` and, with receivers, per-body ``traces``. One
        device-to-host copy of the state (``host_copies``)."""
        self.host_copies.append(self._done_step)
        d = {"us": {k: v.cpu().numpy() for k, v in self.us.items()},
             "bonded": {str(k): _to_host(v)
                        for k, v in self.bonded.items()},
             "aux": {k: {ak: av.cpu().numpy() for ak, av in a.items()}
                     for k, a in self.auxs.items()},
             "step": self._done_step,
             "points_md5": {k: _points_fingerprint(b.grid)
                            for k, b in self.bodies.items()}}
        if self._traces:
            d["traces"] = {k: r.assemble() for k, r in self._traces.items()}
        return d

    def load_state(self, state: Dict) -> None:
        """Restore a ``state_dict`` (this engine's or the JAX engine's, as
        numpy arrays); raises if a body's fields were saved under another
        node numbering. ``run()`` then runs the steps ``step .. nsteps``,
        from an odd step as well."""
        for name, fp in (state.get("points_md5") or {}).items():
            if name in self.bodies:
                _check_points_fingerprint(fp, self.bodies[name].grid,
                                          body=name)
        dev, dt = self.device, self.dtype
        self.us = {k: as_tensor(v, dev, dt) for k, v in state["us"].items()}
        self.bonded = {
            int(k): ({s: as_tensor(m, dev, dt) for s, m in v.items()}
                     if isinstance(v, dict) else as_tensor(v, dev, dt))
            for k, v in state["bonded"].items()}
        if "aux" in state:
            self.auxs = {k: {ak: as_tensor(av, dev) for ak, av in a.items()}
                         for k, a in state["aux"].items()}
        self.start_step = self._done_step = int(np.asarray(state["step"]))
        restored = dict(state.get("traces") or {})
        for name, record in self._traces.items():
            record.restore(restored.get(name))

    # ------------------------------------------------------------------- run

    def run(self, nsteps: int, snapshot_cb=None, snapshot_every: int = 0
            ) -> SimplexMultiRunResult:
        """Run the steps ``start_step .. nsteps``; optionally call
        ``snapshot_cb(step, {name: u})`` after every step that is a
        multiple of ``snapshot_every`` rounded up to the symmetrization
        period of 2, also after a resume off that grid. The states are the
        bodies' tensors on the device, not copies."""
        model = self.model
        start = int(self.start_step)
        every = (-(-snapshot_every // 2) * 2
                 if snapshot_cb is not None and snapshot_every else 0)
        # every step's source amplitudes, in float64, cast once
        times = (np.arange(nsteps, dtype=np.float64) + 1.0) * self.dt
        amps = (np.stack([np.broadcast_to(s.wavelet(times) * self.dt, nsteps)
                          for *_, s in self._srcs], axis=1)
                if self._srcs else np.zeros((nsteps, 0)))
        amps = torch.as_tensor(amps, device=self.device).to(self.dtype)
        for name, record in self._traces.items():
            record.start([(torch.empty(
                (max(nsteps - start, 0), len(self._det_idx[name]),
                 model.ncomp), device=self.device, dtype=self.dtype),
                slice(None))], resumed=start > 0)
        us, bonded, auxs = dict(self.us), dict(self.bonded), dict(self.auxs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = _time.perf_counter()
        for n in range(start, nsteps):
            us, bonded, auxs = self._one_step(us, bonded, auxs, n, amps)
            for name, idx in self._det_idx.items():
                self._traces[name].put(n - start, us[name][:, idx].T)
            self.us, self.bonded, self.auxs = us, bonded, auxs
            self._done_step = n + 1
            if every and (n + 1) % every == 0:
                snapshot_cb(n + 1, us)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = _time.perf_counter() - t0
        npts = sum(b.grid.npoints for b in self.bodies.values())
        return SimplexMultiRunResult(
            bodies={k: v.cpu().numpy() for k, v in us.items()},
            bonded={k: _to_host(v) for k, v in bonded.items()},
            nsteps=nsteps, dt=self.dt, wall_seconds=wall,
            points_per_second=npts * (nsteps - start) / max(wall, 1e-12),
            traces=({k: r.assemble() for k, r in self._traces.items()}
                    if self._traces else None),
            kernels=dict(self.kernels))


def _points_fingerprint(grid) -> Optional[np.ndarray]:
    """md5 (a [16] uint8 array) of the node coordinates in storage order:
    it changes whenever the node numbering does (another mesh, a locality
    reorder), which is what makes a per-node checkpoint unresumable. The
    same digest as the JAX package's on the same mesh."""
    if grid is None or getattr(grid, "points", None) is None:
        return None
    digest = hashlib.md5(np.ascontiguousarray(grid.points).tobytes()).digest()
    return np.frombuffer(digest, np.uint8).copy()


def _check_points_fingerprint(saved, grid,
                              body: Optional[str] = None) -> None:
    """Raise when a checkpoint's node numbering is not the grid's (of
    ``body`` in a multi-body run); a checkpoint without a fingerprint
    (saved is None) loads unverified."""
    if saved is None:
        return
    cur = _points_fingerprint(grid)
    if cur is not None and not np.array_equal(np.asarray(saved), cur):
        where = f" for body '{body}'" if body else ""
        raise ValueError(
            f"checkpoint node numbering mismatch{where}: the saved fields "
            "were written under a different node order than this grid. "
            "Imported meshes (from_cells/load_msh) are locality-reordered "
            "by default: rebuild the grid with the reorder setting the "
            "checkpoint was written under, or remap external data with "
            "grid.node_order.")


def _material_fields(material: Material, npoints: int, device, dtype
                     ) -> "MaterialFields | OrthotropicMaterialFields":
    """Per-node fields pass through (moved to the device and dtype); a
    constant material is spread over the nodes (orthotropic constants from
    float64, cast once)."""
    if isinstance(material, (MaterialFields, OrthotropicMaterialFields)):
        return dataclasses.replace(material, **{
            f.name: getattr(material, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(material)})
    if isinstance(material, OrthotropicMaterial):
        ones = np.ones(npoints)
        return OrthotropicMaterialFields.from_constants(
            material.rho * ones,
            {k: v * ones for k, v in material.constants().items()},
            device=device, dtype=dtype)
    return MaterialFields.uniform(material, (npoints,), device=device,
                                  dtype=dtype)


def _foot_tables(grid: SimplexGrid, model, mat, dt: float,
                 order: int = 1) -> Dict[Tuple, FootTables]:
    """Uncompressed foot tables: one per (axis, wave, direction) for
    isotropic media, one per (axis, pair, direction) for orthotropic ones,
    whose pairs of one sweep travel at different speeds."""
    if isinstance(mat, OrthotropicMaterialFields):
        return build_foot_tables_for_model(grid, model, mat, dt, order=order)
    waves = {"p": mat.cp.cpu().double().numpy()}
    cs = mat.cs.cpu().double().numpy()
    if float(cs.max()) > 0:
        waves["s"] = cs
    return build_foot_tables(grid, waves, dt, order=order)
