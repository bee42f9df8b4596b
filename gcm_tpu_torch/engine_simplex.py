"""Engine for one body on a simplex mesh.

Counterpart of ``gcm_tpu/engine_simplex.py`` (``SimplexEngine``): builds the
static foot tables host-side once, then runs the symmetrized time loop (axes
forward on even steps, reversed on odd ones) with sources, ODE correctors
and detector gathers after each step, in the JAX engine's order. Its
``lax.scan`` becomes a Python loop. ``kernel="simplex"`` sweeps with the
CUDA kernel (``ops/simplex.py``), ``kernel="torch"`` with the plain gather
sweep (``solver/simplex_gcm.py``); ``"auto"`` takes the kernel on a CUDA
device, whatever the mesh size. ``state_dict``/``load_state`` checkpoint
and resume a run, guarded by the mesh's node fingerprint, and
``run_with_outputs`` writes ``.vtu`` snapshots, checkpoints and seismograms.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gcm_tpu_torch.engine import as_tensor, check_device
from gcm_tpu_torch.grids.simplex import (
    FootTables, SimplexGrid, build_foot_tables,
)
from gcm_tpu_torch.materials import IsotropicMaterial, MaterialFields
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.simplex import build_simplex_plan, simplex_step
from gcm_tpu_torch.solver import simplex_gcm
from gcm_tpu_torch.solver.simplex_gcm import NodeBorders, build_node_borders
from gcm_tpu_torch.snapshot import save_seismograms, write_pvd, write_vtu
from gcm_tpu_torch.task import SIMPLEX_KERNELS, BorderSpec
from gcm_tpu_torch.utils.checkpoint import TraceRecord, output_callback


def resolve_simplex_kernel(kernel: str, device) -> str:
    """Resolve ``"auto"``: the simplex sweep kernel on a CUDA device, the
    plain torch sweep elsewhere. There is no minimum mesh size."""
    if kernel not in SIMPLEX_KERNELS:
        raise ValueError(f"unknown simplex kernel {kernel!r} "
                         f"(expected one of {SIMPLEX_KERNELS})")
    if kernel != "auto":
        return kernel
    return "simplex" if torch.device(device).type == "cuda" else "torch"


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
        material: "IsotropicMaterial | MaterialFields",
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
        self.kernel = resolve_simplex_kernel(kernel, self.device)
        if self.kernel == "simplex" and (self.device.type != "cuda"
                                         or dtype != torch.float32):
            raise ValueError("kernel='simplex' runs float32 on a CUDA device")
        self.mat = _material_fields(material, grid.npoints, self.device, dtype)
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
                       _foot_tables(grid, self.mat, self.dt, order))
        if self.kernel == "simplex":
            self._plan = build_simplex_plan(self.model, self.mat, self.tables,
                                            self.border_kind, self.device,
                                            dtype)
        else:
            self._plan = None
            self._dev_tables = {
                k: FootTables(
                    ids=torch.as_tensor(t.ids, device=self.device).long(),
                    weights=torch.as_tensor(t.weights, device=self.device
                                            ).to(dtype),
                    outside=torch.as_tensor(t.outside, device=self.device))
                for k, t in self.tables.items()}
            if isinstance(self.border_kind, NodeBorders):
                self._dev_border = NodeBorders(
                    kind=torch.as_tensor(self.border_kind.kind,
                                         device=self.device),
                    value=torch.as_tensor(self.border_kind.value,
                                          device=self.device))
            else:
                self._dev_border = self.border_kind
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
        if self._plan is not None:
            return simplex_step(self._plan, u, axes)
        return simplex_gcm.simplex_step(self.model, u, self.mat,
                                        self._dev_tables, self._dev_border,
                                        axes)

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


def _points_fingerprint(grid) -> Optional[np.ndarray]:
    """md5 (a [16] uint8 array) of the node coordinates in storage order:
    it changes whenever the node numbering does (another mesh, a locality
    reorder), which is what makes a per-node checkpoint unresumable. The
    same digest as the JAX package's on the same mesh."""
    if grid is None or getattr(grid, "points", None) is None:
        return None
    digest = hashlib.md5(np.ascontiguousarray(grid.points).tobytes()).digest()
    return np.frombuffer(digest, np.uint8).copy()


def _check_points_fingerprint(saved, grid) -> None:
    """Raise when a checkpoint's node numbering is not the grid's; a
    checkpoint without a fingerprint (saved is None) loads unverified."""
    if saved is None:
        return
    cur = _points_fingerprint(grid)
    if cur is not None and not np.array_equal(np.asarray(saved), cur):
        raise ValueError(
            "checkpoint node numbering mismatch: the saved fields "
            "were written under a different node order than this grid. "
            "Imported meshes (from_cells/load_msh) are locality-reordered "
            "by default: rebuild the grid with the reorder setting the "
            "checkpoint was written under, or remap external data with "
            "grid.node_order.")


def _material_fields(material, npoints: int, device,
                     dtype) -> MaterialFields:
    """Per-node fields pass through (moved to the device and dtype); a
    constant isotropic material is spread over the nodes."""
    if isinstance(material, MaterialFields):
        return dataclasses.replace(material, **{
            f.name: getattr(material, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(material)})
    if not isinstance(material, IsotropicMaterial):
        raise NotImplementedError(
            "orthotropic media on simplex meshes are not ported to "
            "gcm_tpu_torch yet")
    return MaterialFields.uniform(material, (npoints,), device=device,
                                  dtype=dtype)


def _foot_tables(grid: SimplexGrid, mat: MaterialFields, dt: float,
                 order: int = 1) -> Dict[Tuple, FootTables]:
    """One table per (axis, wave, direction), uncompressed."""
    waves = {"p": mat.cp.cpu().double().numpy()}
    cs = mat.cs.cpu().double().numpy()
    if float(cs.max()) > 0:
        waves["s"] = cs
    return build_foot_tables(grid, waves, dt, order=order)
