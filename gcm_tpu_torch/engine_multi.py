"""Multi-body engine: several Tasks coupled by contact interfaces.

Counterpart of ``gcm_tpu/engine_multi.py``: the bodies share a global dt
(the CFL minimum over bodies), the contact and fracture state
(per-interface bond masks) is carried between steps on the device, and each
body has its own sources, detectors and corrector aux fields. A step takes
one of four paths (``MultiBodyEngine.path``):

- ``"fused_canonical"`` / ``"fused"`` (``kernel="fused"``, the default on a
  CUDA device, when ``solver.multi.fused_contacts_ok`` holds): one fused
  kernel launch per body and step (``fused_step``, ``fused_step_2d``, or
  ``fused_step_slab`` for canonical or bf16 bodies), then the contact face
  rows (``solver.multi.apply_contact_fixups``);
- ``"sweep"`` (``kernel="sweep"``, or ``"fused"`` on a topology the fused
  composition cannot serve: non-conforming maps, contacts on two axes of a
  body): the per-sweep kernel on each body with no borders, then borders
  and contacts as slab fixups;
- ``"torch"``: ``solver.multi.step_multi``, the plain semantics of record.

With ``mesh=`` (a ``parallel.sharding.DomainMesh``) every body is held in
per-shard blocks from construction on, and the path takes one of the JAX
engine's sharded forms, named with ``_spmd``:

- ``"fused_spmd"`` (JAX ``engine_multi.py:293-333``): ``kernel="fused"``, a
  3D model, every contact axis unsplit by the mesh and
  ``fused_contacts_ok``: the fused SPMD step per body
  (``parallel.fused_spmd``, the interior and ring kernels), then the
  contact face rows;
- ``"sweep_spmd"`` (JAX :224-257): ``"fused"`` or ``"sweep"`` otherwise:
  the per-sweep halo stage per body (``parallel.halo.make_spmd_raw_stage``,
  the sweep kernel), then borders and contacts as fixups. JAX's halo stage
  splits only its leading axis ``sx`` and runs a plain GSPMD step on a mesh
  without it; the port's stage splits any axis, so such a mesh takes the
  sweep kernel too (the same numbers to rounding: the fixups are exact);
- ``"torch_spmd"``: ``kernel="torch"``, where JAX runs ``step_multi`` as
  one GSPMD program: the same halo stage with the plain sweep;
- ``"fused_canonical_spmd"`` (JAX :141-172): the canonical order under a
  mesh of one axis (below).

The contact phases read the faces they need put together on the first
shard's device and write the rows they fix back into the shards' blocks
(``parallel.faces.ShardedFaces``); the bond masks stay whole there. A mesh
may span the processes of a run (``parallel.multihost``): each rank then
steps its own shards, gathers the whole slabs of each contact phase in one
exchange, runs the contact algebra on them as one process would and writes
back its own blocks' rows, so its bond masks are the same whole masks as
every other rank's; ``run()``, ``state_dict()`` and ``run_with_outputs()``
give every rank the whole state, masks and traces, equal to the same run in
one process, and the first rank writes the files.

Bodies may be isotropic or orthotropic (each body's fused stack is compact
or orthotropic, ``ops.fused.stack_mats``). ``canonical_layout=True`` takes
the JAX package's canonical layout as a splitting order: when every contact
is conforming and lies on one axis ``ca != 0`` of a 3D model on the fused
path, and every body is isotropic (as in JAX), the steps sweep (ca, rest)
and its reverse, as the JAX engine sweeps its permuted storage; the port
keeps the task layout in memory. Under a mesh the order engages, as in JAX,
only on a mesh of one axis whose shard count divides every body's x
extent: the mesh then splits x (JAX's middle storage axis).

``state_dict``/``load_state`` checkpoint and resume a run, bond masks
included (the state whole, in task layout, on the host: a state moves
between sharded and unsharded engines, and a JAX engine's resumes), and
``run_with_outputs`` writes per-body snapshots, checkpoints and
seismograms.
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gcm_tpu_torch.engine import (
    as_tensor, check_device, mesh_device, resolve_kernel, shard_detectors,
    shard_sources,
)
from gcm_tpu_torch.materials import AxisViewCache, MaterialFields
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.fused import (
    fused_step, fused_step_2d, fused_step_slab, stack_mats,
)
from gcm_tpu_torch.ops.interp import stencil_radius
from gcm_tpu_torch.ops.sweep import sweep_stage
from gcm_tpu_torch.parallel import multihost
from gcm_tpu_torch.parallel.faces import ShardedFaces
from gcm_tpu_torch.parallel.fused_spmd import (
    extended_mstack, make_fused_spmd_step,
)
from gcm_tpu_torch.parallel.halo import extend_mats_once, make_spmd_raw_stage
from gcm_tpu_torch.parallel.sharding import (
    AXIS_OF, DomainMesh, block_shape, gather_state, shard_field, shard_mats,
    shard_state,
)
from gcm_tpu_torch.solver.contact import ContactSpec
from gcm_tpu_torch.solver.contact_nc import (
    build_interface_maps, faces_conform, init_bonded_nc,
)
from gcm_tpu_torch.solver.gcm import axes_order
from gcm_tpu_torch.solver.multi import (
    fused_contacts_ok, step_multi, step_multi_fast, step_multi_fused,
)
from gcm_tpu_torch.snapshot import (
    save_seismograms, snapshot_fields, write_pvd, write_vti,
)
from gcm_tpu_torch.task import Task, apply_initial
from gcm_tpu_torch.utils.checkpoint import TraceRecord, output_callback
from gcm_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class MultiRunResult:
    bodies: Dict[str, np.ndarray]      # final state per body
    bonded: Dict[int, object]          # bond mask (or per-side dict) per contact
    t: float
    nsteps: int
    dt: float
    wall_seconds: float
    points_per_second: float           # all bodies' points x steps / wall
    traces: Optional[Dict[str, np.ndarray]] = None  # body -> [steps, np, nc]
    path: str = "torch"                # resolved multi-body path


class MultiBodyEngine:
    """Bodies ``{name: Task}`` coupled by ``contacts``. All bodies share the
    model, order, symmetrization and kernel choice; ``device`` defaults to
    the card (``"cuda"``), ``device="cpu"`` runs the plain versions on the
    CPU. With ``mesh=`` (a ``parallel.sharding.DomainMesh``) every body is
    held in per-shard blocks on the mesh's devices (``device`` may be left
    out and must agree with them if given); ``us[name]`` and each aux field
    are then lists of blocks in mesh order (None for a shard another rank
    holds), and the bond masks stay whole on the first shard's device (on
    every rank's own, on a mesh that spans processes)."""

    def __init__(self, bodies: Dict[str, Task],
                 contacts: Sequence[ContactSpec], device=None,
                 dtype=torch.float32, canonical_layout: bool = False,
                 mesh=None):
        with span("gcm.setup"):
            self._build(bodies, contacts, device, dtype, canonical_layout,
                        mesh)

    def _build(self, bodies: Dict[str, Task],
               contacts: Sequence[ContactSpec], device, dtype: torch.dtype,
               canonical_layout: bool, mesh) -> None:
        names = list(bodies)
        self.tasks = bodies
        self.contacts = tuple(contacts)
        t0 = bodies[names[0]]
        self.model = get_model(t0.model)
        self.order = t0.order
        self.symmetrize = t0.symmetrize_stages
        if mesh is not None:
            device = mesh_device(mesh, device)
        self.device = check_device("cuda" if device is None else device)
        self.dtype = dtype
        for t in bodies.values():
            if t.model != t0.model or t.order != t0.order:
                raise ValueError("bodies must share model and order")
            if t.kernel != t0.kernel:
                raise ValueError("bodies must share the kernel choice")
        self.kernel = resolve_kernel(t0.kernel, self.model.dim, self.device)
        if self.kernel in ("fused", "sweep") and (
                self.model.dim not in (2, 3) or dtype != torch.float32):
            raise ValueError(f"kernel={self.kernel!r} runs 2D and 3D bodies "
                             "in float32")

        self.mats: Dict[str, object] = {}
        self.us: Dict[str, torch.Tensor] = {}
        self.hs: Dict[str, Tuple[float, ...]] = {}
        self.borders = {}
        dts = []
        for name, task in bodies.items():
            with span("gcm.setup.materials"):
                mat = task.material_fields(device=self.device, dtype=dtype)
            self.mats[name] = mat
            self.hs[name] = task.grid.h
            self.borders[name] = dict(task.borders)
            with span("gcm.setup.state"):
                u0 = np.zeros((self.model.ncomp,) + task.grid.shape)
                apply_initial(u0, self.model, task.grid, task.initial)
                self.us[name] = torch.as_tensor(u0,
                                                device=self.device).to(dtype)
            dts.append(task.time.cfl * min(task.grid.h) / mat.max_cp())
        self.dt = float(min(dts))
        self.nsteps = t0.time.steps_for(self.dt)

        # non-conforming interfaces get static interpolation maps; explicit
        # lo/span stays on the collocated offset path
        self.ncmaps: Dict[int, object] = {}
        for ci, c in enumerate(self.contacts):
            ga, gb = bodies[c.body_a].grid, bodies[c.body_b].grid
            if c.span is None and not faces_conform(ga, gb, c.axis):
                self.ncmaps[ci] = build_interface_maps(ga, gb, c.axis)

        # the canonical splitting order (JAX's canonical storage order):
        # conforming contacts on one axis ca != 0 of a 3D model, fused path,
        # isotropic bodies; under a mesh also (JAX engine_multi.py:141-172)
        # a mesh of one axis, which then splits axis 0 (JAX's middle axis of
        # its permuted storage, rebuilt as a ('sy',) mesh there), every
        # body's axis 0 divisible by its shards. A 2-axis mesh keeps the
        # default order, as in JAX.
        contact_axes = {c.axis for c in self.contacts}
        iso = all(isinstance(m, MaterialFields) for m in self.mats.values())
        self._fwd = tuple(range(self.model.dim))
        self.canonical = False
        if (canonical_layout and self.kernel == "fused" and not self.ncmaps
                and self.model.dim == 3 and len(contact_axes) == 1 and iso):
            ca = next(iter(contact_axes))
            on_mesh = mesh is None or (
                len(mesh.axis_names) == 1 and all(
                    t.grid.shape[0] % mesh.size == 0
                    for t in bodies.values()))
            if ca != 0 and on_mesh:
                self._fwd = (ca,) + tuple(d for d in range(3) if d != ca)
                self.canonical = True
                if mesh is not None:
                    mesh = DomainMesh(mesh.devices, (mesh.size,), ("sx",),
                                      mesh.ranks)
        #: the mesh the bodies are held on (None: one tensor each)
        self.mesh = mesh
        #: how the receivers of every rank come together (None: all here)
        self._gather = (multihost.all_gather_object
                        if multihost.spans(mesh) else None)

        shapes = {k: t.grid.shape for k, t in bodies.items()}
        full_faces = set()
        for c in self.contacts:
            if c.span is None:
                full_faces.add((c.body_a, c.axis, 1))
                full_faces.add((c.body_b, c.axis, 0))
        self._kernel_bcs = {
            name: {f: b for f, b in self.borders[name].items()
                   if (name,) + f not in full_faces}
            for name in bodies}
        fused_ok = self.kernel == "fused" and fused_contacts_ok(
            self.model, shapes, self.contacts, self.order, self.ncmaps)
        self._fused_multi = None
        self._raw_stage = None
        self._faces = None
        #: whether the per-sweep composition runs the sweep kernel
        self._sweep_kernel = False
        if mesh is not None:
            self._setup_mesh(mesh, fused_ok)
        elif fused_ok:
            # the fused composition: one fused pass per body, contacts as
            # face rows; else the per-sweep kernel with fixups; else plain
            with span("gcm.setup.stack"):
                self._mstacks = {
                    name: stack_mats(self.model, self.mats[name],
                                     dtype=(torch.bfloat16
                                            if task.mat_dtype == "bf16"
                                            else None))
                    for name, task in bodies.items()}
            if self.model.dim == 2:
                ffn = fused_step_2d
            else:
                # canonical bodies run the slab kernel, as JAX runs its
                # permuted ones; fused_step hands bf16 stacks to it too
                ffn = fused_step_slab if self.canonical else fused_step

            def _fused_body(name, u, axes):
                return ffn(self.model, u, self._mstacks[name], self.dt,
                           self.hs[name], self.order, self._kernel_bcs[name],
                           axes)

            self._fused_multi = _fused_body
        elif self.kernel in ("fused", "sweep"):
            # each body's per-axis views, computed once
            self._sweep_mats = {k: AxisViewCache(m)
                                for k, m in self.mats.items()}

            def _raw(name, u, axis):
                return sweep_stage(self.model, u, self._sweep_mats[name],
                                   self.dt, self.hs[name], axis, self.order,
                                   None)

            self._raw_stage = _raw
            self._sweep_kernel = True
        #: the resolved path (``_spmd``: on a mesh)
        self.path = (("fused_canonical" if self.canonical else "fused")
                     if self._fused_multi else "sweep" if self._sweep_kernel
                     else "torch") + ("_spmd" if mesh is not None else "")

        # bond masks of fracture-enabled contacts (overlap slab shape; a
        # non-conforming contact carries one mask per side)
        self.bonded: Dict[int, object] = {}
        for ci, c in enumerate(self.contacts):
            if c.tensile_strength is None:
                continue
            if ci in self.ncmaps:
                self.bonded[ci] = init_bonded_nc(self.ncmaps[ci], dtype,
                                                 self.device)
            else:
                slab = (tuple(c.span) if c.span is not None else tuple(
                    s for a, s in enumerate(bodies[c.body_a].grid.shape)
                    if a != c.axis))
                self.bonded[ci] = torch.ones(slab, dtype=dtype,
                                             device=self.device)

        # corrector aux state per body, applied after the contact solves
        self.auxs: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, task in bodies.items():
            aux: Dict[str, torch.Tensor] = {}
            for corr in task.correctors:
                aux.update(corr.init_aux(self.model, task.grid.shape,
                                         device=self.device))
            self.auxs[name] = {k: self._shard(v, lead=0)
                               for k, v in aux.items()}

        #: the first step run() executes (set by load_state on a resume),
        #: and the steps completed so far
        self.start_step = 0
        self._done_step = 0
        #: the completed step at each device-to-host copy of the state made
        #: by state_dict
        self.host_copies: List[int] = []

        # sources and detectors per body, each on its shard (the one shard
        # of a body held whole): flat indices into the shard's state, every
        # step's source amplitude evaluated in float64 at once
        layout = mesh if mesh is not None else DomainMesh(
            (self.device,), (1,), ("sx",))
        times = (np.arange(self.nsteps, dtype=np.float64) + 1.0) * self.dt
        self._srcs: Dict[str, Dict[int, tuple]] = {}
        self._det: Dict[str, Dict[int, tuple]] = {}
        with span("gcm.setup.sources"):
            for name, task in bodies.items():
                block = block_shape(layout, task.grid.shape)
                nodes, amps = [], []
                for src in task.sources:
                    node = task.grid.index_of(src.position)
                    for cname in src.components:
                        nodes.append((self.model.comp(cname),) + tuple(node))
                        amps.append(np.broadcast_to(
                            np.asarray(src.wavelet(times), np.float64),
                            times.shape) * self.dt)
                if nodes:
                    self._srcs[name] = shard_sources(
                        layout, block, self.model.ncomp, nodes,
                        np.asarray(amps).T, dtype)
                if task.detectors is not None:
                    self._det[name] = shard_detectors(
                        layout, block, [task.grid.index_of(p)
                                        for p in task.detectors.points])
        #: the detector record across a resume, per body with detectors
        self._traces = {name: TraceRecord(len(task.detectors.points),
                                          self.model.ncomp)
                        for name, task in bodies.items() if name in self._det}

    # ------------------------------------------------------------- the mesh

    def _setup_mesh(self, mesh, fused_ok: bool) -> None:
        """Per-body blocks, materials and step on the mesh, in one of the
        JAX engine's three sharded forms (``engine_multi.py:224-333``): the
        fused SPMD step per body (``kernel="fused"``, 3D, every contact axis
        unsplit), else the per-sweep halo step (``"fused"`` or ``"sweep"``:
        the sweep kernel, on any mesh axis; ``"torch"``: the plain sweep,
        where JAX runs its plain GSPMD step), contacts and borders as fixups
        on the put-together face rows (``parallel.faces.ShardedFaces``)."""
        model, dim = self.model, self.model.dim
        for name, task in self.tasks.items():
            try:
                block_shape(mesh, task.grid.shape)
            except ValueError as e:
                raise ValueError(
                    f"body {name!r}: {e}; the JAX engine refuses it too "
                    "(jax.device_put needs every split extent divisible by "
                    "its shards, and the field sharding never splits the "
                    "last spatial axis)") from None
        glob = self.mats
        with span("gcm.setup.shard"):
            self.mats = {k: shard_mats(m, mesh) for k, m in glob.items()}
            self.us = {k: shard_state(u, mesh) for k, u in self.us.items()}
        unsplit = {a for a in range(dim)
                   if all(AXIS_OF[n] != a or mesh.axis_size(n) == 1
                          for n in mesh.axis_names)}
        if fused_ok and dim == 3 and all(c.axis in unsplit
                                         for c in self.contacts):
            with span("gcm.setup.stack"):
                self._mstacks = {
                    name: extended_mstack(model, glob[name], mesh, self.order)
                    for name in self.tasks}
            steps = {name: make_fused_spmd_step(
                model, mesh, self.dt, self.hs[name], self.order,
                self._kernel_bcs[name]) for name in self.tasks}

            def _fused_body(name, u, axes):
                return steps[name](u, self._mstacks[name], axes)

            self._fused_multi = _fused_body
            self._faces = ShardedFaces(model, mesh, self.mats)
            self._faces.prepare(self._contact_faces(
                stencil_radius(self.order) + 1))
            return
        self._sweep_kernel = self.kernel in ("fused", "sweep")
        self._sweep_mats = {k: extend_mats_once(m, mesh, dim, self.order)
                            for k, m in self.mats.items()}
        stages = {name: make_spmd_raw_stage(
            model, mesh, self.dt, self.hs[name], self.order,
            use_kernel=self._sweep_kernel) for name in self.tasks}

        def _raw(name, u, axis):
            return stages[name](u, self._sweep_mats[name], axis)

        self._raw_stage = _raw
        self._faces = ShardedFaces(model, mesh, self._sweep_mats)
        self._faces.prepare(self._contact_faces(1))

    def _contact_faces(self, depth: int) -> List[Tuple[str, int, int, int]]:
        """``(body, axis, side, depth)`` of every contact's two faces."""
        return [(name, c.axis, side, depth) for c in self.contacts
                for name, side in ((c.body_a, 1), (c.body_b, 0))]

    def _shard(self, f: torch.Tensor, lead: int = 1):
        """``f`` (global, task layout) as the engine holds it: per-shard
        blocks on a mesh, else as it is."""
        return f if self.mesh is None else shard_field(f, self.mesh, lead)

    def _host(self, f, lead: int = 1) -> np.ndarray:
        """A field as the engine holds it, whole on the host."""
        if self.mesh is not None:
            f = gather_state(f, self.mesh, lead=lead, device="cpu")
        return f.cpu().numpy()

    def _blocks(self, f) -> list:
        """A field's blocks: the shard list on a mesh, else ``[f]``."""
        return list(f) if self.mesh is not None else [f]

    def _unblocks(self, blocks):
        return blocks if self.mesh is not None else blocks[0]

    # ------------------------------------------------------------------ step

    def _one_step(self, us, bonded, auxs, n: int):
        axes = axes_order(self.model.dim, n, self.symmetrize, self._fwd)
        if self._fused_multi is not None:
            us, bonded = step_multi_fused(
                self.model, us, self.mats, self.dt, self.hs, self.order,
                self.borders, self.contacts, bonded, self._fused_multi, axes,
                self._faces)
        elif self._raw_stage is not None:
            us, bonded = step_multi_fast(
                self.model, us, self._sweep_mats, self.borders,
                self.contacts, bonded, self._raw_stage, axes, self.ncmaps,
                self._faces)
        else:
            us, bonded = step_multi(
                self.model, us, self.mats, self.dt, self.hs, self.order,
                self.borders, self.contacts, bonded, axes, self.ncmaps)
        us = dict(us)
        with span("gcm.step.sources"):
            for name, src in self._srcs.items():
                # a fresh tensor of this step: index_add_ in place
                # accumulates repeated nodes like sequential adds
                blocks = self._blocks(us[name])
                for k, (flat, amps) in src.items():
                    blocks[k] = blocks[k].contiguous()
                    blocks[k].view(-1).index_add_(0, flat, amps[n])
                us[name] = self._unblocks(blocks)
        new_auxs = {}
        for name, task in self.tasks.items():
            if not task.correctors:
                new_auxs[name] = auxs[name]
                continue
            blocks = self._blocks(us[name])
            aux = {k: self._blocks(v) for k, v in auxs[name].items()}
            for s in (self.mesh.local if self.mesh is not None else (0,)):
                a = {k: v[s] for k, v in aux.items()}
                for corr in task.correctors:
                    blocks[s], a = corr(self.model, blocks[s], a, self.dt)
                for k, v in a.items():
                    aux[k][s] = v
            us[name] = self._unblocks(blocks)
            new_auxs[name] = {k: self._unblocks(v) for k, v in aux.items()}
        return us, bonded, new_auxs

    # ----------------------------------------------------------- checkpoint

    def state_dict(self) -> Dict:
        """The restartable state on the host: per-body fields ``us``, the
        fracture bond masks ``bonded`` (string keys; a non-conforming
        contact's per-side dict), per-body corrector ``aux``, the completed
        ``step`` and, with detectors, per-body ``traces``. Bond masks
        matter: a resume without them would heal every crack. One
        device-to-host copy of the state (``host_copies``). On a mesh that
        spans processes every rank takes part and gets the whole state."""
        self.host_copies.append(self._done_step)
        with span("gcm.run.gather"):
            d = {"us": {k: self._host(v) for k, v in self.us.items()},
                 "bonded": {str(k): _to_host(v)
                            for k, v in self.bonded.items()},
                 "aux": {k: {ak: self._host(av, lead=0)
                             for ak, av in a.items()}
                         for k, a in self.auxs.items()},
                 "step": self._done_step}
            if self._traces:
                d["traces"] = self._assemble_traces()
        return d

    def load_state(self, state: Dict) -> None:
        """Restore a ``state_dict`` (this engine's or the JAX engine's, as
        numpy arrays); ``run()`` then runs the steps ``step .. nsteps``,
        from an odd step as well. On a mesh that spans processes every rank
        gives the whole state and keeps its own shards' blocks."""
        dev, dt = self.device, self.dtype
        self.us = {k: self._shard(as_tensor(v, dev, dt))
                   for k, v in state["us"].items()}
        self.bonded = {
            int(k): ({s: as_tensor(m, dev, dt) for s, m in v.items()}
                     if isinstance(v, dict) else as_tensor(v, dev, dt))
            for k, v in state["bonded"].items()}
        if "aux" in state:
            self.auxs = {k: {ak: self._shard(as_tensor(av, dev), lead=0)
                             for ak, av in a.items()}
                         for k, a in state["aux"].items()}
        self.start_step = self._done_step = int(np.asarray(state["step"]))
        restored = dict(state.get("traces") or {})
        for name, record in self._traces.items():
            record.restore(restored.get(name))

    def _sync(self) -> None:
        devs = (self.mesh.unique_devices() if self.mesh is not None
                else [self.device])
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _assemble_traces(self) -> Optional[Dict[str, np.ndarray]]:
        """Per body with detectors, every completed step's receivers; None
        without detectors."""
        return ({name: r.assemble(self._gather)
                 for name, r in self._traces.items()}
                if self._traces else None)

    # ------------------------------------------------------------------- run

    def run(self, snapshot_cb=None, snapshot_every: int = 0
            ) -> MultiRunResult:
        """Run the steps ``start_step .. nsteps``; optionally call
        ``snapshot_cb(step, {name: u})`` after every step that is a
        multiple of ``snapshot_every`` rounded up to the symmetrization
        period (2 when symmetrized), also after a resume off that grid.
        The states are the bodies' tensors on the device, not copies."""
        period = 2 if self.symmetrize else 1
        nsteps, start = self.nsteps, int(self.start_step)
        every = 0
        if snapshot_cb is not None and snapshot_every:
            every = max(period, -(-snapshot_every // period) * period)
        C, rows = self.model.ncomp, max(nsteps - start, 0)
        for name, record in self._traces.items():
            record.start([(torch.empty((rows, len(flat), C),
                                       device=flat.device, dtype=self.dtype),
                           pos) for flat, pos in self._det[name].values()],
                         resumed=start > 0)
        self.us, self.bonded = dict(self.us), dict(self.bonded)
        self.auxs = dict(self.auxs)
        self._sync()
        t0 = _time.perf_counter()
        for n in range(start, nsteps):
            with span("gcm.step", step=n):
                self.us, self.bonded, self.auxs = self._one_step(
                    self.us, self.bonded, self.auxs, n)
                if self._det:
                    with span("gcm.step.receivers"):
                        for name, det in self._det.items():
                            blocks = self._blocks(self.us[name])
                            self._traces[name].put(n - start, *(
                                blocks[k].reshape(C, -1)[:, flat].T
                                for k, (flat, _) in det.items()))
                self._done_step = n + 1
                if every and (n + 1) % every == 0:
                    with span("gcm.callback"):
                        snapshot_cb(n + 1, self.us)
        self._sync()
        wall = _time.perf_counter() - t0
        npts = sum(int(np.prod(t.grid.shape)) for t in self.tasks.values())
        with span("gcm.run.gather"):
            bodies = {k: self._host(v) for k, v in self.us.items()}
            bonded = {k: _to_host(v) for k, v in self.bonded.items()}
            traces = self._assemble_traces()
        return MultiRunResult(
            bodies=bodies, bonded=bonded,
            t=nsteps * self.dt, nsteps=nsteps, dt=self.dt,
            wall_seconds=wall,
            points_per_second=npts * (nsteps - start) / max(wall, 1e-12),
            traces=traces, path=self.path)

    # ------------------------------------------------------------- outputs

    def write_snapshots(self, outdir: str, tag: str = "final") -> None:
        """Per body a ``<name>_<tag>.vti`` of the engine's current fields,
        and each bond mask as ``contact<i>_bonded[_<side>]_<tag>.npy``
        (``write_body_snapshots`` on a copy of the state). On a mesh that
        spans processes every rank calls it, and the first writes."""
        us = {k: self._host(v) for k, v in self.us.items()}
        if multihost.writes_files(self.mesh):
            write_body_snapshots(outdir, tag, self.tasks, self.model, us,
                                 {k: _to_host(v)
                                  for k, v in self.bonded.items()})
        multihost.files_written(self.mesh)

    def run_with_outputs(self, outdir: str, snapshot_every: int = 0,
                         checkpoint_every: int = 0) -> MultiRunResult:
        """``run()`` with its artifacts under ``outdir``: every
        ``snapshot_every`` steps a ``<name>_<step>.vti`` per body in
        ``<outdir>/snapshots``, then a ``<name>.pvd`` per body; checkpoints
        every ``checkpoint_every`` steps in ``<outdir>/checkpoints``; each
        body's seismograms at the end. Each cadence is rounded up to the
        symmetrization period; the state is copied to the host once at
        each step where either fires, and at no other. On a mesh that spans
        processes every rank runs it with the same arguments, as
        ``Engine.run_with_outputs``: the first rank writes every file."""
        writer = multihost.writes_files(self.mesh)
        os.makedirs(outdir, exist_ok=True)
        snapdir = os.path.join(outdir, "snapshots")
        series = {name: [] for name in self.tasks}

        def snapshot(step: int, state: Dict) -> None:
            files = write_body_snapshots(snapdir, f"{step:06d}", self.tasks,
                                         self.model, state["us"])
            for name, fname in files.items():
                series[name].append((step * self.dt, fname))

        cb, every = output_callback(
            outdir, 2 if self.symmetrize else 1, snapshot_every,
            checkpoint_every, self.state_dict, snapshot, self.mesh)
        res = self.run(snapshot_cb=cb, snapshot_every=every)
        for name, entries in series.items():
            if writer and entries:
                write_pvd(os.path.join(snapdir, f"{name}.pvd"), entries)
        for name, tr in (res.traces or {}).items() if writer else ():
            task = self.tasks[name]
            save_seismograms(outdir, task.name, tr, res.dt,
                             task.detectors.points, self.model.comp_names)
        multihost.files_written(self.mesh)
        return res


def _to_host(mask):
    """A bond mask (a tensor, or a non-conforming contact's per-side dict
    of them) as numpy."""
    if isinstance(mask, dict):
        return {s: v.cpu().numpy() for s, v in mask.items()}
    return mask.cpu().numpy()


def write_body_snapshots(outdir: str, tag: str, tasks: Dict[str, Task],
                         model, us: Dict[str, np.ndarray],
                         bonded: Optional[Dict] = None) -> Dict[str, str]:
    """Per body a ``<name>_<tag>.vti`` of its host fields ``us[name]`` in
    ``outdir`` and, given ``bonded`` (host masks, as ``MultiRunResult``
    holds them), each bond mask as ``contact<i>_bonded[_<side>]_<tag>.npy``.
    Returns each body's ``.vti`` file name."""
    os.makedirs(outdir, exist_ok=True)
    files = {}
    for name, task in tasks.items():
        files[name] = f"{name}_{tag}.vti"
        write_vti(os.path.join(outdir, files[name]), task.grid.shape,
                  task.grid.h, task.grid.origin,
                  snapshot_fields(model, us[name]))
    for ci, mask in (bonded or {}).items():
        if isinstance(mask, dict):   # non-conforming: per-side masks
            for side, m in mask.items():
                np.save(os.path.join(
                    outdir, f"contact{ci}_bonded_{side}_{tag}.npy"), m)
        else:
            np.save(os.path.join(outdir, f"contact{ci}_bonded_{tag}.npy"),
                    mask)
    return files
