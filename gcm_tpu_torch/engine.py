"""Engine: builds a Task into device state and runs the time loop.

Counterpart of ``gcm_tpu/engine.py`` (single body): owns the state and the
corrector aux fields, computes the static CFL dt once, sequences the
symmetrized splitting steps, injects sources, runs the ODE correctors and
records detector traces on the device. The JAX engine's ``lax.scan``
becomes a plain Python loop with the same parity rule (reversed axes on odd
step indices).

With ``mesh=`` (a ``parallel.sharding.DomainMesh``) the state, the aux
fields, the sources and the detectors are held per shard, and a step runs
across the shards as in the JAX engine's mesh path: the fused kernels'
interior/ring split with overlapped slab exchange
(``parallel.fused_spmd``) for ``kernel="fused"``, the per-sweep halo step
(``parallel.halo``) for ``"sweep"`` (with the CUDA sweep kernel) and
``"torch"`` (the plain sweep). A mesh may span the processes of a run
(``parallel.multihost``): each rank then steps its own shards, and
``run()``, ``state_dict()`` and ``run_with_outputs()`` give every rank the
whole state and every receiver's trace, equal to the same run in one
process; the first rank writes the files.

Isotropic media run on the compact material stack, orthotropic media
(``OrthotropicMaterial`` regions, ``OrthotropicMaterialFields``) on the
orthotropic one (``ops.fused.stack_mats``); the per-sweep path computes each
axis's material view once (``materials.AxisViewCache``).

The Task knobs of the fused path: ``mat_dtype="bf16"`` stores the material
stack in bf16 (the kernels upcast at the load); ``canonical_layout`` takes
the JAX package's canonical splitting order (``solver.gcm.canonical_axes``,
isotropic media only, as in JAX) and runs a 3D body on ``fused_step_slab``,
as JAX runs its permuted bodies;
``temporal_block`` runs each symmetrized pair of steps as one two-step pass
of the fused kernel when nothing happens between the two (``_pair_fused``).

``state_dict``/``load_state`` checkpoint and resume a run (``start_step``),
and ``run_with_outputs`` writes its snapshots, checkpoints and seismograms,
copying the state off the device only at the steps where one of them fires.
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gcm_tpu_torch.materials import AxisViewCache, MaterialFields
from gcm_tpu_torch.models.spec import Model, get_model
from gcm_tpu_torch.ops.fused import (
    fold_corrector_specs, fused_step, fused_step_2d, fused_step_slab,
    stack_mats,
)
from gcm_tpu_torch.ops.sweep import sweep_step
from gcm_tpu_torch.parallel.fused_spmd import (
    extended_mstack, extended_mstack_2d, make_fused_spmd_step,
    make_fused_spmd_step_2d,
)
from gcm_tpu_torch.parallel import multihost
from gcm_tpu_torch.parallel.halo import extend_mats_once, make_spmd_step
from gcm_tpu_torch.parallel.sharding import (
    DomainMesh, block_shape, gather_state, place, shard_field, shard_mats,
    shard_state,
)
from gcm_tpu_torch.solver.gcm import (
    axes_order, canonical_axes, cfl_dt, step as solver_step,
)
from gcm_tpu_torch.snapshot import (
    save_seismograms, snapshot_fields, write_pvd, write_vti,
)
from gcm_tpu_torch.task import Task, apply_initial
from gcm_tpu_torch.utils.checkpoint import TraceRecord, output_callback
from gcm_tpu_torch.utils.profiling import span


def check_device(device) -> torch.device:
    """``device`` as a torch device; raises if it is a CUDA device and torch
    sees none (the entry points run on the card unless asked for the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    return device


def resolve_kernel(kernel: str, dim: int, device) -> str:
    """Resolve Task.kernel="auto": the fused CUDA kernel for 2D and 3D tasks
    on a CUDA device, the plain torch step elsewhere."""
    if kernel != "auto":
        return kernel
    if torch.device(device).type == "cuda" and dim in (2, 3):
        return "fused"
    return "torch"


def _disagree(device: torch.device, mesh_device: torch.device) -> bool:
    return device.type != mesh_device.type or (
        device.index is not None and device.index != (mesh_device.index or 0))


def mesh_device(mesh, device=None) -> torch.device:
    """The device of this process's first shard of ``mesh`` (a
    ``DomainMesh``), which holds what an engine keeps whole; raises if a
    device of this process's shards is a CUDA device torch does not see, or
    if ``device`` disagrees with one."""
    if not isinstance(mesh, DomainMesh):
        raise TypeError(f"mesh must be a parallel.sharding.DomainMesh, not "
                        f"{type(mesh).__name__}")
    if not mesh.local:
        raise ValueError(f"rank {multihost.rank()} holds no shard of the "
                         f"mesh (ranks {mesh.ranks})")
    devs = mesh.unique_devices()
    for d in devs:
        check_device(d)
    if device is not None and any(
            _disagree(torch.device(device), d) for d in devs):
        raise ValueError(f"device {device} disagrees with the mesh's "
                         f"devices {tuple(devs)}")
    return devs[0]


def shard_sources(mesh, block, ncomp: int, nodes, amps: np.ndarray,
                  dtype: torch.dtype) -> Dict[int, tuple]:
    """Per shard ``k`` of this process holding a source, ``(flat,
    amps_k)``: the flat indices into its state ``[ncomp, *block]`` of the
    source entries ``nodes`` (``(comp, *node)`` each, global nodes) that lie
    on it, and their columns of ``amps`` (``[nsteps, len(nodes)]``), on its
    device."""
    cshape = (ncomp,) + tuple(block)
    by_shard: Dict[int, list] = {}
    for col, (comp, *node) in enumerate(nodes):
        k, local = place(mesh, block, node)
        if mesh.is_local(k):
            by_shard.setdefault(k, []).append(
                (np.ravel_multi_index((comp,) + local, cshape), col))
    out = {}
    for k, items in by_shard.items():
        dev = mesh.devices[k]
        flat, cols = zip(*items)
        out[k] = (torch.as_tensor(np.asarray(flat, np.int64), device=dev),
                  torch.as_tensor(amps[:, list(cols)], device=dev).to(dtype))
    return out


def shard_detectors(mesh, block, nodes) -> Dict[int, tuple]:
    """Per shard ``k`` of this process holding a receiver, ``(flat,
    positions)``: the flat spatial indices into its block of the receivers
    among the global ``nodes`` that lie on it (on its device), and their
    positions in ``nodes``."""
    det: Dict[int, tuple] = {}
    for pos, node in enumerate(nodes or ()):
        k, local = place(mesh, block, node)
        if not mesh.is_local(k):
            continue
        det.setdefault(k, ([], []))
        det[k][0].append(np.ravel_multi_index(local, tuple(block)))
        det[k][1].append(pos)
    return {k: (torch.as_tensor(np.asarray(f, np.int64),
                                device=mesh.devices[k]), np.asarray(p))
            for k, (f, p) in det.items()}


@dataclasses.dataclass
class RunResult:
    u: np.ndarray                       # final state [ncomp, *spatial]
    t: float                            # final time
    nsteps: int
    dt: float
    traces: Optional[np.ndarray]        # [nsteps, npoints, ncomp] or None
    wall_seconds: float
    points_per_second: float
    kernel: str                         # resolved compute path


class Engine:
    """Single-body engine on one device, or on the shards of a mesh.

    ``device`` defaults to the card (``"cuda"``); without a mesh,
    ``device="cpu"`` runs the plain versions on the CPU. With ``mesh=`` the
    shards' devices come from the mesh (a device may hold several shards),
    ``device`` may be left out and must agree with them if given;
    ``Engine.u`` and each ``Engine.aux`` entry are then lists of per-shard
    blocks in mesh order (None for a shard another rank holds), and
    ``run()`` returns the gathered global state (to every rank).
    """

    def __init__(self, task: Task, device=None, dtype=torch.float32,
                 mesh=None):
        with span("gcm.setup"):
            self._build(task, device, dtype, mesh)

    def _build(self, task: Task, device, dtype: torch.dtype, mesh) -> None:
        self.task = task
        self.model: Model = get_model(task.model)
        if self.model.dim != task.grid.dim:
            raise ValueError("model dim != grid dim")
        self.mesh = mesh
        if mesh is not None:
            device = mesh_device(mesh, device)
        self.device = check_device("cuda" if device is None else device)
        self.dtype = dtype
        #: resolved compute path ("auto" -> device-dependent)
        self.kernel = resolve_kernel(task.kernel, self.model.dim, self.device)
        if self.kernel in ("fused", "sweep") and (
                self.model.dim not in (2, 3) or dtype != torch.float32):
            raise ValueError(f"kernel={self.kernel!r} runs 2D and 3D tasks "
                             "in float32")

        with span("gcm.setup.materials"):
            self.mat = task.material_fields(device=self.device, dtype=dtype)
        self.dt = cfl_dt(self.mat, task.grid.h, task.time.cfl)
        self.nsteps = task.time.steps_for(self.dt)
        #: the splitting order of even steps (reversed on odd ones): the
        #: canonical order where the task asks for it and it engages (one
        #: device and isotropic media, as in JAX, whose orthotropic stack
        #: would read a permuted sweep axis as a physical one), else
        #: (0, .., dim-1)
        canon = (canonical_axes(task.grid.shape)
                 if task.canonical_layout and mesh is None
                 and isinstance(self.mat, MaterialFields) else None)
        self._fwd = canon or tuple(range(self.model.dim))
        #: the stored type of the fused kernels' material stacks
        self._mat_dtype = (torch.bfloat16 if task.mat_dtype == "bf16"
                           else None)
        #: material stack of the fused kernel (compact or orthotropic),
        #: built once
        with span("gcm.setup.stack"):
            self._mstack = (stack_mats(self.model, self.mat,
                                       dtype=self._mat_dtype)
                            if self.kernel == "fused" and mesh is None
                            else None)
        #: the per-sweep path's materials: each axis's view computed once
        self._sweep_mat = AxisViewCache(self.mat)
        if self.model.dim == 2:
            self._fused_fn = fused_step_2d
        else:
            # canonical bodies run the slab kernel, as the JAX engine runs
            # its permuted ones; fused_step hands bf16 stacks to it too
            self._fused_fn = fused_step_slab if canon else fused_step
        #: a symmetrized pair of steps as one two-step pass (JAX
        #: ``Engine._build_scan``): only with nothing between the two steps
        self._pair_fused = (self._mstack is not None
                            and task.temporal_block
                            and task.symmetrize_stages and not task.sources
                            and not task.correctors
                            and task.detectors is None)

        # the folding rule of the JAX engine: sources land after the step
        # and before the correctors, so the kernel's epilogue takes them only
        # source-free; one shared "damage" field means at most one damage
        # corrector (the sharded 2D step folds none, as in JAX)
        self._fold_specs = None
        self._fold_naux = 0
        foldable = (self.kernel == "fused" and task.correctors
                    and not task.sources
                    and (mesh is None or self.model.dim == 3))
        if foldable:
            specs, naux = fold_corrector_specs(task.correctors, self.dt)
            if specs is not None and naux <= 1:
                self._fold_specs = specs
                self._fold_naux = naux

        with span("gcm.setup.state"):
            u0 = np.zeros((self.model.ncomp,) + task.grid.shape,
                          dtype=np.float64)
            apply_initial(u0, self.model, task.grid, task.initial)
            self.u = torch.as_tensor(u0, device=self.device).to(dtype)

        # sources: flat indices into u, and every step's amplitude evaluated
        # in float64 at once, cast once to the engine dtype
        with span("gcm.setup.sources"):
            src_nodes, amps = [], []
            times = (np.arange(self.nsteps, dtype=np.float64) + 1.0) * self.dt
            for src in task.sources:
                node = task.grid.index_of(src.position)
                for cname in src.components:
                    src_nodes.append((self.model.comp(cname),) + node)
                    amps.append(np.broadcast_to(
                        np.asarray(src.wavelet(times), np.float64),
                        times.shape) * self.dt)
            amps = (np.asarray(amps, np.float64).T if amps
                    else np.zeros((self.nsteps, 0)))
            det_nodes = ([task.grid.index_of(p)
                          for p in task.detectors.points]
                         if task.detectors is not None else None)
        #: the first step run() executes (set by load_state on a resume),
        #: and the steps completed so far
        self.start_step = 0
        self._done_step = 0
        #: the detector record across a resume (None without detectors)
        self._trace = (TraceRecord(len(det_nodes), self.model.ncomp)
                       if det_nodes is not None else None)
        #: the completed step at each device-to-host copy of the state made
        #: by state_dict
        self.host_copies: List[int] = []
        #: how the receivers of every rank come together (None: all here)
        self._gather = (multihost.all_gather_object
                        if multihost.spans(mesh) else None)
        if mesh is not None:
            self._setup_mesh(src_nodes, amps, det_nodes)
            return
        with span("gcm.setup.sources"):
            shape = (self.model.ncomp,) + task.grid.shape
            self._src_flat = torch.as_tensor(
                np.asarray([np.ravel_multi_index(n, shape)
                            for n in src_nodes], np.int64),
                device=self.device)
            self._src_amps = torch.as_tensor(amps,
                                             device=self.device).to(dtype)

            # detectors: flat spatial indices of the receiver nodes
            self._det_flat = None
            if det_nodes is not None:
                self._det_flat = torch.as_tensor(
                    np.ravel_multi_index(tuple(np.asarray(det_nodes).T),
                                         task.grid.shape).astype(np.int64),
                    device=self.device)

        # corrector aux state (the "damage" field)
        self.aux: Dict[str, torch.Tensor] = {}
        for corr in task.correctors:
            self.aux.update(corr.init_aux(self.model, task.grid.shape,
                                          device=self.device))

    # ------------------------------------------------------------- the mesh

    def _setup_mesh(self, src_nodes, amps, det_nodes) -> None:
        """Per-shard state, aux, materials, step, sources and detectors."""
        task, model, mesh = self.task, self.model, self.mesh
        bshape = block_shape(mesh, task.grid.shape)
        self._block = bshape
        with span("gcm.setup.shard"):
            self.u = shard_state(self.u, mesh)
            self.aux = {}
            for corr in task.correctors:
                for name, f in corr.init_aux(model, task.grid.shape,
                                             device=self.device).items():
                    self.aux[name] = shard_field(f, mesh, lead=0)
        args = (model, mesh, self.dt, task.grid.h, task.order, task.borders)
        with span("gcm.setup.stack"):
            if self.kernel == "fused" and model.dim == 3:
                self._carry = extended_mstack(model, self.mat, mesh,
                                              task.order)
                self._spmd_step = make_fused_spmd_step(
                    *args, correctors=self._fold_specs)
            elif self.kernel == "fused":
                self._carry = extended_mstack_2d(model, self.mat, mesh,
                                                 task.order, self._mat_dtype)
                self._spmd_step = make_fused_spmd_step_2d(*args)
            else:
                self._carry = extend_mats_once(shard_mats(self.mat, mesh),
                                               mesh, model.dim, task.order)
                self._spmd_step = make_spmd_step(
                    *args, use_kernel=self.kernel == "sweep")

        # each source node and detector belongs to exactly one shard: its
        # local flat index there, mapped once
        with span("gcm.setup.sources"):
            self._src = shard_sources(mesh, bshape, model.ncomp, src_nodes,
                                      amps, self.dtype)
            self._det = shard_detectors(mesh, bshape, det_nodes)

    def _one_step_mesh(self, us, aux, n: int):
        task, model = self.task, self.model
        axes = axes_order(model.dim, n, task.symmetrize_stages)
        if self._fold_specs is not None:
            # correctors applied in both kernels' epilogue; nothing follows
            if not self._fold_naux:
                return self._spmd_step(us, self._carry, axes), aux
            us, d = self._spmd_step(
                us, self._carry, axes,
                aux=[None if a is None else a.unsqueeze(0)
                     for a in aux["damage"]])
            return us, {**aux, "damage": [None if a is None else a[0]
                                          for a in d]}
        us = self._spmd_step(us, self._carry, axes)
        with span("gcm.step.sources"):
            for k, (flat, amps) in self._src.items():
                us[k].view(-1).index_add_(0, flat, amps[n])
        if task.correctors:
            for k in self.mesh.local:
                a = {name: v[k] for name, v in aux.items()}
                for corr in task.correctors:
                    us[k], a = corr(model, us[k], a, self.dt)
                for name, v in a.items():
                    aux[name][k] = v
        return us, aux

    # ------------------------------------------------------------------ step

    def _one_step(self, u: torch.Tensor, aux: Dict[str, torch.Tensor],
                  n: int):
        task, model = self.task, self.model
        args = (self.dt, task.grid.h, task.order, task.borders,
                axes_order(model.dim, n, task.symmetrize_stages, self._fwd))
        if self._fold_specs is not None:
            # correctors applied in the kernel's epilogue; nothing follows
            if not self._fold_naux:
                return self._fused_fn(model, u, self._mstack, *args,
                                      correctors=self._fold_specs), aux
            u, astack = self._fused_fn(model, u, self._mstack, *args,
                                       correctors=self._fold_specs,
                                       aux=aux["damage"].unsqueeze(0))
            return u, {**aux, "damage": astack[0]}
        if self.kernel == "fused":
            u = self._fused_fn(model, u, self._mstack, *args)
        elif self.kernel == "sweep":
            u = sweep_step(model, u, self._sweep_mat, *args)
        else:
            u = solver_step(model, u, self.mat, *args)
        if len(self._src_flat):
            # every source lands after the sweep, as in the JAX engine;
            # index_add_ accumulates repeated nodes like sequential adds
            with span("gcm.step.sources"):
                u.view(-1).index_add_(0, self._src_flat, self._src_amps[n])
        for corr in task.correctors:
            u, aux = corr(model, u, aux, self.dt)
        return u, aux

    def _detect(self, u: torch.Tensor) -> torch.Tensor:
        """Receiver values ``[npoints, ncomp]`` in one gather."""
        return u.reshape(self.model.ncomp, -1)[:, self._det_flat].T

    # ----------------------------------------------------------- checkpoint

    def state_dict(self) -> Dict:
        """The restartable state on the host, in task layout: the fields
        ``u``, the corrector ``aux`` fields, the completed ``step`` and,
        with detectors, the ``traces`` recorded so far (gathered from the
        shards on a mesh). Called mid-run (from a ``run`` callback), it
        holds the state after the step the callback was given. One
        device-to-host copy of the state, recorded in ``host_copies``. On a
        mesh that spans processes every rank takes part and gets the whole
        state."""
        self.host_copies.append(self._done_step)
        with span("gcm.run.gather"):
            if self.mesh is not None:
                u = gather_state(self.u, self.mesh, device="cpu").numpy()
                aux = {k: gather_state(v, self.mesh, lead=0,
                                       device="cpu").numpy()
                       for k, v in self.aux.items()}
            else:
                u = self.u.cpu().numpy()
                aux = {k: v.cpu().numpy() for k, v in self.aux.items()}
            d = {"u": u, "aux": aux, "step": self._done_step}
            if self._trace is not None:
                d["traces"] = self._trace.assemble(self._gather)
        return d

    def load_state(self, state: Dict) -> None:
        """Restore a ``state_dict`` (this engine's, or the JAX engine's as
        numpy arrays, ``utils.checkpoint.restore_checkpoint``'s output);
        ``run()`` then runs the steps ``step .. nsteps`` and its traces
        start with the restored rows. On a mesh that spans processes every
        rank gives the whole state and keeps its own shards' blocks."""
        u = as_tensor(state["u"], self.device, self.dtype)
        aux = {k: as_tensor(v, self.device) for k, v in
               dict(state.get("aux", {})).items()}
        if self.mesh is not None:
            self.u = shard_state(u, self.mesh)
            self.aux = {k: shard_field(v, self.mesh, lead=0)
                        for k, v in aux.items()}
        else:
            self.u, self.aux = u, aux
        self.start_step = self._done_step = int(np.asarray(state["step"]))
        if self._trace is not None:
            self._trace.restore(state.get("traces"))

    # ------------------------------------------------------------------ run

    def _sync(self) -> None:
        devs = (self.mesh.unique_devices() if self.mesh is not None
                else [self.device])
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _advance(self, n: int, row: int) -> None:
        """Step ``n`` on the engine's state; its receivers into ``row``."""
        if self.mesh is not None:
            self.u, self.aux = self._one_step_mesh(self.u, self.aux, n)
            if self._trace is not None:
                C = self.model.ncomp
                with span("gcm.step.receivers"):
                    self._trace.put(row, *(
                        self.u[k].reshape(C, -1)[:, flat].T
                        for k, (flat, _) in self._det.items()))
            return
        self.u, self.aux = self._one_step(self.u, self.aux, n)
        if self._trace is not None:
            with span("gcm.step.receivers"):
                self._trace.put(row, self._detect(self.u))

    def run(self, snapshot_cb: Optional[Callable] = None,
            cb_every: Optional[int] = None) -> RunResult:
        """Run the remaining steps, ``start_step .. nsteps``.

        ``snapshot_cb(step, u)`` is called after every step that is a
        multiple of ``cb_every`` (default: the task's snapshot cadence),
        rounded up to the symmetrization period (2 when symmetrized), also
        after a resume off that grid. ``u`` is the state as it lies on the
        device (on a mesh, the list of per-shard blocks), not a copy: the
        callback copies what it writes (``state_dict``), so nothing leaves
        the card, and nothing waits for it, at the steps where it writes
        nothing. A resumed run at an odd step on the pair-fused path
        realigns with one single step before its two-step passes.
        """
        period = 2 if self.task.symmetrize_stages else 1
        every = self.task.snapshots.every if cb_every is None else cb_every
        every = -(-every // period) * period if snapshot_cb and every else 0
        nsteps, start = self.nsteps, int(self.start_step)
        if self._trace is not None:
            rows, C = max(nsteps - start, 0), self.model.ncomp
            self._trace.start(
                [(torch.empty((rows, len(pos), C), device=self.mesh.devices[k],
                              dtype=self.dtype), pos)
                 for k, (_, pos) in self._det.items()]
                if self.mesh is not None else
                [(torch.empty((rows, len(self._det_flat), C),
                              device=self.device, dtype=self.dtype),
                  slice(None))], resumed=start > 0)
        if self.mesh is not None:
            self.u = list(self.u)
            self.aux = {k: list(v) for k, v in self.aux.items()}
        pair = (self._fwd, self._fwd[::-1])
        self._sync()
        t0 = _time.perf_counter()
        n = start
        while n < nsteps:
            # a two-step pass is one span, numbered by its first step
            with span("gcm.step", step=n):
                if self._pair_fused and n % 2 == 0 and n + 2 <= nsteps:
                    self.u = self._fused_fn(self.model, self.u, self._mstack,
                                            self.dt, self.task.grid.h,
                                            self.task.order,
                                            self.task.borders, axes_seq=pair)
                    n += 2
                else:
                    self._advance(n, n - start)
                    n += 1
                self._done_step = n
                if every and n % every == 0:
                    with span("gcm.callback"):
                        snapshot_cb(n, self.u)
        self._sync()
        wall = _time.perf_counter() - t0

        npts = int(np.prod(self.task.grid.shape))
        with span("gcm.run.gather"):
            u = (gather_state(self.u, self.mesh, device="cpu")
                 if self.mesh is not None else self.u.cpu()).numpy()
            traces = (self._trace.assemble(self._gather)
                      if self._trace is not None else None)
        return RunResult(
            u=u,
            t=nsteps * self.dt,
            nsteps=nsteps,
            dt=self.dt,
            traces=traces,
            wall_seconds=wall,
            points_per_second=npts * (nsteps - start) / max(wall, 1e-12),
            kernel=self.kernel,
        )

    # ------------------------------------------------------------- outputs

    def run_with_outputs(self, outdir: str,
                         checkpoint_every: int = 0) -> RunResult:
        """``run()`` with its artifacts under ``outdir``: a ``.vti``
        snapshot at the task's snapshot cadence (``SnapshotSpec.fields``
        and the velocity vector) in ``<outdir>/<snapshots.directory>``, then
        a ``.pvd`` collection of them; checkpoints every
        ``checkpoint_every`` steps in ``<outdir>/checkpoints``; the
        seismograms at the end. Each cadence is rounded up to the
        symmetrization period; the state is copied to the host once at
        each step where either fires, and at no other
        (``utils.checkpoint.output_callback``). On a mesh that spans
        processes every rank runs it with the same arguments: each takes
        part in every copy, the first rank
        (:func:`parallel.multihost.writes_files`) writes every file, and no
        rank goes on past a file before it is written."""
        task = self.task
        writer = multihost.writes_files(self.mesh)
        os.makedirs(outdir, exist_ok=True)
        snapdir = os.path.join(outdir, task.snapshots.directory)
        series = []

        def snapshot(step: int, state: Dict) -> None:
            fields = snapshot_fields(self.model, state["u"])
            if task.snapshots.fields:
                keep = set(task.snapshots.fields) | {"velocity"}
                fields = {k: v for k, v in fields.items() if k in keep}
            fname = f"{task.name}_{step:06d}.vti"
            os.makedirs(snapdir, exist_ok=True)
            write_vti(os.path.join(snapdir, fname), task.grid.shape,
                      task.grid.h, task.grid.origin, fields)
            series.append((step * self.dt, fname))

        cb, every = output_callback(
            outdir, 2 if task.symmetrize_stages else 1, task.snapshots.every,
            checkpoint_every, self.state_dict, snapshot, self.mesh)
        res = self.run(snapshot_cb=cb, cb_every=every)
        if writer and series:
            write_pvd(os.path.join(snapdir, f"{task.name}.pvd"), series)
        if writer and res.traces is not None:
            save_seismograms(outdir, task.name, res.traces, self.dt,
                             task.detectors.points, self.model.comp_names)
        multihost.files_written(self.mesh)
        return res


def as_tensor(a, device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """A copy of ``a`` (a tensor, or an array such as a restored
    checkpoint's or a JAX engine's ``np.asarray``) on ``device``, in
    ``dtype`` or its own."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype, copy=True)
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)
