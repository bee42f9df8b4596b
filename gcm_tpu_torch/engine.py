"""Engine: builds a Task into device state and runs the time loop.

Counterpart of ``gcm_tpu/engine.py`` (single body, one device): owns the
state and the corrector aux fields, computes the static CFL dt once,
sequences the symmetrized splitting steps, injects sources, runs the ODE
correctors and records detector traces on the device. The JAX engine's
``lax.scan`` becomes a plain Python loop with the same parity rule
(reversed axes on odd step indices).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, Optional

import numpy as np
import torch

from gcm_tpu_torch.models.spec import Model, get_model
from gcm_tpu_torch.ops.fused import (
    fold_corrector_specs, fused_step, fused_step_2d, stack_mats,
)
from gcm_tpu_torch.ops.sweep import sweep_step
from gcm_tpu_torch.solver.gcm import axes_order, cfl_dt, step as solver_step
from gcm_tpu_torch.task import Task, apply_initial


def resolve_kernel(kernel: str, dim: int, device) -> str:
    """Resolve Task.kernel="auto": the fused CUDA kernel for 2D and 3D tasks
    on a CUDA device, the plain torch step elsewhere."""
    if kernel != "auto":
        return kernel
    if torch.device(device).type == "cuda" and dim in (2, 3):
        return "fused"
    return "torch"


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
    """Single-body engine on one device."""

    def __init__(self, task: Task, device="cpu", dtype=torch.float32):
        self.task = task
        self.model: Model = get_model(task.model)
        if self.model.dim != task.grid.dim:
            raise ValueError("model dim != grid dim")
        self.device = torch.device(device)
        self.dtype = dtype
        #: resolved compute path ("auto" -> device-dependent)
        self.kernel = resolve_kernel(task.kernel, self.model.dim, self.device)
        if self.kernel in ("fused", "sweep") and (
                self.model.dim not in (2, 3) or dtype != torch.float32):
            raise ValueError(f"kernel={self.kernel!r} runs 2D and 3D tasks "
                             "in float32")

        self.mat = task.material_fields(device=self.device, dtype=dtype)
        self.dt = cfl_dt(self.mat, task.grid.h, task.time.cfl)
        self.nsteps = task.time.steps_for(self.dt)
        #: compact material stack of the fused kernel, built once
        self._mstack = (stack_mats(self.model, self.mat)
                        if self.kernel == "fused" else None)
        self._fused_fn = fused_step if self.model.dim == 3 else fused_step_2d

        # corrector aux state (the "damage" field), and the folding rule of
        # the JAX engine: sources land after the step and before the
        # correctors, so the kernel's epilogue takes them only source-free;
        # one shared "damage" field means at most one damage corrector
        self.aux: Dict[str, torch.Tensor] = {}
        for corr in task.correctors:
            self.aux.update(corr.init_aux(self.model, task.grid.shape,
                                          device=self.device))
        self._fold_specs = None
        self._fold_naux = 0
        if self._mstack is not None and task.correctors and not task.sources:
            specs, naux = fold_corrector_specs(task.correctors, self.dt)
            if specs is not None and naux <= 1:
                self._fold_specs = specs
                self._fold_naux = naux

        u0 = np.zeros((self.model.ncomp,) + task.grid.shape, dtype=np.float64)
        apply_initial(u0, self.model, task.grid, task.initial)
        self.u = torch.as_tensor(u0, device=self.device).to(dtype)

        # sources: flat indices into u, and every step's amplitude evaluated
        # in float64 at once, cast once to the engine dtype
        shape = (self.model.ncomp,) + task.grid.shape
        src_flat, amps = [], []
        times = (np.arange(self.nsteps, dtype=np.float64) + 1.0) * self.dt
        for src in task.sources:
            node = task.grid.index_of(src.position)
            for cname in src.components:
                src_flat.append(np.ravel_multi_index(
                    (self.model.comp(cname),) + node, shape))
                amps.append(np.broadcast_to(
                    np.asarray(src.wavelet(times), np.float64),
                    times.shape) * self.dt)
        self._src_flat = torch.as_tensor(np.asarray(src_flat, np.int64),
                                         device=self.device)
        amps = (np.asarray(amps, np.float64).T if amps
                else np.zeros((self.nsteps, 0)))
        self._src_amps = torch.as_tensor(amps, device=self.device).to(dtype)

        # detectors: flat spatial indices of the receiver nodes
        self._det_flat = None
        if task.detectors is not None:
            nodes = [task.grid.index_of(p) for p in task.detectors.points]
            self._det_flat = torch.as_tensor(
                np.ravel_multi_index(tuple(np.asarray(nodes).T),
                                     task.grid.shape).astype(np.int64),
                device=self.device)

    # ------------------------------------------------------------------ step

    def _one_step(self, u: torch.Tensor, aux: Dict[str, torch.Tensor],
                  n: int):
        task, model = self.task, self.model
        args = (self.dt, task.grid.h, task.order, task.borders,
                axes_order(model.dim, n, task.symmetrize_stages))
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
            u = sweep_step(model, u, self.mat, *args)
        else:
            u = solver_step(model, u, self.mat, *args)
        if len(self._src_flat):
            # every source lands after the sweep, as in the JAX engine;
            # index_add_ accumulates repeated nodes like sequential adds
            u.view(-1).index_add_(0, self._src_flat, self._src_amps[n])
        for corr in task.correctors:
            u, aux = corr(model, u, aux, self.dt)
        return u, aux

    def _detect(self, u: torch.Tensor) -> torch.Tensor:
        """Receiver values ``[npoints, ncomp]`` in one gather."""
        return u.reshape(self.model.ncomp, -1)[:, self._det_flat].T

    # ------------------------------------------------------------------ run

    def run(self) -> RunResult:
        """Run ``nsteps`` steps from the current state."""
        nsteps = self.nsteps
        traces = None
        if self._det_flat is not None:
            traces = torch.empty((nsteps, len(self._det_flat),
                                  self.model.ncomp),
                                 device=self.device, dtype=self.dtype)
        u, aux = self.u, self.aux
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = _time.perf_counter()
        for n in range(nsteps):
            u, aux = self._one_step(u, aux, n)
            if traces is not None:
                traces[n] = self._detect(u)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = _time.perf_counter() - t0
        self.u, self.aux = u, aux

        npts = int(np.prod(self.task.grid.shape))
        return RunResult(
            u=u.cpu().numpy(),
            t=nsteps * self.dt,
            nsteps=nsteps,
            dt=self.dt,
            traces=traces.cpu().numpy() if traces is not None else None,
            wall_seconds=wall,
            points_per_second=npts * nsteps / max(wall, 1e-12),
            kernel=self.kernel,
        )
