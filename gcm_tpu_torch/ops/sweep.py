"""The per-sweep kernel: one characteristic sweep per launch.

Counterpart of ``gcm_tpu/ops/pallas_stage.py`` (``pallas_stage``,
``pallas_step``). The kernel is CUDA C++ for Hopper, ``csrc/sweep_stage.cu``,
sharing its stencil weights and border algebra with the fused kernels. Its
plain PyTorch version is the port's ``solver.gcm.stage``.

``sweep_stage`` launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor; for a CUDA tensor it launches or raises, it never
falls back. The kernel is compiled for the component maps of
``ops.fused.STREAM_MODELS`` (the streamed bodies' four); the binding holds
the runtime model to the compiled map (``check_compiled_map``) and refuses
any other model.
``sweep_stage.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from gcm_tpu_torch.materials import MaterialFields
from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.fused import (
    _BC_CODES, _MAXC, _MAXP, _MAXZ, STREAM_MODELS, check_compiled_map)
from gcm_tpu_torch.solver.gcm import stage
from gcm_tpu_torch.task import BorderSpec

Borders = Dict[Tuple[int, int], BorderSpec]


class _SweepParams(ctypes.Structure):
    """Mirror of ``GcmSweepParams`` in csrc/sweep_stage.cu."""

    _fields_ = [
        ("pair_c", ctypes.c_void_p * _MAXP),
        ("pair_z", ctypes.c_void_p * _MAXP),
        ("zero_kappa", ctypes.c_void_p * _MAXZ),
        ("n", ctypes.c_int * 3), ("axis", ctypes.c_int),
        ("model", ctypes.c_int), ("bc_kind", ctypes.c_int * 2),
        ("bc_val", ctypes.c_float * _MAXP * 2), ("dtoh", ctypes.c_float),
    ]


def _sweep_params(model: Model, u: torch.Tensor, mat: MaterialFields,
                  dt: float, h: Sequence[float], axis: int,
                  borders: Optional[Borders]
                  ) -> Tuple[_SweepParams, List[torch.Tensor]]:
    """The kernel's parameters and the material fields they point to;
    raises on anything the kernel does not take. The caller holds the
    fields until the launch is enqueued: an orthotropic ``axis_view``
    computes them anew, and freed, their memory could be handed to the
    output."""
    st = model.stage(axis)
    if model.ncomp > _MAXC or len(st.pairs) > _MAXP or len(st.zeros) > _MAXZ:
        raise ValueError(f"{model.name}: too many components, pairs or zeros")
    view = mat.axis_view(axis, st)
    fields = view.pair_c + view.pair_z + view.zero_kappa
    for f in fields:
        if f.dtype != torch.float32 or f.device != u.device:
            raise TypeError("sweep_stage's kernel takes float32 material "
                            "fields on the state's device")
        if tuple(f.shape) != tuple(u.shape[1:]) or not f.is_contiguous():
            raise ValueError("material fields must be contiguous and of the "
                             "state's spatial shape")
    p = _SweepParams()
    p.pair_c[:len(st.pairs)] = [f.data_ptr() for f in view.pair_c]
    p.pair_z[:len(st.pairs)] = [f.data_ptr() for f in view.pair_z]
    p.zero_kappa[:len(st.zeros)] = [f.data_ptr() for f in view.zero_kappa]
    p.n[:] = list(u.shape[1:]) + [1] * (4 - u.ndim)
    p.axis = axis
    p.model = STREAM_MODELS[model.name]
    for side in (0, 1):
        bc = (borders or {}).get((axis, side))
        p.bc_kind[side] = -1 if bc is None else _BC_CODES[bc.kind]
        for k, pair in enumerate(st.pairs):
            p.bc_val[side][k] = (0.0 if bc is None else
                                 bc.pair_value(pair.traction_axis, st.axis))
    p.dtoh = float(dt / h[axis])
    return p, fields


def sweep_stage(model: Model, u: torch.Tensor, mat: MaterialFields,
                dt: float, h: Sequence[float], axis: int, order: int,
                borders: Optional[Borders] = None) -> torch.Tensor:
    """One characteristic sweep along ``axis`` of a 2D or 3D state; returns
    the whole new state. A CUDA tensor goes through the CUDA kernel, which
    reads c, z and kappa from ``mat.axis_view`` (isotropic or orthotropic
    fields, or a ``materials.AxisViewCache`` of them); a CPU tensor runs the
    plain ``solver.gcm.stage``."""
    if u.ndim not in (3, 4) or model.dim != u.ndim - 1:
        raise ValueError("sweep_stage runs 2D and 3D models on [C, *spatial] "
                         "state")
    if u.device.type == "cpu":
        return stage(model, u, mat, dt, h, axis, order, borders)
    if u.device.type != "cuda":
        raise ValueError(f"sweep_stage has no kernel for device {u.device}")
    if u.shape[0] != model.ncomp:
        raise ValueError(f"state has {u.shape[0]} components, "
                         f"{model.name} has {model.ncomp}")
    if u.dtype != torch.float32:
        raise TypeError("sweep_stage's kernel takes float32 state")
    if not u.is_contiguous():
        raise ValueError("sweep_stage's kernel takes a contiguous state")
    if order not in (1, 2, 3, 4):
        raise ValueError(f"unsupported interpolation order {order}")
    if axis not in range(model.dim):
        raise ValueError(f"axis {axis} out of range for {model.name}")
    lib = _build.load()
    check_compiled_map(lib, model, "sweep_stage's kernel")
    params, fields = _sweep_params(model, u, mat, dt, h, axis, borders)
    if ctypes.sizeof(params) != lib.gcm_sweep_params_size():
        raise RuntimeError("GcmSweepParams layout differs from its binding")
    out = torch.empty_like(u)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = lib.gcm_sweep_stage(u.data_ptr(), out.data_ptr(),
                              ctypes.addressof(params), order,
                              u.device.index, stream)
    if err != 0:
        raise RuntimeError(f"sweep_stage kernel launch failed: CUDA error "
                           f"{err} ({lib.gcm_error_string(err).decode()})")
    del fields          # the launch is enqueued on the fields' stream
    sweep_stage.launches += 1
    return out


sweep_stage.launches = 0


def sweep_step(model: Model, u: torch.Tensor, mat: MaterialFields,
               dt: float, h: Sequence[float], order: int,
               borders: Optional[Borders] = None,
               axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """A full step with every sweep as one ``sweep_stage`` launch."""
    for a in (axes if axes is not None else range(model.dim)):
        u = sweep_stage(model, u, mat, dt, h, a, order, borders)
    return u
