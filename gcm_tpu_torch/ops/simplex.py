"""The simplex sweep kernel: one characteristic sweep of a simplex mesh per
launch.

Counterpart of ``gcm_tpu/ops/pallas_simplex.py`` (``fused_simplex_sweep``,
``fused_simplex_step``, ``build_fused_simplex_plan``). The kernel is CUDA
C++ for Hopper, ``csrc/simplex_sweep.cu``; it gathers through the foot
tables as they are, so the TPU kernel's compressed stencils, padded
``[C, R, 128]`` layout, row blocks and lane rolls have no counterpart here.

``build_simplex_plan`` puts everything static a sweep needs on the device
once: per sweep axis the stage's tables stacked as ``ids [T, N, K]`` int32,
``weights [T, N, K]`` and ``outside [T, N]`` uint8, each pair's (+1, -1)
table rows, the ``zp``/``zs``/``kappa`` rows, and the border condition (a
uniform kind with its values, or per-node codes ``[N]`` and values
``[dim, dim, N]``).

``simplex_sweep`` launches the kernel for a CUDA tensor and runs
``simplex_sweep_reference``, its plain PyTorch version on the same plan, for
a CPU tensor; for a CUDA tensor it launches or raises, it never falls back.
The kernel is compiled for the component maps of ``ops.fused.STREAM_MODELS``
(a node's components in registers); ``check_compiled_map`` holds the model
to the compiled map and refuses any other model.
``simplex_sweep.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gcm_tpu_torch.materials import MaterialFields
from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.fused import (
    _MAXC, _MAXP, _MAXZ, STREAM_MODELS, check_compiled_map)
from gcm_tpu_torch.solver.simplex_gcm import (
    NodeBorders, pair_table_keys, pair_update, uniform_border,
)
from gcm_tpu_torch.task import BorderSpec

#: rows of SimplexPlan.mats
_ZP, _ZS, _KAPPA = 0, 1, 2


@dataclasses.dataclass
class SimplexStagePlan:
    """One sweep axis: its tables stacked, and its pairs and zeros.

    ``pairs`` holds ``(sigma, vel, t_plus, t_minus, mats_row,
    traction_axis)`` per pair with tables; ``bc_val`` each such pair's
    uniform border value; ``zeros`` the ``(comp, src)`` zero-speed updates
    whose source pair is swept."""

    axis: int
    keys: Tuple[Tuple, ...]             # table key of each stacked row
    ids: torch.Tensor                   # [T, N, K] int32
    weights: torch.Tensor               # [T, N, K]
    outside: torch.Tensor               # [T, N] uint8
    pairs: Tuple[Tuple[int, int, int, int, int, int], ...]
    bc_val: Tuple[float, ...]
    zeros: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class SimplexPlan:
    """Everything static the sweeps need, on one device, built once."""

    model: Model
    N: int
    K: int
    stages: Dict[int, SimplexStagePlan]
    mats: torch.Tensor                  # [3, N]: zp, zs, kappa
    border_code: int                    # uniform BORDER_CODES kind, -1 node
    code: Optional[torch.Tensor]        # [N] int32 per-node kinds
    val: Optional[torch.Tensor]         # [dim, dim, N] per-node values


def build_simplex_plan(model: Model, mat: MaterialFields, tables: Dict,
                       border: Union[str, BorderSpec, NodeBorders] = "absorbing",
                       device="cpu", dtype=torch.float32) -> SimplexPlan:
    """The plan of ``model``'s sweeps over the foot ``tables`` of
    ``grids.simplex.build_foot_tables`` (numpy), with the impedances and
    kappa of the isotropic ``mat`` and the ``border`` condition, as
    ``dtype`` tensors on ``device``."""
    if not isinstance(mat, MaterialFields):
        raise NotImplementedError("the simplex sweep kernel takes isotropic "
                                  "MaterialFields only")
    device = torch.device(device)
    if not tables:
        raise ValueError("no foot tables")
    first = next(iter(tables.values()))
    N, K = (int(s) for s in first.ids.shape)

    def on(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(dt)

    stages: Dict[int, SimplexStagePlan] = {}
    dim = model.dim
    if isinstance(border, NodeBorders):
        border_code, vals = -1, np.zeros((dim, dim))
    else:
        border_code, vals = uniform_border(border, dim)
    for axis in range(dim):
        st = model.stage(axis)
        keys, rows, pairs, bc_val = [], {}, [], []
        pair_keys = pair_table_keys(st, axis, tables)
        if not pair_keys:
            raise ValueError(f"no foot tables for the sweep along {axis}")
        for k, key_p in pair_keys.items():
            p = st.pairs[k]
            for key in (key_p, key_p[:2] + (-1,)):
                if key not in rows:
                    rows[key] = len(keys)
                    keys.append(key)
            pairs.append((p.sigma, p.vel, rows[key_p],
                          rows[key_p[:2] + (-1,)],
                          _ZP if p.wave == "p" else _ZS, p.traction_axis))
            bc_val.append(float(vals[axis, p.traction_axis]))
        tabs = [tables[key] for key in keys]
        if any(t.ids.shape != (N, K) for t in tabs):
            raise ValueError("foot tables of one mesh differ in shape")
        swept = {p[0] for p in pairs}
        stages[axis] = SimplexStagePlan(
            axis=axis, keys=tuple(keys),
            ids=on(np.stack([t.ids for t in tabs]), torch.int32),
            weights=on(np.stack([t.weights for t in tabs]), dtype),
            outside=on(np.stack([t.outside for t in tabs]), torch.uint8),
            pairs=tuple(pairs), bc_val=tuple(bc_val),
            zeros=tuple((zc.comp, zc.src) for zc in st.zeros
                        if zc.src in swept))
    mats = torch.stack([mat.zp, mat.zs, mat.kappa]).to(
        device=device, dtype=dtype).contiguous()
    code = val = None
    if border_code < 0:
        code = on(border.kind, torch.int32)
        val = on(np.transpose(border.value, (1, 2, 0)), dtype)
    return SimplexPlan(model=model, N=N, K=K, stages=stages, mats=mats,
                       border_code=border_code, code=code, val=val)


def simplex_sweep_reference(plan: SimplexPlan, u: torch.Tensor,
                            axis: int) -> torch.Tensor:
    """Plain PyTorch sweep on the plan: the kernel's contract, in the
    state's dtype."""
    sp = plan.stages[axis]
    model = plan.model
    sign = model.sign
    ids = sp.ids.to(u.device).long()
    w = sp.weights.to(device=u.device, dtype=u.dtype)
    out = sp.outside.to(u.device).bool()
    mats = plan.mats.to(device=u.device, dtype=u.dtype)
    if plan.border_code < 0:
        code = plan.code.to(u.device)
        vals = plan.val[axis].to(device=u.device, dtype=u.dtype)
    comps: Dict[int, torch.Tensor] = {}
    for q, (sg, vl, tp, tm, zrow, ta) in enumerate(sp.pairs):
        ip = (u[[sg, vl]][:, ids[tp]] * w[tp]).sum(-1)
        im = (u[[sg, vl]][:, ids[tm]] * w[tm]).sum(-1)
        z = mats[zrow]
        szb = sign * z
        w_l = ip[0] + szb * ip[1]
        w_r = im[0] - szb * im[1]
        if plan.border_code < 0:
            c, v = code, vals[ta]
        else:
            c, v = plan.border_code, sp.bc_val[q]
        comps[sg], comps[vl] = pair_update(w_l, w_r, out[tp], out[tm], c, v,
                                           z, sign, u[vl])
    for zc, zs in sp.zeros:
        comps[zc] = u[zc] + mats[_KAPPA] * (comps[zs] - u[zs])
    return torch.stack([comps.get(i, u[i]) for i in range(model.ncomp)])


class _SimplexParams(ctypes.Structure):
    """Mirror of ``GcmSimplexParams`` in csrc/simplex_sweep.cu."""

    _fields_ = [
        ("ids", ctypes.c_void_p), ("weights", ctypes.c_void_p),
        ("outside", ctypes.c_void_p), ("mats", ctypes.c_void_p),
        ("code", ctypes.c_void_p), ("val", ctypes.c_void_p),
        ("N", ctypes.c_int), ("K", ctypes.c_int), ("model", ctypes.c_int),
        ("axis", ctypes.c_int),
        ("pair_tp", ctypes.c_int * _MAXP), ("pair_tm", ctypes.c_int * _MAXP),
        ("pair_zrow", ctypes.c_int * _MAXP),
        ("pair_traction", ctypes.c_int * _MAXP),
        ("kappa_row", ctypes.c_int), ("bc_kind", ctypes.c_int),
        ("bc_val", ctypes.c_float * _MAXP),
    ]


def _simplex_params(plan: SimplexPlan, u: torch.Tensor,
                    axis: int) -> _SimplexParams:
    """The kernel's parameters; raises on anything it does not take. Each
    plan pair fills the slot of its index in the model's stage (the
    compiled map's pair), and slots without tables stay at -1."""
    sp = plan.stages[axis]
    model = plan.model
    st = model.stage(axis)
    if model.ncomp > _MAXC or len(st.pairs) > _MAXP or len(st.zeros) > _MAXZ:
        raise ValueError(f"{model.name}: too many components, pairs or zeros")
    T = len(sp.keys)
    checks = [(sp.ids, torch.int32, (T, plan.N, plan.K)),
              (sp.weights, torch.float32, (T, plan.N, plan.K)),
              (sp.outside, torch.uint8, (T, plan.N)),
              (plan.mats, torch.float32, (3, plan.N))]
    if plan.border_code < 0:
        checks += [(plan.code, torch.int32, (plan.N,)),
                   (plan.val, torch.float32, (model.dim, model.dim, plan.N))]
    for t, dtype, shape in checks:
        if t.device != u.device or t.dtype != dtype:
            raise TypeError(f"simplex_sweep's kernel takes {dtype} plan "
                            f"tensors on the state's device, got {t.dtype} "
                            f"on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"plan tensor of shape {tuple(t.shape)} is not "
                             f"a contiguous {shape}")
    p = _SimplexParams()
    p.ids, p.weights, p.outside = (sp.ids.data_ptr(), sp.weights.data_ptr(),
                                   sp.outside.data_ptr())
    p.mats = plan.mats.data_ptr()
    if plan.border_code < 0:
        p.code = plan.code.data_ptr()
        p.val = plan.val[axis].data_ptr()
    p.N, p.K = plan.N, plan.K
    p.model, p.axis = STREAM_MODELS.get(model.name, -1), axis
    p.pair_tp[:] = p.pair_tm[:] = [-1] * _MAXP
    slot = {(pr.sigma, pr.vel): q for q, pr in enumerate(st.pairs)}
    for (sg, vl, tp, tm, zrow, ta), bv in zip(sp.pairs, sp.bc_val):
        q = slot[(sg, vl)]
        p.pair_tp[q], p.pair_tm[q] = tp, tm
        p.pair_zrow[q], p.pair_traction[q] = zrow, ta
        p.bc_val[q] = bv
    p.kappa_row = _KAPPA
    p.bc_kind = plan.border_code
    return p


def _check_state(plan: SimplexPlan, u: torch.Tensor, axis: int) -> None:
    model = plan.model
    if u.ndim != 2 or tuple(u.shape) != (model.ncomp, plan.N):
        raise ValueError(f"state of shape {tuple(u.shape)} is not "
                         f"[{model.ncomp}, {plan.N}]")
    if axis not in plan.stages:
        raise ValueError(f"axis {axis} out of range for {model.name}")


def _kernel_params(plan: SimplexPlan, u: torch.Tensor, axis: int):
    """The library and the kernel's parameters for a CUDA state: the
    state's checks, the plan's, and the compiled map's."""
    if u.dtype != torch.float32:
        raise TypeError("simplex_sweep's kernel takes float32 state")
    if not u.is_contiguous():
        raise ValueError("simplex_sweep's kernel takes a contiguous state")
    params = _simplex_params(plan, u, axis)
    lib = _build.load()
    # the plan's pairs and zeros come from the model's stages
    # (build_simplex_plan), so each plan pair is the compiled pair of its
    # index in the model's stage
    check_compiled_map(lib, plan.model, "the simplex kernel")
    if ctypes.sizeof(params) != lib.gcm_simplex_params_size():
        raise RuntimeError("GcmSimplexParams layout differs from its binding")
    return lib, params


def simplex_sweep(plan: SimplexPlan, u: torch.Tensor,
                  axis: int) -> torch.Tensor:
    """One characteristic sweep along ``axis`` of the node state
    ``u [ncomp, N]``; returns the whole new state. A CUDA tensor goes
    through the CUDA kernel, a CPU tensor through the plain version."""
    _check_state(plan, u, axis)
    if u.device.type == "cpu":
        return simplex_sweep_reference(plan, u, axis)
    if u.device.type != "cuda":
        raise ValueError(f"simplex_sweep has no kernel for device {u.device}")
    lib, params = _kernel_params(plan, u, axis)
    out = torch.empty_like(u)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = lib.gcm_simplex_sweep(u.data_ptr(), out.data_ptr(),
                                ctypes.addressof(params), u.device.index,
                                stream)
    if err != 0:
        raise RuntimeError(f"simplex_sweep kernel launch failed: CUDA error "
                           f"{err} ({lib.gcm_error_string(err).decode()})")
    simplex_sweep.launches += 1
    return out


def simplex_sweep_occupancy(plan: SimplexPlan, u: torch.Tensor,
                            axis: int) -> Tuple[int, int]:
    """``(blocks_per_sm, nodes_per_block)`` that a launch of the kernel on
    these arguments gets on ``u``'s card: resident blocks an SM, and the
    nodes each block of the launch takes."""
    _check_state(plan, u, axis)
    lib, params = _kernel_params(plan, u, axis)
    out = (ctypes.c_int * 2)()
    err = lib.gcm_simplex_occupancy(ctypes.addressof(params), u.device.index,
                                    out)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err} "
                           f"({lib.gcm_error_string(err).decode()})")
    return out[0], out[1]


simplex_sweep.launches = 0


def simplex_step(plan: SimplexPlan, u: torch.Tensor,
                 axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One splitting step: a ``simplex_sweep`` along each axis in order."""
    for a in (axes if axes is not None else range(plan.model.dim)):
        u = simplex_sweep(plan, u, a)
    return u
