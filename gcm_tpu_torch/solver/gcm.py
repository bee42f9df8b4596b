"""The grid-characteristic time step: sweeps + borders + zero invariants.

Counterpart of ``gcm_tpu/solver/gcm.py``: one time step is a sequence of 1D
characteristic sweeps (dimensional splitting), with the axis order reversed
on alternate steps for second-order splitting accuracy. Dimension-generic;
this plain torch step is what ``ops.fused.fused_step`` is held against.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from gcm_tpu_torch.materials import MaterialFields
from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.ops.stage import (
    apply_zero_invariants, reconstruct_pair, stage_pair_updates,
)
from gcm_tpu_torch.solver.boundary import correct_pair_at_face
from gcm_tpu_torch.task import BorderSpec

Borders = Dict[Tuple[int, int], BorderSpec]


def cfl_dt(mat: MaterialFields, h: Sequence[float], cfl: float) -> float:
    """Static global time step: dt = cfl * min_a(h_a) / max(c_p)."""
    return float(cfl * min(h) / mat.max_cp())


def stage(model: Model, u: torch.Tensor, mat: MaterialFields, dt: float,
          h: Sequence[float], axis: int, order: int,
          borders: Optional[Borders] = None,
          dim_axis: Optional[int] = None) -> torch.Tensor:
    """One characteristic sweep along physical ``axis`` over the whole
    field; ``dim_axis`` is the tensor dimension it runs along, when that
    differs from ``axis``."""
    ax = dim_axis if dim_axis is not None else axis
    st = model.stage(axis)
    view = mat.axis_view(axis, st)
    pair_ws = stage_pair_updates(model, u, view, dt / h[axis], axis, order,
                                 dim_axis=ax)

    comps: Dict[int, torch.Tensor] = {}
    for k, (w_l, w_r, p) in pair_ws.items():
        z = view.pair_z[k]
        if borders is not None:
            for side in (0, 1):
                bc = borders.get((axis, side))
                if bc is not None:
                    val = bc.pair_value(p.traction_axis, st.axis)
                    w_l, w_r = correct_pair_at_face(
                        w_l, w_r, z, model.sign, bc, ax, side, val)
        A_new, B_new = reconstruct_pair(w_l, w_r, z, u[p.vel], model.sign)
        comps[p.sigma] = A_new
        comps[p.vel] = B_new

    apply_zero_invariants(model, u, comps, view, axis)
    return torch.stack([comps.get(i, u[i]) for i in range(model.ncomp)])


def step(model: Model, u: torch.Tensor, mat: MaterialFields, dt: float,
         h: Sequence[float], order: int, borders: Optional[Borders] = None,
         axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One full time step: sweep every axis in the given order."""
    if axes is None:
        axes = range(model.dim)
    for a in axes:
        u = stage(model, u, mat, dt, h, a, order, borders)
    return u


def axes_order(dim: int, step_index: int, symmetrize: bool,
               fwd: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """Splitting axis order for a given step: ``fwd`` (default (0, .., dim-1)),
    reversed on odd steps."""
    fwd = tuple(fwd) if fwd is not None else tuple(range(dim))
    if symmetrize and (step_index % 2 == 1):
        return fwd[::-1]
    return fwd


def canonical_axes(shape: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """The splitting order of the JAX package's canonical layout of a 2D or
    3D grid (``gcm_tpu/engine.py``, ``Engine.__init__``), or None where it
    does not engage: when the last axis is not a multiple of 128 and
    another is, that axis goes last, the others keep their order; a 2D grid
    also needs its new first axis a multiple of 8. The JAX engine stores the
    state in this order and sweeps it forward; the port sweeps the task
    layout in this order, the same splitting."""
    dim = len(shape)
    if dim not in (2, 3):
        return None
    aligned = [j for j in range(dim) if shape[j] % 128 == 0]
    if shape[-1] % 128 == 0 or not aligned:
        return None
    j = aligned[-1]
    perm = tuple(d for d in range(dim) if d != j) + (j,)
    if dim == 2 and shape[perm[0]] % 8 != 0:
        return None
    return perm
