"""Grid-characteristic method on simplex meshes: gather-based sweeps.

Counterpart of ``gcm_tpu/solver/simplex_gcm.py`` in its gather form: the
pair/zero characteristic algebra of the cubic solver, with the
semi-Lagrangian interpolation a weighted gather over the static foot tables
of ``grids/simplex.py``, ``(u[:, ids] * weights).sum(-1)``. This plain
torch sweep is the engine's ``kernel="torch"`` path and the reference the
simplex sweep kernel (``ops/simplex.py``) is held to.

State layout: ``u[ncomp, N]``; material fields ``[N]``. Border conditions
apply where a characteristic foot leaves the hull: one kind for the whole
hull (a kind string or a ``task.BorderSpec``) or per node
(:class:`NodeBorders`, built by Area with :func:`build_node_borders`).
Table fields may be numpy arrays or tensors; weights are cast to the state
dtype at use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gcm_tpu_torch.grids.simplex import FootTables, SimplexGrid
from gcm_tpu_torch.materials import MaterialFields
from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.task import BORDER_KINDS, Area, BorderSpec

_Z_EPS = 1e-30

#: border-kind codes for the per-node tables (order matches BORDER_KINDS)
BORDER_CODES = {k: i for i, k in enumerate(BORDER_KINDS)}


@dataclasses.dataclass
class NodeBorders:
    """Per-node border assignment:

    - ``kind [N] int32``: BORDER_CODES of each node's condition (only hull
      nodes matter: interior feet never leave the domain);
    - ``value [N, dim, dim]``: value[n, a, t] is the prescribed
      traction/velocity for the pair with traction axis ``t`` in the sweep
      along ``a`` (BorderSpec.pair_value, resolved per node).
    """

    kind: np.ndarray
    value: np.ndarray


def build_node_borders(
    grid: SimplexGrid,
    assignments: Sequence[Tuple[Union[Area, np.ndarray], BorderSpec]],
    default: BorderSpec = BorderSpec("absorbing"),
) -> NodeBorders:
    """Assign BorderSpecs to nodes by Area (or explicit node mask), later
    assignments winning where areas overlap."""
    n, dim = grid.npoints, grid.dim
    kind = np.full(n, BORDER_CODES[default.kind], np.int32)
    value = np.zeros((n, dim, dim))
    for a in range(dim):
        for t in range(dim):
            value[:, a, t] = default.pair_value(t, a)
    for selector, spec in assignments:
        if isinstance(selector, Area):
            m = selector.contains(grid.points)
        else:
            m = np.asarray(selector, bool)
        kind[m] = BORDER_CODES[spec.kind]
        for a in range(dim):
            for t in range(dim):
                value[m, a, t] = spec.pair_value(t, a)
    return NodeBorders(kind=kind, value=value)


def _on(x, u: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """A numpy array or tensor as a tensor on ``u``'s device."""
    t = torch.as_tensor(x, device=u.device)
    return t if dtype is None else t.to(dtype)


def uniform_border(border: Union[str, BorderSpec], dim: int
                   ) -> Tuple[int, np.ndarray]:
    """(BORDER_CODES kind, values [dim, dim]) of a border condition for the
    whole hull: values[a, t] is the pair value for traction axis ``t`` in
    the sweep along ``a``."""
    spec = BorderSpec(border) if isinstance(border, str) else border
    vals = np.asarray([[spec.pair_value(t, a) for t in range(dim)]
                       for a in range(dim)], np.float64)
    return BORDER_CODES[spec.kind], vals


def incoming(code, val, w_out: torch.Tensor, z, sign: int,
             side: int) -> torch.Tensor:
    """The incoming invariant that replaces one whose foot left the hull,
    from the node's outgoing invariant ``w_out``: ``side`` 1 rebuilds w_l
    (from w_r), side 0 rebuilds w_r (from w_l). ``code`` is one
    BORDER_CODES value or a tensor of them (per node)."""
    if side == 1:
        fixed_v = w_out + 2.0 * sign * z * val
    else:
        fixed_v = w_out - 2.0 * sign * z * val
    if isinstance(code, int):
        if code == 0:
            return torch.zeros_like(w_out)
        if code == 1:
            return -w_out
        if code == 2:
            return 2.0 * val - w_out
        return fixed_v
    zero = torch.zeros_like(w_out)
    return torch.where(code == 0, zero, torch.where(
        code == 1, -w_out, torch.where(code == 2, 2.0 * val - w_out,
                                       fixed_v)))


def pair_update(w_l, w_r, out_p, out_m, code, val, z, sign: int, B_old):
    """Border overwrite of the outside feet, then ``(A, B)``; B keeps its
    old value where ``z == 0``."""
    w_l, w_r = (torch.where(out_p, incoming(code, val, w_r, z, sign, 1), w_l),
                torch.where(out_m, incoming(code, val, w_l, z, sign, 0), w_r))
    A_new = 0.5 * (w_l + w_r)
    B_prop = sign * (w_l - w_r) / (2.0 * torch.clamp(z, min=_Z_EPS))
    return A_new, torch.where(z > 0, B_prop, B_old)


def pair_table_keys(st, axis: int, tables) -> Dict[int, Tuple]:
    """Pair index -> its direction +1 table key: ``(axis, k, +1)`` when
    per-pair tables exist, else ``(axis, wave, +1)``; pairs without a table
    are left out (a fluid has no S tables)."""
    keys = {}
    for k, p in enumerate(st.pairs):
        key_p = (axis, k, +1) if (axis, k, +1) in tables else (axis, p.wave, +1)
        if key_p in tables:
            keys[k] = key_p
    return keys


def _gather_interp(u: torch.Tensor, comps, t: FootTables) -> torch.Tensor:
    """``sum_j w[:, j] * u[c, ids[:, j]]`` for each component in ``comps``."""
    ids = _on(t.ids, u).long()
    return (u[list(comps)][:, ids] * _on(t.weights, u, u.dtype)).sum(-1)


def simplex_stage(
    model: Model,
    u: torch.Tensor,
    mat: MaterialFields,
    tables: Dict[Tuple, FootTables],
    axis: int,
    border_kind: Union[str, BorderSpec, NodeBorders] = "absorbing",
) -> torch.Tensor:
    """One characteristic sweep along coordinate axis ``axis``.

    ``tables`` may be keyed ``(axis, wave, dir)`` (one table per wave
    family) or ``(axis, pair_index, dir)`` (per-pair feet)."""
    st = model.stage(axis)
    sign = model.sign
    view = mat.axis_view(axis, st)
    node = isinstance(border_kind, NodeBorders)
    if node:
        code = _on(border_kind.kind, u)
    else:
        code, vals = uniform_border(border_kind, model.dim)
    comps: Dict[int, torch.Tensor] = {}
    for k, key_p in pair_table_keys(st, axis, tables).items():
        p = st.pairs[k]
        tp, tm = tables[key_p], tables[key_p[:2] + (-1,)]
        z = view.pair_z[k]
        ip = _gather_interp(u, (p.sigma, p.vel), tp)
        im = _gather_interp(u, (p.sigma, p.vel), tm)
        szb = sign * z
        w_l = ip[0] + szb * ip[1]
        w_r = im[0] - szb * im[1]
        val = (_on(border_kind.value[:, axis, p.traction_axis], u, u.dtype)
               if node else float(vals[axis, p.traction_axis]))
        comps[p.sigma], comps[p.vel] = pair_update(
            w_l, w_r, _on(tp.outside, u).bool(), _on(tm.outside, u).bool(),
            code, val, z, sign, u[p.vel])

    for j, zc in enumerate(st.zeros):
        if zc.src in comps:
            comps[zc.comp] = u[zc.comp] + view.zero_kappa[j] * (
                comps[zc.src] - u[zc.src])
    return torch.stack([comps.get(i, u[i]) for i in range(model.ncomp)])


def simplex_step(
    model: Model,
    u: torch.Tensor,
    mat: MaterialFields,
    tables: Dict[Tuple, FootTables],
    border_kind: Union[str, BorderSpec, NodeBorders] = "absorbing",
    axes: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """One splitting step: a sweep along each axis in ``axes`` order."""
    for a in (axes if axes is not None else range(model.dim)):
        u = simplex_stage(model, u, mat, tables, a, border_kind)
    return u
