"""Non-conforming contact: interface interpolation maps between face grids.

Counterpart of ``gcm_tpu/solver/contact_nc.py``: contact between bodies
meshed independently (spacing h against h/2, offset node lattices).

- The interface is the geometric overlap of body_a's high face and body_b's
  low face on the contact axis. Each side contributes the contiguous range
  of its face nodes inside the overlap (``lo``/``span`` per side).
- Per side, a static linear interpolation table per transverse axis maps
  the other side's full face onto this side's overlap nodes (index pairs
  and convex weights, numpy, built once at setup; a separable tensor
  product in 3D).
- The two-impedance contact algebra of ``solver.contact`` is solved
  pointwise per side, with the side's own outgoing invariant and the other
  side's interpolated one; collocated faces make the tables the identity.
- Fracture state is per side: each side's overlap nodes carry their own
  bond mask.

The solve is a fixup after raw (border- and contact-free) sweeps, like
``solver.contact.apply_contact_post``, so it follows every kernel path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gcm_tpu_torch.solver.contact import (
    ContactSpec, _pair_incoming, _require_normal_pair, _split_normal,
    face_sub_index,
)


# ---------------------------------------------------------------- geometry

@dataclasses.dataclass(frozen=True)
class AxisMap:
    """1D linear interpolation from another face's node line:
    ``value_at_targets = src[idx[:,0]] * w[:,0] + src[idx[:,1]] * w[:,1]``."""

    idx: np.ndarray   # [n_target, 2] int32, indices into the source line
    w: np.ndarray     # [n_target, 2] float64, convex weights


@dataclasses.dataclass(frozen=True)
class SideMaps:
    """One side's overlap sub-face and the tables interpolating the other
    side's full face onto it."""

    lo: Tuple[int, ...]              # overlap start index per transverse axis
    span: Tuple[int, ...]            # overlap node count per transverse axis
    from_other: Tuple[AxisMap, ...]  # per transverse axis


@dataclasses.dataclass(frozen=True)
class InterfaceMaps:
    """Static interface maps of one non-conforming contact."""

    a: SideMaps
    b: SideMaps


def _axis_map(targets: np.ndarray, src: np.ndarray) -> AxisMap:
    """Linear interpolation table evaluating at ``targets`` from the source
    node line ``src`` (uniformly spaced, ascending); targets outside it
    clamp to the end nodes (they are eps-close by construction)."""
    hs = float(src[1] - src[0]) if len(src) > 1 else 1.0
    t = (targets - src[0]) / hs
    j0 = np.clip(np.floor(t).astype(np.int64), 0, max(len(src) - 2, 0))
    frac = np.clip(t - j0, 0.0, 1.0)
    idx = np.stack([j0, np.minimum(j0 + 1, len(src) - 1)], axis=-1)
    w = np.stack([1.0 - frac, frac], axis=-1)
    return AxisMap(idx.astype(np.int32), w)


def build_interface_maps(grid_a, grid_b, axis: int,
                         tol: float = 1e-9) -> InterfaceMaps:
    """Maps of a contact between grid_a's high face and grid_b's low face
    (``GridSpec``s). The overlap must hold at least 2 nodes of each side on
    every transverse axis."""
    dim = grid_a.dim
    if grid_b.dim != dim:
        raise ValueError("contacting bodies must share dimensionality")
    ca = grid_a.coords()
    cb = grid_b.coords()
    lo_a, span_a, lo_b, span_b = [], [], [], []
    maps_a, maps_b = [], []
    for d in (d for d in range(dim) if d != axis):
        eps = tol * max(grid_a.h[d], grid_b.h[d])
        olo = max(ca[d][0], cb[d][0]) - eps
        ohi = min(ca[d][-1], cb[d][-1]) + eps
        sel_a = np.nonzero((ca[d] >= olo) & (ca[d] <= ohi))[0]
        sel_b = np.nonzero((cb[d] >= olo) & (cb[d] <= ohi))[0]
        if len(sel_a) < 2 or len(sel_b) < 2:
            raise ValueError(
                f"contact faces overlap in fewer than 2 nodes on axis {d}")
        lo_a.append(int(sel_a[0]))
        span_a.append(len(sel_a))
        lo_b.append(int(sel_b[0]))
        span_b.append(len(sel_b))
        maps_a.append(_axis_map(ca[d][sel_a], cb[d]))
        maps_b.append(_axis_map(cb[d][sel_b], ca[d]))
    return InterfaceMaps(
        a=SideMaps(tuple(lo_a), tuple(span_a), tuple(maps_a)),
        b=SideMaps(tuple(lo_b), tuple(span_b), tuple(maps_b)))


def faces_conform(grid_a, grid_b, axis: int, tol: float = 1e-9) -> bool:
    """True iff the two faces have collocated nodes (the shared solve of
    ``solver.contact`` applies, with no lo/span)."""
    for d in range(grid_a.dim):
        if d == axis:
            continue
        if grid_a.shape[d] != grid_b.shape[d]:
            return False
        eps = tol * max(grid_a.h[d], grid_b.h[d])
        if abs(grid_a.h[d] - grid_b.h[d]) > eps:
            return False
        if abs(grid_a.origin[d] - grid_b.origin[d]) > eps:
            return False
    return True


# ------------------------------------------------------------- interpolation

def _map_tensors(m: AxisMap, device, dtype):
    """The table's indices and weights as tensors, made once per device and
    type and kept on the map."""
    cache = m.__dict__.setdefault("_tensors", {})
    key = (torch.device(device), dtype)
    if key not in cache:
        idx = torch.as_tensor(m.idx.astype(np.int64), device=device)
        w = torch.as_tensor(m.w, device=device).to(dtype)
        cache[key] = (idx[:, 0], idx[:, 1], w[:, 0], w[:, 1])
    return cache[key]


def interp_face(vals: torch.Tensor, maps: Sequence[AxisMap]) -> torch.Tensor:
    """Interpolate a full-face tensor onto the target nodes, axis by axis
    (one tensor axis per transverse axis, in increasing axis order)."""
    out = vals
    for d, m in enumerate(maps):
        i0, i1, w0, w1 = _map_tensors(m, vals.device, vals.dtype)
        sh = [1] * out.ndim
        sh[d] = len(m.idx)
        out = (out.index_select(d, i0) * w0.reshape(sh)
               + out.index_select(d, i1) * w1.reshape(sh))
    return out


# ------------------------------------------------------------------ the solve

def init_bonded_nc(maps: InterfaceMaps, dtype=torch.float32,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """Fresh per-side bond masks over the overlap sub-faces."""
    return {"a": torch.ones(maps.a.span, dtype=dtype, device=device),
            "b": torch.ones(maps.b.span, dtype=dtype, device=device)}


def _solve_side(spec: ContactSpec, model, u_old, u_new, view, axis_side,
                sub_idx, out_other_full, z_other_full, maps_side, glue):
    """The interface solve at ONE side's overlap nodes. ``axis_side`` is +1
    for body_a's high face (own outgoing w_R), -1 for body_b's low face
    (own outgoing w_L); the other side's full-face outgoing invariants and
    impedances are interpolated through ``maps_side.from_other``. Returns
    the fixed-up state (a copy) and the normal-traction slab."""
    st = model.stage(spec.axis)
    nax = st.axis
    sign = model.sign
    s_star_n = None
    sigma_c = None
    sigma_fixed: Dict[int, torch.Tensor] = {}
    pairs = {k: (None, None, p) for k, p in enumerate(st.pairs)}
    u_new = u_new.clone()
    for k in _split_normal(pairs, nax):
        p = st.pairs[k]
        is_normal = p.traction_axis == nax
        z_own = view.pair_z[k][sub_idx]
        A = u_new[p.sigma][sub_idx]
        B = u_new[p.vel][sub_idx]
        z_oth = interp_face(z_other_full[k], maps_side.from_other)
        out_oth = interp_face(out_other_full[k], maps_side.from_other)
        if axis_side > 0:   # body_a's high face: own outgoing is w_R
            out_own = A - sign * z_own * B
            in_own, _, s_star = _pair_incoming(
                spec, is_normal, out_own, out_oth, z_own, z_oth, glue,
                sigma_c)
            A2 = 0.5 * (in_own + out_own)
            B2 = torch.where(z_own > 0, sign * (in_own - out_own)
                             / (2.0 * torch.clamp(z_own, min=1e-30)), B)
        else:               # body_b's low face: own outgoing is w_L
            out_own = A + sign * z_own * B
            _, in_own, s_star = _pair_incoming(
                spec, is_normal, out_oth, out_own, z_oth, z_own, glue,
                sigma_c)
            A2 = 0.5 * (out_own + in_own)
            B2 = torch.where(z_own > 0, sign * (out_own - in_own)
                             / (2.0 * torch.clamp(z_own, min=1e-30)), B)
        if is_normal:
            s_star_n = s_star
            sigma_c = torch.clamp(-s_star, min=0.0)
        u_new[(p.sigma,) + sub_idx] = A2
        u_new[(p.vel,) + sub_idx] = B2
        sigma_fixed[p.sigma] = A2

    # re-propagate the zero-speed invariants at the fixed sub-face
    for j, zc in enumerate(st.zeros):
        if zc.src in sigma_fixed:
            kap = view.zero_kappa[j][sub_idx]
            u_new[(zc.comp,) + sub_idx] = u_old[zc.comp][sub_idx] + kap * (
                sigma_fixed[zc.src] - u_old[zc.src][sub_idx])
    return u_new, s_star_n


def apply_contact_nc_post(spec: ContactSpec, model, maps: InterfaceMaps,
                          u_old_a: torch.Tensor, u_a: torch.Tensor,
                          u_old_b: torch.Tensor, u_b: torch.Tensor,
                          view_a, view_b, bonded: Optional[Dict]):
    """Non-conforming contact solve as a fixup after raw sweeps: the algebra
    of ``solver.contact.apply_contact_post``, pointwise per side through the
    static tables. ``bonded`` is the per-side mask dict of
    :func:`init_bonded_nc`, or None without fracture. Returns new states
    and the new masks."""
    ax = spec.axis
    dim = model.dim
    st = model.stage(ax)
    _require_normal_pair(spec, st.pairs, st.axis)
    sign = model.sign
    sub_a = face_sub_index(ax, 1, dim, maps.a.lo, maps.a.span)
    sub_b = face_sub_index(ax, 0, dim, maps.b.lo, maps.b.span)
    full_a = face_sub_index(ax, 1, dim, None, None)
    full_b = face_sub_index(ax, 0, dim, None, None)

    # each side's full-face outgoing invariants and impedances: the
    # sources of the other side's interpolation
    out_a_full, out_b_full, z_a_full, z_b_full = {}, {}, {}, {}
    for k, p in enumerate(st.pairs):
        z_a = view_a.pair_z[k][full_a]
        z_b = view_b.pair_z[k][full_b]
        out_a_full[k] = u_a[p.sigma][full_a] - sign * z_a * u_a[p.vel][full_a]
        out_b_full[k] = u_b[p.sigma][full_b] + sign * z_b * u_b[p.vel][full_b]
        z_a_full[k] = z_a
        z_b_full[k] = z_b

    glue_a = (bonded["a"] > 0.5) if bonded is not None else None
    glue_b = (bonded["b"] > 0.5) if bonded is not None else None
    u_a2, s_n_a = _solve_side(spec, model, u_old_a, u_a, view_a, +1, sub_a,
                              out_b_full, z_b_full, maps.a, glue_a)
    u_b2, s_n_b = _solve_side(spec, model, u_old_b, u_b, view_b, -1, sub_b,
                              out_a_full, z_a_full, maps.b, glue_b)
    new_bonded = bonded
    if bonded is not None and spec.tensile_strength is not None:
        keep_a = (s_n_a <= spec.tensile_strength).to(bonded["a"].dtype)
        keep_b = (s_n_b <= spec.tensile_strength).to(bonded["b"].dtype)
        new_bonded = {"a": bonded["a"] * keep_a, "b": bonded["b"] * keep_b}
    return u_a2, u_b2, new_bonded
