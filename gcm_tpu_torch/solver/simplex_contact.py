"""Contact between simplex-mesh bodies: paired-node characteristic solves.

Counterpart of ``gcm_tpu/solver/simplex_contact.py``. Two simplex bodies
meet on a contact plane normal to ``axis`` (body_a on the low side, body_b
on the high side). The interface solve runs as a fixup after each body's
sweep along ``axis``, on the interface nodes only:

- during body_a's sweep the invariant entering from the high side has its
  foot outside the hull, so the border condition fills it; the fixup
  overwrites it;
- the fixup rebuilds both bodies' outgoing invariants at the interface
  nodes from the swept state (the reconstruction is invertible), applies
  the two-impedance solve of structured contact
  (``solver.contact._pair_incoming``: bonded, slip, Coulomb friction,
  fracture) and re-propagates the zero-speed invariants from the state
  before the sweep.

Conforming interfaces (collocated nodes, found host-side by mutual nearest
neighbours, :func:`pair_contact_nodes`) solve node pair by node pair;
independently meshed bodies (:func:`pair_contact_maps`) interpolate the
other side's values through static linear tables and solve per side.

The fixups write the interface nodes into the sweep's fresh outputs, which
they own, with indexed assignment; the states before the sweep are only
read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gcm_tpu_torch.grids.simplex import SimplexGrid
from gcm_tpu_torch.solver.contact import (
    CONTACT_KINDS, _fracture, _pair_incoming, _require_normal_pair,
    _split_normal,
)


@dataclasses.dataclass(frozen=True)
class SimplexContactSpec:
    """Contact between two simplex bodies along ``axis``.

    body_a is on the LOW side of the contact plane (its interface nodes see
    the +axis characteristic leave the hull), body_b on the high side.
    The kinds and fracture criteria of the structured ``ContactSpec``.
    """

    body_a: str
    body_b: str
    axis: int
    kind: str = "bonded"
    tensile_strength: Optional[float] = None
    broken_kind: str = "free"
    friction_mu: float = 0.0

    def __post_init__(self):
        if self.kind not in CONTACT_KINDS:
            raise ValueError(f"unknown contact kind {self.kind!r}")
        if self.broken_kind not in ("free", "slip", "friction"):
            raise ValueError(f"unknown broken kind {self.broken_kind!r}")


def pair_contact_nodes(grid_a: SimplexGrid, grid_b: SimplexGrid,
                       tol: float = 1e-9) -> Tuple[np.ndarray, np.ndarray]:
    """Pair the collocated hull nodes of two bodies by coordinates:
    ``(idx_a, idx_b)`` int32. Matches must be mutual nearest neighbours,
    so the pairing is a partial bijection (no b node takes two a nodes,
    which would make the fixup's scatter keep one of two updates)."""
    from scipy.spatial import cKDTree

    ha = np.flatnonzero(grid_a.hull_mask())
    hb = np.flatnonzero(grid_b.hull_mask())
    d_ab, j = cKDTree(grid_b.points[hb]).query(grid_a.points[ha], k=1)
    _, i_back = cKDTree(grid_a.points[ha]).query(grid_b.points[hb[j]], k=1)
    keep = (d_ab <= tol) & (i_back == np.arange(len(ha)))
    idx_a = ha[keep].astype(np.int32)
    idx_b = hb[j[keep]].astype(np.int32)
    if len(idx_a) == 0:
        raise ValueError("no collocated interface nodes found")
    if np.unique(idx_b).size != idx_b.size:
        raise ValueError("non-bijective contact pairing")
    return idx_a, idx_b


def _on(x, u: torch.Tensor, dtype: torch.dtype = torch.long) -> torch.Tensor:
    """An index or weight array (numpy or tensor) on ``u``'s device."""
    return torch.as_tensor(x, device=u.device).to(dtype)


def _set_pair(sign: int, u_a, u_b, p, idx_a, idx_b, z_a, z_b, out_a, out_b,
              in_a, in_b):
    """Write one pair's (sigma, vel) at the interface nodes of both sides
    from the outgoing and incoming invariants; the velocity keeps its
    swept value where the impedance is 0. Returns the new sigmas."""
    A_a2 = 0.5 * (in_a + out_a)
    B_a2 = torch.where(z_a > 0, sign * (in_a - out_a)
                       / (2.0 * torch.clamp(z_a, min=1e-30)),
                       u_a[p.vel][idx_a])
    A_b2 = 0.5 * (out_b + in_b)
    B_b2 = torch.where(z_b > 0, sign * (out_b - in_b)
                       / (2.0 * torch.clamp(z_b, min=1e-30)),
                       u_b[p.vel][idx_b])
    u_a[p.sigma, idx_a] = A_a2
    u_a[p.vel, idx_a] = B_a2
    u_b[p.sigma, idx_b] = A_b2
    u_b[p.vel, idx_b] = B_b2
    return A_a2, A_b2


def _repropagate_zeros(st, u_old, u, view, idx, sigma_fixed) -> None:
    """The zero-speed invariants at the interface nodes, from the state
    before the sweep and the fixed sigmas (as the sweep does)."""
    for j, zc in enumerate(st.zeros):
        if zc.src in sigma_fixed:
            u[zc.comp, idx] = u_old[zc.comp][idx] + view.zero_kappa[j][idx] * (
                sigma_fixed[zc.src] - u_old[zc.src][idx])


def apply_simplex_contact_post(
    spec: SimplexContactSpec, model, u_old_a: torch.Tensor,
    u_a: torch.Tensor, u_old_b: torch.Tensor, u_b: torch.Tensor,
    view_a, view_b, idx_a, idx_b, bonded: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One conforming contact's interface solve on the paired nodes, after
    the sweep along ``spec.axis``.

    ``u_old_*`` are the [ncomp, N] states before the sweep (read only),
    ``u_*`` the sweep's fresh outputs, written in place at the paired
    nodes; ``view_*`` the bodies' AxisViews of that sweep; ``idx_*`` the
    pairing of :func:`pair_contact_nodes` (numpy or tensors). Returns
    ``(u_a, u_b, bond mask)``."""
    st = model.stage(spec.axis)
    nax = st.axis          # the normal pair is found on the physical axis
    _require_normal_pair(spec, st.pairs, nax)
    sign = model.sign
    idx_a, idx_b = _on(idx_a, u_a), _on(idx_b, u_b)
    glue = (bonded > 0.5) if bonded is not None else None
    s_star_n = None
    sigma_c = None
    fixed_a: Dict[int, torch.Tensor] = {}
    fixed_b: Dict[int, torch.Tensor] = {}
    pairs = {k: (None, None, p) for k, p in enumerate(st.pairs)}
    for k in _split_normal(pairs, nax):
        p = st.pairs[k]
        is_normal = p.traction_axis == nax
        z_a = view_a.pair_z[k][idx_a]
        z_b = view_b.pair_z[k][idx_b]
        # body_a is on the low side: its outgoing invariant at the plane is
        # w_R (foot inside a), body_b's is w_L
        out_a = u_a[p.sigma][idx_a] - sign * z_a * u_a[p.vel][idx_a]
        out_b = u_b[p.sigma][idx_b] + sign * z_b * u_b[p.vel][idx_b]
        in_a, in_b, s_star = _pair_incoming(
            spec, is_normal, out_a, out_b, z_a, z_b, glue, sigma_c)
        if is_normal:
            s_star_n = s_star
            sigma_c = torch.clamp(-s_star, min=0.0)
        fixed_a[p.sigma], fixed_b[p.sigma] = _set_pair(
            sign, u_a, u_b, p, idx_a, idx_b, z_a, z_b, out_a, out_b, in_a,
            in_b)
    _repropagate_zeros(st, u_old_a, u_a, view_a, idx_a, fixed_a)
    _repropagate_zeros(st, u_old_b, u_b, view_b, idx_b, fixed_b)
    return u_a, u_b, _fracture(spec, bonded, s_star_n)


# ------------------------------------------------ non-conforming interfaces

@dataclasses.dataclass(frozen=True)
class SimplexInterfaceMaps:
    """Static interpolation tables of a non-conforming simplex contact.

    ``idx_*``: each side's interface nodes (the body's node numbering).
    ``nbr_a``/``w_a``: for each a-side interface node, K positions into
    ``idx_b`` and convex weights that interpolate b-side values at the
    node (``nbr_b``/``w_b`` the other way). K is the interface manifold's
    dimension + 1 (2 on a line, 3 on a surface). Host arrays (numpy), or
    tensors on an engine's device.
    """

    idx_a: np.ndarray
    idx_b: np.ndarray
    nbr_a: np.ndarray
    w_a: np.ndarray
    nbr_b: np.ndarray
    w_b: np.ndarray


def _interface_interp(targets: np.ndarray, sources: np.ndarray):
    """Linear interpolation tables on the (dim-1)-d interface manifold,
    from transverse coordinates ``[n, dim-1]``: on a line bracketing
    weights (clamped at the ends), on a surface Delaunay barycentric
    weights with the nearest source node outside the sources' hull. Exact
    on affine data inside the hull."""
    nt = len(targets)
    if targets.shape[1] == 1:
        order = np.argsort(sources[:, 0])
        s = sources[order, 0]
        t = targets[:, 0]
        j = np.clip(np.searchsorted(s, t) - 1, 0, max(len(s) - 2, 0))
        denom = np.maximum(s[j + 1] - s[j], 1e-300)
        frac = np.clip((t - s[j]) / denom, 0.0, 1.0)
        nbr = np.stack([order[j], order[np.minimum(j + 1, len(s) - 1)]], 1)
        w = np.stack([1.0 - frac, frac], 1)
        return nbr.astype(np.int32), w
    from scipy.spatial import Delaunay, cKDTree

    tri = Delaunay(sources)
    simplex = tri.find_simplex(targets)
    K = sources.shape[1] + 1
    nbr = np.zeros((nt, K), dtype=np.int64)
    w = np.zeros((nt, K))
    inside = simplex >= 0
    if inside.any():
        sx = simplex[inside]
        T = tri.transform[sx]
        bary = np.einsum("nij,nj->ni", T[:, :-1], targets[inside] - T[:, -1])
        nbr[inside] = tri.simplices[sx]
        w[inside] = np.concatenate(
            [bary, 1.0 - bary.sum(axis=1, keepdims=True)], axis=1)
    if (~inside).any():
        _, nearest = cKDTree(sources).query(targets[~inside], k=1)
        nbr[~inside, 0] = nearest
        w[~inside, 0] = 1.0
    return nbr.astype(np.int32), w


def pair_contact_maps(grid_a: SimplexGrid, grid_b: SimplexGrid, axis: int,
                      plane_tol: Optional[float] = None
                      ) -> SimplexInterfaceMaps:
    """Interface maps of two independently meshed bodies meeting on the
    plane normal to ``axis`` (body_a below, body_b above): each side's hull
    nodes on the contact plane, and static linear tables interpolating the
    other side's values at them."""
    xa = grid_a.points[:, axis]
    xb = grid_b.points[:, axis]
    x_c_a = xa.max()
    x_c_b = xb.min()
    if plane_tol is None:
        ext = max(xa.max() - xa.min(), xb.max() - xb.min())
        plane_tol = 1e-6 * max(ext, 1.0)
    if abs(x_c_a - x_c_b) > plane_tol:
        raise ValueError(f"contact planes disagree: a ends at {x_c_a}, b "
                         f"starts at {x_c_b}")
    ha = np.flatnonzero(grid_a.hull_mask() & (np.abs(xa - x_c_a) <= plane_tol))
    hb = np.flatnonzero(grid_b.hull_mask() & (np.abs(xb - x_c_b) <= plane_tol))
    if len(ha) < 2 or len(hb) < 2:
        raise ValueError("fewer than 2 interface nodes on a side")
    t_axes = [d for d in range(grid_a.points.shape[1]) if d != axis]
    ta = grid_a.points[np.ix_(ha, t_axes)]
    tb = grid_b.points[np.ix_(hb, t_axes)]
    nbr_a, w_a = _interface_interp(ta, tb)
    nbr_b, w_b = _interface_interp(tb, ta)
    return SimplexInterfaceMaps(
        idx_a=ha.astype(np.int32), idx_b=hb.astype(np.int32),
        nbr_a=nbr_a, w_a=w_a, nbr_b=nbr_b, w_b=w_b)


def interface_is_conforming(maps: SimplexInterfaceMaps, grid_a: SimplexGrid,
                            grid_b: SimplexGrid, tol: float = 1e-9) -> bool:
    """True iff the two interface node sets are collocated: equal counts,
    each a node within ``tol`` of a b node. Shared corner nodes alone make
    a naive collocated pairing succeed, so the whole interface is checked."""
    if len(maps.idx_a) != len(maps.idx_b):
        return False
    from scipy.spatial import cKDTree

    d, _ = cKDTree(grid_b.points[maps.idx_b]).query(
        grid_a.points[maps.idx_a], k=1)
    return bool(d.max() <= tol)


def init_simplex_bonded_nc(maps: SimplexInterfaceMaps, dtype=torch.float32,
                           device="cpu") -> Dict[str, torch.Tensor]:
    """Per-side bond masks over the interface node sets, all bonded."""
    return {"a": torch.ones(len(maps.idx_a), dtype=dtype, device=device),
            "b": torch.ones(len(maps.idx_b), dtype=dtype, device=device)}


def apply_simplex_contact_nc_post(
    spec: SimplexContactSpec, model, maps: SimplexInterfaceMaps,
    u_old_a: torch.Tensor, u_a: torch.Tensor, u_old_b: torch.Tensor,
    u_b: torch.Tensor, view_a, view_b, bonded: Optional[Dict],
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """One non-conforming contact's interface solve, per side through the
    static tables of ``maps``: each side solves with its own outgoing
    invariant and impedance and the other side's interpolated at its
    nodes. Arguments and the in-place writes as
    :func:`apply_simplex_contact_post`; the bond masks are per side."""
    st = model.stage(spec.axis)
    nax = st.axis
    _require_normal_pair(spec, st.pairs, nax)
    sign = model.sign
    idx_a, idx_b = _on(maps.idx_a, u_a), _on(maps.idx_b, u_b)
    nbr_a, nbr_b = _on(maps.nbr_a, u_a), _on(maps.nbr_b, u_b)
    w_a, w_b = _on(maps.w_a, u_a, u_a.dtype), _on(maps.w_b, u_b, u_a.dtype)

    def interp(vals, nbr, w):
        return (vals[nbr] * w).sum(dim=1)

    glue_a = (bonded["a"] > 0.5) if bonded is not None else None
    glue_b = (bonded["b"] > 0.5) if bonded is not None else None
    s_n = {"a": None, "b": None}
    sigma_c = {"a": None, "b": None}
    fixed_a: Dict[int, torch.Tensor] = {}
    fixed_b: Dict[int, torch.Tensor] = {}
    pairs = {k: (None, None, p) for k, p in enumerate(st.pairs)}
    for k in _split_normal(pairs, nax):
        p = st.pairs[k]
        is_normal = p.traction_axis == nax
        z_a = view_a.pair_z[k][idx_a]
        z_b = view_b.pair_z[k][idx_b]
        out_a = u_a[p.sigma][idx_a] - sign * z_a * u_a[p.vel][idx_a]
        out_b = u_b[p.sigma][idx_b] + sign * z_b * u_b[p.vel][idx_b]
        in_a, _, s_a = _pair_incoming(
            spec, is_normal, out_a, interp(out_b, nbr_a, w_a), z_a,
            interp(z_b, nbr_a, w_a), glue_a, sigma_c["a"])
        _, in_b, s_b = _pair_incoming(
            spec, is_normal, interp(out_a, nbr_b, w_b), out_b,
            interp(z_a, nbr_b, w_b), z_b, glue_b, sigma_c["b"])
        if is_normal:
            s_n = {"a": s_a, "b": s_b}
            sigma_c = {"a": torch.clamp(-s_a, min=0.0),
                       "b": torch.clamp(-s_b, min=0.0)}
        fixed_a[p.sigma], fixed_b[p.sigma] = _set_pair(
            sign, u_a, u_b, p, idx_a, idx_b, z_a, z_b, out_a, out_b, in_a,
            in_b)
    _repropagate_zeros(st, u_old_a, u_a, view_a, idx_a, fixed_a)
    _repropagate_zeros(st, u_old_b, u_b, view_b, idx_b, fixed_b)

    if bonded is None or spec.tensile_strength is None:
        return u_a, u_b, bonded
    return u_a, u_b, {
        side: bonded[side] * (s_n[side] <= spec.tensile_strength).to(
            bonded[side].dtype) for side in ("a", "b")}
