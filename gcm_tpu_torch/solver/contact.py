"""Contact and fracture between bodies: paired characteristic face solves.

Counterpart of ``gcm_tpu/solver/contact.py``. Two bodies meet along a
grid-conforming interface: body_a's high face and body_b's low face on the
contact axis, with collocated interface nodes, over the whole faces or an
offset sub-rectangle of each (``lo_a``/``lo_b``/``span``); face nodes
outside the overlap keep the body's own border condition.

During the sweep along the contact axis the incoming invariant of each
body's face comes from the two-impedance interface solve instead of a border
condition. With outgoing invariants a = w_R of body_a and b = w_L of body_b,
adhesion (continuity of traction and velocity) gives

    v*     = (b - a) / (z_a + z_b)
    sigma* = (z_b a + z_a b) / (z_a + z_b)

and the incoming invariants w_L(a) = sigma* + z_a v*, w_R(b) = sigma* - z_b
v*. Kinds: ``bonded`` (adhesion on every pair), ``slip`` (adhesion on the
normal pair, free tangential pairs), ``friction`` (a unilateral normal pair
and a Coulomb cap per tangential pair). Fracture: a per-node bond mask turns
permanently to broken (``broken_kind`` free, slip or friction) where the
normal traction exceeds ``tensile_strength``.

The normal pair is found by its ``traction_axis`` against the PHYSICAL
axis of the sweep's stage, never an array axis. Everything is dense masked
tensor math on face slabs; the inputs are never written.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

CONTACT_KINDS = ("bonded", "slip", "friction")


@dataclasses.dataclass(frozen=True)
class ContactSpec:
    """Contact between body_a's high face and body_b's low face on ``axis``.

    ``lo_a``/``lo_b``/``span`` (transverse node index tuples, one entry per
    non-contact axis in increasing-axis order) restrict the interface to a
    sub-rectangle of each face; ``None`` means full faces. With
    ``tensile_strength`` set, fracture is on: interface nodes whose normal
    traction sigma* (tension positive) exceeds it break for good and behave
    as ``broken_kind`` ('free', 'slip' or 'friction'). ``friction_mu`` is
    the Coulomb coefficient of ``kind='friction'`` and of friction cracks.
    """

    body_a: str
    body_b: str
    axis: int
    kind: str = "bonded"
    tensile_strength: Optional[float] = None
    broken_kind: str = "free"
    lo_a: Optional[Tuple[int, ...]] = None
    lo_b: Optional[Tuple[int, ...]] = None
    span: Optional[Tuple[int, ...]] = None
    friction_mu: float = 0.0

    def __post_init__(self):
        if self.kind not in CONTACT_KINDS:
            raise ValueError(f"unknown contact kind {self.kind!r}")
        if self.broken_kind not in ("free", "slip", "friction"):
            raise ValueError(f"unknown broken kind {self.broken_kind!r}")
        given = (self.lo_a, self.lo_b, self.span)
        if any(g is not None for g in given) and any(g is None for g in given):
            raise ValueError("lo_a, lo_b and span must be given together")


def face_sub_index(ax: int, side: int, dim: int,
                   lo: Optional[Tuple[int, ...]],
                   span: Optional[Tuple[int, ...]]) -> Tuple:
    """Index tuple selecting the (sub-rectangle of the) boundary face."""
    idx = []
    t = 0
    for d in range(dim):
        if d == ax:
            idx.append(0 if side == 0 else -1)
        elif lo is None:
            idx.append(slice(None))
        else:
            idx.append(slice(lo[t], lo[t] + span[t]))
            t += 1
    return tuple(idx)


def _adhesion(a, b, z_a, z_b):
    """Interface solve: (w_in_a, w_in_b, sigma*) for the glued case."""
    denom = torch.clamp(z_a + z_b, min=1e-30)
    v_star = (b - a) / denom
    s_star = (z_b * a + z_a * b) / denom
    return s_star + z_a * v_star, s_star - z_b * v_star, s_star


def _pair_incoming(spec: ContactSpec, is_normal: bool, out_a, out_b, z_a,
                   z_b, glue, sigma_c):
    """Incoming invariants of one pair from the outgoing ones: the kind,
    fracture and unilateral logic in one place. ``sigma_c`` is the contact
    compression of the normal solve (read by tangential friction pairs).
    Returns (in_a, in_b, sigma*)."""
    in_a_glued, in_b_glued, s_star = _adhesion(out_a, out_b, z_a, z_b)
    in_a_free = -out_a
    in_b_free = -out_b

    def unilateral():
        # adhesion while in compression, traction-free when open
        closed = s_star < 0.0
        return (torch.where(closed, in_a_glued, in_a_free),
                torch.where(closed, in_b_glued, in_b_free))

    def coulomb_tangential(mu):
        # stick while |tau*| <= mu sigma_c, else slide at the capped
        # traction (the same prescribed traction on both sides)
        cap = mu * sigma_c
        stick = torch.abs(s_star) <= cap
        tau_c = torch.sign(s_star) * cap
        return (torch.where(stick, in_a_glued, 2.0 * tau_c - out_a),
                torch.where(stick, in_b_glued, 2.0 * tau_c - out_b))

    if spec.kind == "bonded":
        intact_a, intact_b = in_a_glued, in_b_glued
    elif spec.kind == "slip":
        if is_normal:
            intact_a, intact_b = in_a_glued, in_b_glued
        else:
            intact_a, intact_b = in_a_free, in_b_free
    elif is_normal:   # friction
        intact_a, intact_b = unilateral()
    else:
        intact_a, intact_b = coulomb_tangential(spec.friction_mu)

    if glue is None:
        return intact_a, intact_b, s_star
    # broken: 'free' cracks are traction-free; 'slip' cracks still carry
    # compression on the normal pair; 'friction' cracks are Coulomb contacts
    if is_normal and spec.broken_kind in ("slip", "friction"):
        broken_a, broken_b = unilateral()
    elif not is_normal and spec.broken_kind == "friction":
        broken_a, broken_b = coulomb_tangential(spec.friction_mu)
    else:
        broken_a, broken_b = in_a_free, in_b_free
    return (torch.where(glue, intact_a, broken_a),
            torch.where(glue, intact_b, broken_b), s_star)


def _split_normal(pairs: Dict[int, tuple], ax: int):
    """Pair indices with the normal pair (traction_axis == ax) first."""
    keys = sorted(pairs)
    normal = [k for k in keys if pairs[k][2].traction_axis == ax]
    return normal + [k for k in keys if k not in normal]


def _require_normal_pair(spec, pair_specs, ax: int) -> None:
    """Friction reads the normal solve's sigma_c before any tangential pair:
    a stage without a pair whose traction_axis is the contact axis cannot
    take it."""
    needs = (spec.kind == "friction"
             or getattr(spec, "broken_kind", None) == "friction")
    if needs and not any(p.traction_axis == ax for p in pair_specs):
        raise ValueError(
            f"friction contact on axis {ax} requires a characteristic pair "
            "with traction_axis == axis (the normal solve feeds the Coulomb "
            "cap), but this model's stage has none")


def _fracture(spec: ContactSpec, bonded, s_star_n):
    if bonded is None or s_star_n is None or spec.tensile_strength is None:
        return bonded
    still = (s_star_n <= spec.tensile_strength).to(bonded.dtype)
    return bonded * still


def _set(t: torch.Tensor, idx: Tuple, value: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with ``t[idx] = value`` (JAX's ``.at[idx].set``)."""
    t = t.clone()
    t[idx] = value
    return t


def apply_contact(spec: ContactSpec, dim: int, pairs_a: Dict[int, tuple],
                  pairs_b: Dict[int, tuple], view_a, view_b,
                  bonded: Optional[torch.Tensor],
                  normal_axis: Optional[int] = None):
    """One contact's interface solves on both bodies' invariants.

    ``pairs_*``: pair index -> (w_l, w_r, PairSpec), full-domain invariants
    of the raw sweep along ``spec.axis``. The normal pair is solved first
    (its sigma* feeds the unilateral, friction and fracture logic), then
    each tangential pair. ``normal_axis`` is the physical axis of the
    sweep's stage (default ``spec.axis``). Returns the updated dicts (new
    tensors) and the new bond mask (or None)."""
    ax = spec.axis
    nax = normal_axis if normal_axis is not None else ax
    _require_normal_pair(spec, [pairs_a[k][2] for k in pairs_a], nax)
    idx_a = face_sub_index(ax, 1, dim, spec.lo_a, spec.span)
    idx_b = face_sub_index(ax, 0, dim, spec.lo_b, spec.span)
    glue = (bonded > 0.5) if bonded is not None else None
    s_star_n = None
    sigma_c = None
    pairs_a, pairs_b = dict(pairs_a), dict(pairs_b)
    for k in _split_normal(pairs_a, nax):
        is_normal = pairs_a[k][2].traction_axis == nax
        w_l_a, w_r_a, p = pairs_a[k]
        w_l_b, w_r_b, pb = pairs_b[k]
        in_a, in_b, s_star = _pair_incoming(
            spec, is_normal, w_r_a[idx_a], w_l_b[idx_b],
            view_a.pair_z[k][idx_a], view_b.pair_z[k][idx_b], glue, sigma_c)
        if is_normal:
            s_star_n = s_star
            sigma_c = torch.clamp(-s_star, min=0.0)
        pairs_a[k] = (_set(w_l_a, idx_a, in_a), w_r_a, p)
        pairs_b[k] = (w_l_b, _set(w_r_b, idx_b, in_b), pb)
    return pairs_a, pairs_b, _fracture(spec, bonded, s_star_n)


def apply_contact_post(spec: ContactSpec, model, u_old_a: torch.Tensor,
                       u_a: torch.Tensor, u_old_b: torch.Tensor,
                       u_b: torch.Tensor, view_a, view_b,
                       bonded: Optional[torch.Tensor],
                       idx_axis: Optional[int] = None):
    """The contact solve as a fixup after raw (border- and contact-free)
    sweeps: the pair reconstruction is invertible, so the interface
    condition follows from the face slabs alone. ``u_old_*`` are the
    pre-sweep states (the zero-speed invariants are re-propagated from
    them); ``idx_axis`` is the array dimension of the interface normal when
    it differs from ``spec.axis``. Returns new states and the new bond mask
    (or None)."""
    ax = spec.axis
    dim = model.dim
    st = model.stage(ax)
    nax = st.axis
    _require_normal_pair(spec, st.pairs, nax)
    sign = model.sign
    ax_idx = idx_axis if idx_axis is not None else ax
    idx_a = face_sub_index(ax_idx, 1, dim, spec.lo_a, spec.span)
    idx_b = face_sub_index(ax_idx, 0, dim, spec.lo_b, spec.span)
    glue = (bonded > 0.5) if bonded is not None else None
    s_star_n = None
    sigma_c = None
    sigma_fixed_a: Dict[int, torch.Tensor] = {}
    sigma_fixed_b: Dict[int, torch.Tensor] = {}
    pairs = {k: (None, None, p) for k, p in enumerate(st.pairs)}
    u_a, u_b = u_a.clone(), u_b.clone()
    for k in _split_normal(pairs, nax):
        p = st.pairs[k]
        is_normal = p.traction_axis == nax
        z_a = view_a.pair_z[k][idx_a]
        z_b = view_b.pair_z[k][idx_b]
        A_a, B_a = u_a[p.sigma][idx_a], u_a[p.vel][idx_a]
        A_b, B_b = u_b[p.sigma][idx_b], u_b[p.vel][idx_b]
        out_a = A_a - sign * z_a * B_a      # w_R at body_a's high face
        out_b = A_b + sign * z_b * B_b      # w_L at body_b's low face
        in_a, in_b, s_star = _pair_incoming(spec, is_normal, out_a, out_b,
                                            z_a, z_b, glue, sigma_c)
        if is_normal:
            s_star_n = s_star
            sigma_c = torch.clamp(-s_star, min=0.0)
        A_a2 = 0.5 * (in_a + out_a)
        B_a2 = torch.where(z_a > 0, sign * (in_a - out_a)
                           / (2.0 * torch.clamp(z_a, min=1e-30)), B_a)
        A_b2 = 0.5 * (out_b + in_b)
        B_b2 = torch.where(z_b > 0, sign * (out_b - in_b)
                           / (2.0 * torch.clamp(z_b, min=1e-30)), B_b)
        u_a[(p.sigma,) + idx_a] = A_a2
        u_a[(p.vel,) + idx_a] = B_a2
        u_b[(p.sigma,) + idx_b] = A_b2
        u_b[(p.vel,) + idx_b] = B_b2
        sigma_fixed_a[p.sigma] = A_a2
        sigma_fixed_b[p.sigma] = A_b2

    # re-propagate the zero-speed invariants at the fixed face slabs
    for j, zc in enumerate(st.zeros):
        if zc.src in sigma_fixed_a:
            kap_a = view_a.zero_kappa[j][idx_a]
            u_a[(zc.comp,) + idx_a] = u_old_a[zc.comp][idx_a] + kap_a * (
                sigma_fixed_a[zc.src] - u_old_a[zc.src][idx_a])
            kap_b = view_b.zero_kappa[j][idx_b]
            u_b[(zc.comp,) + idx_b] = u_old_b[zc.comp][idx_b] + kap_b * (
                sigma_fixed_b[zc.src] - u_old_b[zc.src][idx_b])
    return u_a, u_b, _fracture(spec, bonded, s_star_n)
