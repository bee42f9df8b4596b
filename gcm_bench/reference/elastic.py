"""The plain reference of the grid-characteristic step, in plain PyTorch.

It judges the program's output and imports nothing of the program: the
velocity-stress system of isotropic elastic media, split along each axis
into P and S characteristic pairs and zero-speed invariants, advanced by
order-``k`` Lagrange interpolation at the characteristics' feet with edge
clamping, absorbing and free borders as corrections of the incoming
invariant on a face, and bonded contacts between two bodies (the adhesion
solve of the two impedances, and fracture to a free crack where the normal
traction exceeds the strength). It follows the closed forms of
``SURVEY.md`` section 0, the semantics the program also implements.

Everything is computed in one floating type, given by the caller: float64
for the reference, a lower one for the control that must fail the check.

A block is a box of each body's grid. ``faces`` names the border of each of
its faces that is a face of the domain (a face cut out of a larger grid
gets none, and its rows are wrong by the stencil's reach a sweep: callers
keep a halo that covers it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = "xyz"
_Z_EPS = 1e-30

#: Lagrange offsets (in units of the direction) of each order's stencil
_OFFSETS = {1: (0, 1), 2: (-1, 0, 1), 3: (-1, 0, 1, 2), 4: (-2, -1, 0, 1, 2)}


def components(dim: int) -> Tuple[str, ...]:
    """State components: velocities, then the stress tensor's upper
    triangle in row-major order (3D: vx vy vz sxx sxy sxz syy syz szz)."""
    vel = tuple(f"v{AXES[i]}" for i in range(dim))
    sig = tuple(f"s{AXES[i]}{AXES[j]}" for i in range(dim)
                for j in range(i, dim))
    return vel + sig


def stage_structure(dim: int, axis: int):
    """``(pairs, zeros)`` of a sweep along ``axis``: each pair is
    ``(stress comp, velocity comp, wave, traction axis)`` with the normal
    (P) pair first; each zero-speed invariant ``(comp, source comp)``:
    ``sigma_bb - kappa sigma_aa`` is frozen during the sweep."""
    idx = {n: k for k, n in enumerate(components(dim))}

    def s(i, j):
        i, j = min(i, j), max(i, j)
        return idx[f"s{AXES[i]}{AXES[j]}"]

    pairs = [(s(axis, axis), idx[f"v{AXES[axis]}"], "p", axis)]
    pairs += [(s(axis, b), idx[f"v{AXES[b]}"], "s", b)
              for b in range(dim) if b != axis]
    zeros = [(s(b, b), s(axis, axis)) for b in range(dim) if b != axis]
    return pairs, zeros


def weights(order: int, t):
    """Lagrange weights at the foot ``t`` cells away, one per offset of
    ``_OFFSETS[order]``."""
    if order == 1:
        return (1.0 - t, t)
    if order == 2:
        return (0.5 * t * (t - 1.0), 1.0 - t * t, 0.5 * t * (t + 1.0))
    if order == 3:
        return (-t * (t - 1.0) * (t - 2.0) / 6.0,
                (t + 1.0) * (t - 1.0) * (t - 2.0) / 2.0,
                -(t + 1.0) * t * (t - 2.0) / 2.0,
                (t + 1.0) * t * (t - 1.0) / 6.0)
    if order == 4:
        return ((t + 1.0) * t * (t - 1.0) * (t - 2.0) / 24.0,
                -(t + 2.0) * t * (t - 1.0) * (t - 2.0) / 6.0,
                (t + 2.0) * (t + 1.0) * (t - 1.0) * (t - 2.0) / 4.0,
                -(t + 2.0) * (t + 1.0) * t * (t - 2.0) / 6.0,
                (t + 2.0) * (t + 1.0) * t * (t - 1.0) / 24.0)
    raise ValueError(f"order {order}: the reference has orders 1-4")


def radius(order: int) -> int:
    """Cells a sweep reaches along its axis."""
    return max(abs(o) for o in _OFFSETS[order])


@dataclasses.dataclass
class Medium:
    """Per-node characteristic fields of an isotropic medium, each
    broadcastable to the block's spatial shape (extent 1 along an axis on
    which it does not vary)."""

    cp: torch.Tensor
    cs: torch.Tensor
    zp: torch.Tensor
    zs: torch.Tensor
    kappa: torch.Tensor

    @staticmethod
    def from_speeds(rho, cp, cs) -> "Medium":
        lam = rho * cp * cp - 2.0 * rho * cs * cs
        return Medium(cp=cp, cs=cs, zp=rho * cp, zs=rho * cs,
                      kappa=lam / (lam + 2.0 * rho * cs * cs))

    def c(self, wave: str):
        return self.cp if wave == "p" else self.cs

    def z(self, wave: str):
        return self.zp if wave == "p" else self.zs

    def cut(self, axis: int, start: int, stop: int) -> "Medium":
        """The fields of the nodes ``start:stop`` along ``axis`` (spatial
        axis numbering)."""
        def take(f):
            if f.shape[axis] == 1:
                return f
            return f.narrow(axis, start, stop - start)
        return Medium(**{k: take(getattr(self, k))
                         for k in ("cp", "cs", "zp", "zs", "kappa")})


def _edge_pad(f: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    n = f.shape[axis]
    lo, hi = f.narrow(axis, 0, 1), f.narrow(axis, n - 1, 1)
    return torch.cat([lo] * r + [f] + [hi] * r, dim=axis)


def _at_foot(fp: torch.Tensor, wts, direction: int, order: int, axis: int,
             r: int, n: int) -> torch.Tensor:
    out = None
    for o, w in zip(_OFFSETS[order], wts):
        term = w * fp.narrow(axis, r + direction * o, n)
        out = term if out is None else out + term
    return out


def _face(axis: int, side: int, ndim: int) -> Tuple:
    return (slice(None),) * axis + (0 if side == 0 else -1,) + (
        slice(None),) * (ndim - axis - 1)


def _broadcast_face(z: torch.Tensor, idx: Tuple) -> torch.Tensor:
    """``z[idx]`` where ``z`` may have extent 1 along the face's axis."""
    fixed = tuple(0 if (not isinstance(i, slice) and z.shape[a] == 1) else i
                  for a, i in enumerate(idx))
    return z[fixed]


def invariants(u: torch.Tensor, med: Medium, dt: float, h: float,
               axis: int, order: int) -> List[list]:
    """Per pair of the sweep along ``axis``: ``[w_l, w_r, pair]``, the new
    Riemann invariants at every node before any border or contact."""
    pairs, _ = stage_structure(u.dim() - 1, axis)
    r, n = radius(order), u.shape[1 + axis]
    out = []
    for p in pairs:
        sg, vl, wave, _ = p
        nu = med.c(wave) * (dt / h)
        z = med.z(wave)
        wts = weights(order, nu)
        Ap, Bp = _edge_pad(u[sg], axis, r), _edge_pad(u[vl], axis, r)
        a_p = _at_foot(Ap, wts, +1, order, axis, r, n)
        b_p = _at_foot(Bp, wts, +1, order, axis, r, n)
        a_m = _at_foot(Ap, wts, -1, order, axis, r, n)
        b_m = _at_foot(Bp, wts, -1, order, axis, r, n)
        out.append([a_p + z * b_p, a_m - z * b_m, p])
    return out


def border(w: list, axis: int, side: int, kind: str) -> None:
    """The incoming invariant of each pair on face ``(axis, side)``, in
    place: 0 on an absorbing face, minus the outgoing one on a free face
    (zero traction)."""
    for item in w:
        w_l, w_r = item[0], item[1]
        idx = _face(axis, side, w_l.dim())
        out = (w_l if side == 0 else w_r)[idx]
        if kind == "absorbing":
            inc = torch.zeros_like(out)
        elif kind == "free":
            inc = -out
        else:
            raise ValueError(f"border {kind!r}: the reference has "
                             "absorbing and free borders")
        tgt = w_r if side == 0 else w_l
        tgt = tgt.clone()
        tgt[idx] = inc
        item[1 if side == 0 else 0] = tgt


def rebuild(u: torch.Tensor, w: list, med: Medium, axis: int
            ) -> torch.Tensor:
    """The state after the sweep from the invariants ``w``: each pair's
    stress and velocity, the zero-speed invariants from the new normal
    stress, the rest carried over."""
    _, zeros = stage_structure(u.dim() - 1, axis)
    comps: Dict[int, torch.Tensor] = {}
    for w_l, w_r, (sg, vl, wave, _) in w:
        z = med.z(wave)
        comps[sg] = 0.5 * (w_l + w_r)
        comps[vl] = torch.where(
            z > 0, (w_l - w_r) / (2.0 * torch.clamp(z, min=_Z_EPS)), u[vl])
    for comp, src in zeros:
        comps[comp] = u[comp] + med.kappa * (comps[src] - u[src])
    return torch.stack([comps.get(i, u[i]) for i in range(u.shape[0])])


@dataclasses.dataclass
class Contact:
    """A bonded contact between ``body_a``'s high face and ``body_b``'s low
    face on ``axis`` (whole faces, collocated nodes); with ``strength`` a
    node whose normal traction exceeds it breaks for good into a free
    crack."""

    body_a: str
    body_b: str
    axis: int
    strength: Optional[float] = None


def _adhesion(a, b, z_a, z_b):
    denom = torch.clamp(z_a + z_b, min=_Z_EPS)
    v = (b - a) / denom
    s = (z_b * a + z_a * b) / denom
    return s + z_a * v, s - z_b * v, s


def contact_solve(c: Contact, wa: list, wb: list, bonded):
    """The interface solve of one contact on the raw invariants of both
    bodies' sweeps along its axis, in place: the normal pair first, then
    each tangential pair; the new bond mask."""
    nd = wa[0][0].dim()
    ia, ib = _face(c.axis, 1, nd), _face(c.axis, 0, nd)
    glue = bonded > 0.5 if bonded is not None else None
    s_normal = None
    for k, (pa, pb) in enumerate(zip(wa, wb)):
        out_a, out_b = pa[1][ia], pb[0][ib]
        z_a = _broadcast_face(pa[3], ia)
        z_b = _broadcast_face(pb[3], ib)
        in_a, in_b, s = _adhesion(out_a, out_b, z_a, z_b)
        if glue is not None:
            in_a = torch.where(glue, in_a, -out_a)
            in_b = torch.where(glue, in_b, -out_b)
        if k == 0:
            s_normal = s
        la, rb = pa[0].clone(), pb[1].clone()
        la[ia], rb[ib] = in_a, in_b
        pa[0], pb[1] = la, rb
    if bonded is None or c.strength is None:
        return bonded
    return bonded * (s_normal <= c.strength).to(bonded.dtype)


@dataclasses.dataclass
class Block:
    """One body's box: its state ``[C, *spatial]``, medium and the borders
    of the faces that are faces of the domain, ``{(axis, side): kind}``."""

    u: torch.Tensor
    med: Medium
    h: Tuple[float, ...]
    faces: Dict[Tuple[int, int], str]


def sweep(blocks: Dict[str, Block], contacts: Sequence[Contact],
          bonded: Dict[int, torch.Tensor], dt: float, axis: int,
          order: int) -> Dict[int, torch.Tensor]:
    """One sweep along ``axis`` of every block, coupled by the contacts on
    that axis between two of them; updates the blocks' states in place and
    returns the new bond masks."""
    on = [(ci, c) for ci, c in enumerate(contacts) if c.axis == axis
          and c.body_a in blocks and c.body_b in blocks]
    consumed = {(c.body_a, c.axis, 1) for _, c in on}
    consumed |= {(c.body_b, c.axis, 0) for _, c in on}
    ws = {}
    for name, b in blocks.items():
        w = invariants(b.u, b.med, dt, b.h[axis], axis, order)
        for item in w:
            item.append(b.med.z(item[2][2]))
        for side in (0, 1):
            kind = b.faces.get((axis, side))
            if kind is not None and (name, axis, side) not in consumed:
                border(w, axis, side, kind)
        ws[name] = w
    bonded = dict(bonded)
    for ci, c in on:
        bonded[ci] = contact_solve(c, ws[c.body_a], ws[c.body_b],
                                   bonded.get(ci))
    for name, b in blocks.items():
        b.u = rebuild(b.u, [item[:3] for item in ws[name]], b.med, axis)
    return bonded


def axes_of_step(n: int, fwd: Sequence[int], symmetrize: bool
                 ) -> Tuple[int, ...]:
    """The sweep order of step ``n`` (0-based): ``fwd``, reversed on odd
    steps when the splitting is symmetrized."""
    return tuple(fwd)[::-1] if symmetrize and n % 2 == 1 else tuple(fwd)


def ricker(t: np.ndarray, f0: float, t0: float, amplitude: float
           ) -> np.ndarray:
    a = (np.pi * f0 * (t - t0)) ** 2
    return amplitude * (1.0 - 2.0 * a) * np.exp(-a)
