"""Characteristic border conditions as boundary-slab corrections.

Counterpart of ``gcm_tpu/solver/boundary.py`` (``face_index``,
``apply_borders_post``, ``correct_pair_at_face``). With ``w_L = A + s z B`` (speed −c, leaves at the
low face) and ``w_R = A − s z B`` (speed +c, enters at the low face):

Low face (side=0), known outgoing ``w_L``:
    absorbing       : w_R = 0
    free            : A = 0      -> w_R = −w_L
    fixed_force  F  : A = F      -> w_R = 2F − w_L
    fixed_velocity V: B = V      -> w_R = w_L − 2 s z V
High face (side=1) mirrors with L<->R and ``w_L = w_R + 2 s z V``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gcm_tpu_torch.task import BorderSpec


def face_index(ax: int, side: int) -> Tuple:
    """Index tuple selecting the boundary slab of a spatial-rank tensor."""
    return (slice(None),) * ax + (0 if side == 0 else -1,)


def apply_borders_post(model, u_old: torch.Tensor, u_raw: torch.Tensor,
                       mat, axis: int, borders,
                       active: Tuple[bool, bool] = (True, True)
                       ) -> torch.Tensor:
    """Reproduce a sweep with borders from the same sweep without them.

    The pair reconstruction is invertible (w_L = A + s z B, w_R = A - s z B),
    so the border correction can follow a raw sweep: recompute the slab
    invariants from the raw update, replace the incoming one, reconstruct,
    and re-propagate the zero-speed invariants on the slab. Only the sides
    ``active`` says (a shard on that domain face) are corrected. Returns a
    new tensor.
    """
    st = model.stage(axis)
    sign = model.sign
    view = mat.axis_view(axis, st)
    u_new = u_raw.clone()
    for side in (0, 1):
        bc = borders.get((axis, side)) if borders else None
        if bc is None or not active[side]:
            continue
        idx = face_index(axis, side)
        sigma_fixed = {}
        for k, p in enumerate(st.pairs):
            z_b = view.pair_z[k][idx]
            A_b = u_new[p.sigma][idx]
            B_b = u_new[p.vel][idx]
            szb = sign * z_b
            w_l = A_b + szb * B_b
            w_r = A_b - szb * B_b
            val = bc.pair_value(p.traction_axis, st.axis)
            out = w_l if side == 0 else w_r
            if bc.kind == "absorbing":
                inc = torch.zeros_like(out)
            elif bc.kind == "free":
                inc = -out
            elif bc.kind == "fixed_force":
                inc = 2.0 * val - out
            elif bc.kind == "fixed_velocity":
                s = -1.0 if side == 0 else 1.0
                inc = out + s * 2.0 * sign * z_b * val
            else:  # pragma: no cover
                raise ValueError(bc.kind)
            w_l2, w_r2 = (w_l, inc) if side == 0 else (inc, w_r)
            A2 = 0.5 * (w_l2 + w_r2)
            B2 = torch.where(
                z_b > 0,
                sign * (w_l2 - w_r2) / (2.0 * torch.clamp(z_b, min=1e-30)),
                B_b)
            u_new[(p.sigma,) + idx] = A2
            u_new[(p.vel,) + idx] = B2
            sigma_fixed[p.sigma] = A2
        for j, zc in enumerate(st.zeros):
            if zc.src in sigma_fixed:
                kap = view.zero_kappa[j][idx]
                u_new[(zc.comp,) + idx] = u_old[zc.comp][idx] + kap * (
                    sigma_fixed[zc.src] - u_old[zc.src][idx])
    return u_new


def correct_pair_at_face(w_l: torch.Tensor, w_r: torch.Tensor,
                         z: torch.Tensor, sign: int, bc: BorderSpec, ax: int,
                         side: int, value: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overwrite the incoming invariant of one pair on one face. Returns new
    tensors; the inputs are left as they were."""
    idx = face_index(ax, side)
    out = (w_l if side == 0 else w_r)[idx]
    if bc.kind == "absorbing":
        inc = torch.zeros_like(out)
    elif bc.kind == "free":
        inc = -out
    elif bc.kind == "fixed_force":
        inc = 2.0 * value - out
    elif bc.kind == "fixed_velocity":
        s = -1.0 if side == 0 else 1.0
        inc = out + s * 2.0 * sign * z[idx] * value
    else:  # pragma: no cover
        raise ValueError(bc.kind)
    if side == 0:
        w_r = w_r.clone()
        w_r[idx] = inc
    else:
        w_l = w_l.clone()
        w_l[idx] = inc
    return w_l, w_r
