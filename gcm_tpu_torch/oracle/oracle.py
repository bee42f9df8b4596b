"""Straight-line, per-node NumPy oracle for the GCM physics.

Copy of ``gcm_tpu/oracle/oracle.py`` (numpy only), held by the port's tests
against its plain step: a deliberately naive, loop-based implementation of
the method - per-node characteristic decomposition frozen at the node-local
material, generic Lagrange interpolation along the sweep line (evaluated
from first principles, not shared with the solver's closed-form weights),
characteristic border corrections, and zero-speed invariant transport.

Conventions match ``gcm_tpu_torch.solver`` exactly (same contract):
- edge-clamped stencil indices at domain boundaries;
- border conditions applied as incoming-invariant overwrites *after* the
  interior interpolation, *before* zero-invariant updates;
- splitting order x,y,z with reversal on odd steps when symmetrized.

Slow by construction: use tiny grids in tests.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from gcm_tpu_torch.models.spec import Model, get_model
from gcm_tpu_torch.task import BorderSpec

_REL_OFFSETS = {1: (0, 1), 2: (-1, 0, 1), 3: (-1, 0, 1, 2), 4: (-2, -1, 0, 1, 2)}


def _lagrange_weights(points, t: float):
    """Generic Lagrange basis evaluation at ``t`` over node ``points``."""
    w = []
    for j, pj in enumerate(points):
        lj = 1.0
        for k, pk in enumerate(points):
            if k != j:
                lj *= (t - pk) / (pj - pk)
        w.append(lj)
    return w


def _interp_line(line: np.ndarray, i: int, direction: int, nu: float, order: int) -> float:
    """Value of a 1D line field at position ``i + direction*nu`` (cells)."""
    rel = _REL_OFFSETS[order]
    pts = [direction * r for r in rel]
    wts = _lagrange_weights(pts, direction * nu)
    n = line.shape[0]
    val = 0.0
    for p, w in zip(pts, wts):
        idx = min(max(i + p, 0), n - 1)  # edge clamp
        val += w * line[idx]
    return val


def _material_fields(rho, lam, mu):
    m2 = lam + 2.0 * mu
    cp = np.sqrt(m2 / rho)
    cs = np.sqrt(mu / rho)
    return {
        "cp": cp, "cs": cs,
        "zp": rho * cp, "zs": rho * cs,
        "kappa": lam / m2,
    }


def oracle_stage(
    model: Model,
    u: np.ndarray,
    rho: np.ndarray,
    lam: np.ndarray,
    mu: np.ndarray,
    dt: float,
    h: Tuple[float, ...],
    axis: int,
    order: int,
    borders: Optional[Dict[Tuple[int, int], BorderSpec]] = None,
) -> np.ndarray:
    """One characteristic sweep along ``axis``, node by node."""
    mats = _material_fields(np.asarray(rho, np.float64),
                            np.asarray(lam, np.float64),
                            np.asarray(mu, np.float64))
    u = np.asarray(u, np.float64)
    spatial = u.shape[1:]
    n_ax = spatial[axis]
    sgn = model.sign
    st = model.stage(axis)
    out = u.copy()

    # per-pair invariant fields (computed for every node, then BC-corrected)
    wl_all = {}
    wr_all = {}
    for k, p in enumerate(st.pairs):
        wl = np.zeros(spatial)
        wr = np.zeros(spatial)
        for idx in np.ndindex(*spatial):
            zname = "zp" if p.wave == "p" else "zs"
            cname = "cp" if p.wave == "p" else "cs"
            z = mats[zname][idx]
            nu = mats[cname][idx] * dt / h[axis]
            i = idx[axis]

            def line(comp):
                sl = list(idx)
                sl[axis] = slice(None)
                return u[(comp,) + tuple(sl)]

            A_line, B_line = line(p.sigma), line(p.vel)
            # w_L rides speed −c: foot at +nu; w_R rides +c: foot at −nu
            A_p = _interp_line(A_line, i, +1, nu, order)
            B_p = _interp_line(B_line, i, +1, nu, order)
            A_m = _interp_line(A_line, i, -1, nu, order)
            B_m = _interp_line(B_line, i, -1, nu, order)
            wl[idx] = A_p + sgn * z * B_p
            wr[idx] = A_m - sgn * z * B_m
        wl_all[k] = wl
        wr_all[k] = wr

    # characteristic border corrections (incoming-invariant overwrite)
    if borders:
        for k, p in enumerate(st.pairs):
            zname = "zp" if p.wave == "p" else "zs"
            for side in (0, 1):
                bc = borders.get((axis, side))
                if bc is None:
                    continue
                val = bc.pair_value(p.traction_axis, axis)
                bidx = 0 if side == 0 else n_ax - 1
                for idx in np.ndindex(*spatial):
                    if idx[axis] != bidx:
                        continue
                    z = mats[zname][idx]
                    if side == 0:
                        w_out = wl_all[k][idx]
                        if bc.kind == "absorbing":
                            w_in = 0.0
                        elif bc.kind == "free":
                            w_in = -w_out
                        elif bc.kind == "fixed_force":
                            w_in = 2.0 * val - w_out
                        elif bc.kind == "fixed_velocity":
                            w_in = w_out - 2.0 * sgn * z * val
                        wr_all[k][idx] = w_in
                    else:
                        w_out = wr_all[k][idx]
                        if bc.kind == "absorbing":
                            w_in = 0.0
                        elif bc.kind == "free":
                            w_in = -w_out
                        elif bc.kind == "fixed_force":
                            w_in = 2.0 * val - w_out
                        elif bc.kind == "fixed_velocity":
                            w_in = w_out + 2.0 * sgn * z * val
                        wl_all[k][idx] = w_in

    # reconstruction
    for k, p in enumerate(st.pairs):
        zname = "zp" if p.wave == "p" else "zs"
        for idx in np.ndindex(*spatial):
            z = mats[zname][idx]
            wl, wr = wl_all[k][idx], wr_all[k][idx]
            out[(p.sigma,) + idx] = 0.5 * (wl + wr)
            if z > 0:
                out[(p.vel,) + idx] = sgn * (wl - wr) / (2.0 * z)
            # z == 0: S pair in a fluid — velocity untouched

    # zero-speed invariants, using the final (post-BC) source stress
    for zc in st.zeros:
        out[zc.comp] = u[zc.comp] + mats["kappa"] * (out[zc.src] - u[zc.src])
    return out


def oracle_step(
    model: Model, u, rho, lam, mu, dt, h, order,
    borders=None, axes=None,
) -> np.ndarray:
    if axes is None:
        axes = range(model.dim)
    for a in axes:
        u = oracle_stage(model, u, rho, lam, mu, dt, h, a, order, borders)
    return u


def oracle_run(
    model_name: str, u, rho, lam, mu, dt, h, order, nsteps,
    borders=None, symmetrize=True,
) -> np.ndarray:
    model = get_model(model_name)
    for n in range(nsteps):
        axes = tuple(range(model.dim))
        if symmetrize and n % 2 == 1:
            axes = axes[::-1]
        u = oracle_step(model, u, rho, lam, mu, dt, h, order, borders, axes)
    return np.asarray(u)
