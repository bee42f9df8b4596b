"""Independent per-node NumPy oracle for orthotropic media.

Copy of ``gcm_tpu/oracle/oracle_ortho.py`` (numpy only). It never touches
the solver's closed-form pair algebra or ``models.spec``'s analytic
decompositions. Instead it

1. assembles the per-axis PDE Jacobian ``A_a`` directly from the physical
   velocity-stress equations (rho dv_i/dt = d_j sigma_ij;
   dsigma_ij/dt = C_ijkl d_k v_l) using the raw orthotropic stiffness
   constants c11..c66 in Voigt form,
2. eigendecomposes it **numerically** per node (np.linalg.eig + inverse:
   the textbook characteristic decomposition, nothing shared with the
   solver), and
3. advects each invariant semi-Lagrangianly: interpolate the raw component
   fields at the characteristic foot (same generic Lagrange weights and
   edge-clamp contract as the isotropic oracle), combine with the center
   node's left eigenvectors, reconstruct with its right eigenvectors.

Step 3's "interpolate components, combine at the center node's frozen
decomposition" is the shared *contract* with the solver (the standard GCM
linearization for heterogeneous media), not shared code.

No border conditions: oracle-vs-solver comparisons restrict to nodes whose
domain of dependence stays inside the grid (nsteps * stencil_radius cells
from every face). Slow by construction: tiny grids only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gcm_tpu_torch.materials import OrthotropicMaterial
from gcm_tpu_torch.models.spec import Model, get_model
from gcm_tpu_torch.oracle.oracle import _interp_line


def _voigt_index(i: int, j: int) -> int:
    """(i, j) tensor indices -> Voigt index 0..5 (xx,yy,zz,yz,xz,xy)."""
    if i == j:
        return i
    s = {i, j}
    return {frozenset({1, 2}): 3, frozenset({0, 2}): 4,
            frozenset({0, 1}): 5}[frozenset(s)]


def _stiffness_matrix(m: OrthotropicMaterial, dim: int) -> np.ndarray:
    """6x6 Voigt stiffness from the 9 orthotropic constants."""
    C = np.zeros((6, 6))
    C[0, 0], C[1, 1], C[2, 2] = m.c11, m.c22, m.c33
    C[0, 1] = C[1, 0] = m.c12
    C[0, 2] = C[2, 0] = m.c13
    C[1, 2] = C[2, 1] = m.c23
    C[3, 3], C[4, 4], C[5, 5] = m.c44, m.c55, m.c66
    return C


def build_jacobian(model: Model, m: OrthotropicMaterial,
                   axis: int) -> np.ndarray:
    """The PDE Jacobian A_axis for ``du/dt + A du/dx_axis = 0``.

    Assembled from the physical equations in the model's component order:
    velocities first, then the stress components named in comp_names.
    """
    dim = model.dim
    C = _stiffness_matrix(m, dim)
    names = model.comp_names
    A = np.zeros((model.ncomp, model.ncomp))
    ax_of = {"x": 0, "y": 1, "z": 2}

    def comp_of_sigma(i: int, j: int):
        a, b = sorted(("xyz"[i], "xyz"[j]))
        name = f"s{a}{b}"
        return names.index(name) if name in names else None

    # rho dv_i/dt = sum_j d_j sigma_ij  ->  A[v_i, sigma_{i,axis}] = -1/rho
    for i in range(dim):
        si = comp_of_sigma(i, axis)
        if si is not None:
            A[i, si] = -1.0 / m.rho
    # dsigma_ij/dt = C_ijkl d_k v_l ; the axis part: C_{ij,(axis l)} d_ax v_l
    for ci, name in enumerate(names):
        if not name.startswith("s"):
            continue
        i, j = ax_of[name[1]], ax_of[name[2]]
        vi = _voigt_index(i, j)
        for l in range(dim):
            A[ci, l] = -C[vi, _voigt_index(axis, l)]
    return A


def oracle_ortho_stage(
    model: Model,
    u: np.ndarray,
    mats: np.ndarray,            # object array of OrthotropicMaterial or
                                 # a single material (homogeneous)
    dt: float,
    h: Tuple[float, ...],
    axis: int,
    order: int,
) -> np.ndarray:
    """One characteristic sweep along ``axis``, node by node, numeric eig."""
    u = np.asarray(u, np.float64)
    spatial = u.shape[1:]
    out = np.empty_like(u)
    homogeneous = isinstance(mats, OrthotropicMaterial)

    cache = {}

    def decomp(m: OrthotropicMaterial):
        key = id(m)
        if key not in cache:
            A = build_jacobian(model, m, axis)
            vals, R = np.linalg.eig(A)
            assert np.abs(vals.imag).max() < 1e-9, "hyperbolicity lost"
            vals = vals.real
            R = R.real
            L = np.linalg.inv(R)
            cache[key] = (vals, R, L)
        return cache[key]

    for idx in np.ndindex(*spatial):
        m = mats if homogeneous else mats[idx]
        vals, R, L = decomp(m)
        i = idx[axis]

        def line(comp):
            sl = list(idx)
            sl[axis] = slice(None)
            return u[(comp,) + tuple(sl)]

        # component fields interpolated at each distinct characteristic
        # foot x - lambda*dt (shared per equal eigenvalue)
        foot_vals = {}
        w_new = np.empty(model.ncomp)
        for k in range(model.ncomp):
            lam = vals[k]
            nu = lam * dt / h[axis]
            key = round(nu, 14)
            if key not in foot_vals:
                if abs(nu) < 1e-14:
                    vec = u[(slice(None),) + idx]
                else:
                    direction = -1 if nu > 0 else +1
                    vec = np.array([
                        _interp_line(line(c), i, direction, abs(nu), order)
                        for c in range(model.ncomp)])
                foot_vals[key] = vec
            w_new[k] = L[k] @ foot_vals[key]
        out[(slice(None),) + idx] = R @ w_new
    return out


def oracle_ortho_run(
    model_name: str, u, mats, dt, h, order, nsteps,
    symmetrize: bool = True,
) -> np.ndarray:
    model = get_model(model_name)
    u = np.asarray(u, np.float64)
    for n in range(nsteps):
        axes = tuple(range(model.dim))
        if symmetrize and n % 2 == 1:
            axes = axes[::-1]
        for a in axes:
            u = oracle_ortho_stage(model, u, mats, dt, h, a, order)
    return u
