"""Material models and per-node material fields, on torch tensors.

Counterpart of ``gcm_tpu/materials.py``. Heterogeneous isotropic media are
per-node tensors of the derived characteristic quantities the sweeps consume
(wave speeds, impedances, the zero-invariant coupling ratio), so the hot path
does no divisions or square roots; orthotropic media keep rho and the nine
stiffnesses, and ``axis_view`` derives each sweep's quantities from them.
Both expose the ``axis_view``/``max_cp`` protocol the sweeps consume.

All quantities are SI: rho [kg/m^3], lambda/mu [Pa], speeds [m/s].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class IsotropicMaterial:
    """Linear isotropic elastic material (rho, Lame lambda, mu).

    For acoustic media set ``mu = 0`` (then ``c_p = sqrt(lambda/rho)``).
    """

    rho: float
    lam: float
    mu: float = 0.0

    @staticmethod
    def from_speeds(rho: float, cp: float, cs: float = 0.0) -> "IsotropicMaterial":
        mu = rho * cs * cs
        lam = rho * cp * cp - 2.0 * mu
        return IsotropicMaterial(rho=rho, lam=lam, mu=mu)

    @property
    def cp(self) -> float:
        return math.sqrt((self.lam + 2.0 * self.mu) / self.rho)

    @property
    def cs(self) -> float:
        return math.sqrt(self.mu / self.rho)


def _as_tensor(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


@dataclasses.dataclass
class MaterialFields:
    """Per-node derived characteristic fields (struct of tensors).

    - ``cp``, ``cs``  : P/S wave speeds (cs == 0 for acoustic media)
    - ``zp``, ``zs``  : impedances rho*cp, rho*cs
    - ``kappa``       : lambda/(lambda+2mu), couples the zero-speed stress
                        invariants to the P update
    - ``rho``         : density
    """

    cp: torch.Tensor
    cs: torch.Tensor
    zp: torch.Tensor
    zs: torch.Tensor
    kappa: torch.Tensor
    rho: torch.Tensor

    @staticmethod
    def from_arrays(rho, lam, mu, device="cpu",
                    dtype=torch.float32) -> "MaterialFields":
        """Derived fields from rho/lambda/mu arrays (numpy or torch),
        computed in ``dtype`` as the JAX package computes them."""
        rho = _as_tensor(rho, device, dtype)
        lam = _as_tensor(lam, device, dtype)
        mu = _as_tensor(mu, device, dtype)
        m2 = lam + 2.0 * mu
        cp = torch.sqrt(m2 / rho)
        cs = torch.sqrt(mu / rho)
        return MaterialFields(cp=cp, cs=cs, zp=rho * cp, zs=rho * cs,
                              kappa=lam / m2, rho=rho)

    @staticmethod
    def uniform(material: IsotropicMaterial, shape, device="cpu",
                dtype=torch.float32) -> "MaterialFields":
        ones = torch.ones(tuple(shape), device=device, dtype=dtype)
        return MaterialFields.from_arrays(
            material.rho * ones, material.lam * ones, material.mu * ones,
            device=device, dtype=dtype)

    def max_cp(self) -> float:
        return float(self.cp.max())

    def z(self, wave: str) -> torch.Tensor:
        return {"p": self.zp, "s": self.zs}[wave]

    def c(self, wave: str) -> torch.Tensor:
        return {"p": self.cp, "s": self.cs}[wave]

    def axis_view(self, axis: int, stage_spec) -> "AxisView":
        """Per-sweep-axis characteristic fields (isotropic: axis-independent)."""
        return AxisView(
            pair_c=[self.c(p.wave) for p in stage_spec.pairs],
            pair_z=[self.z(p.wave) for p in stage_spec.pairs],
            zero_kappa=[self.kappa for _ in stage_spec.zeros],
        )


@dataclasses.dataclass(frozen=True)
class OrthotropicMaterial:
    """Orthotropic elastic material: rho and the nine stiffnesses c_ij
    (Voigt; c44 yz, c55 xz, c66 xy shear). Along axis a the P speed is
    sqrt(c_aa/rho), the shear speeds sqrt(c44..66/rho)."""

    rho: float
    c11: float
    c12: float
    c13: float
    c22: float
    c23: float
    c33: float
    c44: float  # yz shear
    c55: float  # xz shear
    c66: float  # xy shear

    @staticmethod
    def from_isotropic(m: IsotropicMaterial) -> "OrthotropicMaterial":
        """Isotropic limit: c_ii = lam+2mu, off-diagonals = lam, shears = mu."""
        d, o, s = m.lam + 2.0 * m.mu, m.lam, m.mu
        return OrthotropicMaterial(rho=m.rho, c11=d, c12=o, c13=o,
                                   c22=d, c23=o, c33=d, c44=s, c55=s, c66=s)

    def constants(self) -> dict:
        """The 9 stiffnesses as a {name: value} dict (from_constants input)."""
        return {k: getattr(self, k)
                for k in ("c11", "c12", "c13", "c22", "c23", "c33",
                          "c44", "c55", "c66")}


@dataclasses.dataclass
class AxisView:
    """Characteristic quantities of one sweep: per-pair wave speed and
    impedance fields, per-zero coupling ratios."""

    pair_c: List[torch.Tensor]
    pair_z: List[torch.Tensor]
    zero_kappa: List[torch.Tensor]


@dataclasses.dataclass
class OrthotropicMaterialFields:
    """Per-node orthotropic fields: rho and the 9 stiffness tensors.
    ``axis_view`` derives the closed-form per-axis quantities the sweeps
    consume: per pair the speed sqrt(c/rho) of the stiffness that drives it
    and the impedance rho*c, per zero-speed invariant the ratio c_ab/c_aa."""

    rho: torch.Tensor
    c11: torch.Tensor
    c12: torch.Tensor
    c13: torch.Tensor
    c22: torch.Tensor
    c23: torch.Tensor
    c33: torch.Tensor
    c44: torch.Tensor
    c55: torch.Tensor
    c66: torch.Tensor

    @staticmethod
    def from_constants(rho, c, device="cpu",
                       dtype=torch.float32) -> "OrthotropicMaterialFields":
        """``c``: dict with keys c11..c66 of scalars or arrays (numpy or
        torch), each cast once to ``dtype`` on ``device``."""
        return OrthotropicMaterialFields(
            rho=_as_tensor(rho, device, dtype),
            **{k: _as_tensor(c[k], device, dtype)
               for k in ("c11", "c12", "c13", "c22", "c23", "c33",
                         "c44", "c55", "c66")})

    def _diag(self, axis: int) -> torch.Tensor:
        return (self.c11, self.c22, self.c33)[axis]

    def _shear(self, a: int, b: int) -> torch.Tensor:
        a, b = min(a, b), max(a, b)
        return {(1, 2): self.c44, (0, 2): self.c55, (0, 1): self.c66}[(a, b)]

    def _offdiag(self, a: int, b: int) -> torch.Tensor:
        a, b = min(a, b), max(a, b)
        return {(0, 1): self.c12, (0, 2): self.c13, (1, 2): self.c23}[(a, b)]

    def max_cp(self) -> float:
        """Largest characteristic speed of any pair on any sweep axis. The
        CFL step uses it; the shear stiffnesses count too, since a
        positive-definite tensor may have c44..c66 above a diagonal one."""
        return float(max(torch.sqrt(torch.max(c / self.rho))
                         for c in (self.c11, self.c22, self.c33,
                                   self.c44, self.c55, self.c66)))

    def axis_view(self, axis: int, stage_spec) -> AxisView:
        pc, pz = [], []
        for p in stage_spec.pairs:
            stiff = (self._diag(axis) if p.traction_axis == axis
                     else self._shear(axis, p.traction_axis))
            c = torch.sqrt(stiff / self.rho)
            pc.append(c)
            pz.append(self.rho * c)
        # during the a-sweep sigma_bb_t = c_ab dv_a/da, so sigma_bb -
        # (c_ab/c_aa) sigma_aa is frozen
        zk = [self._offdiag(axis, _DIAG_AXIS_OF_COMP[zc.comp])
              / self._diag(axis) for zc in stage_spec.zeros]
        return AxisView(pair_c=pc, pair_z=pz, zero_kappa=zk)


#: diagonal-stress component index -> its axis, for the 3D/2D elastic models
#: (elastic3d: sxx=3, syy=6, szz=8; elastic2d: sxx=2, syy=4)
_DIAG_AXIS_OF_COMP = {3: 0, 6: 1, 8: 2, 2: 0, 4: 1}


class AxisViewCache:
    """Material fields whose per-axis views are computed at their first
    sweep and kept: built once at an engine's setup, it keeps an orthotropic
    view (square roots, impedances and ratios over whole fields) out of
    every later sweep. Has the fields' ``axis_view`` and ``max_cp``."""

    def __init__(self, mat):
        self.mat = mat
        self._views: Dict[Tuple, AxisView] = {}

    def axis_view(self, axis: int, stage_spec) -> AxisView:
        key = (axis, stage_spec)
        if key not in self._views:
            self._views[key] = self.mat.axis_view(axis, stage_spec)
        return self._views[key]

    def max_cp(self) -> float:
        return self.mat.max_cp()
