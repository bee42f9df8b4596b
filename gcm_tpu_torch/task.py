"""Scenario configuration: grid, materials, initial and border conditions,
sources, detectors and time settings of one body, on a structured grid
(``Task``) or a simplex mesh (``SimplexTask``).

Counterpart of ``gcm_tpu/task.py`` (its single-body parts). ``Area``
shapes rasterize to boolean masks host-side (numpy) when the engine is
built, so nothing dynamic reaches the stepped loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gcm_tpu_torch.materials import (
    IsotropicMaterial, MaterialFields, OrthotropicMaterial,
    OrthotropicMaterialFields,
)

Axis = int          # 0, 1, 2
Side = int          # 0 = low face, 1 = high face
Face = Tuple[Axis, Side]
AnyMaterial = Union[IsotropicMaterial, OrthotropicMaterial]

#: compute paths: "auto" resolves to the fused CUDA kernel for 2D and 3D
#: tasks on a CUDA device and to the plain torch step elsewhere; "sweep"
#: takes the per-sweep CUDA kernel, one launch per axis
KERNELS = ("auto", "torch", "fused", "sweep")
#: compute paths of a SimplexTask: "auto" resolves to the simplex sweep
#: kernel on a CUDA device for isotropic media and to the plain torch sweep
#: elsewhere
SIMPLEX_KERNELS = ("auto", "torch", "simplex")


# ---------------------------------------------------------------- geometry

@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Uniform structured grid: shape, spacing and origin per axis.
    Node coordinates are ``origin + index * h``."""

    shape: Tuple[int, ...]
    h: Tuple[float, ...]
    origin: Tuple[float, ...] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.origin is None:
            object.__setattr__(self, "origin", (0.0,) * len(self.shape))
        if not (len(self.shape) == len(self.h) == len(self.origin)):
            raise ValueError("GridSpec shape/h/origin rank mismatch")

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def lengths(self) -> Tuple[float, ...]:
        return tuple((n - 1) * h for n, h in zip(self.shape, self.h))

    def coords(self) -> List[np.ndarray]:
        """Per-axis 1D node coordinate arrays."""
        return [
            self.origin[a] + self.h[a] * np.arange(self.shape[a], dtype=np.float64)
            for a in range(self.dim)
        ]

    def meshgrid(self) -> List[np.ndarray]:
        return list(np.meshgrid(*self.coords(), indexing="ij"))

    def index_of(self, point: Sequence[float]) -> Tuple[int, ...]:
        """Nearest node index of a physical point (for detectors/sources)."""
        idx = []
        for a in range(self.dim):
            i = int(round((point[a] - self.origin[a]) / self.h[a]))
            idx.append(min(max(i, 0), self.shape[a] - 1))
        return tuple(idx)


# ---------------------------------------------------------------- areas

class Area:
    """A spatial region; rasterizes to a node mask on a structured grid
    (``mask``) or on a point cloud (``contains``). Combine areas with
    ``|`` (union), ``&`` (intersection) and ``~`` (complement)."""

    def mask(self, grid: GridSpec) -> np.ndarray:
        pts = np.stack([g.ravel() for g in grid.meshgrid()], axis=-1)
        return self.contains(pts).reshape(grid.shape)

    def contains(self, points: np.ndarray) -> np.ndarray:
        """Boolean mask over ``points [N, dim]``."""
        raise NotImplementedError

    def __or__(self, other: "Area") -> "Area":
        return AreaUnion((self, other))

    def __and__(self, other: "Area") -> "Area":
        return AreaIntersection((self, other))

    def __invert__(self) -> "Area":
        return AreaNot(self)


@dataclasses.dataclass(frozen=True)
class AreaAll(Area):
    def mask(self, grid: GridSpec) -> np.ndarray:
        return np.ones(grid.shape, dtype=bool)

    def contains(self, points: np.ndarray) -> np.ndarray:
        return np.ones(len(points), dtype=bool)


@dataclasses.dataclass(frozen=True)
class AreaBox(Area):
    lo: Tuple[float, ...]
    hi: Tuple[float, ...]

    def mask(self, grid: GridSpec) -> np.ndarray:
        m = np.ones(grid.shape, dtype=bool)
        for a, x in enumerate(grid.meshgrid()):
            m &= (x >= self.lo[a]) & (x <= self.hi[a])
        return m

    def contains(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points)
        return ((points >= np.asarray(self.lo))
                & (points <= np.asarray(self.hi))).all(axis=1)


@dataclasses.dataclass(frozen=True)
class AreaBall(Area):
    center: Tuple[float, ...]
    radius: float

    def mask(self, grid: GridSpec) -> np.ndarray:
        r2 = sum((x - c) ** 2 for x, c in zip(grid.meshgrid(), self.center))
        return r2 <= self.radius ** 2

    def contains(self, points: np.ndarray) -> np.ndarray:
        d2 = ((np.asarray(points) - np.asarray(self.center)) ** 2).sum(axis=1)
        return d2 <= self.radius ** 2


@dataclasses.dataclass(frozen=True)
class AreaLayer(Area):
    """Slab ``lo <= x_axis <= hi``, for layered seismic models."""

    axis: int
    lo: float
    hi: float

    def mask(self, grid: GridSpec) -> np.ndarray:
        x = grid.meshgrid()[self.axis]
        return (x >= self.lo) & (x <= self.hi)

    def contains(self, points: np.ndarray) -> np.ndarray:
        x = np.asarray(points)[:, self.axis]
        return (x >= self.lo) & (x <= self.hi)


@dataclasses.dataclass(frozen=True)
class AreaCylinder(Area):
    """Axis-aligned cylinder: distance to the axis line <= radius, with an
    optional extent [lo, hi] along the axis."""

    axis: int
    center: Tuple[float, ...]      # the axis-coordinate entry is ignored
    radius: float
    lo: float = -np.inf
    hi: float = np.inf

    def contains(self, points: np.ndarray) -> np.ndarray:
        pts = np.asarray(points)
        d2 = np.zeros(len(pts))
        for a in range(pts.shape[1]):
            if a != self.axis:
                d2 += (pts[:, a] - self.center[a]) ** 2
        x = pts[:, self.axis]
        return (d2 <= self.radius ** 2) & (x >= self.lo) & (x <= self.hi)


@dataclasses.dataclass(frozen=True)
class AreaHalfSpace(Area):
    """The half-space ``normal . (x - point) <= 0``."""

    point: Tuple[float, ...]
    normal: Tuple[float, ...]

    def contains(self, points: np.ndarray) -> np.ndarray:
        rel = np.asarray(points) - np.asarray(self.point)
        return rel @ np.asarray(self.normal) <= 0.0


@dataclasses.dataclass(frozen=True)
class AreaUnion(Area):
    areas: Tuple[Area, ...]

    def contains(self, points: np.ndarray) -> np.ndarray:
        m = self.areas[0].contains(points)
        for a in self.areas[1:]:
            m = m | a.contains(points)
        return m


@dataclasses.dataclass(frozen=True)
class AreaIntersection(Area):
    areas: Tuple[Area, ...]

    def contains(self, points: np.ndarray) -> np.ndarray:
        m = self.areas[0].contains(points)
        for a in self.areas[1:]:
            m = m & a.contains(points)
        return m


@dataclasses.dataclass(frozen=True)
class AreaNot(Area):
    area: Area

    def contains(self, points: np.ndarray) -> np.ndarray:
        return ~self.area.contains(points)


# ---------------------------------------------------------------- conditions

#: characteristic border-condition kinds
BORDER_KINDS = ("absorbing", "free", "fixed_force", "fixed_velocity")


@dataclasses.dataclass(frozen=True)
class BorderSpec:
    """Border condition on one face.

    ``value``: for fixed_force/fixed_velocity, either a scalar (applied to
    the normal P pair; S pairs get 0) or a per-spatial-axis vector indexed by
    each pair's ``traction_axis``.
    """

    kind: str = "absorbing"
    value: Union[None, float, Tuple[float, ...]] = None

    def __post_init__(self):
        if self.kind not in BORDER_KINDS:
            raise ValueError(f"unknown border kind {self.kind!r}")

    def pair_value(self, traction_axis: int, normal_axis: int) -> float:
        if self.value is None:
            return 0.0
        if isinstance(self.value, (int, float)):
            return float(self.value) if traction_axis == normal_axis else 0.0
        return float(self.value[traction_axis])


@dataclasses.dataclass(frozen=True)
class MaterialRegion:
    area: Area
    material: AnyMaterial


@dataclasses.dataclass(frozen=True)
class InitialCondition:
    """Set state components inside an area: {component name: value}, where a
    value is a float or a callable ``f(X1, .., Xd)`` of the node meshgrids."""

    area: Area
    values: Dict[str, Union[float, Callable]]


@dataclasses.dataclass(frozen=True)
class WaveletSource:
    """Point source with an arbitrary time function ``fn(t) -> amplitude``
    (vectorized over t)."""

    position: Tuple[float, ...]
    components: Tuple[str, ...]
    fn: Callable
    amplitude: float = 1.0

    def wavelet(self, t):
        out = self.amplitude * np.asarray(self.fn(np.asarray(t, np.float64)))
        return float(out) if out.ndim == 0 else out


@dataclasses.dataclass(frozen=True)
class RickerSource:
    """Point source with a Ricker wavelet time function, injected additively
    into the listed components at the node nearest to ``position`` each
    step: ``amp * ricker(t - t0; f0) * dt``."""

    position: Tuple[float, ...]
    components: Tuple[str, ...]
    f0: float
    t0: float
    amplitude: float = 1.0

    def wavelet(self, t):
        """Ricker amplitude at time(s) ``t``, evaluated in float64."""
        a = (np.pi * self.f0 * (np.asarray(t, np.float64) - self.t0)) ** 2
        out = self.amplitude * (1.0 - 2.0 * a) * np.exp(-a)
        return float(out) if out.ndim == 0 else out


def apply_initial(u0: np.ndarray, model, grid: GridSpec,
                  initial) -> np.ndarray:
    """Rasterize InitialConditions into the numpy state ``u0`` (in place)."""
    X = None
    for ic in initial:
        msk = ic.area.mask(grid)
        for name, val in ic.values.items():
            if callable(val):
                if X is None:
                    X = grid.meshgrid()
                field = np.broadcast_to(
                    np.asarray(val(*X), np.float64), grid.shape)
                u0[model.comp(name)][msk] = field[msk]
            else:
                u0[model.comp(name)][msk] = val
    return u0


@dataclasses.dataclass(frozen=True)
class TimeSpec:
    cfl: float = 0.9
    nsteps: Optional[int] = None
    t_end: Optional[float] = None

    def steps_for(self, dt: float) -> int:
        if self.nsteps is not None:
            return self.nsteps
        if self.t_end is not None:
            return int(np.ceil(self.t_end / dt))
        raise ValueError("TimeSpec needs nsteps or t_end")


@dataclasses.dataclass(frozen=True)
class SnapshotSpec:
    every: int = 0                    # 0 = disabled
    directory: str = "snapshots"
    fields: Tuple[str, ...] = ()      # () = all components


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """Receiver points whose state is recorded every step (seismograms)."""

    points: Tuple[Tuple[float, ...], ...]
    components: Tuple[str, ...] = ()  # () = all


# ---------------------------------------------------------------- task

#: material stack types of the fused kernels
MAT_DTYPES = ("f32", "bf16")
#: knobs of the JAX Task that only tune XLA: the port keeps the field so a
#: task carries over, and refuses any value other than the default
_XLA_ONLY_DEFAULTS = {"scan_unroll": 1}


@dataclasses.dataclass(frozen=True)
class Task:
    """One body: grid + model + materials + ICs/BCs + time + outputs."""

    name: str
    model: str                         # gcm_tpu_torch.models.get_model key
    grid: GridSpec
    default_material: AnyMaterial
    materials: Tuple[MaterialRegion, ...] = ()
    initial: Tuple[InitialCondition, ...] = ()
    borders: Dict[Face, BorderSpec] = dataclasses.field(default_factory=dict)
    sources: Tuple[Union[RickerSource, WaveletSource], ...] = ()
    time: TimeSpec = TimeSpec()
    order: int = 2                     # characteristic interpolation order
    snapshots: SnapshotSpec = SnapshotSpec()
    detectors: Optional[DetectorSpec] = None
    symmetrize_stages: bool = True     # reverse axis order on odd steps
    correctors: Tuple = ()             # ODE correctors (solver.correctors)
    kernel: str = "auto"               # "auto" | "torch" | "fused" | "sweep"
    #: material stack of the fused kernels: "bf16" halves the material
    #: stream; the kernels upcast at the load and compute in float32
    mat_dtype: str = "f32"
    scan_unroll: int = 1
    #: run a symmetrized pair of fused steps as one two-step pass when
    #: nothing happens between them (no sources, correctors or detectors)
    temporal_block: bool = False
    #: the JAX package's canonical layout, as a splitting order: the axes
    #: it would store in order (the last 128-aligned axis last when the
    #: last axis is not aligned), and that order reversed on odd steps; the
    #: port keeps the task layout in memory
    canonical_layout: bool = False

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r} "
                             f"(expected one of {KERNELS})")
        if self.mat_dtype not in MAT_DTYPES:
            raise ValueError(f"unknown mat_dtype {self.mat_dtype!r} "
                             f"(expected one of {MAT_DTYPES})")
        for knob, default in _XLA_ONLY_DEFAULTS.items():
            if getattr(self, knob) != default:
                raise ValueError(
                    f"Task.{knob}={getattr(self, knob)!r} is not supported "
                    f"by the PyTorch port (only {default!r})")

    @property
    def is_orthotropic(self) -> bool:
        mats = (self.default_material,) + tuple(r.material for r in self.materials)
        return any(isinstance(m, OrthotropicMaterial) for m in mats)

    def material_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rasterize isotropic material regions into (rho, lam, mu) node
        arrays. float32, as the JAX package rasterizes them: an f64 run then
        starts from the same rounded parameters."""
        shape = self.grid.shape
        m0 = self.default_material
        rho = np.full(shape, m0.rho, dtype=np.float32)
        lam = np.full(shape, m0.lam, dtype=np.float32)
        mu = np.full(shape, m0.mu, dtype=np.float32)
        for region in self.materials:
            msk = region.area.mask(self.grid)
            rho[msk] = region.material.rho
            lam[msk] = region.material.lam
            mu[msk] = region.material.mu
        return rho, lam, mu

    def material_fields(self, device="cpu", dtype=torch.float32
                        ) -> Union[MaterialFields, OrthotropicMaterialFields]:
        """Rasterize regions into per-node fields: ``MaterialFields`` when
        every material is isotropic, else ``OrthotropicMaterialFields``
        (isotropic regions embed through their orthotropic limit). As in the
        JAX package, isotropic parameters rasterize in float32 and
        orthotropic constants in float64, each cast once to ``dtype``."""
        if not self.is_orthotropic:
            rho, lam, mu = self.material_arrays()
            return MaterialFields.from_arrays(rho, lam, mu, device=device,
                                              dtype=dtype)

        def as_ortho(m: AnyMaterial) -> OrthotropicMaterial:
            if isinstance(m, OrthotropicMaterial):
                return m
            return OrthotropicMaterial.from_isotropic(m)

        shape = self.grid.shape
        m0 = as_ortho(self.default_material)
        rho = np.full(shape, m0.rho, dtype=np.float64)
        cons = {k: np.full(shape, v, dtype=np.float64)
                for k, v in m0.constants().items()}
        for region in self.materials:
            msk = region.area.mask(self.grid)
            mo = as_ortho(region.material)
            rho[msk] = mo.rho
            for k, v in mo.constants().items():
                cons[k][msk] = v
        return OrthotropicMaterialFields.from_constants(rho, cons,
                                                        device=device,
                                                        dtype=dtype)


# ---------------------------------------------------------------- simplex task

@dataclasses.dataclass(frozen=True)
class SimplexTask:
    """One body on an unstructured simplex mesh: the :class:`Task` schema
    (materials, initial and border conditions by Area, sources, detectors,
    time, snapshot cadence, ODE correctors) over an explicit
    :class:`~gcm_tpu_torch.grids.simplex.SimplexGrid`. Areas rasterize
    through ``Area.contains`` on the node cloud."""

    name: str
    model: str                          # gcm_tpu_torch.models.get_model key
    grid: "object"                      # SimplexGrid
    default_material: AnyMaterial
    materials: Tuple[MaterialRegion, ...] = ()
    initial: Tuple[InitialCondition, ...] = ()
    border_default: BorderSpec = dataclasses.field(
        default_factory=lambda: BorderSpec("absorbing"))
    borders: Tuple[Tuple[Area, BorderSpec], ...] = ()
    sources: Tuple = ()
    time: TimeSpec = TimeSpec()
    snapshots: SnapshotSpec = SnapshotSpec()
    detectors: Optional[DetectorSpec] = None
    correctors: Tuple = ()              # ODE correctors (solver.correctors)
    #: characteristic interpolation order: 1 = barycentric over the
    #: containing cell, 2 = least-squares quadratic reconstruction tables
    order: int = 1
    #: "auto" | "torch" | "simplex"; orthotropic media resolve "auto" to
    #: "torch" and refuse "simplex"
    kernel: str = "auto"

    def __post_init__(self):
        if self.kernel not in SIMPLEX_KERNELS:
            raise ValueError(f"unknown simplex kernel {self.kernel!r} "
                             f"(expected one of {SIMPLEX_KERNELS})")

    @property
    def is_orthotropic(self) -> bool:
        mats = (self.default_material,) + tuple(r.material for r in self.materials)
        return any(isinstance(m, OrthotropicMaterial) for m in mats)

    def material_fields(self, device="cpu", dtype=torch.float32
                        ) -> Union[MaterialFields, OrthotropicMaterialFields]:
        """Rasterize regions into per-node fields over the mesh nodes, from
        float64 parameters as the JAX package rasterizes them, each cast
        once to ``dtype``: ``MaterialFields`` when every material is
        isotropic, else ``OrthotropicMaterialFields`` (isotropic regions
        embed through their orthotropic limit)."""
        pts = np.asarray(self.grid.points)
        n = len(pts)
        if not self.is_orthotropic:
            m0 = self.default_material
            rho = np.full(n, m0.rho, dtype=np.float64)
            lam = np.full(n, m0.lam, dtype=np.float64)
            mu = np.full(n, m0.mu, dtype=np.float64)
            for region in self.materials:
                msk = region.area.contains(pts)
                rho[msk] = region.material.rho
                lam[msk] = region.material.lam
                mu[msk] = region.material.mu
            return MaterialFields.from_arrays(rho, lam, mu, device=device,
                                              dtype=dtype)

        def as_ortho(m: AnyMaterial) -> OrthotropicMaterial:
            if isinstance(m, OrthotropicMaterial):
                return m
            return OrthotropicMaterial.from_isotropic(m)

        m0 = as_ortho(self.default_material)
        rho = np.full(n, m0.rho, dtype=np.float64)
        cons = {k: np.full(n, v, dtype=np.float64)
                for k, v in m0.constants().items()}
        for region in self.materials:
            msk = region.area.contains(pts)
            mo = as_ortho(region.material)
            rho[msk] = mo.rho
            for k, v in mo.constants().items():
                cons[k][msk] = v
        return OrthotropicMaterialFields.from_constants(rho, cons,
                                                        device=device,
                                                        dtype=dtype)

    def initial_state(self, model) -> np.ndarray:
        """Rasterize InitialConditions into a fresh ``u0 [ncomp, N]``;
        callable values receive the per-node coordinate arrays."""
        pts = np.asarray(self.grid.points)
        u0 = np.zeros((model.ncomp, len(pts)), dtype=np.float64)
        cols = tuple(pts[:, a] for a in range(pts.shape[1]))
        for ic in self.initial:
            msk = ic.area.contains(pts)
            for name, val in ic.values.items():
                if callable(val):
                    field = np.broadcast_to(
                        np.asarray(val(*cols), np.float64), (len(pts),))
                    u0[model.comp(name)][msk] = field[msk]
                else:
                    u0[model.comp(name)][msk] = val
        return u0
