"""Named scenarios: the structured single-body configurations.

Counterpart of ``gcm_tpu/scenarios.py`` (registry, ``acoustic1d``,
``elastic2d_ps``, ``elastic3d_layered``, ``elastic3d_explosion``,
``elastic2d_viscoelastic``), with the same names, defaults and parameters.
"""

from __future__ import annotations

from typing import Callable, Dict

from gcm_tpu_torch.materials import IsotropicMaterial
from gcm_tpu_torch.solver.correctors import MaxwellCorrector
from gcm_tpu_torch.task import (
    AreaBall, AreaLayer, BorderSpec, DetectorSpec, GridSpec,
    InitialCondition, MaterialRegion, RickerSource, Task, TimeSpec,
)

_REGISTRY: Dict[str, Callable[..., Task]] = {}


def register(fn: Callable[..., Task]) -> Callable[..., Task]:
    _REGISTRY[fn.__name__] = fn
    return fn


def get_scenario(name: str, **kw) -> Task:
    return _REGISTRY[name](**kw)


def list_scenarios():
    return sorted(_REGISTRY)


@register
def acoustic1d(n: int = 1024, nsteps: int = 500) -> Task:
    """BASELINE config 1: 1D acoustic pulse, linear characteristic interp."""
    water = IsotropicMaterial.from_speeds(rho=1000.0, cp=1500.0)
    L = 1000.0
    return Task(
        name="acoustic1d",
        model="acoustic1d",
        grid=GridSpec(shape=(n,), h=(L / (n - 1),)),
        default_material=water,
        initial=(
            InitialCondition(AreaBall(center=(L / 2,), radius=L / 20),
                             values={"p": 1.0e5}),
        ),
        borders={(0, 0): BorderSpec("absorbing"), (0, 1): BorderSpec("absorbing")},
        time=TimeSpec(cfl=0.9, nsteps=nsteps),
        order=1,
        detectors=DetectorSpec(points=((L / 4,),)),
    )


@register
def elastic2d_ps(n: int = 512, nsteps: int = 300) -> Task:
    """BASELINE config 2: homogeneous 2D elastic P/S waves, order 2."""
    rock = IsotropicMaterial.from_speeds(rho=2500.0, cp=4000.0, cs=2300.0)
    L = 2000.0
    h = L / (n - 1)
    return Task(
        name="elastic2d_ps",
        model="elastic2d",
        grid=GridSpec(shape=(n, n), h=(h, h)),
        default_material=rock,
        initial=(
            InitialCondition(
                AreaBall(center=(L / 2, L / 2), radius=L / 25),
                values={"sxx": 1.0e6, "syy": 1.0e6},
            ),
        ),
        borders={(a, s): BorderSpec("absorbing") for a in (0, 1) for s in (0, 1)},
        time=TimeSpec(cfl=0.8, nsteps=nsteps),
        order=2,
        detectors=DetectorSpec(points=((L / 4, L / 2), (3 * L / 4, L / 2))),
    )


def _layered_3d(nx: int, ny: int, nz: int):
    """A 3-layer seismic velocity model stacked along z (axis 2)."""
    L = (2000.0, 2000.0, 1500.0)
    h = (L[0] / (nx - 1), L[1] / (ny - 1), L[2] / (nz - 1))
    sediments = IsotropicMaterial.from_speeds(rho=1900.0, cp=2100.0, cs=900.0)
    sandstone = IsotropicMaterial.from_speeds(rho=2300.0, cp=3300.0, cs=1800.0)
    basement = IsotropicMaterial.from_speeds(rho=2700.0, cp=5200.0, cs=3000.0)
    regions = (
        MaterialRegion(AreaLayer(axis=2, lo=0.0, hi=500.0), sediments),
        MaterialRegion(AreaLayer(axis=2, lo=500.0, hi=1000.0), sandstone),
        MaterialRegion(AreaLayer(axis=2, lo=1000.0, hi=1500.0), basement),
    )
    return GridSpec(shape=(nx, ny, nz), h=h), regions, L


@register
def elastic3d_layered(n: int = 128, nsteps: int = 100) -> Task:
    """3D layered heterogeneous elastic medium, absorbing on every face."""
    grid, regions, L = _layered_3d(n, n, max(n // 2, 8))
    return Task(
        name="elastic3d_layered",
        model="elastic3d",
        grid=grid,
        default_material=regions[-1].material,
        materials=regions,
        initial=(
            InitialCondition(
                AreaBall(center=(L[0] / 2, L[1] / 2, 300.0), radius=120.0),
                values={"sxx": 1.0e6, "syy": 1.0e6, "szz": 1.0e6},
            ),
        ),
        borders={(a, s): BorderSpec("absorbing")
                 for a in (0, 1, 2) for s in (0, 1)},
        time=TimeSpec(cfl=0.8, nsteps=nsteps),
        order=2,
        detectors=DetectorSpec(points=((L[0] / 2, L[1] / 2, 50.0),)),
    )


@register
def elastic3d_explosion(n: int = 128, nsteps: int = 100) -> Task:
    """Free surface at z=0, explosion (isotropic moment Ricker) source at
    depth, absorbing elsewhere."""
    grid, regions, L = _layered_3d(n, n, max(n // 2, 8))
    borders = {(a, s): BorderSpec("absorbing")
               for a in (0, 1, 2) for s in (0, 1)}
    borders[(2, 0)] = BorderSpec("free")  # z = 0 is the free surface
    f0 = 8.0
    return Task(
        name="elastic3d_explosion",
        model="elastic3d",
        grid=grid,
        default_material=regions[-1].material,
        materials=regions,
        borders=borders,
        sources=(
            RickerSource(
                position=(L[0] / 2, L[1] / 2, 400.0),
                components=("sxx", "syy", "szz"),
                f0=f0, t0=1.2 / f0, amplitude=1.0e8,
            ),
        ),
        time=TimeSpec(cfl=0.8, nsteps=nsteps),
        order=2,
        detectors=DetectorSpec(points=(
            (L[0] / 2, L[1] / 2, 0.0),
            (L[0] / 4, L[1] / 2, 0.0),
        )),
    )


@register
def elastic2d_viscoelastic(n: int = 256, nsteps: int = 200,
                           tau: float = 0.02) -> Task:
    """2D viscoelastic medium: Maxwell deviatoric relaxation (time tau)
    applied after each hyperbolic step and its source injection. An S pulse
    decays with distance while the P (pressure) part persists, the
    qualitative Maxwell signature."""
    mat = IsotropicMaterial.from_speeds(rho=2200.0, cp=3200.0, cs=1800.0)
    L = 1000.0
    h = L / (n - 1)
    f0 = 12.0
    return Task(
        name="elastic2d_viscoelastic", model="elastic2d",
        grid=GridSpec(shape=(n, n), h=(h, h)),
        default_material=mat,
        borders={(a, s): BorderSpec("absorbing") for a in (0, 1)
                 for s in (0, 1)},
        sources=(RickerSource(position=(L / 2, L / 2),
                              components=("sxy",), f0=f0, t0=1.2 / f0,
                              amplitude=1.0e9),),
        detectors=DetectorSpec(points=((0.75 * L, L / 2),)),
        correctors=(MaxwellCorrector(tau=tau),),
        time=TimeSpec(cfl=0.8, nsteps=nsteps), order=2,
    )
