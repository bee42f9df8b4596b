"""Named scenarios: the structured single-body configurations, the
simplex-mesh ones and the multi-body contact ones.

Counterpart of ``gcm_tpu/scenarios.py`` (registry, ``acoustic1d``,
``elastic2d_ps``, ``elastic3d_layered``, ``elastic3d_explosion``,
``elastic2d_viscoelastic``, ``simplex2d_canyon_layered``,
``simplex3d_layered``, and the unregistered ``elastic3d_contact``,
``elastic2d_basin_refined``, ``simplex2d_acoustic`` and
``simplex3d_elastic``), with the same names, defaults and parameters.
The registered simplex scenarios return a
:class:`~gcm_tpu_torch.task.SimplexTask`, run by
``engine_simplex.SimplexEngine.from_task``; ``simplex2d_acoustic`` and
``simplex3d_elastic`` return a ready ``SimplexEngine`` (on the card unless
``device`` says otherwise); the contact scenarios return ``(bodies,
contacts)`` for ``engine_multi.MultiBodyEngine`` and are listed in
:data:`MULTI_SCENARIOS`.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from gcm_tpu_torch.materials import IsotropicMaterial
from gcm_tpu_torch.solver.correctors import MaxwellCorrector
from gcm_tpu_torch.task import (
    AreaBall, AreaBox, AreaHalfSpace, AreaLayer, BorderSpec, DetectorSpec,
    GridSpec, InitialCondition, MaterialRegion, RickerSource, SimplexTask,
    SnapshotSpec, Task, TimeSpec,
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


def elastic3d_contact(n: int = 64, nsteps: int = 80):
    """BASELINE config 4: two 3D elastic bodies bonded along z with a finite
    tensile strength (fracture), an explosion source in the lower body, a
    free surface on top. Returns (bodies dict, contacts) for
    MultiBodyEngine."""
    from gcm_tpu_torch.solver.contact import ContactSpec

    rock = IsotropicMaterial.from_speeds(rho=2500.0, cp=4000.0, cs=2300.0)
    soft = IsotropicMaterial.from_speeds(rho=2000.0, cp=2500.0, cs=1200.0)
    L = 1000.0
    nz = max(n // 2, 8)
    h = L / (n - 1)
    hz = h
    grid = GridSpec(shape=(n, n, nz), h=(h, h, hz))
    f0 = 10.0
    # body "upper": z in [0, (nz-1)hz] with free surface at z=0
    upper = Task(
        name="upper", model="elastic3d", grid=grid, default_material=soft,
        borders={**{(a, s): BorderSpec("absorbing") for a in (0, 1, 2)
                    for s in (0, 1)},
                 (2, 0): BorderSpec("free")},
        time=TimeSpec(cfl=0.8, nsteps=nsteps), order=2,
    )
    # body "lower": continues downward, explosion source inside
    lower = Task(
        name="lower", model="elastic3d", grid=grid, default_material=rock,
        borders={(a, s): BorderSpec("absorbing") for a in (0, 1, 2)
                 for s in (0, 1)},
        sources=(RickerSource(
            position=(L / 2, L / 2, (nz - 1) * hz / 2),
            components=("sxx", "syy", "szz"),
            f0=f0, t0=1.2 / f0, amplitude=1.0e10,
        ),),
        time=TimeSpec(cfl=0.8, nsteps=nsteps), order=2,
    )
    contacts = (ContactSpec("upper", "lower", axis=2, kind="bonded",
                            tensile_strength=1.0e5, broken_kind="free"),)
    return {"upper": upper, "lower": lower}, contacts


def elastic2d_basin_refined(n: int = 65, nsteps: int = 240):
    """Non-conforming multi-body: a coarse bedrock half coupled to a basin
    half meshed at HALF the spacing (h against h/2 interface maps,
    solver.contact_nc), with a soft sediment layer in the fine body.
    Returns (bodies dict, contacts) for MultiBodyEngine."""
    from gcm_tpu_torch.solver.contact import ContactSpec

    rock = IsotropicMaterial.from_speeds(rho=2500.0, cp=4000.0, cs=2300.0)
    sediment = IsotropicMaterial.from_speeds(rho=1800.0, cp=1800.0, cs=700.0)
    L = 1000.0               # each half is L wide, L tall
    h = L / (n - 1)
    f0 = 8.0
    borders = {(a, s): BorderSpec("absorbing") for a in (0, 1)
               for s in (0, 1)}
    borders_free_top = {**borders, (1, 1): BorderSpec("free")}
    bedrock = Task(
        name="bedrock", model="elastic2d",
        grid=GridSpec(shape=(n, n), h=(h, h), origin=(0.0, 0.0)),
        default_material=rock,
        borders=dict(borders_free_top),
        sources=(RickerSource(
            position=(L / 2, L / 3), components=("sxx", "syy"),
            f0=f0, t0=1.2 / f0, amplitude=1.0e9,
        ),),
        time=TimeSpec(cfl=0.8, nsteps=nsteps), order=2,
    )
    nb = 2 * (n - 1) + 1     # h/2 spacing over the same extent
    basin = Task(
        name="basin", model="elastic2d",
        grid=GridSpec(shape=(nb, nb), h=(h / 2, h / 2), origin=(L, 0.0)),
        default_material=rock,
        materials=(MaterialRegion(
            AreaLayer(axis=1, lo=0.7 * L, hi=L), sediment),),
        borders=dict(borders_free_top),
        detectors=DetectorSpec(points=tuple(
            (L + x, L) for x in np.linspace(0.1 * L, 0.9 * L, 9))),
        time=TimeSpec(cfl=0.8, nsteps=nsteps), order=2,
    )
    contacts = (ContactSpec("bedrock", "basin", axis=0, kind="bonded"),)
    return {"bedrock": bedrock, "basin": basin}, contacts


#: the multi-body scenarios, by name (not in the single-body registry)
MULTI_SCENARIOS: Dict[str, Callable] = {
    "elastic3d_contact": elastic3d_contact,
    "elastic2d_basin_refined": elastic2d_basin_refined,
}


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


def simplex2d_acoustic(n: int = 61, jitter: float = 0.2, device="cuda"):
    """BASELINE config 5 (2D): an acoustic pulse on a jittered triangle
    mesh, as a ready ``SimplexEngine`` on ``device``."""
    from gcm_tpu_torch.engine_simplex import SimplexEngine
    from gcm_tpu_torch.grids.simplex import SimplexGrid

    L = 100.0
    g = SimplexGrid.box((0.0, 0.0), (L, L), (n, n), jitter=jitter)
    water = IsotropicMaterial.from_speeds(rho=1000.0, cp=1500.0)
    u0 = np.zeros((3, g.npoints))
    r2 = ((g.points - L / 2) ** 2).sum(1)
    u0[2] = 1.0e5 * np.exp(-r2 / (2 * (L / 20) ** 2))
    return SimplexEngine(g, "acoustic2d", water, u0=u0, device=device)


def simplex3d_elastic(n: int = 21, jitter: float = 0.15, device="cuda"):
    """BASELINE config 5 (3D): an elastic pulse on a jittered tet mesh, as
    a ready ``SimplexEngine`` on ``device``."""
    from gcm_tpu_torch.engine_simplex import SimplexEngine
    from gcm_tpu_torch.grids.simplex import SimplexGrid

    L = 100.0
    g = SimplexGrid.box((0.0,) * 3, (L,) * 3, (n,) * 3, jitter=jitter)
    rock = IsotropicMaterial.from_speeds(rho=2500.0, cp=4000.0, cs=2300.0)
    u0 = np.zeros((9, g.npoints))
    r2 = ((g.points - L / 2) ** 2).sum(1)
    ball = np.exp(-r2 / (2 * (L / 15) ** 2))
    for c in (3, 6, 8):  # sxx, syy, szz
        u0[c] = 1.0e6 * ball
    return SimplexEngine(g, "elastic3d", rock, u0=u0, device=device)


@register
def simplex2d_canyon_layered(n: int = 65, nsteps: int = 160) -> SimplexTask:
    """Layered medium on an unstructured, non-convex mesh: a 2D elastic
    half-space with a canyon notch cut into the free surface, soft
    sediments over stiff basement, explosion source at depth, receivers on
    the canyon rim and on the flat free field."""
    from gcm_tpu_torch.grids.simplex import SimplexGrid

    L, cw, cd = 64.0, 16.0, 8.0
    x_lo, x_hi = (L - cw) / 2, (L + cw) / 2
    y_cut = L - cd
    canyon = AreaBox((x_lo, y_cut), (x_hi, L + 1.0))
    grid = SimplexGrid.box_minus((0.0, 0.0), (L, L), (n, n), holes=(canyon,))

    sediments = IsotropicMaterial.from_speeds(rho=1900.0, cp=2100.0, cs=900.0)
    basement = IsotropicMaterial.from_speeds(rho=2700.0, cp=5200.0, cs=3000.0)
    surface = AreaHalfSpace(point=(0.0, y_cut - 1e-6), normal=(0.0, -1.0))
    f0 = 120.0
    return SimplexTask(
        name="simplex2d_canyon_layered",
        model="elastic2d",
        grid=grid,
        default_material=basement,
        materials=(MaterialRegion(AreaLayer(axis=1, lo=40.0, hi=L + 1.0),
                                  sediments),),
        border_default=BorderSpec("absorbing"),
        borders=((surface, BorderSpec("free")),),
        sources=(RickerSource(position=(L / 2, 16.0),
                              components=("sxx", "syy"),
                              f0=f0, t0=1.2 / f0, amplitude=1.0e7),),
        time=TimeSpec(cfl=0.6, nsteps=nsteps),
        snapshots=SnapshotSpec(every=40),
        detectors=DetectorSpec(points=(
            (x_lo, y_cut), (x_hi, y_cut),          # canyon rim
            (x_lo / 2, L), (L - x_lo / 2, L),      # flat free field
        )),
    )


@register
def simplex3d_layered(n: int = 17, nsteps: int = 60,
                      jitter: float = 0.15) -> SimplexTask:
    """3D layered heterogeneous elastic medium on a jittered tet mesh with
    a free surface on top (BASELINE config 3 on the unstructured path)."""
    from gcm_tpu_torch.grids.simplex import SimplexGrid

    L = 150.0
    grid = SimplexGrid.box((0.0,) * 3, (L,) * 3, (n,) * 3, jitter=jitter)
    sediments = IsotropicMaterial.from_speeds(rho=1900.0, cp=2100.0, cs=900.0)
    sandstone = IsotropicMaterial.from_speeds(rho=2300.0, cp=3300.0, cs=1800.0)
    basement = IsotropicMaterial.from_speeds(rho=2700.0, cp=5200.0, cs=3000.0)
    top = AreaHalfSpace(point=(0.0, 0.0, L - 1e-6), normal=(0.0, 0.0, -1.0))
    f0 = 40.0
    return SimplexTask(
        name="simplex3d_layered",
        model="elastic3d",
        grid=grid,
        default_material=basement,
        materials=(
            MaterialRegion(AreaLayer(axis=2, lo=2 * L / 3, hi=L + 1.0),
                           sediments),
            MaterialRegion(AreaLayer(axis=2, lo=L / 3, hi=2 * L / 3),
                           sandstone),
        ),
        border_default=BorderSpec("absorbing"),
        borders=((top, BorderSpec("free")),),
        sources=(RickerSource(position=(L / 2, L / 2, L / 3),
                              components=("sxx", "syy", "szz"),
                              f0=f0, t0=1.2 / f0, amplitude=1.0e7),),
        time=TimeSpec(cfl=0.6, nsteps=nsteps),
        detectors=DetectorSpec(points=((L / 2, L / 2, L), (L / 4, L / 2, L))),
    )
