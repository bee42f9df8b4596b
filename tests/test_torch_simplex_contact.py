"""The port's simplex contact solve against the JAX package's.

Inputs come from a seeded numpy generator and reach both packages as numpy
arrays; JAX runs on the CPU with x64 (tests/conftest.py), its
``SimplexMultiEngine`` on the jnp sweeps (``kernel="jnp"``), the port's on
the plain torch sweeps (``device="cpu"``).

- ``pair_contact_nodes``: equal pairings on 2D and 3D splits.
- ``apply_simplex_contact_post`` alone, on random heterogeneous media, a
  random swept state and a random bond mask: equal to 1e-12 (normalized),
  for every kind and broken kind, 2D and 3D.
- ``SimplexMultiEngine`` after 6-14 steps: 1e-9 in float64 with equal bond
  masks (bonded, slip, friction, fracture under the three broken kinds, on
  the 2D lattice split L=16, n=17 and a jittered 3D n=7 split), 1e-5
  normalized in float32. The 3D meshes are ones where the JAX package's
  C++ walk misplaces feet (tests/test_torch_simplex.py), so the port's
  engine there gets JAX's own tables (``tables=``); on the 2D lattice the
  two packages' tables agree (asserted) and each engine builds its own.
- The port alone: the bonded two-body run equals the monolithic run on the
  lattice, where every foot lies on a lattice edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from gcm_tpu import task as jtask
from gcm_tpu.engine_simplex import SimplexBody as JSimplexBody
from gcm_tpu.engine_simplex import SimplexMultiEngine as JSimplexMultiEngine
from gcm_tpu.grids.simplex import SimplexGrid as JSimplexGrid
from gcm_tpu.materials import IsotropicMaterial as JIsotropicMaterial
from gcm_tpu.materials import MaterialFields as JMaterialFields
from gcm_tpu.models.spec import get_model as jget_model
from gcm_tpu.solver import simplex_contact as jsc
from gcm_tpu.solver.correctors import MaxwellCorrector as JMaxwellCorrector
from gcm_tpu_torch import task as ttask
from gcm_tpu_torch.convert import (
    MATERIAL_LEAVES, foot_tables_from_numpy, material_fields_from_numpy,
)
from gcm_tpu_torch.engine_simplex import (
    SimplexBody, SimplexEngine, SimplexMultiEngine,
)
from gcm_tpu_torch.grids.simplex import SimplexGrid
from gcm_tpu_torch.materials import IsotropicMaterial
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.solver import simplex_contact as tsc
from gcm_tpu_torch.solver.correctors import MaxwellCorrector
from test_torch_simplex import (  # noqa: F401  (a module fixture)
    assert_tables_agree, norm_err, private_native_library,
)

ROCK = dict(rho=1000.0, cp=2000.0, cs=1100.0)
#: (dim, L, n, k, jitter): two boxes sharing the plane x = k L / (n - 1)
SPLITS = {"2d": (2, 16.0, 17, 8, 0.0), "3d": (3, 6.0, 7, 3, 0.15)}
MODELS = {2: "elastic2d", 3: "elastic3d"}


def split(grid_cls, mesh):
    """Body a below and body b above the contact plane."""
    dim, L, n, k, jitter = SPLITS[mesh]
    xk = k * L / (n - 1)
    a = grid_cls.box((0.0,) * dim, (xk,) + (L,) * (dim - 1),
                     (k + 1,) + (n,) * (dim - 1), jitter=jitter, seed=1)
    b = grid_cls.box((xk,) + (0.0,) * (dim - 1), (L,) * dim,
                     (n - k,) + (n,) * (dim - 1), jitter=jitter, seed=2)
    return a, b


def random_states(mesh, seed=0):
    dim = SPLITS[mesh][0]
    ga, gb = split(JSimplexGrid, mesh)
    rng = np.random.default_rng(seed)
    nc = jget_model(MODELS[dim]).ncomp
    out = []
    for g in (ga, gb):
        u = rng.standard_normal((nc, g.npoints))
        u[dim:] *= 1e5
        out.append(u)
    return out


def test_pair_contact_nodes_match_jax():
    for mesh in SPLITS:
        ja, jb = split(JSimplexGrid, mesh)
        ta, tb = split(SimplexGrid, mesh)
        want = jsc.pair_contact_nodes(ja, jb)
        got = tsc.pair_contact_nodes(ta, tb)
        n = SPLITS[mesh][2]
        assert len(got[0]) == n ** (SPLITS[mesh][0] - 1)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    far = SimplexGrid.box((20.0, 20.0), (22.0, 22.0), (3, 3))
    with pytest.raises(ValueError, match="no collocated"):
        tsc.pair_contact_nodes(split(SimplexGrid, "2d")[0], far)


#: (kind, tensile_strength, broken_kind) of the contact-solve cases
SOLVE_CASES = [("bonded", None, "free"), ("slip", None, "free"),
               ("friction", None, "free"), ("bonded", 1e5, "free"),
               ("bonded", 1e5, "slip"), ("bonded", 1e5, "friction"),
               ("friction", 1e5, "friction")]


@pytest.mark.parametrize("mesh", ["2d", "3d"])
@pytest.mark.parametrize("kind,strength,broken", SOLVE_CASES)
def test_contact_post_matches_jax(mesh, kind, strength, broken):
    dim = SPLITS[mesh][0]
    name = MODELS[dim]
    jmodel, tmodel = jget_model(name), get_model(name)
    ja, jb = split(JSimplexGrid, mesh)
    idx_a, idx_b = jsc.pair_contact_nodes(ja, jb)
    rng = np.random.default_rng(7)
    spec_kw = dict(axis=0, kind=kind, tensile_strength=strength,
                   broken_kind=broken, friction_mu=0.4)
    jspec = jsc.SimplexContactSpec("a", "b", **spec_kw)
    tspec = tsc.SimplexContactSpec("a", "b", **spec_kw)
    jargs, targs = [], []
    views = []
    for g in (ja, jb):
        N = g.npoints
        jmat = JMaterialFields.from_arrays(
            2500.0 * (1 + 0.2 * rng.random(N)), 1e9 * (1 + rng.random(N)),
            1e9 * (0.5 + rng.random(N)), xp=jnp, dtype=jnp.float64)
        tmat = material_fields_from_numpy(
            {k: np.asarray(getattr(jmat, k)) for k in MATERIAL_LEAVES},
            dtype=torch.float64)
        u_old = rng.standard_normal((jmodel.ncomp, N))
        u = rng.standard_normal((jmodel.ncomp, N))
        u_old[dim:] *= 1e6
        u[dim:] *= 1e6
        jargs += [jnp.asarray(u_old), jnp.asarray(u)]
        targs += [torch.tensor(u_old), torch.tensor(u)]
        views.append((jmat.axis_view(0, jmodel.stage(0)),
                      tmat.axis_view(0, tmodel.stage(0))))
    bonded = (rng.random(len(idx_a)) < 0.6).astype(np.float64)
    jb_ = jnp.asarray(bonded) if strength is not None else None
    tb_ = torch.tensor(bonded) if strength is not None else None
    wa, wb, wm = jsc.apply_simplex_contact_post(
        jspec, jmodel, *jargs, views[0][0], views[1][0], jnp.asarray(idx_a),
        jnp.asarray(idx_b), jb_)
    u_old_a = targs[0].clone()
    ga, gb, gm = tsc.apply_simplex_contact_post(
        tspec, tmodel, *targs, views[0][1], views[1][1], idx_a, idx_b, tb_)
    assert ga is targs[1] and gb is targs[3]       # the sweep's outputs
    assert torch.equal(targs[0], u_old_a)         # the old state only read
    assert norm_err(ga.numpy(), np.asarray(wa)) < 1e-12
    assert norm_err(gb.numpy(), np.asarray(wb)) < 1e-12
    if strength is None:
        assert gm is None and wm is None
    else:
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        assert 0 < gm.sum() < bonded.sum()        # some bonds broke here


#: engine cases: (mesh, kind, tensile_strength, broken_kind, nsteps)
ENGINE_CASES = [("2d", "bonded", None, "free", 6),
                ("2d", "slip", None, "free", 7),
                ("2d", "friction", None, "free", 8),
                ("2d", "bonded", 1e5, "free", 14),
                ("2d", "bonded", 1e5, "slip", 9),
                ("2d", "bonded", 1e5, "friction", 10),
                ("3d", "bonded", None, "free", 6),
                ("3d", "friction", None, "free", 7),
                ("3d", "bonded", 1e5, "slip", 8)]


def engines(mesh, kind, strength, broken, jdtype, tdtype, extras=False):
    """Both packages' engines on the same split, states and contact; with
    ``extras`` a Ricker source and receivers in body a and a Maxwell
    corrector in body b."""
    dim = SPLITS[mesh][0]
    ja, jb = split(JSimplexGrid, mesh)
    ta, tb = split(SimplexGrid, mesh)
    u0a, u0b = random_states(mesh)
    spec_kw = dict(axis=0, kind=kind, tensile_strength=strength,
                   broken_kind=broken, friction_mu=0.3)
    jkw, tkw = ({}, {}), ({}, {})
    if extras:
        pos = (2.0, 9.0)[:dim] + (3.0,) * (dim - 2)
        for pkg, kw in ((jtask, jkw), (ttask, tkw)):
            kw[0]["sources"] = (pkg.RickerSource(
                position=pos, components=("vx",), f0=200.0, t0=2e-3,
                amplitude=1e3),)
            kw[0]["detector_points"] = ((1.0, 5.0), (7.5, 12.0))
        jkw[1]["correctors"] = (JMaxwellCorrector(tau=1e-3),)
        tkw[1]["correctors"] = (MaxwellCorrector(tau=1e-3),)
    jeng = JSimplexMultiEngine(
        {"a": JSimplexBody(ja, JIsotropicMaterial.from_speeds(**ROCK),
                           u0=u0a, **jkw[0]),
         "b": JSimplexBody(jb, JIsotropicMaterial.from_speeds(**ROCK),
                           u0=u0b, **jkw[1])},
        [jsc.SimplexContactSpec("a", "b", **spec_kw)],
        model_name=MODELS[dim], cfl=0.6, dtype=jdtype, kernel="jnp")
    tables = None
    if mesh == "3d":
        tables = {k: foot_tables_from_numpy(v) for k, v in jeng.tables.items()}
    teng = SimplexMultiEngine(
        {"a": SimplexBody(ta, IsotropicMaterial.from_speeds(**ROCK), u0=u0a,
                          **tkw[0]),
         "b": SimplexBody(tb, IsotropicMaterial.from_speeds(**ROCK), u0=u0b,
                          **tkw[1])},
        [tsc.SimplexContactSpec("a", "b", **spec_kw)],
        model_name=MODELS[dim], cfl=0.6, dtype=tdtype, device="cpu",
        tables=tables)
    if tables is None:
        for name in ("a", "b"):
            N = teng.bodies[name].grid.npoints
            none = {k: np.zeros(N, bool) for k in jeng.tables[name]}
            assert_tables_agree(teng.tables[name], jeng.tables[name], none, N)
    return jeng, teng


def assert_multi_agree(got, want, dtype="f64"):
    assert got.nsteps == want.nsteps
    for name, w in want.bodies.items():
        g = got.bodies[name]
        if dtype == "f64":
            assert got.dt == pytest.approx(want.dt, rel=1e-15)
            np.testing.assert_allclose(g, w, rtol=1e-9,
                                       atol=1e-9 * np.abs(w).max())
        else:
            assert norm_err(g, w) < 1e-5
    assert set(got.bonded) == set(want.bonded)
    for ci, w in want.bonded.items():
        g = got.bonded[ci]
        if isinstance(w, dict):                   # per side
            assert set(g) == set(w)
            for s in w:
                np.testing.assert_array_equal(g[s], np.asarray(w[s]))
        else:
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("mesh,kind,strength,broken,nsteps", ENGINE_CASES)
def test_multi_engine_matches_jax(mesh, kind, strength, broken, nsteps):
    jeng, teng = engines(mesh, kind, strength, broken, jnp.float64,
                         torch.float64)
    want = jeng.run(nsteps)
    got = teng.run(nsteps)
    assert got.kernels == {"a": "torch", "b": "torch"}
    assert_multi_agree(got, want)
    if strength is not None:
        assert 0 < got.bonded[0].mean() < 1       # fracture happened


def test_multi_engine_f32_sources_receivers_correctors_match_jax():
    jeng, teng = engines("2d", "bonded", 1e5, "slip", jnp.float32,
                         torch.float32, extras=True)
    want = jeng.run(9)
    got = teng.run(9)
    assert got.dt == pytest.approx(want.dt, rel=1e-6)
    assert_multi_agree(got, want, "f32")
    w = want.traces["a"]
    assert got.traces["a"].shape == w.shape == (9, 2, 5)
    assert np.abs(got.traces["a"] - w).max() / np.abs(w).max() < 1e-5
    assert set(got.traces) == {"a"}


def test_multi_engine_kernel_choice_on_cpu():
    ta, tb = split(SimplexGrid, "2d")
    bodies = {"a": SimplexBody(ta, IsotropicMaterial.from_speeds(**ROCK)),
              "b": SimplexBody(tb, IsotropicMaterial.from_speeds(**ROCK))}
    spec = tsc.SimplexContactSpec("a", "b", axis=0)
    for kernel in ("auto", "torch", "jnp"):
        eng = SimplexMultiEngine(bodies, [spec], device="cpu", kernel=kernel)
        assert eng.kernels == {"a": "torch", "b": "torch"}
    for kernel in ("simplex", "pallas_simplex"):
        with pytest.raises(ValueError, match="CUDA"):
            SimplexMultiEngine(bodies, [spec], device="cpu", kernel=kernel)
    with pytest.raises(ValueError, match="unknown"):
        SimplexMultiEngine(bodies, [spec], device="cpu", kernel="fused")


def test_bonded_split_equals_monolithic_run():
    """On the unjittered lattice every foot lies on a lattice edge, so the
    bonded two-body run equals the one-body run, interface nodes too."""
    dim, L, n, k, _ = SPLITS["2d"]
    g_all = SimplexGrid.box((0.0, 0.0), (L, L), (n, n))
    ga, gb = split(SimplexGrid, "2d")
    rng = np.random.default_rng(3)
    u0 = rng.standard_normal((5, g_all.npoints))
    u0[2:] *= 1e5
    tree = cKDTree(g_all.points)
    ja = tree.query(ga.points, k=1)[1]
    jb = tree.query(gb.points, k=1)[1]
    rock = IsotropicMaterial.from_speeds(**ROCK)
    mono = SimplexEngine(g_all, "elastic2d", rock, cfl=0.6, u0=u0,
                         dtype=torch.float64, device="cpu")
    multi = SimplexMultiEngine(
        {"a": SimplexBody(ga, rock, u0=u0[:, ja]),
         "b": SimplexBody(gb, rock, u0=u0[:, jb])},
        [tsc.SimplexContactSpec("a", "b", axis=0)], cfl=0.6,
        dtype=torch.float64, device="cpu")
    assert multi.dt == pytest.approx(mono.dt, rel=1e-15)
    want = mono.run(6).u
    got = multi.run(6)
    for name, j in (("a", ja), ("b", jb)):
        np.testing.assert_allclose(got.bodies[name], want[:, j], rtol=1e-10,
                                   atol=1e-6)
