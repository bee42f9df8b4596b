"""Orthotropic media on simplex meshes, port against JAX.

Orthotropic media sweep on the plain per-pair path in both packages: one
foot table per (axis, pair, direction), since the pairs of one sweep ride
different speeds. Inputs come from seeded numpy generators; JAX runs on the
CPU with x64 (tests/conftest.py).

- ``SimplexTask.material_fields``: the ten fields equal JAX's (float64 and
  float32), isotropic regions embedded through their orthotropic limit.
- ``build_foot_tables_for_model``: equal ids and outside flags, weights to
  1e-12, on a 2D mesh; equal as interpolation operators (ids with weights,
  to 1e-12) on a 3D mesh, where a foot on a face shared by two cells may
  take either, except at the feet where JAX's C++ walk cycled.
- The port's forms of tests/test_simplex.py's isotropic limit (a sweep on
  isotropic constants written as orthotropic equals the isotropic sweep)
  and anisotropy (the P front reaches farther along the stiffer axis),
  each also against JAX at 1e-9 in float64.
- ``resolve_simplex_kernel``: ``"auto"`` on orthotropic media is
  ``"torch"``, on a CUDA device too; ``"simplex"`` raises.
- ``SimplexEngine.from_task`` on an orthotropic ``simplex3d_layered``, and
  a ``SimplexMultiEngine`` with one orthotropic body, against JAX at 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.engine_simplex import SimplexBody as JSimplexBody
from gcm_tpu.engine_simplex import SimplexEngine as JSimplexEngine
from gcm_tpu.engine_simplex import SimplexMultiEngine as JSimplexMultiEngine
from gcm_tpu.grids import simplex as jsimplex
from gcm_tpu.materials import IsotropicMaterial as JIsotropicMaterial
from gcm_tpu.materials import OrthotropicMaterial as JOrthotropicMaterial
from gcm_tpu.materials import (
    OrthotropicMaterialFields as JOrthotropicMaterialFields,
)
from gcm_tpu.models.spec import get_model as jget_model
from gcm_tpu.scenarios import get_scenario as jget_scenario
from gcm_tpu.solver import simplex_gcm as jsgcm
from gcm_tpu.solver.simplex_contact import (
    SimplexContactSpec as JSimplexContactSpec,
)
from gcm_tpu_torch.convert import ORTHO_LEAVES
from gcm_tpu_torch.engine_simplex import (
    SimplexBody, SimplexEngine, SimplexMultiEngine, resolve_simplex_kernel,
)
from gcm_tpu_torch.grids import simplex as tsimplex
from gcm_tpu_torch.materials import (
    IsotropicMaterial, MaterialFields, OrthotropicMaterial,
    OrthotropicMaterialFields,
)
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.scenarios import get_scenario
from gcm_tpu_torch.solver.simplex_contact import SimplexContactSpec
from gcm_tpu_torch.solver.simplex_gcm import simplex_step
from test_torch_simplex import (  # noqa: F401  (a module fixture)
    assert_tables_agree, private_native_library,
)
from test_torch_simplex_contact import assert_multi_agree, split
from test_torch_simplex_engine import assert_runs_agree

STIFF = dict(rho=1500.0, c11=12.0e9, c12=2.0e9, c13=2.0e9, c22=4.0e9,
             c23=1.5e9, c33=5.0e9, c44=1.2e9, c55=1.4e9, c66=1.6e9)


def orthotropic(m, pkg):
    """The orthotropic medium built on the isotropic ``m`` (c33 = lam+2mu,
    c11 = 1.3 c33, c22 = 1.1 c33, c12 = c13 = c23 = lam, c44 = mu, c55 =
    1.15 mu, c66 = 1.3 mu) as ``pkg``'s OrthotropicMaterial."""
    c33 = m.lam + 2.0 * m.mu
    return pkg(rho=m.rho, c11=1.3 * c33, c12=m.lam, c13=m.lam, c22=1.1 * c33,
               c23=m.lam, c33=c33, c44=m.mu, c55=1.15 * m.mu, c66=1.3 * m.mu)


def orthoize(task, pkg, every=True):
    """``task`` with its default material (and, with ``every``, each
    region's) made :func:`orthotropic`; other regions stay isotropic."""
    regions = tuple(dataclasses.replace(r, material=orthotropic(
        r.material, pkg)) if every else r for r in task.materials)
    return dataclasses.replace(
        task, default_material=orthotropic(task.default_material, pkg),
        materials=regions)


@pytest.mark.parametrize("every", [True, False])
def test_task_material_fields_match_jax(every):
    jtask = orthoize(jget_scenario("simplex3d_layered", n=7),
                     JOrthotropicMaterial, every)
    task = orthoize(get_scenario("simplex3d_layered", n=7),
                    OrthotropicMaterial, every)
    assert task.is_orthotropic
    for jdt, tdt in ((jnp.float64, torch.float64),
                     (jnp.float32, torch.float32)):
        want = jtask.material_fields(xp=jnp, dtype=jdt)
        got = task.material_fields(dtype=tdt)
        assert isinstance(got, OrthotropicMaterialFields)
        for k in ORTHO_LEAVES:
            g = getattr(got, k)
            assert g.dtype == tdt
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(want, k)))
    iso = get_scenario("simplex3d_layered", n=7)
    assert not iso.is_orthotropic
    assert isinstance(iso.material_fields(), MaterialFields)


def ortho_fields(N, rng):
    """Random heterogeneous orthotropic fields (positive definite), in
    float64, as (JAX, port)."""
    scale = 1.0 + 0.2 * rng.random(N)
    cons = {k: v * scale for k, v in STIFF.items() if k != "rho"}
    rho = STIFF["rho"] * (1.0 + 0.1 * rng.random(N))
    j = JOrthotropicMaterialFields.from_constants(rho, cons, xp=jnp,
                                                  dtype=jnp.float64)
    t = OrthotropicMaterialFields.from_constants(rho, cons,
                                                 dtype=torch.float64)
    return j, t


@pytest.mark.parametrize("dim,n", [(2, 13), (3, 13)])
def test_per_pair_foot_tables_match_jax(dim, n):
    rng = np.random.default_rng(dim)
    jg = jsimplex.SimplexGrid.box((0.0,) * dim, (1.0,) * dim, (n,) * dim,
                                  jitter=0.15)
    tg = tsimplex.SimplexGrid.box((0.0,) * dim, (1.0,) * dim, (n,) * dim,
                                  jitter=0.15)
    jmat, tmat = ortho_fields(jg.npoints, rng)
    name = f"elastic{dim}d"
    dt = 0.7 / (n - 1) / tmat.max_cp()
    want = jsimplex.build_foot_tables_for_model(jg, jget_model(name), jmat,
                                                dt)
    got = tsimplex.build_foot_tables_for_model(tg, get_model(name), tmat, dt)
    npairs = len(get_model(name).stage(0).pairs)
    assert set(got) == set(want) == {(a, k, d) for a in range(dim)
                                     for k in range(npairs) for d in (1, -1)}
    if dim == 2:
        for key, w in want.items():
            g = got[key]
            np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
            np.testing.assert_array_equal(g.outside, np.asarray(w.outside))
            np.testing.assert_allclose(g.weights, np.asarray(w.weights),
                                       rtol=0, atol=1e-12)
    else:
        # a foot on a face shared by two cells may take either cell, with
        # the same nonzero weights: the tables agree as operators, except
        # at the few feet JAX's walk cycled on (tests/test_torch_simplex.py)
        faults = {}
        for key, w in want.items():
            a, k, d = key
            feet = jg.points.copy()
            feet[:, a] += d * tmat.axis_view(a, get_model(name).stage(a)
                                             ).pair_c[k].numpy() * dt
            faults[key] = (np.asarray(w.outside)
                           & (jg.delaunay.find_simplex(feet) >= 0))
        assert sum(int(f.sum()) for f in faults.values()) <= len(faults)
        assert_tables_agree(got, want, faults, tg.npoints)
    # the two shear pairs of a 3D sweep ride different speeds
    if dim == 3:
        assert not np.array_equal(got[(0, 1, 1)].weights,
                                  got[(0, 2, 1)].weights)


def test_isotropic_limit_matches_isotropic_run_and_jax():
    g = tsimplex.SimplexGrid.box((0, 0), (12, 12), (13, 13), jitter=0.2)
    jg = jsimplex.SimplexGrid.box((0, 0), (12, 12), (13, 13), jitter=0.2)
    iso = IsotropicMaterial.from_speeds(1200.0, 2000.0, 1000.0)
    model = get_model("elastic2d")
    dt = 0.3 * 1.0 / iso.cp
    mat = MaterialFields.uniform(iso, (g.npoints,), dtype=torch.float64)
    tabs = tsimplex.build_foot_tables(
        g, {"p": mat.cp.numpy(), "s": mat.cs.numpy()}, dt)
    om = OrthotropicMaterial.from_isotropic(iso)
    ones = np.ones(g.npoints)
    omat = OrthotropicMaterialFields.from_constants(
        om.rho * ones, {k: v * ones for k, v in om.constants().items()},
        dtype=torch.float64)
    otabs = tsimplex.build_foot_tables_for_model(g, model, omat, dt)
    assert set(otabs) == {(a, k, d) for a in (0, 1) for k in (0, 1)
                          for d in (+1, -1)}
    jom = JOrthotropicMaterial.from_isotropic(
        JIsotropicMaterial.from_speeds(1200.0, 2000.0, 1000.0))
    jomat = JOrthotropicMaterialFields.from_constants(
        jom.rho * ones, {k: v * ones for k, v in jom.constants().items()},
        xp=jnp, dtype=jnp.float64)
    jotabs = jsimplex.build_foot_tables_for_model(
        jg, jget_model("elastic2d"), jomat, dt)
    u0 = np.random.default_rng(3).standard_normal((model.ncomp, g.npoints))
    u_iso = u_ort = torch.tensor(u0)
    u_jax = jnp.asarray(u0)
    for _ in range(3):
        u_iso = simplex_step(model, u_iso, mat, tabs)
        u_ort = simplex_step(model, u_ort, omat, otabs)
        u_jax = jsgcm.simplex_step(jget_model("elastic2d"), u_jax, jomat,
                                   jotabs)
    np.testing.assert_allclose(u_ort.numpy(), u_iso.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(u_ort.numpy(), np.asarray(u_jax), rtol=1e-9,
                               atol=1e-9 * np.abs(u0).max())


def test_engine_anisotropy_matches_jax():
    """The P front moves faster along the stiffer axis (c11 = 3 c22), in
    the port as in JAX."""
    n = 41
    g = tsimplex.SimplexGrid.box((0, 0), (n - 1.0, n - 1.0), (n, n),
                                 jitter=0.1)
    jg = jsimplex.SimplexGrid.box((0, 0), (n - 1.0, n - 1.0), (n, n),
                                  jitter=0.1)
    u0 = np.zeros((5, g.npoints))
    r2 = ((g.points - (n - 1) / 2.0) ** 2).sum(1)
    blob = np.exp(-r2 / (2 * 1.5 ** 2))
    u0[2] = blob
    u0[4] = blob
    eng = SimplexEngine(g, "elastic2d", OrthotropicMaterial(**STIFF),
                        cfl=0.6, u0=u0, dtype=torch.float64, device="cpu")
    assert isinstance(eng.mat, OrthotropicMaterialFields)
    assert (0, 1, 1) in eng.tables
    res = eng.run(nsteps=14)
    assert res.kernel == "torch"
    want = JSimplexEngine(jg, "elastic2d", JOrthotropicMaterial(**STIFF),
                          cfl=0.6, u0=u0, dtype=jnp.float64).run(nsteps=14)
    assert res.dt == pytest.approx(want.dt, rel=1e-15)
    np.testing.assert_allclose(res.u, want.u, rtol=1e-9,
                               atol=1e-9 * np.abs(want.u).max())
    v = np.sqrt(res.u[0] ** 2 + res.u[1] ** 2)
    c = (n - 1) / 2.0
    lit = g.points[v > 0.05 * v.max()]
    reach_x = np.abs(lit[:, 0] - c).max()
    reach_y = np.abs(lit[:, 1] - c).max()
    assert reach_x > 1.25 * reach_y, (reach_x, reach_y)


def test_kernel_resolution_on_orthotropic_media():
    om = OrthotropicMaterial(**STIFF)
    ones = np.ones(4)
    omat = OrthotropicMaterialFields.from_constants(
        om.rho * ones, {k: v * ones for k, v in om.constants().items()})
    imat = MaterialFields.uniform(IsotropicMaterial(2500.0, 1e9, 5e8), (4,))
    for device in ("cpu", "cuda"):
        assert resolve_simplex_kernel("auto", device, omat) == "torch"
        assert resolve_simplex_kernel("torch", device, omat) == "torch"
        assert resolve_simplex_kernel("jnp", device, omat) == "torch"
        with pytest.raises(ValueError, match="isotropic"):
            resolve_simplex_kernel("simplex", device, omat)
        with pytest.raises(ValueError, match="isotropic"):
            resolve_simplex_kernel("pallas_simplex", device, omat)
    assert resolve_simplex_kernel("auto", "cuda", imat) == "simplex"
    assert resolve_simplex_kernel("pallas_simplex", "cuda", imat) == "simplex"
    task = orthoize(get_scenario("simplex3d_layered", n=5, nsteps=2),
                    OrthotropicMaterial)
    with pytest.raises(ValueError, match="isotropic"):
        SimplexEngine.from_task(dataclasses.replace(task, kernel="simplex"),
                                device="cpu")


def test_orthotropic_task_engine_matches_jax():
    """``simplex3d_layered`` at n=13 (a mesh where the two locators agree)
    with its default layer orthotropic and the others isotropic, source
    and receivers, through both packages' ``from_task``."""
    jtask = orthoize(jget_scenario("simplex3d_layered", n=13, nsteps=7),
                     JOrthotropicMaterial, every=False)
    task = orthoize(get_scenario("simplex3d_layered", n=13, nsteps=7),
                    OrthotropicMaterial, every=False)
    jeng = JSimplexEngine.from_task(jtask, dtype=jnp.float64)
    eng = SimplexEngine.from_task(task, device="cpu", dtype=torch.float64)
    assert isinstance(eng.mat, OrthotropicMaterialFields)
    got = eng.run()
    assert got.kernel == "torch" and got.nsteps == 7
    assert_runs_agree(got, jeng.run(), "f64")


def test_multi_engine_with_an_orthotropic_body_matches_jax():
    ja, jb = split(jsimplex.SimplexGrid, "2d")
    ta, tb = split(tsimplex.SimplexGrid, "2d")
    rng = np.random.default_rng(4)
    u0 = []
    for g in (ta, tb):
        u = rng.standard_normal((5, g.npoints))
        u[2:] *= 1e5
        u0.append(u)
    rock = dict(rho=1000.0, cp=2000.0, cs=1100.0)
    spec = dict(axis=0, kind="bonded", tensile_strength=1e5,
                broken_kind="slip")
    jeng = JSimplexMultiEngine(
        {"a": JSimplexBody(ja, orthotropic(JIsotropicMaterial.from_speeds(
            **rock), JOrthotropicMaterial), u0=u0[0]),
         "b": JSimplexBody(jb, JIsotropicMaterial.from_speeds(**rock),
                           u0=u0[1])},
        [JSimplexContactSpec("a", "b", **spec)], model_name="elastic2d",
        cfl=0.6, dtype=jnp.float64, kernel="jnp")
    eng = SimplexMultiEngine(
        {"a": SimplexBody(ta, orthotropic(IsotropicMaterial.from_speeds(
            **rock), OrthotropicMaterial), u0=u0[0]),
         "b": SimplexBody(tb, IsotropicMaterial.from_speeds(**rock),
                          u0=u0[1])},
        [SimplexContactSpec("a", "b", **spec)], model_name="elastic2d",
        cfl=0.6, dtype=torch.float64, device="cpu")
    assert isinstance(eng.mats["a"], OrthotropicMaterialFields)
    assert (0, 1, 1) in eng.tables["a"] and (0, "s", 1) in eng.tables["b"]
    want = jeng.run(10)
    got = eng.run(10)
    assert got.kernels == {"a": "torch", "b": "torch"}
    assert_multi_agree(got, want)
    assert 0 < got.bonded[0].mean() < 1
