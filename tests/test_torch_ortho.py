"""Orthotropic media in the port, module by module, against the JAX package
and the NumPy oracles.

Inputs come from a seeded numpy generator and cross over as numpy arrays
(``convert.ortho_material_fields_from_numpy``), so both packages start from
identical parameters. Tolerances: float64 views and oracles 1e-12 (the same
arithmetic); the plain step against JAX's 1e-10 (tests/test_torch_step.py);
the plain step against the orthotropic oracle rtol 1e-8 / atol 1e-10 and
the isotropic oracle 1e-10 / 1e-9 (tests/test_oracle_ortho.py,
tests/test_solver_parity.py:62,81); the plain fused versions on orthotropic
stacks against JAX's kernels in interpret mode 3e-6 normalized
(tests/test_fused_variants.py:108, 152).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcm_tpu.materials as jmaterials
import gcm_tpu.task as jtask
import gcm_tpu_torch.materials as tmaterials
import gcm_tpu_torch.task as ttask
from gcm_tpu.models.spec import get_model as jget_model
from gcm_tpu.ops import pallas_fused as jfused
from gcm_tpu.oracle import oracle as joracle
from gcm_tpu.oracle import oracle_ortho as joracle_ortho
from gcm_tpu.solver.gcm import step as jstep
from gcm_tpu_torch.convert import (
    ORTHO_LEAVES, ortho_material_fields_from_numpy, state_from_numpy)
from gcm_tpu_torch.materials import (
    AxisViewCache, MaterialFields, OrthotropicMaterial,
    OrthotropicMaterialFields)
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.fused import (
    fused_step, fused_step_2d, fused_step_2d_reference, fused_step_reference,
    infer_layout, mat_layout, ortho_mat_layout, stack_mats, stack_mats_ortho)
from gcm_tpu_torch.ops.interp import stencil_radius
from gcm_tpu_torch.oracle import oracle_run
from gcm_tpu_torch.oracle.oracle_ortho import build_jacobian, oracle_ortho_run
from gcm_tpu_torch.solver.gcm import axes_order, stage, step
from test_torch_step import borders_pair, norm_err

H3 = (10.0, 12.0, 9.0)
#: the layered pair of tests/test_oracle_ortho.py
ORTHO = dict(rho=1500.0, c11=12.0e9, c12=2.5e9, c13=1.8e9, c22=9.0e9,
             c23=2.1e9, c33=14.0e9, c44=2.2e9, c55=3.1e9, c66=2.7e9)
ORTHO2 = dict(rho=2200.0, c11=20.0e9, c12=4.0e9, c13=3.0e9, c22=16.0e9,
              c23=3.5e9, c33=24.0e9, c44=4.0e9, c55=5.5e9, c66=4.8e9)


def orthotropic(m, cls):
    """An orthotropic medium built on the isotropic ``m`` (either package's
    material, made as ``cls``): c33 = lam+2mu, c11 = 1.3 c33, c22 = 1.1 c33,
    off-diagonals lam, c44 = mu, c55 = 1.15 mu, c66 = 1.3 mu."""
    c33 = m.lam + 2.0 * m.mu
    return cls(rho=m.rho, c11=1.3 * c33, c12=m.lam, c13=m.lam, c22=1.1 * c33,
               c23=m.lam, c33=c33, c44=m.mu, c55=1.15 * m.mu, c66=1.3 * m.mu)


def orthoize(task, cls):
    """``task`` with every material region made :func:`orthotropic`."""
    return dataclasses.replace(
        task, default_material=orthotropic(task.default_material, cls),
        materials=tuple(dataclasses.replace(r, material=orthotropic(
            r.material, cls)) for r in task.materials))


def ortho_problem(rng, name, shape, dtype=np.float64):
    """Random heterogeneous orthotropic medium (the recipe of
    tests/test_fused_variants.py) and smooth state for both packages:
    (model, jax state, jax fields, torch state, torch fields, dt) with dt
    at half the CFL limit on ``H3``."""
    model = jget_model(name)
    ones = np.ones(shape)
    rho = 2500.0 * (1.0 + 0.2 * rng.random(shape))
    c = {"c11": 60e9 * (1 + 0.1 * rng.random(shape)), "c22": 45e9 * ones,
         "c33": 70e9 * (1 + 0.1 * rng.random(shape)), "c12": 12e9 * ones,
         "c13": 10e9 * ones, "c23": 14e9 * ones, "c44": 18e9 * ones,
         "c55": 22e9 * (1 + 0.1 * rng.random(shape)), "c66": 16e9 * ones}
    jmat = jmaterials.OrthotropicMaterialFields.from_constants(
        rho, c, xp=jnp, dtype=dtype)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tmat = ortho_material_fields_from_numpy(
        {k: np.asarray(getattr(jmat, k)) for k in ORTHO_LEAVES},
        dtype=tdtype)
    u0 = rng.standard_normal((model.ncomp,) + shape)
    for a in range(1, u0.ndim):
        u0 = 0.25 * np.roll(u0, 1, a) + 0.5 * u0 + 0.25 * np.roll(u0, -1, a)
    u0[model.dim:] *= 1e6
    u0 = u0.astype(dtype)
    dt = 0.5 * min(H3[:len(shape)]) / jmat.max_cp()
    return (model, jnp.asarray(u0), jmat, state_from_numpy(u0, dtype=tdtype),
            tmat, dt)


# ---------------------------------------------------------------- materials

@pytest.mark.parametrize("name,shape", [("elastic3d", (4, 5, 6)),
                                        ("elastic2d", (5, 6))])
def test_axis_views_match_jax(rng, name, shape):
    model, _, jmat, _, tmat, _ = ortho_problem(rng, name, shape)
    tmodel = get_model(name)
    assert tmat.max_cp() == pytest.approx(jmat.max_cp(), rel=1e-15)
    cache = AxisViewCache(tmat)
    for axis in range(model.dim):
        jv = jmat.axis_view(axis, model.stage(axis))
        tv = tmat.axis_view(axis, tmodel.stage(axis))
        for leaf in ("pair_c", "pair_z", "zero_kappa"):
            want, got = getattr(jv, leaf), getattr(tv, leaf)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-12, atol=0)
        first = cache.axis_view(axis, tmodel.stage(axis))
        assert cache.axis_view(axis, tmodel.stage(axis)) is first
        torch.testing.assert_close(first.pair_c, tv.pair_c, rtol=0, atol=0)
    assert cache.max_cp() == tmat.max_cp()
    assert tmaterials._DIAG_AXIS_OF_COMP == jmaterials._DIAG_AXIS_OF_COMP


def test_materials_match_jax():
    iso = tmaterials.IsotropicMaterial.from_speeds(2000.0, 3500.0, 1800.0)
    jiso = jmaterials.IsotropicMaterial.from_speeds(2000.0, 3500.0, 1800.0)
    got = OrthotropicMaterial.from_isotropic(iso)
    want = jmaterials.OrthotropicMaterial.from_isotropic(jiso)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.constants() == want.constants()
    cons = {k: np.linspace(1e9, 2e9, 6) * (j + 1)
            for j, k in enumerate(got.constants())}
    t = OrthotropicMaterialFields.from_constants(np.full(6, 1500.0), cons,
                                                 dtype=torch.float32)
    j = jmaterials.OrthotropicMaterialFields.from_constants(
        np.full(6, 1500.0), cons)
    for k in ORTHO_LEAVES:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)))


def _layered_task(task_mod, mat_mod, name, shape):
    """An isotropic body with an orthotropic layer and an isotropic ball
    inside it, of either package."""
    iso = mat_mod.IsotropicMaterial.from_speeds(2000.0, 3000.0, 1500.0)
    iso2 = mat_mod.IsotropicMaterial.from_speeds(2400.0, 4100.0, 2200.0)
    dim = len(shape)
    return task_mod.Task(
        name="mixed", model=name,
        grid=task_mod.GridSpec(shape, (1.0,) * dim),
        default_material=iso,
        materials=(
            task_mod.MaterialRegion(task_mod.AreaLayer(0, 2.0, 9.0),
                                    mat_mod.OrthotropicMaterial(**ORTHO)),
            task_mod.MaterialRegion(task_mod.AreaBall((4.0,) * dim, 1.5),
                                    iso2)),
        time=task_mod.TimeSpec(nsteps=1))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("name,shape", [("elastic3d", (8, 7, 6)),
                                        ("elastic2d", (8, 7))])
def test_task_material_fields_match_jax(name, shape, dtype):
    """Mixed isotropic/orthotropic regions: the orthotropic constants
    rasterize in float64 and cast once, as in JAX, so the fields are equal
    in either type."""
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    t = _layered_task(ttask, tmaterials, name, shape)
    j = _layered_task(jtask, jmaterials, name, shape)
    assert t.is_orthotropic and j.is_orthotropic
    got = t.material_fields(dtype=tdt)
    want = j.material_fields(xp=jnp, dtype=jdt)
    assert isinstance(got, OrthotropicMaterialFields)
    for k in ORTHO_LEAVES:
        assert getattr(got, k).dtype == tdt
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    iso = dataclasses.replace(t, materials=t.materials[1:])
    assert not iso.is_orthotropic
    assert isinstance(iso.material_fields(), MaterialFields)


# ------------------------------------------------------------- plain step

@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name,shape", [("elastic3d", (6, 7, 8)),
                                        ("elastic2d", (9, 11))])
def test_plain_step_matches_jax(rng, name, shape, order):
    """``solver.gcm.step`` and ``stage`` on orthotropic fields against JAX's
    jnp step, every border kind, both sweep orders (float64)."""
    model, ju, jmat, tu, tmat, dt = ortho_problem(rng, name, shape)
    jb, tb = borders_pair(model.dim)
    tmodel = get_model(name)
    h = H3[:model.dim]
    for axes in (tuple(range(model.dim)), tuple(range(model.dim))[::-1]):
        want = np.asarray(jstep(model, ju, jmat, dt, h, order, jb, axes))
        got = step(tmodel, tu, tmat, dt, h, order, tb, axes).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    one = stage(tmodel, tu, tmat, dt, h, 0, order, tb).numpy()
    want = np.asarray(jstep(model, ju, jmat, dt, h, order, jb, (0,)))
    np.testing.assert_allclose(one, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_sweep_params_hold_the_views_they_point_to(rng):
    """The per-sweep kernel's parameters point into the fields that
    ``_sweep_params`` returns and the wrapper holds across the launch: an
    orthotropic view is computed anew on every call, and a freed view's
    memory could become the kernel's output."""
    from gcm_tpu_torch.ops.sweep import _sweep_params

    _, _, _, tu, tmat, dt = ortho_problem(rng, "elastic3d", (4, 5, 6),
                                          np.float32)
    tmodel = get_model("elastic3d")
    for axis in range(3):
        p, fields = _sweep_params(tmodel, tu, tmat, dt, H3, axis, None)
        st = tmodel.stage(axis)
        npairs, nzeros = len(st.pairs), len(st.zeros)
        assert list(p.pair_c[:npairs]) + list(p.pair_z[:npairs]) + list(
            p.zero_kappa[:nzeros]) == [f.data_ptr() for f in fields]


# ----------------------------------------------------------------- oracles

def test_oracles_match_jax(rng):
    """The port's copies of the NumPy oracles against JAX's, on the same
    inputs: an isotropic 2D run with borders, an orthotropic layered 2D run
    and the Jacobians of each axis."""
    shape = (7, 6)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = rng.standard_normal((5,) + shape)
    dt = 0.6 / np.sqrt((lam + 2 * mu) / rho).max()
    jb, tb = borders_pair(2)
    want = joracle.oracle_run("elastic2d", u0, rho, lam, mu, dt, (1.0, 1.3),
                              2, 2, jb)
    got = oracle_run("elastic2d", u0, rho, lam, mu, dt, (1.0, 1.3), 2, 2, tb)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    tm = [OrthotropicMaterial(**ORTHO), OrthotropicMaterial(**ORTHO2)]
    jm = [jmaterials.OrthotropicMaterial(**ORTHO),
          jmaterials.OrthotropicMaterial(**ORTHO2)]
    tobj, jobj = np.empty(shape, object), np.empty(shape, object)
    for idx in np.ndindex(*shape):
        tobj[idx], jobj[idx] = tm[idx[1] >= 3], jm[idx[1] >= 3]
    dt = 0.5 * 10.0 / np.sqrt(ORTHO2["c11"] / ORTHO2["rho"])
    want = joracle_ortho.oracle_ortho_run("elastic2d", u0, jobj, dt,
                                          (10.0, 10.0), 2, 2)
    got = oracle_ortho_run("elastic2d", u0, tobj, dt, (10.0, 10.0), 2, 2)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(
        want).max())
    for name in ("elastic2d", "elastic3d"):
        for ax in range(jget_model(name).dim):
            np.testing.assert_array_equal(
                build_jacobian(get_model(name), tm[0], ax),
                joracle_ortho.build_jacobian(jget_model(name), jm[0], ax))


def _smooth(rng, shape, ncomp):
    u = rng.standard_normal((ncomp,) + shape)
    for a in range(1, len(shape) + 1):
        u = 0.25 * np.roll(u, 1, a) + 0.5 * u + 0.25 * np.roll(u, -1, a)
    return u


def _uniform(m, shape):
    return OrthotropicMaterialFields.from_constants(
        np.full(shape, m.rho), {k: np.full(shape, v)
                                for k, v in m.constants().items()},
        dtype=torch.float64)


def _max_speed(m):
    return max(np.sqrt(c / m.rho) for c in
               (m.c11, m.c22, m.c33, m.c44, m.c55, m.c66))


@pytest.mark.parametrize("case", ["2d-o1", "2d-o2", "3d-o1", "3d-o2",
                                  "2d-layered"])
def test_plain_step_matches_ortho_oracle(rng, case):
    """The cases of tests/test_oracle_ortho.py on the port: its plain step
    against its numeric-eigendecomposition oracle, on the nodes whose domain
    of dependence stays inside the grid."""
    m1, m2 = OrthotropicMaterial(**ORTHO), OrthotropicMaterial(**ORTHO2)
    name = "elastic3d" if case.startswith("3d") else "elastic2d"
    model = get_model(name)
    shape, nsteps = {"elastic3d": ((10, 9, 8), 2),
                     "elastic2d": ((16, 14), 3)}[name]
    if case == "2d-layered":
        shape = (16, 12)
    order = 1 if case.endswith("o1") else 2
    h = (10.0,) * model.dim
    u0 = _smooth(rng, shape, model.ncomp)
    if case == "2d-layered":
        layer = np.arange(shape[1]) >= shape[1] // 2
        oracle_mats = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            oracle_mats[idx] = m2 if layer[idx[1]] else m1
        mat = OrthotropicMaterialFields.from_constants(
            np.where(layer, m2.rho, m1.rho) * np.ones(shape),
            {k: np.where(layer, getattr(m2, k), getattr(m1, k))
             * np.ones(shape) for k in m1.constants()}, dtype=torch.float64)
        dt = 0.6 * min(h) / max(_max_speed(m1), _max_speed(m2))
    else:
        oracle_mats, mat = m1, _uniform(m1, shape)
        dt = 0.6 * min(h) / _max_speed(m1)
    u = torch.tensor(u0)
    for n in range(nsteps):
        u = step(model, u, mat, dt, h, order, None,
                 axes_order(model.dim, n, True))
    want = oracle_ortho_run(name, u0, oracle_mats, dt, h, order, nsteps)
    r = nsteps * stencil_radius(order) + 1
    sl = (slice(None),) + (slice(r, -r),) * model.dim
    np.testing.assert_allclose(u.numpy()[sl], want[sl], rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("name,shape,order,tol", [
    ("acoustic1d", (31,), 1, 1e-10), ("acoustic1d", (31,), 2, 1e-10),
    ("elastic1d", (31,), 2, 1e-10), ("elastic2d", (12, 14), 1, 1e-9),
    ("elastic2d", (12, 14), 2, 1e-9), ("elastic2d", (12, 14), 3, 1e-9),
    ("elastic3d", (8, 9, 10), 2, 1e-9)])
def test_plain_step_matches_isotropic_oracle(rng, name, shape, order, tol):
    """The cases of tests/test_solver_parity.py on the port: its plain step
    on heterogeneous isotropic media against its copy of the oracle, with
    borders, at that file's tolerances."""
    model = get_model(name)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    if name.startswith("acoustic"):
        mu = np.zeros(shape)
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = _smooth(rng, shape, model.ncomp)
    h = {1: (1.0,), 2: (1.0, 1.3), 3: (1.0, 1.1, 0.9)}[model.dim]
    dt = 0.6 * min(h) / np.sqrt((lam + 2 * mu) / rho).max()
    kinds = ("free", "fixed_force", "absorbing", "fixed_velocity",
             "absorbing", "free")
    values = {"fixed_force": 0.5, "fixed_velocity": (0.1, -0.2, 0.3)[
        :model.dim]}
    borders = {(a, s): ttask.BorderSpec(kinds[2 * a + s],
                                        values.get(kinds[2 * a + s]))
               for a in range(model.dim) for s in (0, 1)}
    nsteps = {1: 5, 2: 4, 3: 3}[model.dim]
    mat = MaterialFields.from_arrays(rho, lam, mu, dtype=torch.float64)
    u = torch.tensor(u0)
    for n in range(nsteps):
        u = step(model, u, mat, dt, h, order, borders,
                 axes_order(model.dim, n, True))
    want = oracle_run(name, u0, rho, lam, mu, dt, h, order, nsteps, borders)
    np.testing.assert_allclose(u.numpy(), want, rtol=tol, atol=tol)


# ---------------------------------------------------------- material stacks

@pytest.mark.parametrize("name,shape", [("elastic3d", (4, 5, 6)),
                                        ("elastic2d", (5, 6))])
def test_ortho_stack_matches_jax(rng, name, shape):
    model, _, jmat, _, tmat, _ = ortho_problem(rng, name, shape, np.float32)
    tmodel = get_model(name)
    assert ortho_mat_layout(tmodel) == jfused.ortho_mat_layout(model)
    nm = len(ortho_mat_layout(tmodel))
    assert nm == {"elastic3d": 13, "elastic2d": 6}[name]
    assert infer_layout(tmodel, nm) == jfused.infer_layout(model, nm)
    assert infer_layout(tmodel, len(mat_layout(tmodel))) == "compact"
    with pytest.raises(ValueError):    # the JAX "derived" layout
        infer_layout(tmodel, len(jfused.mat_layout(model)))
    want = np.asarray(jfused.stack_mats_ortho(model, jmat))
    got = stack_mats_ortho(tmodel, tmat)
    assert got.is_contiguous() and got.dtype == torch.float32
    # XLA's float32 sqrt and division may round a value 1 ulp apart
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=0)
    torch.testing.assert_close(stack_mats(tmodel, tmat), got, rtol=0, atol=0)
    # a bf16 stack rounds to nearest even, 1 bf16 ulp at most apart
    np.testing.assert_allclose(
        stack_mats(tmodel, tmat, dtype=torch.bfloat16).float().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(
            jnp.float32)), rtol=2 ** -8, atol=0)


def test_fused_reference_on_ortho_stack_matches_jax_kernel(rng):
    """The 3D plain fused version on an orthotropic stack against JAX's
    fused kernel in interpret mode (float32)."""
    model, ju, jmat, tu, tmat, dt = ortho_problem(rng, "elastic3d",
                                                  (8, 16, 8), np.float32)
    jb, tb = borders_pair(3)
    tmodel = get_model("elastic3d")
    ms = stack_mats(tmodel, tmat)
    for order, axes in ((1, (0, 1, 2)), (2, (2, 1, 0))):
        want = jfused.fused_step(model, ju, jfused.stack_mats_ortho(
            model, jmat), dt, H3, order, jb, axes, bx=4, by=8,
            interpret=True)
        got = fused_step(tmodel, tu, ms, dt, H3, order, tb, axes)
        assert norm_err(got, want) < 3e-6
        # the plain fused version is the plain step on the fields
        torch.testing.assert_close(
            fused_step_reference(tmodel, tu, ms, dt, H3, order, tb, axes),
            step(tmodel, tu, tmat, dt, H3, order, tb, axes), rtol=0, atol=0)


def test_fused_2d_reference_on_ortho_stack_matches_jax_kernel(rng):
    model, ju, jmat, tu, tmat, dt = ortho_problem(rng, "elastic2d", (24, 16),
                                                  np.float32)
    jb, tb = borders_pair(2)
    tmodel = get_model("elastic2d")
    ms = stack_mats(tmodel, tmat)
    for axes in ((0, 1), (1, 0)):
        want = jfused.fused_step_2d(model, ju, jfused.stack_mats_ortho(
            model, jmat), dt, H3[:2], 2, jb, axes, bx=8, interpret=True)
        got = fused_step_2d(tmodel, tu, ms, dt, H3[:2], 2, tb, axes)
        assert norm_err(got, want) < 3e-6
        torch.testing.assert_close(
            fused_step_2d_reference(tmodel, tu, ms, dt, H3[:2], 2, tb, axes),
            step(tmodel, tu, tmat, dt, H3[:2], 2, tb, axes), rtol=0, atol=0)
