"""The port's engines on orthotropic media, against the JAX package's.

Both packages build the same tasks (their own scenario registries and
material classes, the same parameters; ``test_torch_ortho.orthoize`` turns
each isotropic region into an orthotropic one) and run on the CPU: JAX on
its jnp path, the port on its plain, fused and per-sweep paths (the
wrappers' plain versions on CPU tensors). Tolerances as
tests/test_torch_engine.py: float64 1e-9, float32 1e-5 normalized; a
sharded run against the unsharded one 1e-12 (1e-6 on the per-sweep path,
whose border post-fixup rounds differently in float32); a bonded contact
against the monolithic body 1e-12, as tests/test_contact.py holds it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcm_tpu.materials as jmaterials
from gcm_tpu.engine import Engine as JEngine
from gcm_tpu.engine_multi import MultiBodyEngine as JMultiBodyEngine
from gcm_tpu.scenarios import elastic3d_contact as jcontact
from gcm_tpu.scenarios import get_scenario as jget_scenario
from gcm_tpu_torch.engine import Engine
from gcm_tpu_torch.engine_multi import MultiBodyEngine
from gcm_tpu_torch.materials import (
    OrthotropicMaterial, OrthotropicMaterialFields)
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.fused import fused_step
from gcm_tpu_torch.parallel.sharding import domain_mesh
from gcm_tpu_torch.scenarios import elastic3d_contact as tcontact
from gcm_tpu_torch.scenarios import get_scenario
from gcm_tpu_torch.solver.contact import ContactSpec
from gcm_tpu_torch.solver.gcm import step
from gcm_tpu_torch.solver.multi import step_multi
from gcm_tpu_torch.task import (
    AreaBall, BorderSpec, GridSpec, InitialCondition, Task, TimeSpec)
from test_torch_engine import _assert_runs_agree
from test_torch_multibody import _agree
from test_torch_ortho import orthoize
from test_torch_step import norm_err


def _ortho2d_task(pkg):
    """The task of tests/test_orthotropic.py::test_engine_orthotropic_task,
    from ``pkg`` (a module with the Task classes and OrthotropicMaterial)."""
    rho = 1500.0
    ortho = pkg.OrthotropicMaterial(
        rho=rho, c11=12.0e9, c12=2.0e9, c13=2.0e9, c22=4.0e9, c23=1.5e9,
        c33=5.0e9, c44=1.2e9, c55=1.4e9, c66=1.6e9)
    n = 61
    return pkg.Task(
        name="ortho2d", model="elastic2d",
        grid=pkg.GridSpec(shape=(n, n), h=(1.0, 1.0)),
        default_material=ortho,
        initial=(pkg.InitialCondition(
            pkg.AreaBall(center=(30.0, 30.0), radius=2.5),
            {"sxx": 1.0, "syy": 1.0}),),
        borders={(a, s): pkg.BorderSpec("absorbing")
                 for a in (0, 1) for s in (0, 1)},
        time=pkg.TimeSpec(cfl=0.8, nsteps=16), order=2)


class _Port:
    OrthotropicMaterial = OrthotropicMaterial
    Task, GridSpec, InitialCondition = Task, GridSpec, InitialCondition
    AreaBall, BorderSpec, TimeSpec = AreaBall, BorderSpec, TimeSpec


class _Jax:
    from gcm_tpu.task import (  # noqa: F401
        AreaBall, BorderSpec, GridSpec, InitialCondition, Task, TimeSpec)
    OrthotropicMaterial = jmaterials.OrthotropicMaterial


def test_engine_orthotropic_task_matches_jax():
    """float64: the port's Engine equals JAX's to 1e-9, and the wavefront
    reaches farther along x than along y, by about sqrt(c11/c22)."""
    want = JEngine(_ortho2d_task(_Jax), dtype=jnp.float64).run()
    eng = Engine(_ortho2d_task(_Port), device="cpu", dtype=torch.float64)
    assert isinstance(eng.mat, OrthotropicMaterialFields)
    got = eng.run()
    assert got.dt == pytest.approx(want.dt, rel=1e-15)
    np.testing.assert_allclose(got.u, want.u, rtol=1e-9,
                               atol=1e-9 * np.abs(want.u).max())
    vmag = np.sqrt(got.u[0] ** 2 + got.u[1] ** 2)
    thresh = 0.02 * vmag.max()
    reach_x = np.abs(np.nonzero(vmag[:, 30] > thresh)[0] - 30).max()
    reach_y = np.abs(np.nonzero(vmag[30, :] > thresh)[0] - 30).max()
    assert reach_x > reach_y, (reach_x, reach_y)
    np.testing.assert_allclose(reach_x / reach_y, np.sqrt(12.0 / 4.0),
                               rtol=0.35)


@pytest.mark.parametrize("kernel", ["torch", "fused", "sweep"])
def test_3d_engine_matches_jax_f32(kernel):
    """A small orthotropic elastic3d_explosion (7 steps, an odd tail) on
    each path of the port against JAX's jnp engine, in float32."""
    jtask = orthoize(jget_scenario("elastic3d_explosion", n=16, nsteps=7),
                     jmaterials.OrthotropicMaterial)
    ttask = orthoize(get_scenario("elastic3d_explosion", n=16, nsteps=7),
                     OrthotropicMaterial)
    want = JEngine(jtask, dtype=jnp.float32).run()
    eng = Engine(dataclasses.replace(ttask, kernel=kernel), device="cpu")
    assert eng._mstack is None or eng._mstack.shape[0] == 13
    got = eng.run()
    assert got.kernel == kernel
    _assert_runs_agree(got, want, "f32")
    if kernel == "sweep":
        # each axis's view computed once, at its first sweep
        assert len(eng._sweep_mat._views) == 3


def test_canonical_order_stays_off_for_orthotropic_media():
    """The canonical order engages for isotropic media only (JAX
    ``engine.py:104-110`` and ``engine_multi.py:132-139``)."""
    base = get_scenario("elastic3d_explosion", n=8, nsteps=1)
    base = dataclasses.replace(base, grid=dataclasses.replace(
        base.grid, shape=(128, 8, 8)), kernel="fused", detectors=None,
        canonical_layout=True)
    assert Engine(base, device="cpu")._fwd == (1, 2, 0)
    eng = Engine(orthoize(base, OrthotropicMaterial), device="cpu")
    assert eng._fwd == (0, 1, 2) and eng._mstack.shape[0] == 13
    bodies, contacts = tcontact(n=12, nsteps=2)
    bodies = {k: dataclasses.replace(t, kernel="fused")
              for k, t in bodies.items()}
    iso = MultiBodyEngine(bodies, contacts, device="cpu",
                          canonical_layout=True)
    assert iso.path == "fused_canonical"
    ortho = MultiBodyEngine(
        {k: orthoize(t, OrthotropicMaterial) for k, t in bodies.items()},
        contacts, device="cpu", canonical_layout=True)
    assert ortho.path == "fused" and ortho._fwd == (0, 1, 2)
    assert all(ms.shape[0] == 13 for ms in ortho._mstacks.values())


@pytest.mark.parametrize("kernel,dtype", [("fused", torch.float32),
                                          ("sweep", torch.float32),
                                          ("torch", torch.float64)])
@pytest.mark.parametrize("scenario,n,shape", [
    ("elastic3d_explosion", 16, (2, 2)), ("elastic2d_viscoelastic", 32, (2,))])
def test_sharded_engine_matches_unsharded(scenario, n, shape, kernel, dtype):
    """Engine(mesh=) on CPU shards against Engine(device="cpu") on
    orthotropic media: the orthotropic extended stacks (fused), the halo
    step with views computed once (sweep, torch)."""
    task = dataclasses.replace(orthoize(get_scenario(
        scenario, n=n, nsteps=5), OrthotropicMaterial), kernel=kernel)
    mesh = domain_mesh(task.grid.dim, ["cpu"] * int(np.prod(shape)), shape)
    eng = Engine(task, mesh=mesh, dtype=dtype)
    got, want = eng.run(), Engine(task, device="cpu", dtype=dtype).run()
    assert got.kernel == want.kernel == kernel and len(eng.u) == mesh.size
    if kernel == "fused":
        assert all(m.shape[0] == (13 if task.grid.dim == 3 else 6)
                   for m in eng._carry)
    assert norm_err(got.u, want.u) < (1e-12 if kernel != "sweep" else 1e-6)
    assert np.abs(want.u).max() > 0


@pytest.mark.parametrize("dtype,kernel", [("f64", "torch"), ("f32", "fused")])
def test_multibody_engine_matches_jax(dtype, kernel):
    """elastic3d_contact with orthotropic bodies (float64 on the plain
    path, float32 on the fused path: one fused step per body on its
    orthotropic stack plus the face-row fixups), from a common, partly
    broken bond mask, against JAX's jnp MultiBodyEngine."""
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    jb, jc = jcontact(n=12, nsteps=12)
    tb, tc = tcontact(n=12, nsteps=12)
    jb = {k: orthoize(t, jmaterials.OrthotropicMaterial)
          for k, t in jb.items()}
    tb = {k: dataclasses.replace(orthoize(t, OrthotropicMaterial),
                                 kernel=kernel) for k, t in tb.items()}
    mask = (np.random.default_rng(3).random((12, 12)) > 0.3).astype(
        np.float64 if dtype == "f64" else np.float32)
    jeng = JMultiBodyEngine(jb, jc, dtype=jdt)
    jeng.bonded = {0: jnp.asarray(mask)}
    want = jeng.run()
    eng = MultiBodyEngine(tb, tc, device="cpu", dtype=tdt)
    assert eng.path == kernel
    eng.bonded = {0: torch.tensor(mask)}
    before = fused_step.launches
    got = eng.run()
    assert fused_step.launches == before        # CPU tensors: plain versions
    _agree(got, want, dtype)


def _split(u, k, axis):
    """The monolithic state split at node k, collocated on both sides."""
    idx_a = [slice(None)] * u.ndim
    idx_b = [slice(None)] * u.ndim
    idx_a[axis + 1] = slice(0, k + 1)
    idx_b[axis + 1] = slice(k, None)
    return u[tuple(idx_a)], u[tuple(idx_b)]


def _uniform_ortho(shape):
    ones = torch.ones(shape, dtype=torch.float64)
    c = dict(c11=9.0e9, c12=2.0e9, c13=1.5e9, c22=6.5e9, c23=1.2e9,
             c33=5.0e9, c44=1.8e9, c55=2.2e9, c66=2.6e9)
    return OrthotropicMaterialFields.from_constants(
        1200.0 * ones, {k: v * ones for k, v in c.items()},
        dtype=torch.float64)


@pytest.mark.parametrize("axis", [0, 1])
def test_bonded_orthotropic_contact_equals_monolithic(axis, rng):
    """tests/test_contact.py::test_bonded_contact_orthotropic_equals_
    monolithic on the port: the bonded interface solve over orthotropic
    views reproduces the monolithic body."""
    model = get_model("elastic2d")
    shape, h = (17, 14), (1.0, 1.0)
    mat_m = _uniform_ortho(shape)
    dt = 0.5 * min(h) / mat_m.max_cp()
    u0 = rng.standard_normal((model.ncomp,) + shape)
    for a in range(1, u0.ndim):
        u0 = 0.25 * np.roll(u0, 1, a) + 0.5 * u0 + 0.25 * np.roll(u0, -1, a)
    borders = {(a, s): BorderSpec("absorbing") for a in range(2)
               for s in (0, 1)}
    mono = torch.tensor(u0)
    k = shape[axis] // 2
    ua, ub = _split(mono, k, axis)
    mats = {"a": _uniform_ortho(ua.shape[1:]),
            "b": _uniform_ortho(ub.shape[1:])}
    body_borders = {
        "a": {f: b for f, b in borders.items() if f != (axis, 1)},
        "b": {f: b for f, b in borders.items() if f != (axis, 0)}}
    contact = ContactSpec("a", "b", axis=axis, kind="bonded")
    us, hs = {"a": ua, "b": ub}, {"a": h, "b": h}
    for n in range(4):
        axes = (0, 1) if n % 2 == 0 else (1, 0)
        mono = step(model, mono, mat_m, dt, h, 1, borders, axes)
        us, _ = step_multi(model, us, mats, dt, hs, 1, body_borders,
                           (contact,), {}, axes)
    ma, mb = _split(mono.numpy(), k, axis)
    np.testing.assert_allclose(us["a"].numpy(), ma, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(us["b"].numpy(), mb, rtol=1e-12, atol=1e-12)
