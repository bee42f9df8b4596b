"""The port's Engine against the JAX package's Engine, end to end.

Both engines build the same scenario from their own scenario registries
(same names, defaults and parameters) and run it on the CPU: the JAX one
through its jnp path, the port through its plain torch path. Final state,
detector traces and dt must agree: to 1e-9 in float64 (round-off of the
same arithmetic), to 1e-5 normalized in float32 (the two run the f32 ops
in different fused orders). nsteps=7 covers an odd tail step.
elastic3d_layered runs at n=24: at n=16 its initial ball holds no node, so
its state stays zero. The corrector cases carry the damage aux field too:
a source-free elastic3d_layered with Maxwell and damage correctors, where
the port's ``kernel="fused"`` folds them into the step (its plain epilogue
on the CPU) and the JAX jnp engine runs them after the step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.engine import Engine as JEngine
from gcm_tpu.scenarios import get_scenario as jget_scenario
from gcm_tpu.scenarios import list_scenarios as jlist_scenarios
from gcm_tpu.solver import correctors as jcorr
from gcm_tpu_torch.convert import aux_from_numpy
from gcm_tpu_torch.engine import Engine, resolve_kernel
from gcm_tpu_torch.ops.fused import fused_step, fused_step_2d
from gcm_tpu_torch.ops.sweep import sweep_stage
from gcm_tpu_torch.scenarios import get_scenario, list_scenarios
from gcm_tpu_torch.solver import correctors as tcorr
from gcm_tpu_torch.task import SimplexTask, Task
from test_torch_step import norm_err

DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


def _assert_runs_agree(got, want, dtype):
    assert got.u.shape == want.u.shape and got.nsteps == want.nsteps
    assert got.traces.shape == want.traces.shape
    if dtype == "f64":
        assert got.dt == pytest.approx(want.dt, rel=1e-15)
        np.testing.assert_allclose(got.u, want.u, rtol=1e-9,
                                   atol=1e-9 * np.abs(want.u).max())
        np.testing.assert_allclose(got.traces, want.traces, rtol=1e-9,
                                   atol=1e-9 * np.abs(want.traces).max())
    else:
        assert got.dt == pytest.approx(want.dt, rel=1e-6)
        assert norm_err(got.u, want.u) < 1e-5
        tr_scale = np.abs(want.traces).max() + 1e-30
        assert np.abs(got.traces - want.traces).max() / tr_scale < 1e-5
    assert np.abs(got.u).max() > 0


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("nsteps", [6, 7])
@pytest.mark.parametrize("scenario,n", [("elastic3d_explosion", 16),
                                        ("elastic3d_layered", 24)])
def test_engine_matches_jax_engine(scenario, n, nsteps, dtype):
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    want = JEngine(jget_scenario(scenario, n=n, nsteps=nsteps),
                   dtype=jdt).run()
    got = Engine(get_scenario(scenario, n=n, nsteps=nsteps), device="cpu",
                 dtype=tdt).run()
    assert got.kernel == "torch"
    assert got.u.shape == want.u.shape and got.nsteps == nsteps
    assert got.traces.shape == want.traces.shape == (nsteps, len(
        get_scenario(scenario).detectors.points), 9)
    if dtype == "f64":
        assert got.dt == pytest.approx(want.dt, rel=1e-15)
        np.testing.assert_allclose(got.u, want.u, rtol=1e-9,
                                   atol=1e-9 * np.abs(want.u).max())
        np.testing.assert_allclose(got.traces, want.traces, rtol=1e-9,
                                   atol=1e-9 * np.abs(want.traces).max())
    else:
        assert got.dt == pytest.approx(want.dt, rel=1e-6)
        assert norm_err(got.u, want.u) < 1e-5
        tr_scale = np.abs(want.traces).max() + 1e-30
        assert np.abs(got.traces - want.traces).max() / tr_scale < 1e-5
    assert np.abs(got.u).max() > 0


def test_engine_fused_kernel_on_cpu_runs_plain_version():
    """kernel='fused' on the CPU goes through the fused wrapper, which runs
    its plain version for CPU tensors: same result as the torch path, and
    no kernel launch."""
    task = get_scenario("elastic3d_explosion", n=12, nsteps=3)
    before = fused_step.launches
    got = Engine(dataclasses.replace(task, kernel="fused"),
                 device="cpu").run()
    assert fused_step.launches == before
    assert got.kernel == "fused"
    want = Engine(task, device="cpu").run()
    assert norm_err(got.u, want.u) < 2e-6
    with pytest.raises(ValueError, match="float32"):
        Engine(dataclasses.replace(task, kernel="fused"), device="cpu",
               dtype=torch.float64)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("scenario,n,nsteps", [
    ("acoustic1d", 64, 7),
    ("elastic2d_ps", 24, 7),
    ("elastic2d_viscoelastic", 24, 7),
])
def test_1d_2d_scenarios_match_jax_engine(scenario, n, nsteps, dtype):
    jdt, tdt = DTYPES[dtype]
    want = JEngine(jget_scenario(scenario, n=n, nsteps=nsteps),
                   dtype=jdt).run()
    got = Engine(get_scenario(scenario, n=n, nsteps=nsteps), device="cpu",
                 dtype=tdt).run()
    assert got.kernel == "torch"
    _assert_runs_agree(got, want, dtype)


def _visco_layered_pair(n, nsteps, seed=0):
    """Source-free elastic3d_layered with Maxwell + damage, for both
    packages, and a common non-zero initial damage field."""
    base = get_scenario("elastic3d_layered", n=n, nsteps=nsteps)
    dt = Engine(base, device="cpu").dt
    task = dataclasses.replace(base, correctors=(
        tcorr.MaxwellCorrector(tau=50 * dt),
        tcorr.DamageCorrector(threshold=5e5, rate=0.1 / dt)))
    jtask = dataclasses.replace(
        jget_scenario("elastic3d_layered", n=n, nsteps=nsteps),
        correctors=(jcorr.MaxwellCorrector(tau=50 * dt),
                    jcorr.DamageCorrector(threshold=5e5, rate=0.1 / dt)))
    d0 = (0.2 * np.random.default_rng(seed).random(
        task.grid.shape)).astype(np.float32)
    return task, jtask, d0


@pytest.mark.parametrize("dtype,kernel", [("f64", "torch"), ("f32", "torch"),
                                          ("f32", "fused")])
def test_correctors_match_jax_engine(dtype, kernel):
    """Maxwell + damage in both engines from one non-zero damage field; the
    port's fused path folds them (plain epilogue on the CPU), its torch
    path runs them after the step, as the JAX jnp engine does."""
    jdt, tdt = DTYPES[dtype]
    task, jtask, d0 = _visco_layered_pair(24, 7)
    # the JAX engine's scan carries the aux in the state dtype once a
    # float64 state has promoted it, so a float64 run starts it there
    d0 = d0.astype(np.float64 if dtype == "f64" else np.float32)
    jeng = JEngine(jtask, dtype=jdt)
    jeng.aux = {"damage": jnp.asarray(d0)}
    want = jeng.run()
    eng = Engine(dataclasses.replace(task, kernel=kernel), device="cpu",
                 dtype=tdt)
    assert (eng._fold_specs is not None) == (kernel == "fused")
    eng.aux = aux_from_numpy({"damage": d0})
    before = fused_step.launches
    got = eng.run()
    assert fused_step.launches == before
    _assert_runs_agree(got, want, dtype)
    jd = np.asarray(jeng.aux["damage"])
    td = eng.aux["damage"].numpy()
    assert td.dtype == jd.dtype and td.max() > d0.max()
    tol = 1e-9 if dtype == "f64" else 1e-5
    np.testing.assert_allclose(td, jd, rtol=tol, atol=tol)


def test_folding_rule():
    """Fold only source-free, with foldable correctors and one damage
    field at most; anything else runs the correctors after the step."""
    task, _, _ = _visco_layered_pair(12, 1)
    fused = dataclasses.replace(task, kernel="fused")
    eng = Engine(fused, device="cpu")
    assert eng._fold_specs is not None and eng._fold_naux == 1
    assert set(eng.aux) == {"damage"}
    assert Engine(task, device="cpu")._fold_specs is None    # torch path
    two = dataclasses.replace(fused, correctors=fused.correctors
                              + (tcorr.DamageCorrector(1e6, 1.0),))
    assert Engine(two, device="cpu")._fold_specs is None
    per_node = dataclasses.replace(fused, correctors=(
        tcorr.MaxwellCorrector(tau=torch.full(task.grid.shape, 0.01)),))
    assert Engine(per_node, device="cpu")._fold_specs is None
    visco = get_scenario("elastic2d_viscoelastic", n=16, nsteps=1)
    assert Engine(dataclasses.replace(visco, kernel="fused"),
                  device="cpu")._fold_specs is None          # has a source
    assert Engine(dataclasses.replace(
        visco, kernel="fused", sources=()), device="cpu")._fold_specs == (
            ("maxwell", pytest.approx(np.exp(
                -Engine(visco, device="cpu").dt / 0.02))),)


@pytest.mark.parametrize("kernel", ["fused", "sweep"])
def test_2d_kernels_on_cpu_run_plain_versions(kernel):
    """kernel='fused'/'sweep' on a 2D CPU task go through the kernels'
    wrappers, which run their plain versions for CPU tensors: the torch
    path's result, and no kernel launch."""
    task = get_scenario("elastic2d_viscoelastic", n=20, nsteps=5)
    before = (fused_step_2d.launches, sweep_stage.launches)
    got = Engine(dataclasses.replace(task, kernel=kernel), device="cpu").run()
    assert (fused_step_2d.launches, sweep_stage.launches) == before
    assert got.kernel == kernel
    assert norm_err(got.u, Engine(task, device="cpu").run().u) < 2e-6


def test_resolve_kernel():
    assert resolve_kernel("auto", 3, "cpu") == "torch"
    assert resolve_kernel("auto", 2, "cpu") == "torch"
    assert resolve_kernel("auto", 1, "cuda") == "torch"
    assert resolve_kernel("auto", 2, "cuda") == "fused"
    assert resolve_kernel("auto", 3, "cuda") == "fused"
    assert resolve_kernel("torch", 3, "cuda") == "torch"
    assert resolve_kernel("sweep", 2, "cuda") == "sweep"
    assert Engine(get_scenario("elastic3d_layered", n=8, nsteps=1),
                  device="cpu").kernel == "torch"
    for kernel in ("fused", "sweep"):
        with pytest.raises(ValueError, match="2D and 3D"):
            Engine(dataclasses.replace(get_scenario("acoustic1d", n=16),
                                       kernel=kernel), device="cpu")


@pytest.mark.parametrize("knob,value", [
    ("kernel", "pallas_fused"), ("kernel", "jnp"),
    ("canonical_layout", True), ("scan_unroll", 2),
    ("mat_dtype", "bf16"), ("temporal_block", True),
])
def test_task_rejects_unknown_kernels_and_tpu_knobs(knob, value):
    """JAX kernel names and the XLA-only scan_unroll are refused; the
    fused path's knobs are taken and reach the engine: the stack's type,
    the pair-fused body, the splitting order."""
    task = get_scenario("elastic3d_layered", n=8, nsteps=1)
    if knob in ("kernel", "scan_unroll"):
        with pytest.raises(ValueError,
                           match=knob if knob != "kernel" else value):
            dataclasses.replace(task, **{knob: value})
        return
    # a 128-long x axis: the canonical order moves it last
    grid = dataclasses.replace(task.grid, shape=(128, 8, 8))
    task = dataclasses.replace(task, grid=grid, kernel="fused",
                               detectors=None, **{knob: value})
    eng = Engine(task, device="cpu")
    reached = {"canonical_layout": eng._fwd == (1, 2, 0),
               "mat_dtype": eng._mstack.dtype == torch.bfloat16,
               "temporal_block": eng._pair_fused}
    assert reached[knob]
    assert not any(v for k, v in reached.items() if k != knob)


def test_task_refuses_orthotropic_media():
    """A structured Task takes orthotropic media: its fields equal JAX's
    (float64 constants cast once); so does a SimplexTask, which refused
    them before the port's simplex meshes took orthotropic media."""
    from gcm_tpu.materials import OrthotropicMaterial as JOrthotropic
    from gcm_tpu_torch.materials import (
        OrthotropicMaterial, OrthotropicMaterialFields)

    consts = dict(rho=1500.0, c11=12.0e9, c12=2.5e9, c13=1.8e9, c22=9.0e9,
                  c23=2.1e9, c33=14.0e9, c44=2.2e9, c55=3.1e9, c66=2.7e9)
    task = get_scenario("elastic3d_layered", n=8, nsteps=1)
    jtask = jget_scenario("elastic3d_layered", n=8, nsteps=1)
    got = dataclasses.replace(
        task, default_material=OrthotropicMaterial(**consts)).material_fields()
    want = dataclasses.replace(
        jtask, default_material=JOrthotropic(**consts)).material_fields()
    assert isinstance(got, OrthotropicMaterialFields)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)))
    simplex = get_scenario("simplex3d_layered", n=5)
    jsimplex = jget_scenario("simplex3d_layered", n=5)
    got = dataclasses.replace(simplex, default_material=OrthotropicMaterial(
        **consts)).material_fields(dtype=torch.float64)
    want = dataclasses.replace(jsimplex, default_material=JOrthotropic(
        **consts)).material_fields(xp=jnp, dtype=jnp.float64)
    assert isinstance(got, OrthotropicMaterialFields)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)))


def test_scenarios_and_materials_match_jax():
    """Every structured single-body scenario of the JAX registry, and the
    two single-body simplex scenarios, are ported with their names,
    defaults and parameters."""
    structured = ["acoustic1d", "elastic2d_ps", "elastic2d_viscoelastic",
                  "elastic3d_explosion", "elastic3d_layered"]
    simplex = ["simplex2d_canyon_layered", "simplex3d_layered"]
    assert list_scenarios() == structured + simplex
    assert set(list_scenarios()) <= set(jlist_scenarios())
    for name, n in zip(simplex, (9, 5)):
        t, j = get_scenario(name, n=n), jget_scenario(name, n=n)
        assert isinstance(t, SimplexTask)
        assert (t.name, t.model, t.order, t.kernel) == \
            (j.name, j.model, j.order, j.kernel)
        np.testing.assert_array_equal(t.grid.points, j.grid.points)
        np.testing.assert_array_equal(t.grid.cells, j.grid.cells)
        assert dataclasses.astuple(t.time) == dataclasses.astuple(j.time)
        assert t.snapshots.every == j.snapshots.every
        tm = t.material_fields(dtype=torch.float64)
        jm = j.material_fields(dtype=np.float64)
        for leaf in ("cp", "cs", "zp", "zs", "kappa", "rho"):
            np.testing.assert_array_equal(getattr(tm, leaf).numpy(),
                                          np.asarray(getattr(jm, leaf)))
        assert t.border_default.kind == j.border_default.kind
        assert [(type(a).__name__, b.kind) for a, b in t.borders] == \
            [(type(a).__name__, b.kind) for a, b in j.borders]
        for (ta, _), (ja, _) in zip(t.borders, j.borders):
            np.testing.assert_array_equal(ta.contains(t.grid.points),
                                          ja.contains(j.grid.points))
        assert [dataclasses.astuple(s) for s in t.sources] == \
            [dataclasses.astuple(s) for s in j.sources]
        assert t.detectors.points == j.detectors.points
    for name in structured:
        t, j = get_scenario(name, n=12), jget_scenario(name, n=12)
        assert isinstance(t, Task)
        assert (t.name, t.model, t.grid.shape, t.grid.h, t.order) == \
            (j.name, j.model, j.grid.shape, j.grid.h, j.order)
        assert dataclasses.astuple(t.time) == dataclasses.astuple(j.time)
        for got, want in zip(t.material_arrays(), j.material_arrays()):
            np.testing.assert_array_equal(got, want)
        assert sorted(t.borders) == sorted(j.borders)
        assert all(t.borders[f].kind == j.borders[f].kind for f in t.borders)
        assert [(type(c).__name__, c.name, getattr(c, "tau", None))
                for c in t.correctors] == \
            [(type(c).__name__, c.name, getattr(c, "tau", None))
             for c in j.correctors]
        assert [dataclasses.astuple(s) for s in t.sources] == \
            [dataclasses.astuple(s) for s in j.sources]
        assert t.detectors == j.detectors or \
            t.detectors.points == j.detectors.points
