"""The port's SimplexEngine against the JAX package's, end to end.

Both engines build the same scenario from their own registries (same
names, defaults, parameters and meshes) and run it on the CPU: the JAX one
through its jnp sweeps, the port through its plain torch gather sweeps.
Final state, detector traces and dt agree to 1e-9 in float64 and to 1e-5
normalized in float32. The meshes are ones where the two packages' point
locators agree (asserted: same operators, same outside feet); elsewhere
the JAX package's C++ walk misplaces a few feet (tests/test_torch_simplex.py)
and an engine given JAX's own tables (``convert.foot_tables_from_numpy``)
runs the comparison instead. Odd step counts cover the forward tail step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.engine_simplex import SimplexEngine as JSimplexEngine
from gcm_tpu.scenarios import get_scenario as jget_scenario
from gcm_tpu.solver.correctors import MaxwellCorrector as JMaxwellCorrector
from gcm_tpu_torch.convert import foot_tables_from_numpy
from gcm_tpu_torch.engine_simplex import SimplexEngine
from gcm_tpu_torch.scenarios import get_scenario
from gcm_tpu_torch.solver.correctors import MaxwellCorrector
from test_torch_simplex import (  # noqa: F401  (a module fixture)
    assert_tables_agree, norm_err, private_native_library,
)

ENGINE_CASES = [("simplex3d_layered", 13, 9),
                ("simplex2d_canyon_layered", 17, 15)]


def assert_runs_agree(got, want, dtype):
    assert got.nsteps == want.nsteps
    assert got.u.shape == want.u.shape and got.traces.shape == want.traces.shape
    assert np.abs(want.traces).max() > 0
    if dtype == "f64":
        assert got.dt == pytest.approx(want.dt, rel=1e-15)
        np.testing.assert_allclose(got.u, want.u, rtol=1e-9,
                                   atol=1e-9 * np.abs(want.u).max())
        np.testing.assert_allclose(got.traces, want.traces, rtol=1e-9,
                                   atol=1e-9 * np.abs(want.traces).max())
    else:
        assert got.dt == pytest.approx(want.dt, rel=1e-6)
        assert norm_err(got.u, want.u) < 1e-5
        scale = np.abs(want.traces).max()
        assert np.abs(got.traces - want.traces).max() / scale < 1e-5


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("scenario,n,nsteps", ENGINE_CASES)
def test_engine_matches_jax_engine(scenario, n, nsteps, dtype):
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    jeng = JSimplexEngine.from_task(jget_scenario(scenario, n=n,
                                                  nsteps=nsteps), dtype=jdt)
    eng = SimplexEngine.from_task(get_scenario(scenario, n=n, nsteps=nsteps),
                                  device="cpu", dtype=tdt)
    # a mesh where the two locators agree: same nodes, same operators
    assert np.array_equal(eng.grid.points, jeng.grid.points)
    none = {k: np.zeros(eng.grid.npoints, bool) for k in jeng.tables}
    assert_tables_agree(eng.tables, jeng.tables, none, eng.grid.npoints)
    got = eng.run()
    assert got.kernel == "torch" and got.nsteps == nsteps
    assert_runs_agree(got, jeng.run(), dtype)


def test_engine_on_jax_tables_with_a_corrector():
    """On a mesh where the locators differ (simplex3d_layered at n=7), the
    port's engine given JAX's own tables runs JAX's steps; a Maxwell
    corrector runs after the source, and an engine built on another's
    tables repeats its run."""
    jtask = jget_scenario("simplex3d_layered", n=7, nsteps=5)
    task = get_scenario("simplex3d_layered", n=7, nsteps=5)
    tau = 0.02
    jeng = JSimplexEngine.from_task(dataclasses.replace(
        jtask, correctors=(JMaxwellCorrector(tau=tau),)), dtype=jnp.float64)
    tables = foot_tables_from_numpy(jeng.tables)
    task = dataclasses.replace(task, correctors=(MaxwellCorrector(tau=tau),))
    eng = SimplexEngine.from_task(task, device="cpu", dtype=torch.float64,
                                  tables=tables)
    assert eng.tables is tables
    got = eng.run()
    assert_runs_agree(got, jeng.run(), "f64")
    again = SimplexEngine.from_task(task, device="cpu", dtype=torch.float64,
                                    tables=eng.tables).run()
    np.testing.assert_array_equal(again.u, got.u)


@pytest.mark.parametrize("helper,n,nsteps", [("simplex2d_acoustic", 15, 7),
                                             ("simplex3d_elastic", 13, 5)])
def test_unregistered_simplex_helpers_match_jax(helper, n, nsteps):
    """``simplex2d_acoustic`` and ``simplex3d_elastic`` build the JAX
    helpers' engines (mesh, medium, pulse, dt; float32; tables equal except
    at the feet JAX's walk cycled on) and run their steps; on JAX's own
    tables the port's engine runs JAX's."""
    import gcm_tpu.scenarios as jscen

    import gcm_tpu_torch.scenarios as tscen
    from test_torch_simplex import assert_tables_agree, jax_walk_faults

    jeng = getattr(jscen, helper)(n=n)
    eng = getattr(tscen, helper)(n=n, device="cpu")
    assert eng.device.type == "cpu" and eng.dtype == torch.float32
    assert np.array_equal(eng.grid.points, jeng.grid.points)
    np.testing.assert_array_equal(eng.u.numpy(), np.asarray(jeng.u))
    assert eng.dt == pytest.approx(jeng.dt, rel=1e-6)
    waves = {"p": np.asarray(jeng.mat.cp), "s": np.asarray(jeng.mat.cs)}
    faults = jax_walk_faults(jeng.grid, jeng.tables, waves, jeng.dt)
    assert sum(int(f.sum()) for f in faults.values()) <= 2 * len(faults)
    assert_tables_agree(eng.tables, jeng.tables, faults, eng.grid.npoints)
    assert eng.run(nsteps).kernel == "torch"
    on_jax = SimplexEngine(eng.grid, jeng.model.name, eng.mat,
                           u0=np.array(jeng.u), device="cpu",
                           tables=foot_tables_from_numpy(jeng.tables))
    assert norm_err(on_jax.run(nsteps).u, jeng.run(nsteps).u) < 1e-5
