"""The port's Engine on a mesh, and its sharded 2D step, against JAX's.

JAX runs ``Engine(task, mesh=...)`` on the 8 virtual CPU devices of
tests/conftest.py (``kernel="pallas_fused"`` takes its interior/ring
kernels in interpret mode; ``"jnp"`` the GSPMD program); the port runs
``Engine(task, device="cpu", mesh=...)`` on co-resident CPU shards, with
the sharded fused step (its kernels' plain versions) in float32 and the
per-sweep halo step with the plain sweep in float64. Final state, detector
traces and dt must agree: to 1e-9 in float64, to 1e-5 normalized in
float32, as tests/test_torch_engine.py holds the unsharded engines. The 2D
sharded fused step is held to the JAX one at 2e-6 normalized.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.engine import Engine as JEngine
from gcm_tpu.parallel import fused_spmd as jfs
from gcm_tpu.parallel.sharding import domain_mesh as jdomain_mesh
from gcm_tpu.parallel.sharding import field_sharding
from gcm_tpu.scenarios import get_scenario as jget_scenario
from gcm_tpu_torch.engine import Engine
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.parallel import fused_spmd as tfs
from gcm_tpu_torch.parallel.sharding import (
    domain_mesh, gather_state, shard_state)
from gcm_tpu_torch.scenarios import get_scenario
from test_torch_engine import _assert_runs_agree
from test_torch_step import borders_pair, norm_err, problem

#: (scenario, n, nsteps, mesh shape): the JAX engine test's layered case,
#: the explosion with its source and receivers on shard edges, and the 2D
#: viscoelastic section on sx=4 (its source after the step, Maxwell after
#: the source, on every shard)
CASES = [("elastic3d_layered", 32, 6, (4, 2)),
         ("elastic3d_explosion", 16, 6, (4, 2)),
         ("elastic2d_viscoelastic", 32, 6, (4,))]


def _meshes(dim, shape):
    n = int(np.prod(shape))
    jm = jdomain_mesh(dim, devices=jax.devices("cpu")[:n],
                      shape=shape if dim == 3 else None)
    return jm, domain_mesh(dim, ["cpu"] * n, shape if dim == 3 else None)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_mesh_engine_matches_jax(case, dtype):
    scenario, n, nsteps, shape = case
    task, jtask = (get_scenario(scenario, n=n, nsteps=nsteps),
                   jget_scenario(scenario, n=n, nsteps=nsteps))
    jmesh, mesh = _meshes(task.grid.dim, shape)
    if dtype == "f64":
        jeng = JEngine(jtask, mesh=jmesh, dtype=jnp.float64)
        eng = Engine(task, device="cpu", mesh=mesh, dtype=torch.float64)
        kernel = "torch"
    else:
        jeng = JEngine(dataclasses.replace(jtask, kernel="pallas_fused"),
                       mesh=jmesh)
        assert jeng._spmd_step is not None
        eng = Engine(dataclasses.replace(task, kernel="fused"), mesh=mesh)
        kernel = "fused"
    got = eng.run()
    assert got.kernel == kernel and isinstance(eng.u, list)
    assert len(eng.u) == mesh.size
    _assert_runs_agree(got, jeng.run(), dtype)


@pytest.mark.parametrize("nsh", [4, 2])
def test_fused_spmd_2d_step_matches_jax(rng, nsh):
    """(128, 24) on sx = 4 (32-row shards: interior and ring x-tiles) and
    sx = 2, order 2, three steps over both axes orders."""
    model, ju, jmat, tu, tmat, dt = problem(rng, "elastic2d", (128, 24),
                                            np.float32)
    jb, tb = borders_pair(2)
    h = (1.0, 1.1)
    jmesh, mesh = _meshes(2, (nsh,))
    jstep = jfs.make_fused_spmd_step_2d(model, jmesh, dt, h, 2, jb, bx=8)
    tmodel = get_model("elastic2d")
    tstep = tfs.make_fused_spmd_step_2d(tmodel, mesh, dt, h, 2, tb)
    jmext = jfs.extended_mstack_2d(model, jmat, jmesh)
    tmext = tfs.extended_mstack_2d(tmodel, tmat, mesh, 2)
    got = jax.device_put(ju, field_sharding(jmesh, 2))
    us = shard_state(tu, mesh)
    for n in range(3):
        axes = (0, 1) if n % 2 == 0 else (1, 0)
        got = jstep(got, jmext, axes)
        us = tstep(us, tmext, axes)
    assert norm_err(gather_state(us, mesh).numpy(), np.asarray(got)) < 2e-6
