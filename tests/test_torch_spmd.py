"""The port's sharded fused step against the JAX package's, on a mesh.

The JAX side runs ``gcm_tpu.parallel.fused_spmd`` under ``shard_map`` on
the 8 virtual CPU devices of tests/conftest.py, its interior/ring kernels
in interpret mode, as tests/test_fused_spmd.py runs them; the port runs
``gcm_tpu_torch.parallel.fused_spmd`` on shards co-resident on the CPU,
where the kernels' wrappers run their plain versions. Same inputs, made
from a seeded numpy generator. float32 steps are held to the JAX tests'
own limit, a per-component normalized max error under 2e-6, the folded
damage aux to rtol 1e-5 / atol 1e-6; the slab exchange and the extended
material stack must be equal; ``apply_borders_post`` (float64) to 1e-12
and the per-sweep halo step (float64) to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gcm_tpu.ops.pallas_fused import fold_corrector_specs as jfold
from gcm_tpu.parallel import fused_spmd as jfs
from gcm_tpu.parallel.halo import make_spmd_step as jmake_spmd_step
from gcm_tpu.parallel.sharding import domain_mesh as jdomain_mesh
from gcm_tpu.parallel.sharding import field_sharding, shard_state as jshard
from gcm_tpu.solver.boundary import apply_borders_post as japply_post
from gcm_tpu.solver.correctors import DamageCorrector as JDamage
from gcm_tpu.solver.correctors import MaxwellCorrector as JMaxwell
from gcm_tpu.solver.gcm import stage as jstage
from gcm_tpu.task import BorderSpec as JBorderSpec
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.fused import fold_corrector_specs
from gcm_tpu_torch.parallel import fused_spmd as tfs
from gcm_tpu_torch.parallel.halo import extend_mats_once, make_spmd_step
from gcm_tpu_torch.parallel.sharding import (
    domain_mesh, gather_state, shard_mats, shard_state)
from gcm_tpu_torch.solver.boundary import apply_borders_post
from gcm_tpu_torch.solver.correctors import DamageCorrector, MaxwellCorrector
from gcm_tpu_torch.solver.gcm import stage
from gcm_tpu_torch.task import BorderSpec
from test_torch_step import borders_pair, norm_err, problem

H = (1.0, 1.1, 0.9)
SPEC = P(None, "sx", "sy", None)
#: the border set of tests/test_fused_spmd.py, for both packages
SPMD_BORDERS = (((0, 0), "free", None), ((0, 1), "absorbing", None),
                ((1, 0), "absorbing", None), ((1, 1), "fixed_force", 2e5),
                ((2, 0), "fixed_velocity", (0.1, 0.2, -0.3)),
                ((2, 1), "free", None))


def _spmd_borders():
    return ({f: JBorderSpec(k, v) for f, k, v in SPMD_BORDERS},
            {f: BorderSpec(k, v) for f, k, v in SPMD_BORDERS})


def _meshes(shape):
    n = int(np.prod(shape))
    return (jdomain_mesh(3, devices=jax.devices("cpu")[:n], shape=shape),
            domain_mesh(3, ["cpu"] * n, shape))


def test_exchange_slabs_and_extended_mstack_match_jax(rng):
    """Per-shard slabs (corners included) and halo-extended stacks are
    the JAX package's, value for value, on a 4x2 mesh at order 3."""
    order, r = 3, 2
    model, ju, jmat, tu, tmat, _ = problem(rng, "elastic3d", (32, 24, 8),
                                           np.float32)
    jmesh, mesh = _meshes((4, 2))
    f = jax.jit(jax.shard_map(
        lambda u: jfs.exchange_slabs(u, ("sx", "sy"), r), mesh=jmesh,
        in_specs=(SPEC,), out_specs=(SPEC,) * 4, check_vma=False))
    want = f(jax.device_put(ju, field_sharding(jmesh, 3)))
    got = tfs.exchange_slabs(shard_state(tu, mesh), mesh, r)
    for q in range(4):
        np.testing.assert_array_equal(
            gather_state([s[q] for s in got], mesh).numpy(),
            np.asarray(want[q]))
    tmodel = get_model("elastic3d")
    np.testing.assert_array_equal(
        gather_state(tfs.extended_mstack(tmodel, tmat, mesh, order),
                     mesh).numpy(),
        np.asarray(jfs.extended_mstack(model, jmat, jmesh, order)))


def _run_both(rng, shape, mesh_shape, order, nsteps, borders=True,
              correctors=False, h=H):
    """nsteps of the JAX and the port's sharded fused step from one state
    (with Maxwell + damage folded if ``correctors``); returns the two final
    states, and the two damage fields."""
    model, ju, jmat, tu, tmat, dt = problem(rng, "elastic3d", shape,
                                            np.float32)
    jb, tb = _spmd_borders() if borders else (None, None)
    jmesh, mesh = _meshes(mesh_shape)
    tmodel = get_model("elastic3d")
    jspecs = tspecs = None
    if correctors:
        jspecs, _ = jfold((JMaxwell(tau=40 * dt),
                           JDamage(threshold=2e5, rate=0.5 / dt)), dt)
        tspecs, _ = fold_corrector_specs(
            (MaxwellCorrector(tau=40 * dt),
             DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
    jstep = jfs.make_fused_spmd_step(model, jmesh, dt, h, order, jb, bx=4,
                                     by=8, correctors=jspecs)
    tstep = tfs.make_fused_spmd_step(tmodel, mesh, dt, h, order, tb,
                                     correctors=tspecs)
    jmext = jfs.extended_mstack(model, jmat, jmesh, order)
    tmext = tfs.extended_mstack(tmodel, tmat, mesh, order)
    got = jax.device_put(ju, field_sharding(jmesh, 3))
    us = shard_state(tu, mesh)
    jaux = jax.device_put(jnp.zeros((1,) + shape, jnp.float32),
                          field_sharding(jmesh, 3))
    taux = shard_state(torch.zeros((1,) + shape), mesh)
    for n in range(nsteps):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        if correctors:
            got, jaux = jstep(got, jmext, axes, aux=jaux)
            us, taux = tstep(us, tmext, axes, aux=taux)
        else:
            got = jstep(got, jmext, axes)
            us = tstep(us, tmext, axes)
    return (np.asarray(got), gather_state(us, mesh).numpy(),
            np.asarray(jaux)[0], gather_state(taux, mesh).numpy()[0])


@pytest.mark.parametrize("order", [2, 3])
def test_fused_spmd_step_matches_jax(rng, order):
    """(64, 32, 16) on a 4x2 mesh (16x16 shards: interior and ring tiles in
    both packages), the border set of tests/test_fused_spmd.py, two steps
    over both axes orders."""
    want, got, _, _ = _run_both(rng, (64, 32, 16), (4, 2), order, 2)
    assert norm_err(got, want) < 2e-6


def test_fused_spmd_ring_only_matches_jax(rng):
    """8x8 shards: every tile of both packages is a ring tile."""
    want, got, _, _ = _run_both(rng, (32, 16, 16), (4, 2), 2, 2)
    assert norm_err(got, want) < 2e-6


def test_fused_spmd_folded_correctors_match_jax(rng):
    """Maxwell + damage folded into both launches, on the grid spacing of
    tests/test_fused_spmd.py's folded case."""
    want, got, jd, td = _run_both(rng, (32, 32, 16), (4, 2), 2, 2,
                                  correctors=True, h=(10.0, 10.0, 10.0))
    assert norm_err(got, want) < 2e-6
    assert jd.max() > 1e-4
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)


def test_apply_borders_post_matches_jax(rng):
    """Raw sweep + post-fixup, float64, every axis, the four border kinds,
    one side at a time and both."""
    model, ju, jmat, tu, tmat, dt = problem(rng, "elastic3d", (12, 10, 8))
    jb, tb = borders_pair(3)
    tmodel = get_model("elastic3d")
    for axis in range(3):
        jraw = jstage(model, ju, jmat, dt, H, axis, 2, None)
        traw = stage(tmodel, tu, tmat, dt, H, axis, 2, None)
        for active in ((True, True), (True, False), (False, True)):
            want = np.asarray(japply_post(model, ju, jraw, jmat, axis, jb,
                                          active))
            got = apply_borders_post(tmodel, tu, traw, tmat, axis, tb,
                                     active).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max())


def test_halo_step_matches_jax(rng):
    """The per-sweep halo step with the plain sweep against JAX
    ``make_spmd_step(use_pallas=False)``, float64, order 2, 3 steps."""
    model, ju, jmat, tu, tmat, dt = problem(rng, "elastic3d", (32, 16, 8))
    jb, tb = borders_pair(3)
    jmesh, mesh = _meshes((4, 2))
    jstep = jmake_spmd_step(model, jmesh, dt, H, 2, jb)
    tmodel = get_model("elastic3d")
    tstep = make_spmd_step(tmodel, mesh, dt, H, 2, tb, use_kernel=False)
    got, jm = jshard(ju, jmat, jmesh)
    us = shard_state(tu, mesh)
    mats = extend_mats_once(shard_mats(tmat, mesh), mesh, 3, 2)
    for n in range(3):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        got = jstep(got, jm, axes)
        us = tstep(us, mats, axes)
    want = np.asarray(got)
    np.testing.assert_allclose(gather_state(us, mesh).numpy(), want,
                               rtol=1e-10, atol=1e-10 * np.abs(want).max())
