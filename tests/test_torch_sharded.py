"""The port's sharded paths against its own unsharded ones, on the CPU.

Shards co-resident on the CPU (a mesh may name one device many times, as
the JAX tests' virtual CPU devices do). The kernels' wrappers run their
plain versions on CPU tensors, so a sharded step is held to the unsharded
plain step in float64 to 1e-12 (normalized): the same arithmetic on the
same cells. Also the tiling, the mesh helpers, the device rules of the
entry points and the slab buffers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gcm_tpu_torch.engine import Engine
from gcm_tpu_torch.engine_simplex import SimplexEngine
from gcm_tpu_torch.materials import MaterialFields
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops import fused_spmd as ofs
from gcm_tpu_torch.ops.fused import (
    fold_corrector_specs, fused_step_reference, stack_mats)
from gcm_tpu_torch.parallel import fused_spmd as pfs
from gcm_tpu_torch.parallel.halo import (
    extend_mats_once, make_spmd_raw_stage, make_spmd_step)
from gcm_tpu_torch.parallel.sharding import (
    DomainMesh, domain_mesh, gather_state, shard_mats, shard_state)
from gcm_tpu_torch.scenarios import get_scenario
from gcm_tpu_torch.solver.correctors import DamageCorrector, MaxwellCorrector
from gcm_tpu_torch.solver.boundary import apply_borders_post
from gcm_tpu_torch.solver.gcm import stage, step
from gcm_tpu_torch.task import BorderSpec
from test_torch_step import norm_err

BORDERS = {(0, 0): BorderSpec("free"), (0, 1): BorderSpec("absorbing"),
           (1, 0): BorderSpec("fixed_force", value=(1e5, 2e5, -1e5)),
           (1, 1): BorderSpec("fixed_velocity", value=(0.1, -0.2, 0.3)),
           (2, 0): BorderSpec("absorbing"), (2, 1): BorderSpec("free")}


def _borders(dim):
    return {f: BorderSpec(b.kind, value=None if b.value is None
                          else b.value[:dim])
            for f, b in BORDERS.items() if f[0] < dim}


def _problem(rng, name, shape):
    """Random heterogeneous medium and state, float64 on the CPU."""
    model = get_model(name)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = rng.standard_normal((model.ncomp,) + shape)
    u0[model.dim:] *= 1e6
    mat = MaterialFields.from_arrays(rho, lam, mu, dtype=torch.float64)
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    return model, torch.tensor(u0), mat, dt


def _mesh(dim, shape):
    return domain_mesh(dim, ["cpu"] * int(np.prod(shape)),
                       shape if dim == 3 else None)


# (global shape, mesh shape, order, force_spmd, borders)
CASES_3D = [((64, 32, 16), (4, 2), 1, False, True),
            ((64, 32, 16), (4, 2), 2, False, True),
            ((64, 32, 16), (4, 2), 3, False, True),
            ((32, 32, 8), (2, 2), 2, False, False),
            ((30, 26, 12), (2, 2), 3, False, True),      # ragged shards
            ((48, 8, 12), (8, 1), 2, False, True),       # ring only
            ((32, 16, 16), (1, 1), 2, True, True),       # forced split
            ((32, 16, 16), (1, 1), 2, False, True)]      # fused_step


@pytest.mark.parametrize("case", CASES_3D, ids=str)
def test_sharded_fused_step_matches_unsharded(rng, case):
    shape, mshape, order, force, with_borders = case
    model, u, mat, dt = _problem(rng, "elastic3d", shape)
    bc = _borders(3) if with_borders else None
    h = (1.0, 1.1, 0.9)
    mesh = _mesh(3, mshape)
    mext = pfs.extended_mstack(model, mat, mesh, order)
    stepper = pfs.make_fused_spmd_step(model, mesh, dt, h, order, bc,
                                       force_spmd=force)
    us, want, ms = shard_state(u, mesh), u, stack_mats(model, mat)
    for n in range(3):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        us = stepper(us, mext, axes)
        want = fused_step_reference(model, want, ms, dt, h, order, bc, axes)
    assert norm_err(gather_state(us, mesh), want) < 1e-12


def test_sharded_fused_step_folds_correctors(rng):
    shape = (32, 32, 16)
    model, u, mat, dt = _problem(rng, "elastic3d", shape)
    specs, naux = fold_corrector_specs(
        (MaxwellCorrector(tau=40 * dt),
         DamageCorrector(threshold=2e5, rate=0.05 / dt)), dt)
    assert naux == 1
    h = (10.0, 10.0, 10.0)
    mesh = _mesh(3, (4, 2))
    stepper = pfs.make_fused_spmd_step(model, mesh, dt, h, 2, _borders(3),
                                       correctors=specs)
    mext = pfs.extended_mstack(model, mat, mesh, 2)
    with pytest.raises(ValueError, match="aux"):
        stepper(shard_state(u, mesh), mext, (0, 1, 2))
    us = shard_state(u, mesh)
    aux = shard_state(torch.zeros((1,) + shape, dtype=torch.float64), mesh)
    want, waux = u, torch.zeros((1,) + shape, dtype=torch.float64)
    for n in range(3):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        us, aux = stepper(us, mext, axes, aux=aux)
        want, waux = fused_step_reference(model, want, stack_mats(model, mat),
                                          dt, h, 2, _borders(3), axes, specs,
                                          waux)
    assert waux.max() > 1e-4
    assert norm_err(gather_state(us, mesh), want) < 1e-12
    np.testing.assert_allclose(gather_state(aux, mesh).numpy(), waux.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,nsh", [((256, 30), 4), ((200, 24), 2),
                                       ((64, 20), 4), ((32, 20), 1)])
def test_sharded_2d_step_matches_unsharded(rng, order, shape, nsh):
    """Interior and ring x-tiles (256 and 200 rows), ring only (16-row
    shards) and the one-shard dispatch to fused_step_2d."""
    model, u, mat, dt = _problem(rng, "elastic2d", shape)
    h = (1.0, 1.1)
    mesh = _mesh(2, (nsh,))
    mext = pfs.extended_mstack_2d(model, mat, mesh, order)
    stepper = pfs.make_fused_spmd_step_2d(model, mesh, dt, h, order,
                                          _borders(2))
    us, want = shard_state(u, mesh), u
    for n in range(3):
        axes = (0, 1) if n % 2 == 0 else (1, 0)
        us = stepper(us, mext, axes)
        want = fused_step_reference(model, want, stack_mats(model, mat), dt,
                                    h, order, _borders(2), axes)
    assert norm_err(gather_state(us, mesh), want) < 1e-12


@pytest.mark.parametrize("name,shape,mshape,use_kernel", [
    (name, shape, mshape, k)
    for name, shape, mshape in (("elastic3d", (32, 16, 8), (2, 2)),
                                ("elastic3d", (32, 16, 8), (8, 1)),
                                ("acoustic3d", (24, 16, 8), (4, 2)),
                                ("elastic2d", (64, 24), (4,)))
    for k in (False, True)] + [("elastic1d", (64,), (4,), False)])
def test_halo_step_matches_unsharded(rng, name, shape, mshape, use_kernel):
    """The per-sweep halo step, raw sweeps plus the border post-fixup,
    against the plain step with in-sweep borders (float64)."""
    model, u, mat, dt = _problem(rng, name, shape)
    if name.startswith("acoustic"):
        mat = MaterialFields.from_arrays(mat.rho, mat.cp ** 2 * mat.rho,
                                         torch.zeros_like(mat.rho),
                                         dtype=torch.float64)
    dim = model.dim
    h = (1.0, 1.1, 0.9)[:dim]
    mesh = _mesh(dim, mshape)
    stepper = make_spmd_step(model, mesh, dt, h, 2, _borders(dim),
                             use_kernel=use_kernel)
    mats = extend_mats_once(shard_mats(mat, mesh), mesh, dim, 2)
    us, want = shard_state(u, mesh), u
    for n in range(3):
        axes = tuple(range(dim))[::(-1 if n % 2 else 1)]
        us = stepper(us, mats if n else shard_mats(mat, mesh), axes)
        want = step(model, want, mat, dt, h, 2, _borders(dim), axes)
    assert norm_err(gather_state(us, mesh), want) < 1e-12


@pytest.mark.parametrize("use_kernel", [False, True])
def test_raw_stage_matches_unsharded(rng, use_kernel):
    """The border-free sharded sweep, plus the post-fixup on the whole
    field, is the sweep with borders."""
    model, u, mat, dt = _problem(rng, "elastic3d", (32, 16, 8))
    h = (1.0, 1.1, 0.9)
    mesh = _mesh(3, (4, 2))
    raw = make_spmd_raw_stage(model, mesh, dt, h, 2, use_kernel=use_kernel)
    mats = extend_mats_once(shard_mats(mat, mesh), mesh, 3, 2)
    for axis in range(3):
        got = gather_state(raw(shard_state(u, mesh), mats, axis), mesh)
        got = apply_borders_post(model, u, got, mat, axis, _borders(3))
        want = stage(model, u, mat, dt, h, axis, 2, _borders(3))
        assert norm_err(got, want) < 1e-12


@pytest.mark.parametrize("kernel,dtype", [("fused", torch.float32),
                                          ("sweep", torch.float32),
                                          ("torch", torch.float64)])
@pytest.mark.parametrize("scenario,n,shape", [
    ("elastic3d_explosion", 16, (2, 2)), ("elastic3d_layered", 24, (4, 2)),
    ("elastic2d_viscoelastic", 32, (4,))])
def test_mesh_engine_matches_unsharded(scenario, n, shape, kernel, dtype):
    """Engine(mesh=) against Engine(device="cpu"): sources and receivers
    mapped to their shards, correctors per shard; the traces in the global
    receiver order."""
    task = dataclasses.replace(get_scenario(scenario, n=n, nsteps=5),
                               kernel=kernel)
    mesh = _mesh(task.grid.dim, shape)
    eng = Engine(task, mesh=mesh, dtype=dtype)
    got, want = eng.run(), Engine(task, device="cpu", dtype=dtype).run()
    assert got.kernel == want.kernel == kernel and len(eng.u) == mesh.size
    assert norm_err(got.u, want.u) < (1e-12 if kernel != "sweep" else 1e-6)
    assert np.abs(want.u).max() > 0
    scale = max(float(np.abs(want.traces).max()), 1e-30)
    assert np.abs(got.traces - want.traces).max() / scale < 1e-6


def test_mesh_engine_folds_correctors_per_shard():
    base = get_scenario("elastic3d_layered", n=24, nsteps=4)
    dt = Engine(base, device="cpu").dt
    task = dataclasses.replace(base, kernel="fused", correctors=(
        MaxwellCorrector(tau=50 * dt),
        DamageCorrector(threshold=5e5, rate=0.1 / dt)))
    eng = Engine(task, mesh=_mesh(3, (2, 2)))
    assert eng._fold_specs is not None and eng._fold_naux == 1
    got = eng.run()
    ref = Engine(task, device="cpu")
    want = ref.run()
    assert norm_err(got.u, want.u) < 1e-12
    np.testing.assert_array_equal(
        gather_state(eng.aux["damage"], eng.mesh, lead=0).numpy(),
        ref.aux["damage"].numpy())
    assert ref.aux["damage"].max() > 0


def test_entry_points_default_to_the_card(monkeypatch):
    """Engine(task) and SimplexEngine.from_task(task) run on CUDA unless
    asked for the CPU: without a card they raise, never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = get_scenario("elastic3d_layered", n=8, nsteps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(task)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(task, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimplexEngine.from_task(get_scenario("simplex3d_layered", n=5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        domain_mesh(3)
    assert Engine(task, device="cpu").device.type == "cpu"


def test_mesh_devices_and_explicit_device_must_agree():
    task = get_scenario("elastic3d_explosion", n=16, nsteps=1)
    mesh = _mesh(3, (2, 2))
    assert Engine(task, mesh=mesh, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="disagrees"):
        Engine(task, mesh=mesh, device="cuda")


def test_domain_mesh_and_shards():
    mesh = domain_mesh(3, ["cpu"] * 8)
    assert (mesh.shape, mesh.axis_names) == ((4, 2), ("sx", "sy"))
    assert domain_mesh(3, ["cpu"] * 6).shape == (3, 2)
    assert domain_mesh(2, ["cpu"] * 4).axis_names == ("sx",)
    assert [mesh.coords(k) for k in (0, 1, 2, 7)] == [(0, 0), (0, 1),
                                                       (1, 0), (3, 1)]
    u = torch.arange(2 * 8 * 6 * 3, dtype=torch.float64).reshape(2, 8, 6, 3)
    blocks = shard_state(u, mesh)
    assert [tuple(b.shape) for b in blocks] == [(2, 2, 3, 3)] * 8
    assert torch.equal(blocks[3], u[:, 2:4, 3:6])
    assert torch.equal(gather_state(blocks, mesh), u)
    with pytest.raises(ValueError, match="divisible"):
        shard_state(torch.zeros(2, 9, 6, 3), mesh)
    with pytest.raises(ValueError, match="devices"):
        DomainMesh(("cpu",) * 3, (2, 2), ("sx", "sy"))
    with pytest.raises(ValueError, match="last"):
        shard_state(torch.zeros(2, 8, 6), DomainMesh(("cpu",) * 2, (2,),
                                                     ("sy",)))


@pytest.mark.parametrize("n,tile,r", [(128, 8, 1), (128, 8, 2), (25, 8, 2),
                                      (17, 8, 1), (9, 8, 1), (100, 32, 2),
                                      (512, 32, 1), (8, 8, 2)])
def test_tile_split(n, tile, r):
    """Interior tiles are whole tiles whose r-haloed window lies inside
    the block; every other tile of the ceil(n / tile) grid is a ring tile,
    so the two launches write each cell exactly once."""
    nt, i0, i1 = ofs.tile_split(n, tile, r)
    assert nt == -(-n // tile)
    inner = set(range(i0, i1))
    for i in range(nt):
        fits = i * tile - r >= 0 and (i + 1) * tile + r <= n
        assert (i in inner) == fits
    mask = ofs.interior_mask((n, 40), r, (tile, 8))
    _, j0, j1 = ofs.tile_split(40, 8, r)
    assert int(mask.sum()) == ((i1 - i0) * tile * (j1 - j0) * 8
                               if i1 and j1 else 0)


def test_slab_buffers_are_reused(rng):
    model, u, _, _ = _problem(rng, "elastic3d", (16, 16, 4))
    mesh = _mesh(3, (2, 2))
    ex = pfs.SlabExchange(mesh, (9, 8, 8, 4), 1, torch.float64, 3)
    first = [tuple(t.data_ptr() for t in s) for s in ex(shard_state(u, mesh))]
    slabs = ex(shard_state(2 * u, mesh))
    assert [tuple(t.data_ptr() for t in s) for s in slabs] == first
    want = pfs.exchange_slabs(shard_state(2 * u, mesh), mesh, 1)
    for s, w in zip(slabs, want):
        for a, b in zip(s, w):
            assert torch.equal(a, b)
    # shard (1, 1): x-lo slab from shard (0, 1), y-lo strip from (1, 0)
    # with its corner from shard (0, 0); x-hi on the domain face
    xlo, xhi, ylo, yhi = slabs[3]
    assert torch.equal(xlo, 2 * u[:, 7:8, 8:16])
    assert torch.equal(xhi, 2 * u[:, 15:16, 8:16])
    assert torch.equal(ylo[:, 1:9], 2 * u[:, 8:16, 7:8])
    assert torch.equal(ylo[:, :1], 2 * u[:, 7:8, 7:8])


def test_wrappers_on_cpu_run_plain_versions(rng):
    model, u, mat, dt = _problem(rng, "elastic3d", (16, 16, 8))
    mext = pfs.extended_mstack(model, mat, _mesh(3, (1, 1)), 2)[0]
    before = (ofs.fused_spmd_interior.launches, ofs.fused_spmd_ring.launches,
              ofs.fused_spmd_2d.launches)
    got = ofs.fused_spmd_interior(model, u, mext, dt, (1.0,) * 3, 2)
    want = ofs.fused_spmd_interior_reference(model, u, mext, dt, (1.0,) * 3,
                                             2)
    assert torch.equal(got, want)
    assert (ofs.fused_spmd_interior.launches, ofs.fused_spmd_ring.launches,
            ofs.fused_spmd_2d.launches) == before
    with pytest.raises(ValueError, match="which"):
        ofs.fused_spmd_2d(get_model("elastic2d"), u[:5, :, :, 0], mext[:, :, 1],
                          dt, (1.0, 1.0), 2, which="both")
    with pytest.raises(ValueError, match="unsupported axes"):
        pfs.make_fused_spmd_step(model, _mesh(3, (2, 2)), dt, (1.0,) * 3, 2)(
            shard_state(u, _mesh(3, (2, 2))), None, (0, 1, 1))
    with pytest.raises(ValueError, match="stencil radius"):
        pfs.make_fused_spmd_step(model, _mesh(3, (16, 1)), dt, (1.0,) * 3,
                                 3)(shard_state(u, _mesh(3, (16, 1))), None,
                                    (0, 1, 2))
