"""The CUDA kernels of the port on the card (marked ``gpu``).

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed, without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Inputs are random heterogeneous problems made from a seeded numpy
generator, with all four border kinds (and per-node borders on simplex
meshes); each kernel is held to its plain version
(``fused_step_reference``, ``fused_step_slab_reference``,
``fused_step_2d_reference``, ``solver.gcm.stage``,
``simplex_sweep_reference``) with the per-component
normalized max error of 2e-6
that the JAX package holds its TPU kernels to, and the damage aux stream to
rtol 1e-5, atol 1e-6 (the atol absorbs threshold-crossing knife-edges in
``max(smax - threshold, 0)``), as tests/test_pallas_fused.py holds it.
"""

import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from gcm_tpu_torch.engine import Engine
from gcm_tpu_torch.engine_simplex import SimplexEngine
from gcm_tpu_torch.grids.simplex import SimplexGrid, build_foot_tables
from gcm_tpu_torch.materials import MaterialFields
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.fused import (
    fold_corrector_specs, fused_step, fused_step_2d, fused_step_2d_reference,
    fused_step_reference, fused_step_slab, fused_step_slab_reference,
    stack_mats)
from gcm_tpu_torch.ops.simplex import (
    build_simplex_plan, simplex_sweep, simplex_sweep_reference)
from gcm_tpu_torch.ops.sweep import sweep_stage
from gcm_tpu_torch.scenarios import get_scenario
from gcm_tpu_torch.solver.correctors import DamageCorrector, MaxwellCorrector
from gcm_tpu_torch.solver.gcm import stage
from gcm_tpu_torch.solver.simplex_gcm import build_node_borders
from gcm_tpu_torch.task import AreaLayer, BorderSpec
from gcm_tpu_torch.utils import profiling

BORDERS = {
    (0, 0): BorderSpec("free"),
    (0, 1): BorderSpec("absorbing"),
    (1, 0): BorderSpec("fixed_force", value=(1e5, 2e5, -1e5)),
    (1, 1): BorderSpec("fixed_velocity", value=(0.1, -0.2, 0.3)),
    (2, 0): BorderSpec("absorbing"),
    (2, 1): BorderSpec("free"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def borders(dim):
    """BORDERS cut to ``dim`` axes."""
    return {f: BorderSpec(b.kind, value=b.value if b.value is None
                          else b.value[:dim])
            for f, b in BORDERS.items() if f[0] < dim}


def card_problem(seed, name, shape, device, with_mat=False):
    rng = np.random.default_rng(seed)
    model = get_model(name)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    if name.startswith("acoustic"):
        mu = np.zeros(shape)
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = rng.standard_normal((model.ncomp,) + shape)
    u0[model.dim:] *= 1e6
    mat = MaterialFields.from_arrays(rho, lam, mu, device=device)
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    u = torch.tensor(u0, dtype=torch.float32, device=device)
    return model, u, (mat if with_mat else stack_mats(model, mat)), dt


def owned(name, order, ortho=False):
    """The one-step 3D body a form compiles to: the owned one for elastic3d
    at orders 1-2 on a compact stack, else the ring body."""
    return ("owned" if name == "elastic3d" and order <= 2 and not ortho
            else "ring")


def bodies(rec):
    """The one-step 3D launches a recording counted, by body."""
    pre = "gcm.kernels.stream."
    return {k[len(pre):]: n for k, n in rec.counters.items()
            if k.startswith(pre)}


def norm_err(got, want):
    c = want.shape[0]
    scale = want.abs().reshape(c, -1).amax(1) + 1e-30
    return ((got - want).abs().reshape(c, -1).amax(1) / scale).max().item()


def seqs_2d(ksteps):
    """The 2D sweep sequences of a pass of ``ksteps`` steps: both orders for
    one step, every pair of them for two."""
    orders = ((0, 1), (1, 0))
    return ([(ax,) for ax in orders] if ksteps == 1
            else list(itertools.product(orders, orders)))


#: every 3D sweep order: x first, in the middle and last, each with y
#: before z and after it (each is an instantiation of the one-step body)
AXES_3D = list(itertools.permutations(range(3)))
#: 3D extents: a tile multiple along none of the axes, ragged against the
#: 8 x 32 (y, z) tile in every axis, thinner than an x chunk and than the
#: halo (nx = 1, 2; nz = 2)
SHAPES_3D = [(24, 40, 56), (3, 5, 7), (70, 19, 45), (9, 17, 2), (1, 9, 33),
             (2, 3, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("name", ["elastic3d", "acoustic3d"])
@pytest.mark.parametrize("axes", AXES_3D)
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_kernel_matches_plain_on_card(cuda, order, axes, name, shape):
    model, u, ms, dt = card_problem(order, name, shape, cuda)
    h = (10.0, 12.0, 9.0)
    before = fused_step.launches
    with profiling.recording() as rec:
        got = fused_step(model, u, ms, dt, h, order, BORDERS, axes)
    torch.cuda.synchronize()
    assert fused_step.launches == before + 1
    assert bodies(rec) == {owned(name, order): 1}
    want = fused_step_reference(model, u, ms, dt, h, order, BORDERS, axes)
    assert norm_err(got, want) < 2e-6


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    model, u, ms, dt = card_problem(0, "elastic3d", (8, 8, 8), cuda)
    h = (1.0, 1.0, 1.0)
    with pytest.raises(TypeError):
        fused_step(model, u.double(), ms, dt, h, 2)
    with pytest.raises(ValueError):
        fused_step(model, u.transpose(1, 2), ms, dt, h, 2)
    with pytest.raises(ValueError):
        fused_step(model, u, ms[:3], dt, h, 2)
    with pytest.raises(ValueError):
        fused_step(model, u, ms, dt, h, 5)
    with pytest.raises(ValueError):
        fused_step(model, u, ms.cpu(), dt, h, 2)


@pytest.mark.gpu
def test_engine_takes_the_kernel_on_card(cuda):
    task = get_scenario("elastic3d_explosion", n=32, nsteps=7)
    before = fused_step.launches
    got = Engine(task, device=cuda).run()
    assert got.kernel == "fused"
    assert fused_step.launches == before + 7
    want = Engine(dataclasses.replace(task, kernel="torch"),
                  device=cuda).run()
    assert norm_err(torch.from_numpy(got.u), torch.from_numpy(want.u)) < 1e-5
    np.testing.assert_allclose(got.traces, want.traces, rtol=1e-4,
                               atol=1e-5 * np.abs(want.traces).max())


#: 2D extents of the row-streamed body: rows not a multiple of 4 cells
#: (4-byte copies), aligned rows, a multiple of the 126-column strip (r =
#: 1), and thinner than the 2r halo along x with fewer columns than a strip
SHAPES_2D = [(37, 61), (64, 128), (70, 252), (3, 130), (4, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("name", ["elastic2d", "acoustic2d"])
@pytest.mark.parametrize("axes", [(0, 1), (1, 0)])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_2d_kernel_matches_plain_on_card(cuda, order, axes, name, shape):
    model, u, ms, dt = card_problem(order, name, shape, cuda)
    h = (10.0, 12.0)
    before = fused_step_2d.launches
    got = fused_step_2d(model, u, ms, dt, h, order, borders(2), axes)
    torch.cuda.synchronize()
    assert fused_step_2d.launches == before + 1
    want = fused_step_2d_reference(model, u, ms, dt, h, order, borders(2),
                                   axes)
    assert norm_err(got, want) < 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [("elastic3d", (12, 16, 24)),
                                        ("elastic2d", (37, 61))])
def test_folded_correctors_match_plain_on_card(cuda, name, shape):
    """Maxwell + damage folded into the kernels' epilogue, three steps."""
    model, u, ms, dt = card_problem(0, name, shape, cuda)
    dim = model.dim
    kernel = fused_step if dim == 3 else fused_step_2d
    corr = (MaxwellCorrector(tau=40 * dt),
            DamageCorrector(threshold=2e5, rate=0.5 / dt))
    specs, naux = fold_corrector_specs(corr, dt)
    assert naux == 1
    h = (10.0, 11.0, 9.0)[:dim]
    got, gaux = u, torch.zeros((1,) + shape, device=cuda)
    want, waux = u, gaux
    for n in range(3):
        axes = tuple(range(dim))[::(-1 if n % 2 else 1)]
        got, gaux = kernel(model, got, ms, dt, h, 2, borders(dim), axes,
                           correctors=specs, aux=gaux)
        want, waux = fused_step_reference(model, want, ms, dt, h, 2,
                                          borders(dim), axes,
                                          correctors=specs, aux=waux)
    torch.cuda.synchronize()
    assert gaux.max().item() > 1e-4
    assert norm_err(got, want) < 2e-6
    torch.testing.assert_close(gaux, waux, rtol=1e-5, atol=1e-6)


#: per-sweep extents: each compiled model (the kernel's component maps),
#: tile-multiple, ragged against the 16 x 64 tiles, thinner than the halo
#: along the sweep axis and along the contiguous one
SWEEP_CASES = [("elastic3d", (24, 40, 56)), ("elastic3d", (32, 64, 128)),
               ("elastic3d", (9, 17, 2)), ("elastic3d", (1, 3, 130)),
               ("acoustic3d", (3, 5, 7)), ("acoustic3d", (33, 4, 65)),
               ("elastic2d", (37, 61)), ("elastic2d", (5, 3)),
               ("elastic2d", (130, 2)), ("acoustic2d", (64, 128)),
               ("acoustic2d", (2, 201))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", SWEEP_CASES)
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_sweep_kernel_matches_plain_on_card(cuda, order, name, shape):
    model, u, mat, dt = card_problem(order, name, shape, cuda, with_mat=True)
    h = (10.0, 12.0, 9.0)[:model.dim]
    for axis in range(model.dim):
        before = sweep_stage.launches
        got = sweep_stage(model, u, mat, dt, h, axis, order,
                          borders(model.dim))
        torch.cuda.synchronize()
        assert sweep_stage.launches == before + 1
        want = stage(model, u, mat, dt, h, axis, order, borders(model.dim))
        assert norm_err(got, want) < 2e-6


@pytest.mark.gpu
def test_engine_2d_takes_the_kernel_once_a_step(cuda):
    task = get_scenario("elastic2d_viscoelastic", n=64, nsteps=7)
    before = fused_step_2d.launches
    eng = Engine(task, device=cuda)
    got = eng.run()
    assert got.kernel == "fused" and eng._fold_specs is None
    assert fused_step_2d.launches == before + 7
    want = Engine(dataclasses.replace(task, kernel="torch"),
                  device=cuda).run()
    assert norm_err(torch.from_numpy(got.u), torch.from_numpy(want.u)) < 1e-5


@pytest.mark.gpu
def test_engine_sweep_path_takes_the_kernel_per_axis(cuda):
    task = dataclasses.replace(get_scenario("elastic3d_explosion", n=32,
                                            nsteps=5), kernel="sweep")
    before = sweep_stage.launches
    got = Engine(task, device=cuda).run()
    assert got.kernel == "sweep"
    assert sweep_stage.launches == before + 3 * 5
    want = Engine(dataclasses.replace(task, kernel="torch"),
                  device=cuda).run()
    assert norm_err(torch.from_numpy(got.u), torch.from_numpy(want.u)) < 1e-5


@pytest.mark.gpu
def test_2d_and_sweep_kernels_reject_what_they_do_not_take(cuda):
    model, u, ms, dt = card_problem(0, "elastic2d", (8, 8), cuda)
    h = (1.0, 1.0)
    with pytest.raises(TypeError):
        fused_step_2d(model, u.double(), ms, dt, h, 2)
    with pytest.raises(ValueError):
        fused_step_2d(model, u.transpose(1, 2), ms, dt, h, 2)
    with pytest.raises(ValueError):
        fused_step_2d(model, u, ms, dt, h, 2, axes=(0, 0))
    with pytest.raises(TypeError):
        fused_step_2d(model, u, ms, dt, h, 2,
                      correctors=(("damage", 1.0, 1.0),),
                      aux=torch.zeros((1, 8, 8), dtype=torch.float64,
                                      device=cuda))
    model, u, mat, dt = card_problem(0, "elastic2d", (8, 8), cuda,
                                     with_mat=True)
    with pytest.raises(TypeError):
        sweep_stage(model, u.double(), mat, dt, h, 0, 2)
    with pytest.raises(ValueError):
        sweep_stage(model, u, mat, dt, h, 2, 2)
    with pytest.raises(TypeError):
        sweep_stage(model, u, dataclasses.replace(mat, cp=mat.cp.double()),
                    dt, h, 0, 2)


# ------------------------------------------------------------------ simplex

#: (n, dim, model, order, fluid): jittered n^dim box meshes; 9^3 = 729
#: nodes is no multiple of the kernel's 128-thread block, the 2D order-2
#: mesh has tables of K = 10 (no 16-byte rows), the 2D order-3 one of
#: K = 16, and the 3D order-3 one of K = 40 (the kernel's generic width)
SIMPLEX_CASES = [(8, 3, "elastic3d", 1, False), (8, 3, "elastic3d", 2, False),
                 (8, 3, "elastic3d", 1, True), (8, 3, "acoustic3d", 1, True),
                 (12, 2, "elastic2d", 1, False), (9, 3, "elastic3d", 1, False),
                 (12, 2, "elastic2d", 2, False), (12, 2, "elastic2d", 3, False),
                 (8, 3, "elastic3d", 3, False)]


def simplex_problem(seed, n, dim, name, order, fluid, device):
    """Random heterogeneous medium on a jittered box mesh, its foot tables
    (built on the host) and a random float32 state on ``device``."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    grid = SimplexGrid.box((0.0,) * dim, (1.0,) * dim, (n,) * dim,
                           jitter=0.1, seed=n)
    N = grid.npoints
    model = get_model(name)
    rho = 2500.0 * (1.0 + 0.2 * rng.random(N))
    mu = np.zeros(N) if fluid else 1e9 * (0.5 + rng.random(N))
    lam = 1e9 * (1.0 + rng.random(N))
    mat = MaterialFields.from_arrays(rho, lam, mu, device=device)
    d, _ = cKDTree(grid.points).query(grid.points, k=2)
    dt = 0.7 * float(d[:, 1].min()) / mat.max_cp()
    waves = {"p": mat.cp.double().cpu().numpy()}
    if not fluid:
        waves["s"] = mat.cs.double().cpu().numpy()
    tables = build_foot_tables(grid, waves, dt, order=order)
    u0 = rng.standard_normal((model.ncomp, N))
    u0[model.dim:] *= 1e6
    return (grid, model, mat, tables,
            torch.tensor(u0, dtype=torch.float32, device=device))


def simplex_border(grid, dim, kind):
    """A uniform border kind, or per-node borders ("node"): free top,
    fixed_force on the low x side, fixed_velocity on the high one."""
    if kind == "node":
        return build_node_borders(grid, [
            (AreaLayer(axis=dim - 1, lo=0.99, hi=1.01), BorderSpec("free")),
            (AreaLayer(axis=0, lo=-0.01, hi=0.01),
             BorderSpec("fixed_force", value=(2e5, 1e5, -1e5)[:dim])),
            (AreaLayer(axis=0, lo=0.99, hi=1.01),
             BorderSpec("fixed_velocity", value=(0.1, -0.2, 0.3)[:dim]))])
    value = {"fixed_force": (1e5, -2e5, 3e5),
             "fixed_velocity": (0.1, 0.2, -0.3)}.get(kind)
    return BorderSpec(kind, value=None if value is None else value[:dim])


@pytest.mark.gpu
@pytest.mark.parametrize("border", ["absorbing", "free", "fixed_force",
                                    "fixed_velocity", "node"])
@pytest.mark.parametrize(
    "case", SIMPLEX_CASES,
    ids=lambda c: f"{c[2]}-o{c[3]}{'-fluid' * c[4]}-n{c[0]}")
def test_simplex_kernel_matches_plain_on_card(cuda, case, border):
    n, dim, name, order, fluid = case
    grid, model, mat, tables, u0 = simplex_problem(order, *case, cuda)
    plan = build_simplex_plan(model, mat, tables,
                              simplex_border(grid, dim, border), cuda)
    for axes in (tuple(range(dim)), tuple(range(dim))[::-1]):
        u = u0
        for a in axes:
            before = simplex_sweep.launches
            got = simplex_sweep(plan, u, a)
            torch.cuda.synchronize()
            assert simplex_sweep.launches == before + 1
            want = simplex_sweep_reference(plan, u, a)
            assert norm_err(got, want) < 2e-6
            u = want


@pytest.mark.gpu
def test_simplex_engine_takes_the_kernel_three_times_a_step(cuda):
    task = get_scenario("simplex3d_layered", n=13, nsteps=9)
    before = simplex_sweep.launches
    eng = SimplexEngine.from_task(task, device=cuda)
    got = eng.run()
    assert got.kernel == "simplex"
    assert simplex_sweep.launches == before + 3 * 9
    want = SimplexEngine.from_task(dataclasses.replace(task, kernel="torch"),
                                   device=cuda, tables=eng.tables).run()
    assert norm_err(torch.from_numpy(got.u), torch.from_numpy(want.u)) < 1e-5
    np.testing.assert_allclose(got.traces, want.traces, rtol=1e-4,
                               atol=1e-5 * np.abs(want.traces).max())


@pytest.mark.gpu
def test_simplex_kernel_rejects_what_it_does_not_take(cuda):
    grid, model, mat, tables, u = simplex_problem(0, *SIMPLEX_CASES[0], cuda)
    plan = build_simplex_plan(model, mat, tables, "free", cuda)
    with pytest.raises(TypeError):
        simplex_sweep(plan, u.double(), 0)
    with pytest.raises(ValueError):
        simplex_sweep(plan, u[:, :-1], 0)
    with pytest.raises(ValueError):
        simplex_sweep(plan, u.t().contiguous().t(), 0)
    with pytest.raises(ValueError):
        simplex_sweep(plan, u, 3)
    with pytest.raises(TypeError):
        simplex_sweep(build_simplex_plan(model, mat, tables, "free", "cpu"),
                      u, 0)



#: multi-body cases (dim, conforming, tensile strength, order): two boxes
#: meeting at x = 0.5, body b meshed at h/2 where the interface does not
#: conform; jittered at order 1, lattices at order 2 (the order-2 tables
#: grow without bound on jittered 3D meshes, one body alone too)
SIMPLEX_MULTI_CASES = [(2, True, None, 1), (2, True, 3e5, 2),
                       (2, False, 3e5, 1), (3, True, 3e5, 1),
                       (3, True, None, 2), (3, False, None, 1),
                       (3, False, 3e5, 2)]


def simplex_pair(dim, conforming, strength, order, kernel, device,
                 tables=None):
    """Two rock bodies bonded across x = 0.5, a P pulse in body a heading
    for the interface, peaked at the middle of the plane (so the interface
    breaks there first where fracture is on)."""
    from gcm_tpu_torch.engine_simplex import SimplexBody, SimplexMultiEngine
    from gcm_tpu_torch.materials import IsotropicMaterial
    from gcm_tpu_torch.solver.simplex_contact import SimplexContactSpec

    n = 9 if dim == 3 else 17
    nb = n if conforming else 2 * n - 1
    jitter = 0.15 if order == 1 else 0.0
    ga = SimplexGrid.box((0.0,) * dim, (0.5,) + (1.0,) * (dim - 1),
                         ((n + 1) // 2,) + (n,) * (dim - 1), jitter=jitter,
                         seed=1)
    gb = SimplexGrid.box((0.5,) + (0.0,) * (dim - 1), (1.0,) * dim,
                         ((nb + 1) // 2,) + (nb,) * (dim - 1), jitter=jitter,
                         seed=2)
    rock = IsotropicMaterial.from_speeds(2500.0, 4000.0, 2300.0)
    model = get_model(f"elastic{dim}d")
    p = ga.points
    prof = 1e6 * np.exp(-((p[:, 0] - 0.35) / 0.08) ** 2
                        - (((p[:, 1:] - 0.5) / 0.3) ** 2).sum(1))
    u0 = np.zeros((model.ncomp, ga.npoints))
    kappa = rock.lam / (rock.lam + 2 * rock.mu)
    u0[model.comp("sxx")] = prof
    for c in ("syy", "szz")[:dim - 1]:
        u0[model.comp(c)] = kappa * prof
    u0[model.comp("vx")] = -prof / (rock.rho * rock.cp)
    return SimplexMultiEngine(
        {"a": SimplexBody(ga, rock, u0=u0), "b": SimplexBody(gb, rock)},
        [SimplexContactSpec("a", "b", axis=0, tensile_strength=strength)],
        model_name=model.name, order=order, kernel=kernel, device=device,
        tables=tables)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SIMPLEX_MULTI_CASES, ids=str)
def test_simplex_multi_kernel_path_matches_plain_on_card(cuda, case):
    dim, conforming, strength, order = case
    nsteps = 24
    eng = simplex_pair(*case, "auto", cuda)
    assert (0 in eng._pairs) == conforming
    before = simplex_sweep.launches
    got = eng.run(nsteps)
    assert got.kernels == {"a": "simplex", "b": "simplex"}
    assert simplex_sweep.launches == before + 2 * dim * nsteps
    plain = simplex_pair(*case, "torch", cuda, tables=eng.tables)
    before = simplex_sweep.launches
    want = plain.run(nsteps)
    assert simplex_sweep.launches == before
    for name in ("a", "b"):
        assert norm_err(torch.from_numpy(got.bodies[name]),
                        torch.from_numpy(want.bodies[name])) < 1e-4
    assert np.abs(got.bodies["b"]).max() > 0
    if strength is not None:
        masks = (got.bonded[0], want.bonded[0])
        if not conforming:
            masks = tuple(np.concatenate([m["a"], m["b"]]) for m in masks)
        np.testing.assert_array_equal(*masks)
        assert 0 < masks[0].mean() < 1


@pytest.mark.gpu
def test_simplex_orthotropic_media_take_the_plain_path_on_card(cuda):
    from gcm_tpu_torch.materials import OrthotropicMaterial

    task = get_scenario("simplex3d_layered", n=9, nsteps=4)
    ortho = OrthotropicMaterial.from_isotropic(task.default_material)
    task = dataclasses.replace(task, default_material=ortho)
    before = simplex_sweep.launches
    got = SimplexEngine.from_task(task, device=cuda).run()
    assert got.kernel == "torch" and simplex_sweep.launches == before
    assert np.isfinite(got.u).all()
    with pytest.raises(ValueError, match="isotropic"):
        SimplexEngine.from_task(dataclasses.replace(task, kernel="simplex"),
                                device=cuda)


# -------------------------------------------------------------- sharded

#: (global shape, mesh shape, order, axes): tile-multiple, ragged and
#: ring-only (8-row) shards on 2x2 and 4x1 meshes
SPMD_CASES = [((64, 48, 16), (2, 2), 1, (0, 1, 2)),
              ((64, 48, 16), (2, 2), 2, (2, 1, 0)),
              ((50, 38, 20), (2, 2), 3, (0, 1, 2)),
              ((96, 20, 16), (4, 1), 2, (2, 1, 0)),
              ((32, 16, 16), (4, 1), 2, (0, 1, 2)),
              ((70, 38, 45), (2, 2), 2, (2, 0, 1)),
              ((50, 38, 20), (2, 2), 1, (1, 2, 0))]


def _card_mesh(cuda, dim, shape):
    from gcm_tpu_torch.parallel.sharding import domain_mesh

    n = int(np.prod(shape))
    return domain_mesh(dim, [cuda] * n, shape if dim == 3 else None)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPMD_CASES, ids=str)
def test_spmd_kernels_match_plain_on_card(cuda, case):
    """Interior and ring kernels of every shard (all on one card) against
    their plain versions, and the sharded step against the unsharded one."""
    from gcm_tpu_torch.ops import fused_spmd as fs
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack, face_flags, make_fused_spmd_step)
    from gcm_tpu_torch.parallel.sharding import gather_state, shard_state

    shape, mshape, order, axes = case
    model, u, mat, dt = card_problem(order, "elastic3d", shape, cuda,
                                     with_mat=True)
    h = (10.0, 12.0, 9.0)
    mesh = _card_mesh(cuda, 3, mshape)
    mext = extended_mstack(model, mat, mesh, order)
    us = shard_state(u, mesh)
    slabs = exchange_slabs(us, mesh, fs.stencil_radius(order))
    for k, uk in enumerate(us):
        before = (fs.fused_spmd_interior.launches, fs.fused_spmd_ring.launches)
        args = (model, uk, mext[k], dt, h, order, BORDERS, axes)
        with profiling.recording() as rec:
            got = fs.fused_spmd_interior(*args, out=torch.zeros_like(uk))
            ring = fs.fused_spmd_ring(model, uk, mext[k], slabs[k],
                                      face_flags(mesh, k),
                                      torch.zeros_like(uk), *args[3:])
        torch.cuda.synchronize()
        assert (fs.fused_spmd_interior.launches,
                fs.fused_spmd_ring.launches) == (before[0] + 1, before[1] + 1)
        assert bodies(rec) == {owned("elastic3d", order): 2}
        want = fs.fused_spmd_interior_reference(*args,
                                                out=torch.zeros_like(uk))
        assert norm_err(got, want) < 2e-6
        want = fs.fused_spmd_ring_reference(
            model, uk, mext[k], slabs[k], face_flags(mesh, k),
            torch.zeros_like(uk), *args[3:])
        assert norm_err(ring, want) < 2e-6
    step = make_fused_spmd_step(model, mesh, dt, h, order, BORDERS)
    want = fused_step_reference(model, u, stack_mats(model, mat), dt, h,
                                order, BORDERS, axes)
    assert norm_err(gather_state(step(us, mext, axes), mesh), want) < 2e-6


#: (global shape, mesh shape, order, axes, orthotropic): ragged shards,
#: thin and ring-only ones, x in the middle of the sweep order
SPMD_COVER_CASES = [((64, 48, 16), (2, 2), 3, (2, 0, 1), False),
                    ((50, 38, 20), (2, 2), 2, (1, 0, 2), False),
                    ((70, 38, 45), (2, 2), 4, (2, 0, 1), False),
                    ((8, 36, 9), (2, 2), 1, (1, 0, 2), False),
                    ((140, 38, 33), (2, 2), 2, (0, 2, 1), False),
                    ((96, 20, 16), (4, 1), 2, (1, 2, 0), False),
                    ((4, 4, 5), (2, 2), 1, (2, 0, 1), False),
                    ((50, 38, 20), (2, 2), 2, (2, 0, 1), True),
                    ((70, 38, 45), (2, 2), 3, (1, 0, 2), True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPMD_COVER_CASES, ids=str)
def test_spmd_launches_cover_every_cell_once_on_card(cuda, case):
    """The interior launch writes exactly the interior cells of a NaN
    buffer, the ring launch all the others; each is held to its plain
    version and their union to the unsharded plain step."""
    from gcm_tpu_torch.ops import fused_spmd as fs
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack, face_flags)
    from gcm_tpu_torch.parallel.sharding import gather_state, shard_state

    shape, mshape, order, axes, ortho = case
    make = card_ortho_problem if ortho else card_problem
    model, u, mat, dt = make(order, "elastic3d", shape, cuda, with_mat=True)
    h = (10.0, 12.0, 9.0)
    mesh = _card_mesh(cuda, 3, mshape)
    r = fs.stencil_radius(order)
    mext = extended_mstack(model, mat, mesh, order)
    us = shard_state(u, mesh)
    slabs = exchange_slabs(us, mesh, r)
    outs = []
    for k, uk in enumerate(us):
        args = (model, uk, mext[k], dt, h, order, BORDERS, axes)
        got = fs.fused_spmd_interior(*args,
                                     out=torch.full_like(uk, float("nan")))
        torch.cuda.synchronize()
        inner = fs.interior_mask(uk.shape[1:], r, device=cuda)
        assert not torch.isnan(got[:, inner]).any()
        assert torch.isnan(got[:, ~inner]).all()
        want = fs.fused_spmd_interior_reference(*args,
                                                out=torch.zeros_like(uk))
        assert norm_err(torch.nan_to_num(got), want) < 2e-6
        flags = face_flags(mesh, k)
        got = fs.fused_spmd_ring(model, uk, mext[k], slabs[k], flags, got,
                                 *args[3:])
        torch.cuda.synchronize()
        assert not torch.isnan(got).any()
        want = fs.fused_spmd_ring_reference(model, uk, mext[k], slabs[k],
                                            flags, want, *args[3:])
        assert norm_err(got, want) < 2e-6
        outs.append(got)
    want = fused_step_reference(model, u, stack_mats(model, mat), dt, h,
                                order, BORDERS, axes)
    assert norm_err(gather_state(outs, mesh), want) < 2e-6


#: blocks an SM of the owned one-step body (its register budget)
OWNED_BLOCKS = 2


@pytest.mark.gpu
def test_stream_occupancy_on_card(cuda):
    """The owned one-step body (elastic3d, r = 1) holds OWNED_BLOCKS blocks
    an SM on 69-85 KB of shared memory (the raw planes, the x sweep's three
    planes and one or two temporaries), in every sweep order, float and
    bf16 stacks, single-card and SPMD launches; the two-step body holds
    three blocks an SM in every order pair at r = 1 and fits one at r =
    2."""
    from gcm_tpu_torch.ops import fused_spmd as fs
    from gcm_tpu_torch.ops.fused import fused_step_slab_occupancy
    from gcm_tpu_torch.parallel.fused_spmd import extended_mstack

    model, u, mat, dt = card_problem(0, "elastic3d", (16, 16, 32), cuda,
                                     with_mat=True)
    ms = stack_mats(model, mat)
    mext = extended_mstack(model, mat, _card_mesh(cuda, 3, (1, 1)), 2)[0]
    h = (1.0, 1.0, 1.0)
    for axes in AXES_3D:
        for stack in (ms, ms.to(torch.bfloat16)):
            bps, smem = fused_step_slab_occupancy(model, u, stack, dt, h, 2,
                                                  BORDERS, axes)
            assert bps == OWNED_BLOCKS and 69_000 < smem < 85_000
        for ring in (False, True):
            bps, smem = fs.fused_spmd_occupancy(model, u, mext, dt, h, 2,
                                                BORDERS, axes, ring=ring)
            assert bps == OWNED_BLOCKS and 69_000 < smem < 85_000
    for order in (2, 4):
        for seq in slab_seqs(2):
            bps, smem = fused_step_slab_occupancy(model, u, ms, dt, h, order,
                                                  BORDERS, axes_seq=seq)
            if order == 2:
                assert bps == 3 and 60_000 < smem < 80_000
            else:
                assert bps == 1 and smem <= 232_448


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["elastic2d", "acoustic2d"])
def test_rows_occupancy_on_card(cuda, name):
    """The row-streamed 2D body takes a few rows of shared memory (under
    16 KB) and holds at least four blocks of 4 warps an SM, single-card
    and SPMD launches, in both sweep orders at every stencil order."""
    from gcm_tpu_torch.ops import fused_spmd as fs
    from gcm_tpu_torch.ops.fused import fused_step_2d_occupancy
    from gcm_tpu_torch.parallel.fused_spmd import extended_mstack

    model, u, mat, dt = card_problem(0, name, (16, 64), cuda, with_mat=True)
    ms = stack_mats(model, mat)
    h = (1.0, 1.0)
    for order in (1, 2, 3, 4):
        mext = extended_mstack(model, mat, _card_mesh(cuda, 2, (1,)),
                               order)[0]
        for axes in ((0, 1), (1, 0)):
            bps, smem = fused_step_2d_occupancy(model, u, ms, dt, h, order,
                                                borders(2), axes)
            assert bps >= 4 and 0 < smem < 16_384
            for ring in (False, True):
                bps, smem = fs.fused_spmd_occupancy(
                    model, u, mext, dt, h, order, borders(2), axes,
                    ring=ring)
                assert bps >= 4 and 0 < smem < 16_384


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["elastic2d", "acoustic2d"])
def test_rows_pair_occupancy_on_card(cuda, name):
    """The two-step 2D body takes a few rows of shared memory (under 24 KB)
    and holds at least four blocks of 4 warps an SM, in every pair of sweep
    orders at every stencil order, float and bf16 stacks."""
    from gcm_tpu_torch.ops.fused import fused_step_2d_occupancy

    model, u, ms, dt = card_problem(0, name, (16, 64), cuda)
    for order in (1, 2, 3, 4):
        for stack in (ms, ms.to(torch.bfloat16)):
            for seq in seqs_2d(2):
                bps, smem = fused_step_2d_occupancy(
                    model, u, stack, dt, (1.0, 1.0), order, borders(2),
                    axes_seq=seq)
                assert bps >= 4 and 0 < smem < 24_576


@pytest.mark.gpu
def test_simplex_occupancy_on_card(cuda):
    """The simplex sweep keeps a node's components in registers within the
    budget of six 128-thread blocks an SM, and hands each block at least a
    node a thread: at 65^3 (274,625 nodes) every block of one wave."""
    from gcm_tpu_torch.ops.simplex import simplex_sweep_occupancy

    for case in SIMPLEX_CASES:
        grid, model, mat, tables, u = simplex_problem(0, *case, cuda)
        plan = build_simplex_plan(model, mat, tables, "free", cuda)
        for axis in range(case[1]):
            bps, nb = simplex_sweep_occupancy(plan, u, axis)
            assert bps >= 6 and nb >= 128


@pytest.mark.gpu
def test_kernels_refuse_a_model_without_a_compiled_map_on_card(cuda):
    """A model the kernels have no component map for (here elastic2d and
    elastic3d under other names) is refused by the two-step 2D launch and
    the simplex sweep, before any launch."""
    model, u, ms, dt = card_problem(0, "elastic2d", (16, 24), cuda)
    other = dataclasses.replace(model, name="elastic2d_other")
    before = fused_step_2d.launches
    with pytest.raises(ValueError, match="compiled for"):
        fused_step_2d(other, u, ms, dt, (1.0, 1.0), 2, borders(2),
                      axes_seq=((0, 1), (1, 0)))
    grid, model3, mat, tables, u3 = simplex_problem(0, *SIMPLEX_CASES[0],
                                                    cuda)
    other3 = dataclasses.replace(model3, name="elastic3d_other")
    plan = build_simplex_plan(other3, mat, tables, "free", cuda)
    sweeps = simplex_sweep.launches
    with pytest.raises(ValueError, match="compiled for"):
        simplex_sweep(plan, u3, 0)
    assert fused_step_2d.launches == before
    assert simplex_sweep.launches == sweeps


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(20, 19, 45), (67, 1, 45)])
@pytest.mark.parametrize("bf16", [False, True])
def test_folded_correctors_in_every_sweep_order_on_card(cuda, bf16, shape):
    """Maxwell + damage folded into the one-step body, a step in each of
    the six sweep orders, against the plain steps with the epilogue; the
    second shape divides by neither tile extent, spans many x chunks and
    has one row along y, thinner than the halo."""
    model, u, ms, dt = card_problem(4, "elastic3d", shape, cuda)
    for a in range(1, 4):   # a smooth state, off the damage knife-edges
        u = 0.25 * u.roll(1, a) + 0.5 * u + 0.25 * u.roll(-1, a)
    if bf16:
        ms = ms.to(torch.bfloat16)
    specs, _ = fold_corrector_specs(
        (MaxwellCorrector(tau=40 * dt),
         DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
    h = (10.0, 11.0, 9.0)
    got, gaux = u, torch.zeros((1,) + shape, device=cuda)
    want, waux = u, gaux
    for axes in itertools.permutations(range(3)):
        with profiling.recording() as rec:
            got, gaux = fused_step_slab(model, got, ms, dt, h, 2, BORDERS,
                                        axes, correctors=specs, aux=gaux)
        assert bodies(rec) == {"owned": 1}
        want, waux = fused_step_slab_reference(model, want, ms, dt, h, 2,
                                               BORDERS, axes,
                                               correctors=specs, aux=waux)
        torch.cuda.synchronize()
        assert norm_err(got, want) < 2e-6
        torch.testing.assert_close(gaux, waux, rtol=1e-5, atol=1e-6)
        want, waux = got, gaux    # held a step at a time
    assert gaux.max().item() > 1e-4


def aux_excess(got, want, rtol=1e-5, atol=1e-6):
    """The largest ``|got - want| / (atol + rtol |want|)``: at most 1 where
    ``torch.testing.assert_close(got, want, rtol=rtol, atol=atol)``
    passes."""
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("shape,smooth", [((37, 61), True), ((64, 128), True),
                                          ((37, 61), False),
                                          ((64, 128), False)])
def test_2d_folded_correctors_a_step_at_a_time_on_card(cuda, shape, smooth,
                                                       order, bf16):
    """Maxwell + damage folded into the row-streamed 2D body, on unaligned
    and aligned rows, both sweep orders in turn, held a step at a time,
    from a smooth state and from the random one. On 64 x 128 cells the
    random state's damage sits on its threshold's knife-edge in enough
    cells that the float32 plain version itself strays from its float64
    form by up to 1.55 x the aux tolerance in three steps
    (tools/torch_fold_drift.py). So that case is held to the float64 plain
    step, by the rule PERF.md section 2 states for a kernel on a path's
    own state: state and aux each within their limit (2e-6 normalized;
    rtol 1e-5, atol 1e-6), or within twice the float32 plain step's own
    distance from the float64 one."""
    model, u, ms, dt = card_problem(5, "elastic2d", shape, cuda)
    for a in range(1, 3) if smooth else ():   # off the damage knife-edges
        u = 0.25 * u.roll(1, a) + 0.5 * u + 0.25 * u.roll(-1, a)
    if bf16:
        ms = ms.to(torch.bfloat16)
    specs, _ = fold_corrector_specs(
        (MaxwellCorrector(tau=40 * dt),
         DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
    h = (10.0, 11.0)
    got, gaux = u, torch.zeros((1,) + shape, device=cuda)
    want, waux = u, gaux
    knife_edge = shape == (64, 128) and not smooth
    for n in range(3):
        axes = (0, 1) if n % 2 == 0 else (1, 0)
        held, held_aux = want, waux
        got, gaux = fused_step_2d(model, got, ms, dt, h, order, borders(2),
                                  axes, correctors=specs, aux=gaux)
        want, waux = fused_step_2d_reference(
            model, held, ms, dt, h, order, borders(2), axes,
            correctors=specs, aux=held_aux)
        torch.cuda.synchronize()
        if knife_edge:
            want64, waux64 = fused_step_2d_reference(
                model, held.double(), ms.double(), dt, h, order, borders(2),
                axes, correctors=specs, aux=held_aux.double())
            err, err32 = norm_err(got, want64), norm_err(want, want64)
            assert err < 2e-6 or err < 2 * err32, (n, err, err32)
            ex, ex32 = aux_excess(gaux, waux64), aux_excess(waux, waux64)
            assert ex <= 1 or ex < 2 * ex32, (n, ex, ex32)
        else:
            assert norm_err(got, want) < 2e-6
            torch.testing.assert_close(gaux, waux, rtol=1e-5, atol=1e-6)
        want, waux = got, gaux    # held a step at a time
    assert gaux.max().item() > 1e-4


@pytest.mark.gpu
def test_spmd_folded_correctors_on_card(cuda):
    from gcm_tpu_torch.parallel.fused_spmd import (
        extended_mstack, make_fused_spmd_step)
    from gcm_tpu_torch.parallel.sharding import gather_state, shard_state

    shape = (48, 48, 16)
    model, u, mat, dt = card_problem(0, "elastic3d", shape, cuda,
                                     with_mat=True)
    for a in range(1, 4):   # a smooth state, off the damage knife-edges
        u = 0.25 * u.roll(1, a) + 0.5 * u + 0.25 * u.roll(-1, a)
    specs, _ = fold_corrector_specs(
        (MaxwellCorrector(tau=40 * dt),
         DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
    h = (10.0, 10.0, 10.0)
    mesh = _card_mesh(cuda, 3, (2, 2))
    mext = extended_mstack(model, mat, mesh, 2)
    step = make_fused_spmd_step(model, mesh, dt, h, 2, BORDERS,
                                correctors=specs)
    got = shard_state(u, mesh)
    gaux = shard_state(torch.zeros((1,) + shape, device=cuda), mesh)
    want, waux = u, torch.zeros((1,) + shape, device=cuda)
    ms = stack_mats(model, mat)
    for n in range(3):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        got, gaux = step(got, mext, axes, aux=gaux)
        want, waux = fused_step_reference(model, want, ms, dt, h, 2, BORDERS,
                                          axes, specs, waux)
    torch.cuda.synchronize()
    gaux = gather_state(gaux, mesh)
    assert gaux.max().item() > 1e-4
    assert norm_err(gather_state(got, mesh), want) < 2e-6
    torch.testing.assert_close(gaux, waux, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,nsh", [((512, 70), 2), ((400, 61), 4),
                                       ((64, 40), 4), ((8, 132), 4),
                                       ((12, 61), 4)])
@pytest.mark.parametrize("name", ["elastic2d", "acoustic2d"])
@pytest.mark.parametrize("axes", [(0, 1), (1, 0)])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_spmd_2d_kernel_matches_plain_on_card(cuda, order, axes, name, shape,
                                              nsh):
    """Both launches on sx = 2 and 4, shards with an interior and shards
    too thin for one (nxl <= 2r): the interior launch writes exactly the
    rows [r, nxl - r) of a NaN buffer, the ring launch the others."""
    from gcm_tpu_torch.ops import fused_spmd as fs
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack, face_flags, make_fused_spmd_step_2d)
    from gcm_tpu_torch.parallel.sharding import gather_state, shard_state

    model, u, mat, dt = card_problem(order, name, shape, cuda, with_mat=True)
    h = (10.0, 12.0)
    r = fs.stencil_radius(order)
    mesh = _card_mesh(cuda, 2, (nsh,))
    mext = extended_mstack(model, mat, mesh, order)
    us = shard_state(u, mesh)
    slabs = exchange_slabs(us, mesh, r, dim=2)
    for k, uk in enumerate(us):
        args = (model, uk, mext[k], dt, h, order, borders(2), axes)
        flags = face_flags(mesh, k)[:2]
        before = (fs.fused_spmd_2d.launches, fs.fused_spmd_2d.ring_launches)
        got = fs.fused_spmd_2d(*args, "interior",
                               base=torch.full_like(uk, float("nan")))
        torch.cuda.synchronize()
        rows = torch.zeros(uk.shape[1], dtype=torch.bool, device=cuda)
        rows[r:uk.shape[1] - r] = uk.shape[1] > 2 * r
        assert torch.isnan(got[:, ~rows]).all()
        assert not torch.isnan(got[:, rows]).any()
        want = fs.fused_spmd_2d_reference(*args, "interior")
        assert norm_err(torch.nan_to_num(got), want) < 2e-6
        got = fs.fused_spmd_2d(*args, "ring", slabs[k], flags, got)
        torch.cuda.synchronize()
        assert (fs.fused_spmd_2d.launches - before[0],
                fs.fused_spmd_2d.ring_launches - before[1]) == (2, 1)
        assert not torch.isnan(got).any()
        assert norm_err(got, fs.fused_spmd_2d_reference(
            *args, "ring", slabs[k], flags, want)) < 2e-6
    step = make_fused_spmd_step_2d(model, mesh, dt, h, order, borders(2))
    want = fused_step_reference(model, u, stack_mats(model, mat), dt, h,
                                order, borders(2), axes)
    assert norm_err(gather_state(step(us, mext, axes), mesh), want) < 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused", "sweep", "torch"])
def test_sharded_engine_on_card(cuda, kernel):
    """Engine(mesh=) with four shards on one card: the kernels it launches,
    and the unsharded engine's result."""
    from gcm_tpu_torch.ops import fused_spmd as fs

    task = dataclasses.replace(get_scenario("elastic3d_explosion", n=64,
                                            nsteps=6), kernel=kernel)
    counters = (fs.fused_spmd_interior, fs.fused_spmd_ring, fused_step,
                sweep_stage)
    before = [f.launches for f in counters]
    got = Engine(task, mesh=_card_mesh(cuda, 3, (2, 2))).run()
    launched = [f.launches - b for f, b in zip(counters, before)]
    assert launched == {"fused": [24, 24, 0, 0], "sweep": [0, 0, 0, 72],
                        "torch": [0, 0, 0, 0]}[kernel]
    want = Engine(task, device=cuda).run()
    assert norm_err(torch.from_numpy(got.u), torch.from_numpy(want.u)) < 2e-6
    assert np.abs(got.traces - want.traces).max() <= \
        1e-5 * np.abs(want.traces).max()


@pytest.mark.gpu
def test_sharded_2d_engine_on_card(cuda):
    from gcm_tpu_torch.ops import fused_spmd as fs

    # 128-row shards: interior rows [r, 128 - r) and r ring rows at each
    # face, both launch
    task = get_scenario("elastic2d_viscoelastic", n=512, nsteps=5)
    before = (fs.fused_spmd_2d.launches, fs.fused_spmd_2d.ring_launches)
    got = Engine(task, mesh=_card_mesh(cuda, 2, (4,))).run()
    assert (fs.fused_spmd_2d.launches - before[0],
            fs.fused_spmd_2d.ring_launches - before[1]) == (40, 20)
    want = Engine(task, device=cuda).run()
    assert norm_err(torch.from_numpy(got.u), torch.from_numpy(want.u)) < 2e-6


@pytest.mark.gpu
def test_two_ranks_on_one_card_step_as_one_process(cuda, tmp_path):
    """Two gloo ranks on cuda:0, one row of a 2x2 mesh each (the x slabs
    pass between the ranks through host memory): two fused SPMD steps
    equal the same steps in one process bit for bit, and each rank
    launches the interior and ring kernels on its 2 shards a step."""
    from gcm_tpu_torch.parallel.sharding import domain_mesh
    from test_torch_multihost import _material, fused_card_steps, spawn

    shape = (48, 64, 8)
    rng, rho, lam, mu = _material(shape)
    u0 = rng.standard_normal((9,) + shape).astype(np.float32)
    u0[3:] *= 1e6
    d = dict(u0=u0, rho=rho, lam=lam, mu=mu,
             dt=0.6 / float(np.sqrt((lam + 2 * mu) / rho).max()))
    np.savez(tmp_path / "in.npz", **d)
    spawn(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "test_torch_multihost.py"), "card", tmp_path)
    want, launches = fused_card_steps(domain_mesh(3, [cuda] * 4, (2, 2)), d)
    assert launches == [8, 8]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npz")["u"], want)
    for rank in (0, 1):
        assert np.load(tmp_path / f"info_{rank}.npy").tolist() == [4, 4]


@pytest.fixture(scope="module")
def two_rank_contact_runs(tmp_path_factory):
    """tests/test_torch_multihost_contact.py::card_runs by two gloo ranks
    on cuda:0 (one row of the 2x2 mesh each), and in one process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from test_torch_multihost import spawn
    from test_torch_multihost_contact import card_runs

    d = tmp_path_factory.mktemp("two_rank_contact")
    spawn(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "test_torch_multihost_contact.py"), "card", d)
    got = [dict(np.load(d / f"card_{r}.npz")) for r in (0, 1)]
    return got, card_runs()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused", "sweep"])
def test_two_ranks_contact_on_one_card_as_one_process(two_rank_contact_runs,
                                                      kernel):
    """elastic3d_contact n=32 on 2x2 from a partly broken mask, two ranks on
    cuda:0: the bodies, bond masks and form equal the one-process run bit
    for bit, and each rank launches its own 2 shards' kernels a body and
    step (the SPMD ring kernel, or the sweep kernel 3 times), half of what
    one process launches. A 16x16x16 shard has no interior tile (every
    tile lies on the ring), so the interior kernel never launches here;
    chip_smoke.py phase 20 runs it on 128^3 shards."""
    from test_torch_multihost_contact import CARD_STEPS, card_mask

    got, want = two_rank_contact_runs
    n = CARD_STEPS[kernel]
    per_rank = [0, 4 * n, 0] if kernel == "fused" else [0, 0, 12 * n]
    assert want[f"{kernel}/launches"].tolist() == [2 * x for x in per_rank]
    assert str(want[f"{kernel}/path"]) == f"{kernel}_spmd"
    for run in got:
        assert run[f"{kernel}/launches"].tolist() == per_rank
        for key, w in want.items():
            if key.startswith(f"{kernel}/") and not key.endswith("launches"):
                np.testing.assert_array_equal(run[key], w, err_msg=key)
    mask, start = want[f"{kernel}/bonded_0_"], card_mask()
    assert (mask <= start).all() and mask.mean() < start.mean()


@pytest.mark.gpu
def test_two_ranks_contact_resume_on_one_card(two_rank_contact_runs):
    """The fused run cut at an odd step, its checkpoint written by rank 0
    and read by both ranks, ends equal to the uninterrupted one-process
    run, no broken cell healed."""
    got, want = two_rank_contact_runs
    for run in got:
        for key, w in want.items():
            if key.startswith("fused/") and not key.endswith("launches"):
                np.testing.assert_array_equal(run["resumed/" + key[6:]], w,
                                              err_msg=key)


@pytest.mark.gpu
def test_spmd_kernels_reject_what_they_do_not_take(cuda):
    from gcm_tpu_torch.ops import fused_spmd as fs
    from gcm_tpu_torch.parallel.fused_spmd import extended_mstack

    model, u, mat, dt = card_problem(0, "elastic3d", (32, 32, 8), cuda,
                                     with_mat=True)
    mext = extended_mstack(model, mat, _card_mesh(cuda, 3, (1, 1)), 2)[0]
    h = (1.0, 1.0, 1.0)
    with pytest.raises(TypeError):
        fs.fused_spmd_interior(model, u.double(), mext, dt, h, 2)
    with pytest.raises(ValueError):
        fs.fused_spmd_interior(model, u, mext[:, 1:-1], dt, h, 2)
    with pytest.raises(ValueError):
        fs.fused_spmd_interior(model, u, mext, dt, h, 5)
    with pytest.raises(ValueError):
        fs.fused_spmd_2d(model, u, mext, dt, h, 2, which="middle")


# ------------------------------------------------- the slab step (K steps)

SLAB_AXES = [(0, 1, 2), (2, 1, 0), (2, 0, 1), (1, 0, 2)]


def slab_seqs(ksteps, nx=2):
    """The sweep-order sequences of a pass: every order one at a time, or
    every pair of the six orders. On a single x plane (nx = 1)
    two steps take each order of SLAB_AXES and its reverse: there a first
    step ending with x and a second beginning with x apply both x borders
    to the one row twice in a row, which leaves a stress component zero up
    to round-off (sxz after (1, 2, 0) + (0, 2, 1)), and a normalized error
    on it would weigh the kernel's round-off against the plain version's."""
    if ksteps == 1:
        return [(ax,) for ax in AXES_3D]
    if nx == 1:
        return [(ax, ax[::-1]) for ax in SLAB_AXES]
    orders = list(itertools.permutations(range(3)))
    return list(itertools.product(orders, orders))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(24, 40, 56), (3, 5, 7), (9, 17, 2),
                                   (70, 19, 45), (1, 9, 33), (16, 32, 64)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ksteps", [1, 2])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_slab_kernel_matches_plain_on_card(cuda, order, ksteps, bf16, shape):
    """fused_step_slab against its plain version: one step in four sweep
    orders, two steps a pass in every pair of sweep orders (the two-step
    body's 36 instantiations a model and order), float32 and bf16 stacks,
    tile-multiple and ragged extents and extents thinner than the 2r halo;
    a K = 2 pass is held to 2e-6 a step."""
    model, u, ms, dt = card_problem(order + 10 * ksteps, "elastic3d", shape,
                                    cuda)
    if bf16:
        ms = ms.to(torch.bfloat16)
    h = (10.0, 12.0, 9.0)
    for seq in slab_seqs(ksteps, shape[0]):
        before = (fused_step_slab.launches, fused_step_slab.pair_launches)
        with profiling.recording() as rec:
            got = fused_step_slab(model, u, ms, dt, h, order, BORDERS,
                                  axes_seq=seq)
        torch.cuda.synchronize()
        assert (fused_step_slab.launches - before[0],
                fused_step_slab.pair_launches - before[1]) == (1, ksteps - 1)
        assert bodies(rec) == ({owned("elastic3d", order): 1} if ksteps == 1
                               else {})
        want = fused_step_slab_reference(model, u, ms, dt, h, order, BORDERS,
                                         axes_seq=seq)
        assert norm_err(got, want) < 2e-6 * ksteps


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_slab_kernel_folds_correctors_on_card(cuda, bf16):
    model, u, ms, dt = card_problem(3, "elastic3d", (12, 16, 24), cuda)
    if bf16:
        ms = ms.to(torch.bfloat16)
    specs, _ = fold_corrector_specs(
        (MaxwellCorrector(tau=40 * dt),
         DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
    h = (10.0, 11.0, 9.0)
    got, gaux = u, torch.zeros((1, 12, 16, 24), device=cuda)
    want, waux = u, gaux
    for n in range(3):
        axes = (2, 0, 1) if n % 2 == 0 else (1, 0, 2)
        got, gaux = fused_step_slab(model, got, ms, dt, h, 2, BORDERS, axes,
                                    correctors=specs, aux=gaux)
        want, waux = fused_step_slab_reference(model, want, ms, dt, h, 2,
                                               BORDERS, axes,
                                               correctors=specs, aux=waux)
    torch.cuda.synchronize()
    assert gaux.max().item() > 1e-4
    assert norm_err(got, want) < 2e-6
    torch.testing.assert_close(gaux, waux, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(37, 61), (5, 3), (64, 128), (3, 130),
                                   (4, 40)])
@pytest.mark.parametrize("name", ["elastic2d", "acoustic2d"])
@pytest.mark.parametrize("bf16,ksteps", [(True, 1), (False, 2), (True, 2)])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_2d_kernel_bf16_and_two_steps_on_card(cuda, order, bf16, ksteps,
                                              name, shape):
    model, u, ms, dt = card_problem(order, name, shape, cuda)
    if bf16:
        ms = ms.to(torch.bfloat16)
    h = (10.0, 12.0)
    for seq in seqs_2d(ksteps):
        before = fused_step_2d.launches
        got = fused_step_2d(model, u, ms, dt, h, order, borders(2),
                            axes_seq=seq)
        torch.cuda.synchronize()
        assert fused_step_2d.launches == before + 1
        want = fused_step_2d_reference(model, u, ms, dt, h, order,
                                       borders(2), axes_seq=seq)
        assert norm_err(got, want) < 2e-6 * ksteps


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_spmd_2d_kernel_takes_bf16_stacks_on_card(cuda, order):
    from gcm_tpu_torch.ops import fused_spmd as fs
    from gcm_tpu_torch.ops.interp import stencil_radius
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack_2d, face_flags)
    from gcm_tpu_torch.parallel.sharding import domain_mesh, shard_state

    model, u, mat, dt = card_problem(order, "elastic2d", (400, 61), cuda,
                                     with_mat=True)
    mesh = domain_mesh(2, [cuda] * 4)
    mext = extended_mstack_2d(model, mat, mesh, order, torch.bfloat16)
    assert all(m.dtype == torch.bfloat16 for m in mext)
    us = shard_state(u, mesh)
    slabs = exchange_slabs(us, mesh, stencil_radius(order), dim=2)
    for k, uk in enumerate(us):
        for which in ("interior", "ring"):
            args = (model, uk, mext[k], dt, (10.0, 12.0), order, borders(2),
                    (0, 1), which, slabs[k], face_flags(mesh, k)[:2])
            got = fs.fused_spmd_2d(*args, torch.zeros_like(uk))
            torch.cuda.synchronize()
            want = fs.fused_spmd_2d_reference(*args, torch.zeros_like(uk))
            assert norm_err(got, want) < 2e-6


@pytest.mark.gpu
def test_engine_knobs_take_the_slab_kernel_on_card(cuda):
    """temporal_block launches the two-step pass once a pair; canonical and
    bf16 bodies launch fused_step_slab."""
    task = dataclasses.replace(get_scenario("elastic3d_layered", n=32,
                                            nsteps=7), detectors=None)
    before = (fused_step_slab.launches, fused_step_slab.pair_launches,
              fused_step.launches)
    eng = Engine(dataclasses.replace(task, temporal_block=True), device=cuda)
    got = eng.run()
    assert eng._pair_fused
    # 3 two-step passes on the slab kernel, the odd tail step on fused_step
    assert (fused_step_slab.launches - before[0],
            fused_step_slab.pair_launches - before[1],
            fused_step.launches - before[2]) == (3, 3, 1)
    want = Engine(task, device=cuda).run()
    assert norm_err(torch.from_numpy(got.u), torch.from_numpy(want.u)) < 1e-5
    b16 = Engine(dataclasses.replace(task, mat_dtype="bf16"), device=cuda)
    assert b16._mstack.dtype == torch.bfloat16
    before = fused_step_slab.launches
    b16.run()
    assert fused_step_slab.launches == before + 7


@pytest.mark.gpu
def test_contact_engine_on_card(cuda):
    """The canonical contact path launches the slab kernel once per body and
    step, and agrees with the plain multi-body path in the same order. Both
    start from a common, partly broken bond mask, so the face-row fixups
    act on crack faces from the first step; at n=32 the interface goes into
    tension from step ~25 and breaks further by step 32."""
    from gcm_tpu_torch.convert import bonded_from_numpy
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.scenarios import elastic3d_contact

    nsteps = 32
    bodies, contacts = elastic3d_contact(n=32, nsteps=nsteps)
    mask = (np.random.default_rng(3).random((32, 32)) > 0.3).astype(
        np.float32)
    before = (fused_step_slab.launches, fused_step.launches)
    eng = MultiBodyEngine(bodies, contacts, device=cuda,
                          canonical_layout=True)
    eng.bonded = bonded_from_numpy({0: mask}, device=cuda)
    got = eng.run()
    assert got.path == "fused_canonical"
    assert (fused_step_slab.launches - before[0],
            fused_step.launches - before[1]) == (2 * nsteps, 0)
    plain = MultiBodyEngine({k: dataclasses.replace(t, kernel="torch")
                             for k, t in bodies.items()}, contacts,
                            device=cuda)
    plain._fwd = eng._fwd
    plain.bonded = bonded_from_numpy({0: mask}, device=cuda)
    want = plain.run()
    for k in got.bodies:
        assert norm_err(torch.from_numpy(got.bodies[k]),
                        torch.from_numpy(want.bodies[k])) < 1e-5
    np.testing.assert_array_equal(got.bonded[0], want.bonded[0])
    assert got.bonded[0].mean() < mask.mean()      # the interface broke


# ------------------------------------------------------- orthotropic stacks

def card_ortho_problem(seed, name, shape, device, with_mat=False):
    """Random heterogeneous orthotropic medium (the recipe of
    tests/test_fused_variants.py) and a random state on the card:
    (model, state, orthotropic stack or fields, dt)."""
    from gcm_tpu_torch.materials import OrthotropicMaterialFields

    rng = np.random.default_rng(seed)
    model = get_model(name)
    ones = np.ones(shape)
    rho = 2500.0 * (1.0 + 0.2 * rng.random(shape))
    c = {"c11": 60e9 * (1 + 0.1 * rng.random(shape)), "c22": 45e9 * ones,
         "c33": 70e9 * (1 + 0.1 * rng.random(shape)), "c12": 12e9 * ones,
         "c13": 10e9 * ones, "c23": 14e9 * ones, "c44": 18e9 * ones,
         "c55": 22e9 * (1 + 0.1 * rng.random(shape)), "c66": 16e9 * ones}
    mat = OrthotropicMaterialFields.from_constants(rho, c, device=device)
    u0 = rng.standard_normal((model.ncomp,) + shape)
    u0[model.dim:] *= 1e6
    u = torch.tensor(u0, dtype=torch.float32, device=device)
    dt = 0.5 * 9.0 / mat.max_cp()
    return model, u, (mat if with_mat else stack_mats(model, mat)), dt


def _f64(mat):
    return dataclasses.replace(mat, **{f.name: getattr(mat, f.name).double()
                                       for f in dataclasses.fields(mat)})


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(24, 40, 56), (64, 64, 32)])
@pytest.mark.parametrize("axes", AXES_3D)
@pytest.mark.parametrize("order", [1, 2, 3])
def test_ortho_kernel_matches_plain_on_card(cuda, order, axes, shape):
    """fused_step on an orthotropic stack (13 rows) against its plain
    version (2e-6), and against the float64 plain step on the fields (3e-6,
    the JAX limit: the stack's v = sqrt(c/rho) rounds in float32)."""
    from gcm_tpu_torch.solver.gcm import step

    model, u, mat, dt = card_ortho_problem(order, "elastic3d", shape, cuda,
                                           with_mat=True)
    ms = stack_mats(model, mat)
    assert ms.shape[0] == 13
    h = (10.0, 12.0, 9.0)
    before = fused_step.launches
    with profiling.recording() as rec:
        got = fused_step(model, u, ms, dt, h, order, BORDERS, axes)
    torch.cuda.synchronize()
    assert fused_step.launches == before + 1
    assert bodies(rec) == {"ring": 1}
    assert norm_err(got, fused_step_reference(model, u, ms, dt, h, order,
                                              BORDERS, axes)) < 2e-6
    exact = step(model, u.double(), _f64(mat), dt, h, order, BORDERS, axes)
    assert norm_err(got.double(), exact) < 3e-6


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(24, 40, 56), (9, 17, 2)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ksteps", [1, 2])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ortho_slab_kernel_matches_plain_on_card(cuda, order, ksteps, bf16,
                                                 shape):
    model, u, ms, dt = card_ortho_problem(order + 10 * ksteps, "elastic3d",
                                          shape, cuda)
    if bf16:
        ms = ms.to(torch.bfloat16)
    h = (10.0, 12.0, 9.0)
    for seq in slab_seqs(ksteps, shape[0]):
        before = fused_step_slab.launches
        with profiling.recording() as rec:
            got = fused_step_slab(model, u, ms, dt, h, order, BORDERS,
                                  axes_seq=seq)
        torch.cuda.synchronize()
        assert fused_step_slab.launches == before + 1
        assert bodies(rec) == ({"ring": 1} if ksteps == 1 else {})
        want = fused_step_slab_reference(model, u, ms, dt, h, order, BORDERS,
                                         axes_seq=seq)
        assert norm_err(got, want) < 2e-6 * ksteps


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(37, 61), (3, 130)])
@pytest.mark.parametrize("bf16,ksteps", [(False, 1), (True, 1), (False, 2),
                                         (True, 2)])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ortho_2d_kernel_matches_plain_on_card(cuda, order, bf16, ksteps,
                                               shape):
    from gcm_tpu_torch.solver.gcm import step

    model, u, mat, dt = card_ortho_problem(order, "elastic2d", shape, cuda,
                                           with_mat=True)
    ms = stack_mats(model, mat)
    assert ms.shape[0] == 6
    if bf16:
        ms = ms.to(torch.bfloat16)
    h = (10.0, 12.0)
    for seq in seqs_2d(ksteps):
        before = fused_step_2d.launches
        got = fused_step_2d(model, u, ms, dt, h, order, borders(2),
                            axes_seq=seq)
        torch.cuda.synchronize()
        assert fused_step_2d.launches == before + 1
        want = fused_step_2d_reference(model, u, ms, dt, h, order,
                                       borders(2), axes_seq=seq)
        assert norm_err(got, want) < 2e-6 * ksteps
        if not bf16 and ksteps == 1:
            exact = step(model, u.double(), _f64(mat), dt, h, order,
                         borders(2), seq[0])
            assert norm_err(got.double(), exact) < 3e-6


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [("elastic3d", (24, 40, 56)),
                                        ("elastic3d", (9, 17, 2)),
                                        ("elastic3d", (1, 3, 130)),
                                        ("elastic2d", (37, 61)),
                                        ("elastic2d", (130, 2))])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ortho_sweep_kernel_matches_plain_on_card(cuda, order, name, shape):
    model, u, mat, dt = card_ortho_problem(order, name, shape, cuda,
                                           with_mat=True)
    h = (10.0, 12.0, 9.0)[:model.dim]
    for axis in range(model.dim):
        before = sweep_stage.launches
        got = sweep_stage(model, u, mat, dt, h, axis, order,
                          borders(model.dim))
        torch.cuda.synchronize()
        assert sweep_stage.launches == before + 1
        want = stage(model, u, mat, dt, h, axis, order, borders(model.dim))
        assert norm_err(got, want) < 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("order,axes", [(1, (0, 1, 2)), (2, (2, 1, 0)),
                                        (3, (0, 1, 2))])
def test_ortho_spmd_kernels_match_plain_on_card(cuda, order, axes):
    """The interior and ring kernels on orthotropic extended stacks, 2x2
    shards on one card, and the sharded step against the unsharded one."""
    from gcm_tpu_torch.ops import fused_spmd as fs
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack, face_flags, make_fused_spmd_step)
    from gcm_tpu_torch.parallel.sharding import gather_state, shard_state

    model, u, mat, dt = card_ortho_problem(order, "elastic3d", (50, 38, 20),
                                           cuda, with_mat=True)
    h = (10.0, 12.0, 9.0)
    mesh = _card_mesh(cuda, 3, (2, 2))
    mext = extended_mstack(model, mat, mesh, order)
    assert all(m.shape[0] == 13 for m in mext)
    us = shard_state(u, mesh)
    slabs = exchange_slabs(us, mesh, fs.stencil_radius(order))
    for k, uk in enumerate(us):
        args = (model, uk, mext[k], dt, h, order, BORDERS, axes)
        with profiling.recording() as rec:
            got = fs.fused_spmd_interior(*args, out=torch.zeros_like(uk))
            ring = fs.fused_spmd_ring(model, uk, mext[k], slabs[k],
                                      face_flags(mesh, k),
                                      torch.zeros_like(uk), *args[3:])
        torch.cuda.synchronize()
        assert bodies(rec) == {"ring": 2}
        assert norm_err(got, fs.fused_spmd_interior_reference(
            *args, out=torch.zeros_like(uk))) < 2e-6
        assert norm_err(ring, fs.fused_spmd_ring_reference(
            model, uk, mext[k], slabs[k], face_flags(mesh, k),
            torch.zeros_like(uk), *args[3:])) < 2e-6
    step = make_fused_spmd_step(model, mesh, dt, h, order, BORDERS)
    want = fused_step_reference(model, u, stack_mats(model, mat), dt, h,
                                order, BORDERS, axes)
    assert norm_err(gather_state(step(us, mext, axes), mesh), want) < 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ortho_spmd_2d_kernel_matches_plain_on_card(cuda, order, bf16):
    from gcm_tpu_torch.ops import fused_spmd as fs
    from gcm_tpu_torch.parallel.fused_spmd import (
        exchange_slabs, extended_mstack_2d, face_flags)
    from gcm_tpu_torch.parallel.sharding import shard_state

    model, u, mat, dt = card_ortho_problem(order, "elastic2d", (512, 70),
                                           cuda, with_mat=True)
    mesh = _card_mesh(cuda, 2, (2,))
    mext = extended_mstack_2d(model, mat, mesh, order,
                              torch.bfloat16 if bf16 else None)
    assert all(m.shape[0] == 6 for m in mext)
    us = shard_state(u, mesh)
    slabs = exchange_slabs(us, mesh, fs.stencil_radius(order), dim=2)
    for k, uk in enumerate(us):
        for which in ("interior", "ring"):
            args = (model, uk, mext[k], dt, (10.0, 12.0), order, borders(2),
                    (0, 1), which, slabs[k], face_flags(mesh, k)[:2])
            got = fs.fused_spmd_2d(*args, torch.zeros_like(uk))
            torch.cuda.synchronize()
            assert norm_err(got, fs.fused_spmd_2d_reference(
                *args, torch.zeros_like(uk))) < 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused", "sweep"])
def test_ortho_engine_takes_the_kernels_on_card(cuda, kernel):
    """An orthotropic elastic3d_explosion: the fused path launches
    fused_step once a step, the per-sweep path sweep_stage three times;
    both agree with the plain path."""
    from gcm_tpu_torch.materials import OrthotropicMaterial

    def ortho(m):
        c33 = m.lam + 2.0 * m.mu
        return OrthotropicMaterial(
            rho=m.rho, c11=1.3 * c33, c12=m.lam, c13=m.lam, c22=1.1 * c33,
            c23=m.lam, c33=c33, c44=m.mu, c55=1.15 * m.mu, c66=1.3 * m.mu)

    task = get_scenario("elastic3d_explosion", n=32, nsteps=7)
    task = dataclasses.replace(
        task, kernel=kernel, default_material=ortho(task.default_material),
        materials=tuple(dataclasses.replace(r, material=ortho(r.material))
                        for r in task.materials))
    counters = (fused_step, fused_step_slab, sweep_stage)
    before = [f.launches for f in counters]
    got = Engine(task, device=cuda).run()
    launched = [f.launches - b for f, b in zip(counters, before)]
    assert launched == {"fused": [7, 0, 0], "sweep": [0, 0, 21]}[kernel]
    want = Engine(dataclasses.replace(task, kernel="torch"), device=cuda).run()
    assert norm_err(torch.from_numpy(got.u), torch.from_numpy(want.u)) < 1e-5


# ------------------------------------------------------- outputs and resume

def _resumed_on_card(build, cut, tmp_path):
    """``build()`` run to ``cut``, checkpointed, restored into a fresh
    engine and run to the end: (that engine, its result, the cut state)."""
    from gcm_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    part = build()
    part.nsteps = cut
    part.run()
    save_checkpoint(str(tmp_path), cut, part.state_dict())
    state = restore_checkpoint(str(tmp_path), step=cut)
    eng = build()
    eng.load_state(state)
    return eng, eng.run(), state


@pytest.mark.gpu
@pytest.mark.parametrize("cut", [5, 6])
def test_fused_engine_resumes_exactly_on_card(cuda, tmp_path, cut):
    """kernel="fused" with a source and receivers: the resumed run launches
    the kernel once a step from the cut and equals the uninterrupted one,
    state and traces (the same launches in the same order)."""
    task = get_scenario("elastic3d_explosion", n=32, nsteps=12)
    full = Engine(task, device=cuda)
    want = full.run()
    before = fused_step.launches
    eng, got, _ = _resumed_on_card(lambda: Engine(task, device=cuda), cut,
                                   tmp_path)
    assert fused_step.launches - before == 12
    assert got.kernel == "fused" and eng.start_step == cut
    assert torch.equal(eng.u, full.u)
    np.testing.assert_array_equal(got.traces, want.traces)


@pytest.mark.gpu
def test_pair_fused_engine_resumes_on_card(cuda, tmp_path):
    """temporal_block from an odd cut: one single step, then two-step
    passes; equal to the same run continued without the checkpoint, and to
    the uninterrupted run, which takes the two steps around the cut in one
    pass."""
    task = dataclasses.replace(
        get_scenario("elastic3d_layered", n=32, nsteps=10),
        detectors=None, temporal_block=True)
    from gcm_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    full = Engine(task, device=cuda)
    full.run()
    part = Engine(task, device=cuda)
    part.nsteps = 5
    part.run()
    save_checkpoint(str(tmp_path), 5, part.state_dict())
    eng = Engine(task, device=cuda)
    eng.load_state(restore_checkpoint(str(tmp_path)))
    assert eng._pair_fused
    before = (fused_step.launches, fused_step_slab.pair_launches)
    eng.run()
    assert (fused_step.launches - before[0],
            fused_step_slab.pair_launches - before[1]) == (1, 2)
    part.start_step, part.nsteps = 5, 10
    part.run()
    assert torch.equal(eng.u, part.u)
    assert torch.equal(eng.u, full.u)
    assert full.u.abs().max().item() > 0


@pytest.mark.gpu
def test_contact_engine_resumes_exactly_on_card(cuda, tmp_path):
    """The canonical contact path from a partly broken bond mask, cut at an
    odd step: bodies, masks and traces equal the uninterrupted run, and no
    restored broken cell heals."""
    from gcm_tpu_torch.convert import bonded_from_numpy
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.scenarios import elastic3d_contact

    bodies, contacts = elastic3d_contact(n=32, nsteps=32)
    mask = (np.random.default_rng(3).random((32, 32)) > 0.3).astype(
        np.float32)

    def build():
        e = MultiBodyEngine(bodies, contacts, device=cuda,
                            canonical_layout=True)
        e.bonded = bonded_from_numpy({0: mask}, device=cuda)
        return e

    want = build().run()
    eng, got, state = _resumed_on_card(build, 17, tmp_path)
    assert got.path == "fused_canonical"
    for k in want.bodies:
        np.testing.assert_array_equal(got.bodies[k], want.bodies[k])
    np.testing.assert_array_equal(got.bonded[0], want.bonded[0])
    at_cut = state["bonded"]["0"]
    assert (got.bonded[0][at_cut == 0] == 0).all()
    assert got.bonded[0].mean() < at_cut.mean()


@pytest.mark.gpu
def test_run_with_outputs_on_card(cuda, tmp_path):
    """Snapshots every 6 and checkpoints every 4 steps: the state leaves the
    card at 4, 6, 8 and 12 only, the files are written, and the run equals
    run() without outputs."""
    import os

    from gcm_tpu_torch.task import SnapshotSpec

    task = dataclasses.replace(
        get_scenario("elastic3d_explosion", n=32, nsteps=12),
        snapshots=SnapshotSpec(every=6))
    want = Engine(task, device=cuda).run()
    eng = Engine(task, device=cuda)
    got = eng.run_with_outputs(str(tmp_path), checkpoint_every=4)
    assert eng.host_copies == [4, 6, 8, 12]
    np.testing.assert_array_equal(got.u, want.u)
    np.testing.assert_array_equal(got.traces, want.traces)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "step_12.npz", "step_4.npz", "step_8.npz"]
    assert sorted(os.listdir(tmp_path / "snapshots")) == [
        "elastic3d_explosion.pvd", "elastic3d_explosion_000006.vti",
        "elastic3d_explosion_000012.vti"]
    assert (tmp_path / "elastic3d_explosion.npz").exists()


# ------------------------------------------------- multi-body on a mesh

def _mesh_contact_engine(cuda, mesh_name, kernel="auto", canon=True,
                         nsteps=32):
    """elastic3d_contact at n=32 from a partly broken bond mask on a mesh
    whose 4 shards all lie on the card (``mesh_name`` "2x2" or the one-axis
    "sx4"), or unsharded (None)."""
    from gcm_tpu_torch.convert import bonded_from_numpy
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.parallel.sharding import DomainMesh, domain_mesh
    from gcm_tpu_torch.scenarios import elastic3d_contact

    bodies, contacts = elastic3d_contact(n=32, nsteps=nsteps)
    bodies = {k: dataclasses.replace(t, kernel=kernel)
              for k, t in bodies.items()}
    mesh = {None: None,
            "2x2": domain_mesh(3, [cuda] * 4, (2, 2)),
            "sx4": DomainMesh((cuda,) * 4, (4,), ("sx",))}[mesh_name]
    eng = MultiBodyEngine(bodies, contacts, device=None if mesh else cuda,
                          mesh=mesh, canonical_layout=canon)
    mask = (np.random.default_rng(3).random((32, 32)) > 0.3).astype(
        np.float32)
    eng.bonded = bonded_from_numpy({0: mask}, device=cuda)
    return eng, mask


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_name,kernel,canon,path", [
    ("2x2", "auto", True, "fused_spmd"),
    ("sx4", "auto", True, "fused_canonical_spmd"),
    ("2x2", "sweep", False, "sweep_spmd")])
def test_contact_mesh_paths_on_card(cuda, mesh_name, kernel, canon, path):
    """MultiBodyEngine on 4 shards of the card: each form launches its
    kernels on every shard of both bodies a step (the SPMD ring kernel 8
    times, and the interior one as often where a shard has interior tiles:
    the 2x2 shards of 16 x 16 rows are all ring; or the sweep kernel 24
    times) and no unsharded kernel, and agrees with the unsharded path in
    the same order (under 2e-6, bond masks equal) as the interface breaks
    further."""
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_interior, fused_spmd_ring, split_3d)
    from gcm_tpu_torch.ops.interp import stencil_radius

    counters = (fused_spmd_interior, fused_spmd_ring, sweep_stage,
                fused_step, fused_step_slab)
    eng, mask = _mesh_contact_engine(cuda, mesh_name, kernel, canon)
    assert eng.path == path
    before = [f.launches for f in counters]
    got = eng.run()
    launched = [f.launches - b for f, b in zip(counters, before)]
    n = eng.nsteps
    _, nxl, nyl, _ = eng.us["upper"][0].shape
    inner = split_3d(nxl, nyl, stencil_radius(eng.order))[3] > 0
    assert inner == (mesh_name == "sx4")
    assert launched == ([0, 0, 24 * n, 0, 0] if kernel == "sweep"
                        else [8 * n * inner, 8 * n, 0, 0, 0])
    ref, _ = _mesh_contact_engine(cuda, None, kernel, eng.canonical)
    assert ref._fwd == eng._fwd
    want = ref.run()
    for k in want.bodies:
        assert norm_err(torch.from_numpy(got.bodies[k]),
                        torch.from_numpy(want.bodies[k])) < 2e-6
    np.testing.assert_array_equal(got.bonded[0], want.bonded[0])
    assert got.bonded[0].mean() < mask.mean()      # the interface broke


@pytest.mark.gpu
def test_contact_on_a_y_mesh_takes_the_sweep_kernel_on_card(cuda):
    """A y contact on a ('sy',) mesh of 4 shards of the card with
    kernel="fused": the mesh splits the contact axis, so the per-sweep halo
    stage runs, and it launches the sweep kernel 24 times a step (3 axes x
    2 bodies x 4 shards), no plain sweep, and ends within 2e-6 of the
    unsharded per-sweep path, bond masks equal."""
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.parallel.sharding import DomainMesh
    from gcm_tpu_torch.scenarios import elastic3d_contact

    bodies, contacts = elastic3d_contact(n=32, nsteps=16)
    contacts = tuple(dataclasses.replace(c, axis=1) for c in contacts)

    def build(kernel, mesh):
        b = {k: dataclasses.replace(t, kernel=kernel)
             for k, t in bodies.items()}
        return MultiBodyEngine(b, contacts, device=None if mesh else cuda,
                               mesh=mesh)

    eng = build("fused", DomainMesh((cuda,) * 4, (4,), ("sy",)))
    assert eng.path == "sweep_spmd"
    before = sweep_stage.launches
    got = eng.run()
    assert sweep_stage.launches - before == 24 * eng.nsteps
    ref = build("sweep", None)
    assert ref.path == "sweep"
    want = ref.run()
    for k in want.bodies:
        assert norm_err(torch.from_numpy(got.bodies[k]),
                        torch.from_numpy(want.bodies[k])) < 2e-6
    np.testing.assert_array_equal(got.bonded[0], want.bonded[0])


@pytest.mark.gpu
def test_contact_mesh_resumes_exactly_on_card(cuda, tmp_path):
    """The 2x2 fused SPMD contact path cut at an odd step through a
    checkpoint equals the uninterrupted run; no restored broken cell heals;
    an unsharded engine's checkpoint resumes on the mesh."""
    def build():
        return _mesh_contact_engine(cuda, "2x2")[0]

    want = build().run()
    eng, got, state = _resumed_on_card(build, 17, tmp_path / "a")
    assert got.path == "fused_spmd"
    for k in want.bodies:
        np.testing.assert_array_equal(got.bodies[k], want.bodies[k])
    np.testing.assert_array_equal(got.bonded[0], want.bonded[0])
    at_cut = state["bonded"]["0"]
    assert (got.bonded[0][at_cut == 0] == 0).all()
    assert got.bonded[0].mean() < at_cut.mean()

    def unsharded():
        return _mesh_contact_engine(cuda, None, canon=False)[0]

    part = unsharded()
    part.nsteps = 17
    part.run()
    eng = build()
    eng.load_state(part.state_dict())
    got = eng.run()
    whole = unsharded().run()
    for k in whole.bodies:
        assert norm_err(torch.from_numpy(got.bodies[k]),
                        torch.from_numpy(whole.bodies[k])) < 2e-6
    np.testing.assert_array_equal(got.bonded[0], whole.bonded[0])


@pytest.mark.gpu
def test_bench_fused_path_on_card(cuda):
    """``bench.main`` with ``only="fused"`` at 64x64x32: the one-path line,
    a finite positive rate on this card, one ``fused_step`` launch a step
    of the warm-up and the three timed calls."""
    import json

    from gcm_tpu_torch import bench

    lines = []
    fused_step.launches = 0
    line = bench.main((64, 64, 32), "fused", out=lines.append)
    assert fused_step.launches == (1 + bench.REPS) * bench.K_STEPS
    assert json.loads(lines[-1]) == line
    assert (line["path"], line["shape"]) == ("fused", [64, 64, 32])
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["device"].startswith(torch.cuda.get_device_name(0))


@pytest.mark.gpu
def test_bench_every_path_on_card(cuda):
    """``bench.main`` with every path at small sizes (flagship 64x64x32,
    unit boxes 9^3 and 13^3, ``elastic3d_contact(n=32)``, simplex contact
    bodies of 7 and 7 x 13 x 13 nodes): every rate finite and positive, the
    kernel forms held to their plain twins inside ``main``, and each kernel
    launched as the bench's step counts say."""
    import json
    import re

    from gcm_tpu_torch import bench

    calls = 1 + bench.REPS
    kernels = (fused_step, fused_step_slab, sweep_stage, simplex_sweep)
    for k in kernels:
        k.launches = 0
    lines = []
    line = bench.main((64, 64, 32), "best", simplex_sizes=(9, 13),
                      contact_n=32, simplex_contact_size=(13, 7),
                      out=lines.append)
    assert [k.launches for k in kernels] == [
        calls * (bench.K_STEPS + 2 * bench.K_PAIRS),
        2 * calls * 2 * bench.K_PAIRS, 3 * calls * bench.K_STEPS,
        calls * bench.K_PAIRS * (6 * 2 + 12)]
    assert json.loads(lines[-1]) == line
    assert lines[-2].startswith("kernel forms against their plain twins")
    rates = [v for k, v in line.items()
             if k == "value" or "points_per_s" in k]
    assert len(rates) == 9
    assert all(np.isfinite(v) and v > 0 for v in rates)
    assert line["shape"] == [64, 64, 32]
    assert line["contact_path"] == "fused_canonical"
    assert re.fullmatch(re.escape(torch.cuda.get_device_name(0))
                        + r", \d+(\.\d+)? W", line["device"])


# ------------------------------------------ one process, several cards

@pytest.fixture
def cards():
    """The visible cards, at most four; skips with fewer than two."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    return [torch.device("cuda", i) for i in range(min(n, 4))]


def _on_cards(cards, n):
    """n shard devices over ``cards``, one card after another."""
    return [cards[i % len(cards)] for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused_step", "sweep_stage",
                                    "fused_step_2d", "fused_spmd"])
def test_multicard_launch_leaves_the_current_device(cards, kernel):
    """A kernel launched on the last card's tensors runs there and leaves
    cuda:0 the current device: work that names no device stays on cuda:0
    (the entry points restore the device they found)."""
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_interior, fused_spmd_interior_reference)

    dev = cards[-1]
    dim = 2 if kernel == "fused_step_2d" else 3
    name = f"elastic{dim}d"
    shape = (40, 48) if dim == 2 else (16, 24, 40)
    model, u, mat, dt = card_problem(5, name, shape, dev, with_mat=True)
    ms = stack_mats(model, mat)
    h = (10.0,) * dim
    bc = borders(dim)
    torch.cuda.set_device(0)
    if kernel == "fused_step":
        got = fused_step(model, u, ms, dt, h, 2, bc, (0, 1, 2))
        want = fused_step_reference(model, u, ms, dt, h, 2, bc, (0, 1, 2))
    elif kernel == "fused_step_2d":
        got = fused_step_2d(model, u, ms, dt, h, 2, bc, (0, 1))
        want = fused_step_2d_reference(model, u, ms, dt, h, 2, bc, (0, 1))
    elif kernel == "sweep_stage":
        got = sweep_stage(model, u, mat, dt, h, 1, 2, bc)
        want = stage(model, u, mat, dt, h, 1, 2, bc)
    else:
        from gcm_tpu_torch.parallel.fused_spmd import extended_mstack
        from gcm_tpu_torch.parallel.sharding import domain_mesh

        mext = extended_mstack(model, mat, domain_mesh(3, [dev], (1, 1)), 2)[0]
        got = fused_spmd_interior(model, u, mext, dt, h, 2, bc, (0, 1, 2),
                                  out=torch.zeros_like(u))
        want = fused_spmd_interior_reference(model, u, mext, dt, h, 2, bc,
                                             (0, 1, 2),
                                             out=torch.zeros_like(u))
    assert torch.cuda.current_device() == 0
    assert got.device == dev and torch.empty(1, device="cuda").device == \
        torch.device("cuda", 0)
    torch.cuda.synchronize(dev)
    assert norm_err(got, want) < 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,dim,shape", [
    ("fused", 3, (2, 2)), ("sweep", 3, (2, 2)), ("fused", 2, (4,))])
def test_multicard_engine_equals_its_co_resident_run(cards, kernel, dim,
                                                     shape):
    """Engine(mesh=) with its shards spread over the cards equals, bit for
    bit, the same mesh with every shard on cuda:0: the same launches on
    the same bytes (state and traces)."""
    from gcm_tpu_torch.parallel.sharding import domain_mesh

    task = (get_scenario("elastic3d_explosion", n=64, nsteps=8) if dim == 3
            else get_scenario("elastic2d_viscoelastic", n=256, nsteps=8))
    task = dataclasses.replace(task, kernel=kernel)
    got = Engine(task, mesh=domain_mesh(dim, _on_cards(cards, 4),
                                        shape)).run()
    want = Engine(task, mesh=domain_mesh(
        dim, [torch.device("cuda", 0)] * 4, shape)).run()
    np.testing.assert_array_equal(got.u, want.u)
    np.testing.assert_array_equal(got.traces, want.traces)
    assert np.abs(got.u).max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_name,kernel", [
    ("2x2", "auto"), ("sx4", "auto"), ("2x2", "sweep")])
def test_multicard_contact_equals_its_co_resident_run(cards, mesh_name,
                                                      kernel):
    """MultiBodyEngine with its shards spread over the cards (the contact
    faces put together on cuda:0) equals the same mesh on cuda:0 bit for
    bit, bond masks included, as the interface breaks further."""
    from gcm_tpu_torch.convert import bonded_from_numpy
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.parallel.sharding import DomainMesh, domain_mesh
    from gcm_tpu_torch.scenarios import elastic3d_contact

    bodies, contacts = elastic3d_contact(n=32, nsteps=32)
    bodies = {k: dataclasses.replace(t, kernel=kernel)
              for k, t in bodies.items()}
    mask = (np.random.default_rng(3).random((32, 32)) > 0.3).astype(
        np.float32)
    runs = []
    for devs in (_on_cards(cards, 4), [torch.device("cuda", 0)] * 4):
        mesh = (domain_mesh(3, devs, (2, 2)) if mesh_name == "2x2"
                else DomainMesh(tuple(devs), (4,), ("sx",)))
        eng = MultiBodyEngine(bodies, contacts, mesh=mesh,
                              canonical_layout=True)
        eng.bonded = bonded_from_numpy({0: mask}, device=eng.device)
        runs.append(eng.run())
    got, want = runs
    for k in want.bodies:
        np.testing.assert_array_equal(got.bodies[k], want.bodies[k])
    np.testing.assert_array_equal(got.bonded[0], want.bonded[0])
    assert got.bonded[0].mean() < mask.mean()
