"""The port's simplex path against the JAX package's.

Inputs are made from a seeded numpy generator and handed to both packages
as numpy arrays; JAX runs on the CPU with x64 (tests/conftest.py).

- Meshes: ``box``, ``box_minus`` with a hole and ``from_cells`` give the
  JAX package's points, cells and node numbering.
- Foot tables: the port's equal JAX's ``build_foot_tables`` (orders 1 and
  2, 2D and 3D) as interpolation operators (ids with weights, to 1e-12),
  except at the feet where JAX's C++ walk says "outside" and scipy finds a
  cell: there the reference walk cycled to its step limit
  (``gcm_native.cpp``), a fault of the reference that the port's bounded
  walk does not share. The tests count those feet (a handful at most).
- ``solver.simplex_gcm.simplex_stage`` (float64) equals JAX's to 1e-12
  normalized, for the four uniform border kinds, per-node borders, a fluid,
  2D and order 2; ``ops.simplex.simplex_sweep_reference`` equals JAX's
  ``fused_simplex_step`` run in interpret mode (float64, 1e-12).
- ``SimplexEngine`` equals JAX's ``SimplexEngine`` on ``simplex3d_layered``
  and ``simplex2d_canyon_layered`` at small n: final state and detector
  traces to 1e-9 in float64 and 1e-5 normalized in float32, on meshes where
  the two locators agree (asserted).
"""

import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.spatial import cKDTree

import gcm_tpu.ops.pallas_simplex as psx
from gcm_tpu import native
from gcm_tpu import task as jtask
from gcm_tpu.grids import simplex as jsimplex
from gcm_tpu.materials import MaterialFields as JMaterialFields
from gcm_tpu.models.spec import get_model as jget_model
from gcm_tpu.solver import simplex_gcm as jsgcm
from gcm_tpu_torch import task as ttask
from gcm_tpu_torch.convert import (
    MATERIAL_LEAVES, foot_tables_from_numpy, material_fields_from_numpy,
    node_borders_from_numpy,
)
from gcm_tpu_torch.engine_simplex import SimplexEngine, resolve_simplex_kernel
from gcm_tpu_torch.grids import simplex as tsimplex
from gcm_tpu_torch.grids.locate import MAX_STEPS, walk_locate
from gcm_tpu_torch.materials import (
    IsotropicMaterial, OrthotropicMaterial, OrthotropicMaterialFields,
)
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops import fused as ofu
from gcm_tpu_torch.ops import simplex as osx
from gcm_tpu_torch.ops.simplex import (
    build_simplex_plan, simplex_step, simplex_sweep,
    simplex_sweep_reference,
)
from gcm_tpu_torch.scenarios import get_scenario
from gcm_tpu_torch.solver.simplex_gcm import build_node_borders, simplex_stage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (n, dim, model, order, fluid): jittered n^dim box meshes
MESHES = {
    "3d": (8, 3, "elastic3d", 1, False),
    "3d-order2": (8, 3, "elastic3d", 2, False),
    "3d-fluid": (8, 3, "elastic3d", 1, True),
    "2d": (12, 2, "elastic2d", 1, False),
    "2d-order2": (12, 2, "elastic2d", 2, False),
}
#: border cases: (mesh, border) with border a uniform kind or "node"
STAGE_CASES = [("3d", "absorbing"), ("3d", "free"), ("3d", "fixed_force"),
               ("3d", "fixed_velocity"), ("3d", "node"),
               ("3d-fluid", "absorbing"), ("2d", "free"),
               ("3d-order2", "free")]
#: the cases held to JAX's fused kernel in interpret mode (per-node borders
#: hold all four kinds at once); its cost is the interpreter's
FUSED_CASES = [("3d", "node"), ("3d-fluid", "absorbing"), ("2d", "free"),
               ("2d-order2", "node")]


@pytest.fixture(scope="module", autouse=True)
def private_native_library(tmp_path_factory):
    """JAX's native library (its C++ point locator), built by the package's
    own ``native._build`` into a path of this test process's own for the
    module's tests. The package builds ``libgcm_native.so`` in place,
    guarded by a thread lock only: test processes of a fresh checkout build
    it at once, and one that loads a half-written file loses the library
    for the rest of its life (``available()`` False, the walk's parity
    cases then fail). The other port simplex test modules use this fixture
    too."""
    saved = native._SO, native._lib, native._build_failed
    native._SO = str(tmp_path_factory.mktemp("native") / "libgcm_native.so")
    native._lib, native._build_failed = None, False
    yield
    native._SO, native._lib, native._build_failed = saved


def norm_err(got, want):
    """Per-component max error over the component's max magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    c = want.shape[0]
    scale = np.abs(want).reshape(c, -1).max(1) + 1e-30
    return float((np.abs(got - want).reshape(c, -1).max(1) / scale).max())


def mesh_problem(mesh, seed=0):
    """A random heterogeneous medium on a jittered box, with both packages'
    grids, materials (float64) and JAX's foot tables."""
    n, dim, name, order, fluid = MESHES[mesh]
    rng = np.random.default_rng(seed)
    jgrid = jsimplex.SimplexGrid.box((0.0,) * dim, (1.0,) * dim, (n,) * dim,
                                     jitter=0.1)
    N = jgrid.npoints
    rho = 2500.0 * (1.0 + 0.2 * rng.random(N))
    mu = np.zeros(N) if fluid else 1e9 * (0.5 + rng.random(N))
    lam = 1e9 * (1.0 + rng.random(N))
    jmat = JMaterialFields.from_arrays(rho, lam, mu, xp=jnp,
                                       dtype=jnp.float64)
    tmat = material_fields_from_numpy(
        {k: np.asarray(getattr(jmat, k)) for k in MATERIAL_LEAVES},
        dtype=torch.float64)
    d, _ = cKDTree(jgrid.points).query(jgrid.points, k=2)
    dt = 0.7 * float(d[:, 1].min()) / float(np.asarray(jmat.cp).max())
    waves = {"p": np.asarray(jmat.cp)}
    if not fluid:
        waves["s"] = np.asarray(jmat.cs)
    jtables = jsimplex.build_foot_tables(jgrid, waves, dt, order=order)
    u0 = rng.standard_normal((jget_model(name).ncomp, N))
    u0[dim:] *= 1e6
    return dict(jgrid=jgrid, jmat=jmat, tmat=tmat, jtables=jtables,
                ttables=foot_tables_from_numpy(jtables), u0=u0, dt=dt,
                waves=waves, model=name, dim=dim, order=order)


def borders_pair(border, jgrid, dim):
    """The same border condition for both packages: (JAX, port)."""
    if border == "node":
        free_top = (jtask.AreaLayer(axis=dim - 1, lo=0.99, hi=1.01),
                    jtask.BorderSpec("free"))
        force_side = (jtask.AreaLayer(axis=0, lo=-0.01, hi=0.01),
                      jtask.BorderSpec("fixed_force",
                                       value=(2e5, 1e5, -1e5)[:dim]))
        vel_side = (jtask.AreaLayer(axis=0, lo=0.99, hi=1.01),
                    jtask.BorderSpec("fixed_velocity",
                                     value=(0.1, -0.2, 0.3)[:dim]))
        nb = jsgcm.build_node_borders(jgrid, [free_top, force_side, vel_side])
        return nb, node_borders_from_numpy(nb.kind, nb.value)
    value = {"fixed_force": (1e5, -2e5, 3e5),
             "fixed_velocity": (0.1, 0.2, -0.3)}.get(border)
    value = None if value is None else value[:dim]
    return (jtask.BorderSpec(border, value=value),
            ttask.BorderSpec(border, value=value))


def operator(t, N):
    """The interpolation operator of a table as a sparse [N, N] matrix."""
    K = t.ids.shape[1]
    m = sp.csr_matrix((np.asarray(t.weights, np.float64).ravel(),
                       (np.repeat(np.arange(N), K), np.asarray(t.ids).ravel())),
                      shape=(N, N))
    m.sum_duplicates()
    return m


def jax_walk_faults(jgrid, jtables, waves, dt):
    """Per table key, the feet where JAX's walk says "outside" while scipy
    finds a cell: the feet the reference walk cycled on."""
    out = {}
    for key, t in jtables.items():
        a, w, d = key
        feet = jgrid.points.copy()
        feet[:, a] += d * np.asarray(waves[w], np.float64) * dt
        out[key] = t.outside & (jgrid.delaunay.find_simplex(feet) >= 0)
    return out


def assert_tables_agree(ttables, jtables, faults, N):
    """The port's tables equal JAX's as operators, except at the feet in
    ``faults``, where the port interpolates inside a cell."""
    assert set(ttables) == set(jtables)
    for key, j in jtables.items():
        t = ttables[key]
        bad = faults[key]
        assert np.array_equal(t.outside[~bad], j.outside[~bad]), key
        assert not t.outside[bad].any(), key
        keep = sp.diags((~bad).astype(float))
        diff = (keep @ (operator(t, N) - operator(j, N))).tocoo()
        assert np.abs(diff.data).max(initial=0.0) < 1e-12, key


# ------------------------------------------------------------------ meshes

def test_box_and_box_minus_give_the_jax_meshes():
    for dim, n in ((3, 7), (2, 9)):
        j = jsimplex.SimplexGrid.box((0.0,) * dim, (3.0,) * dim, (n,) * dim,
                                     jitter=0.15, seed=3)
        t = tsimplex.SimplexGrid.box((0.0,) * dim, (3.0,) * dim, (n,) * dim,
                                     jitter=0.15, seed=3)
        assert np.array_equal(t.points, j.points)
        assert np.array_equal(t.cells, j.cells)
        assert np.array_equal(t.hull_mask(), j.hull_mask())
    hole = ((jtask.AreaBox((2.0, 5.0), (5.0, 9.0)),),
            (ttask.AreaBox((2.0, 5.0), (5.0, 9.0)),))
    for reorder in ("lex", "rcm", None):
        j = jsimplex.SimplexGrid.box_minus((0.0, 0.0), (8.0, 8.0), (17, 17),
                                           holes=hole[0], reorder=reorder)
        t = tsimplex.SimplexGrid.box_minus((0.0, 0.0), (8.0, 8.0), (17, 17),
                                           holes=hole[1], reorder=reorder)
        assert np.array_equal(t.points, j.points)
        assert np.array_equal(t.cells, j.cells)
        if reorder is None:
            assert t.node_order is None and j.node_order is None
        else:
            assert np.array_equal(t.node_order, j.node_order)
        assert np.array_equal(t.boundary_faces(), j.boundary_faces())


def test_from_cells_and_load_msh_renumber_as_jax(tmp_path):
    rng = np.random.default_rng(4)
    base = jsimplex.SimplexGrid.box((0.0,) * 3, (1.0,) * 3, (5, 5, 5))
    perm = rng.permutation(base.npoints)
    inv = np.argsort(perm)
    pts, cells = base.points[perm], inv[base.cells]
    j = jsimplex.SimplexGrid.from_cells(pts, cells)
    t = tsimplex.SimplexGrid.from_cells(pts, cells)
    assert np.array_equal(t.points, j.points)
    assert np.array_equal(t.cells, j.cells)
    assert np.array_equal(t.node_order, j.node_order)
    path = tmp_path / "mesh.msh"
    lines = ["$Nodes", str(len(pts))]
    lines += [f"{i + 1} {x} {y} {z}" for i, (x, y, z) in enumerate(pts)]
    lines += ["$EndNodes", "$Elements", str(len(cells))]
    lines += [f"{i + 1} 4 2 0 1 " + " ".join(str(v + 1) for v in c)
              for i, c in enumerate(cells)]
    lines += ["$EndElements"]
    path.write_text("\n".join(lines) + "\n")
    j, t = jsimplex.load_msh(str(path)), tsimplex.load_msh(str(path))
    assert np.array_equal(t.points, j.points)
    assert np.array_equal(t.cells, j.cells)
    assert np.array_equal(t.node_order, j.node_order)


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("mesh", ["3d", "3d-order2", "2d"])
def test_foot_tables_match_jax(mesh):
    if mesh == "2d":
        p = mesh_problem(mesh)
        p2 = dict(p, order=2)
        cases = [p, p2]
    else:
        cases = [mesh_problem(mesh)]
    for p in cases:
        jgrid = p["jgrid"]
        tgrid = tsimplex.SimplexGrid.box((0.0,) * p["dim"], (1.0,) * p["dim"],
                                         (MESHES[mesh][0],) * p["dim"],
                                         jitter=0.1)
        jtables = jsimplex.build_foot_tables(jgrid, p["waves"], p["dt"],
                                             order=p["order"])
        ttables = tsimplex.build_foot_tables(tgrid, p["waves"], p["dt"],
                                             order=p["order"])
        faults = jax_walk_faults(jgrid, jtables, p["waves"], p["dt"])
        assert sum(int(f.sum()) for f in faults.values()) <= 2 * len(faults)
        assert_tables_agree(ttables, jtables, faults, jgrid.npoints)


def test_per_pair_foot_tables_match_jax():
    p = mesh_problem("3d")
    model = jget_model("elastic3d")
    tgrid = tsimplex.SimplexGrid.box((0.0,) * 3, (1.0,) * 3, (8,) * 3,
                                     jitter=0.1)
    jt = jsimplex.build_foot_tables_for_model(p["jgrid"], model, p["jmat"],
                                              p["dt"])
    tt = tsimplex.build_foot_tables_for_model(tgrid, get_model("elastic3d"),
                                              p["tmat"], p["dt"])
    waves = {(a, k, d): p["waves"][model.stage(a).pairs[k].wave]
             for a, k, d in jt}
    faults = {}
    for key, t in jt.items():
        a, _, d = key
        feet = p["jgrid"].points.copy()
        feet[:, a] += d * waves[key] * p["dt"]
        faults[key] = t.outside & (p["jgrid"].delaunay.find_simplex(feet) >= 0)
    assert_tables_agree(tt, jt, faults, p["jgrid"].npoints)


def test_reference_walk_cycles_and_the_port_locator_does_not():
    """On a jittered 17^3 box, feet shifted 0.6 h along x: the reference
    walk (reproduced with its bound of ncells + 16 steps) cycles to that
    bound on hundreds of feet, and JAX's C++ walk reports "outside" where
    scipy finds a cell; the port's walk stops at MAX_STEPS steps and agrees
    with scipy on every foot."""
    g = tsimplex.SimplexGrid.box((0.0,) * 3, (1.0,) * 3, (17,) * 3,
                                 jitter=0.15)
    tri = g.delaunay
    starts = tri.vertex_to_simplex.astype(np.int32)
    feet = g.points.copy()
    feet[:, 0] += 0.6 / 16
    bound = len(tri.simplices) + 16
    scipy_cells = tri.find_simplex(feet)
    _, _, ref_steps = walk_locate(tri, feet, starts, max_steps=bound)
    cycling = ref_steps >= bound
    assert cycling.sum() > 100

    cells, bary, steps = walk_locate(tri, feet, starts)
    assert steps.max() <= MAX_STEPS
    assert np.array_equal(cells < 0, scipy_cells < 0)
    inside = cells >= 0
    assert (bary[inside] >= -1e-9).all()
    np.testing.assert_allclose(bary[inside].sum(1), 1.0, atol=1e-12)

    assert native.available()
    jcells, _ = native.walk_locate(tri, feet, starts)
    fault = (jcells < 0) & (scipy_cells >= 0)
    assert 1 <= fault.sum() <= 5
    assert cycling[fault].all()
    # below the bound the port walks the reference's own path
    resolved = steps < MAX_STEPS
    assert np.array_equal(cells[resolved], jcells[resolved])


# ------------------------------------------------------------------ sweeps

@pytest.mark.parametrize("mesh,border", STAGE_CASES)
def test_simplex_stage_matches_jax(mesh, border):
    p = mesh_problem(mesh)
    jb, tb = borders_pair(border, p["jgrid"], p["dim"])
    jmodel, tmodel = jget_model(p["model"]), get_model(p["model"])
    for axis in range(p["dim"]):
        want = jsgcm.simplex_stage(jmodel, jnp.asarray(p["u0"]), p["jmat"],
                                   p["jtables"], axis, jb)
        got = simplex_stage(tmodel, torch.tensor(p["u0"]), p["tmat"],
                            p["ttables"], axis, tb)
        assert norm_err(got.numpy(), np.asarray(want)) < 1e-12


def test_node_borders_match_jax():
    p = mesh_problem("3d")
    jb, tb = borders_pair("node", p["jgrid"], 3)
    tgrid = tsimplex.SimplexGrid.box((0.0,) * 3, (1.0,) * 3, (8,) * 3,
                                     jitter=0.1)
    own = build_node_borders(tgrid, [
        (ttask.AreaLayer(axis=2, lo=0.99, hi=1.01), ttask.BorderSpec("free")),
        (ttask.AreaLayer(axis=0, lo=-0.01, hi=0.01),
         ttask.BorderSpec("fixed_force", value=(2e5, 1e5, -1e5))),
        (ttask.AreaLayer(axis=0, lo=0.99, hi=1.01),
         ttask.BorderSpec("fixed_velocity", value=(0.1, -0.2, 0.3)))])
    assert np.array_equal(own.kind, jb.kind)
    assert np.array_equal(own.value, jb.value)
    assert set(np.unique(own.kind)) == {0, 1, 2, 3}


@pytest.mark.parametrize("mesh,border", FUSED_CASES)
def test_sweep_reference_matches_jax_fused_kernel(monkeypatch, mesh, border):
    orig = psx.pl.pallas_call

    def wrapped(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(psx.pl, "pallas_call", wrapped)
    p = mesh_problem(mesh)
    jb, tb = borders_pair(border, p["jgrid"], p["dim"])
    jmodel, tmodel = jget_model(p["model"]), get_model(p["model"])
    jplan = psx.build_fused_simplex_plan(
        jmodel, p["jmat"], jsimplex.compress_foot_tables(dict(p["jtables"])),
        jb, dtype=jnp.float64)
    assert jplan is not None
    tplan = build_simplex_plan(tmodel, p["tmat"], p["ttables"], tb,
                               dtype=torch.float64)
    axes = tuple(range(p["dim"]))[::-1]
    u3 = psx.fused_simplex_step(jplan, jplan.pad(jnp.asarray(p["u0"])), axes,
                                interpret=True)
    u = torch.tensor(p["u0"])
    for a in axes:
        u = simplex_sweep_reference(tplan, u, a)
    assert norm_err(u.numpy(), np.asarray(jplan.unpad(u3))) < 1e-12


def test_sweep_wrapper_on_cpu_runs_the_plain_version():
    p = mesh_problem("3d")
    model = get_model("elastic3d")
    _, tb = borders_pair("node", p["jgrid"], 3)
    mat32 = material_fields_from_numpy(
        {k: np.asarray(getattr(p["jmat"], k)) for k in MATERIAL_LEAVES})
    plan = build_simplex_plan(model, mat32, p["ttables"], tb)
    assert plan.K == 4 and plan.stages[0].ids.shape[0] == 4
    u = torch.tensor(p["u0"], dtype=torch.float32)
    before = simplex_sweep.launches
    got = simplex_step(plan, u, (2, 1, 0))
    assert simplex_sweep.launches == before
    want = u
    for a in (2, 1, 0):
        want = simplex_stage(model, want, mat32, p["ttables"], a, tb)
    assert norm_err(got.numpy(), want.numpy()) < 2e-6
    with pytest.raises(ValueError):
        simplex_sweep(plan, u[:, :-1], 0)


class _SimplexMapLib:
    """Stands in for the kernel library's ``gcm_model_map`` (the
    CPU has no library): fills the map of model ``name`` for every id it
    knows, optionally with one pair's velocity component moved."""

    def __init__(self, name, moved=False):
        self.name, self.moved = name, moved

    def gcm_model_map(self, model_id, addr):
        if model_id not in ofu.STREAM_MODELS.values():
            return 1
        model = get_model(self.name)
        src = ofu._params(model, (4,) * model.dim,
                          len(ofu.mat_layout(model)), 1.0, (1.0,) * model.dim,
                          None, tuple(range(model.dim)), ())
        if self.moved:
            src.pair_vel[0][0] += 1
        ctypes.memmove(addr, ctypes.addressof(src), ctypes.sizeof(src))
        return 0


@pytest.mark.parametrize("name", ["elastic3d", "acoustic3d", "elastic2d",
                                  "acoustic2d"])
def test_simplex_binding_holds_the_model_to_the_compiled_map(name):
    model = get_model(name)
    # distinct live stand-ins: the check is remembered a model and library
    good, moved = _SimplexMapLib(name), _SimplexMapLib(name, moved=True)
    other = _SimplexMapLib({"elastic3d": "acoustic3d",
                            "acoustic3d": "elastic3d",
                            "elastic2d": "acoustic2d",
                            "acoustic2d": "elastic2d"}[name])
    ofu.check_compiled_map(good, model, "the simplex kernel")
    for lib in (moved, other):
        with pytest.raises(RuntimeError, match="component map"):
            ofu.check_compiled_map(lib, model, "the simplex kernel")


@pytest.mark.parametrize("name", ["elastic1d", "acoustic1d"])
def test_simplex_binding_refuses_a_model_without_a_map(name):
    """No simplex map is compiled for the 1D models: the binding raises
    before it asks the library."""
    class Unasked:
        def gcm_model_map(self, *args):
            raise AssertionError("the library was asked")

    with pytest.raises(ValueError, match="compiled for"):
        ofu.check_compiled_map(Unasked(), get_model(name),
                               "the simplex kernel")


@pytest.mark.parametrize("mesh", ["3d", "3d-fluid", "2d"])
def test_simplex_params_fill_the_model_pair_slots(mesh):
    """The kernel's parameters put each plan pair's tables in the slot of
    its index in the model's stage, the compiled map's pair; a pair without
    tables keeps -1, the two S pairs of a 3D sweep name one pair of tables,
    and the zeros the kernel applies with the P pair are the plan's."""
    p = mesh_problem(mesh)
    model = get_model(p["model"])
    plan = build_simplex_plan(model, p["tmat"], p["ttables"], "free")
    u = torch.zeros((model.ncomp, plan.N))
    for axis, sp in plan.stages.items():
        params = osx._simplex_params(plan, u, axis)
        assert (params.model, params.axis) == (
            ofu.STREAM_MODELS[model.name], axis)
        st = model.stage(axis)
        by_pair = {(sg, vl): (tp, tm) for sg, vl, tp, tm, *_ in sp.pairs}
        for q, pair in enumerate(st.pairs):
            want = by_pair.get((pair.sigma, pair.vel), (-1, -1))
            assert (params.pair_tp[q], params.pair_tm[q]) == want
        if mesh == "3d":
            assert params.pair_tp[1] == params.pair_tp[2] >= 0
            assert params.pair_tm[1] == params.pair_tm[2] >= 0
        if mesh == "3d-fluid":
            assert params.pair_tp[1] == params.pair_tp[2] == -1
        assert params.pair_tp[0] >= 0
        assert sp.zeros == tuple((z.comp, z.src) for z in st.zeros)


# ------------------------------------------------------------------ engine

def test_engine_refuses_what_the_port_does_not_run():
    task = get_scenario("simplex3d_layered", n=5, nsteps=2)
    assert resolve_simplex_kernel("auto", "cpu") == "torch"
    assert resolve_simplex_kernel("auto", "cuda") == "simplex"
    with pytest.raises(ValueError):
        SimplexEngine.from_task(dataclasses.replace(task, kernel="simplex"),
                                device="cpu")
    with pytest.raises(ValueError):
        dataclasses.replace(task, kernel="fused")
    # orthotropic media run on the plain per-pair path and refuse the kernel
    ortho = OrthotropicMaterial.from_isotropic(IsotropicMaterial(
        2500.0, 1e9, 5e8))
    fields = dataclasses.replace(task, default_material=ortho
                                 ).material_fields()
    assert isinstance(fields, OrthotropicMaterialFields)
    assert resolve_simplex_kernel("auto", "cuda", fields) == "torch"
    eng = SimplexEngine(task.grid, "elastic3d", ortho, device="cpu")
    assert eng.kernel == "torch" and (0, 1, 1) in eng.tables
    with pytest.raises(ValueError, match="isotropic"):
        SimplexEngine(task.grid, "elastic3d", ortho, device="cpu",
                      kernel="simplex")


def test_cli_runs_a_simplex_scenario_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "gcm_tpu_torch", "run", "simplex3d_layered",
         "--n", "7", "--nsteps", "3", "--device", "cpu", "--outdir",
         str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["kernel"] == "torch" and summary["device"] == "cpu"
    assert summary["npoints"] == 7 ** 3 and summary["nsteps"] == 3
    assert summary["points_per_second"] > 0 and summary["dt"] > 0
    proc = subprocess.run(
        [sys.executable, "-m", "gcm_tpu_torch", "run", "simplex3d_layered",
         "--n", "5", "--nsteps", "1", "--kernel", "simplex", "--device",
         "cpu", "--outdir", str(tmp_path)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
