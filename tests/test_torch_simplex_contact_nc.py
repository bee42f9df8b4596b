"""Non-conforming simplex contacts and multi-body resume, port against JAX.

Two independently meshed bodies (h against h/2) couple through static
interface maps. Inputs come from seeded numpy generators; JAX runs on the
CPU with x64 (tests/conftest.py).

- ``pair_contact_maps``: equal node sets and neighbours, weights to 1e-12,
  on a 2D line interface and a jittered 3D surface interface.
- ``apply_simplex_contact_nc_post`` alone: 1e-12 (normalized), every kind,
  per-side bond masks equal.
- ``SimplexMultiEngine`` on the 2D mismatched halves and the 3D mismatched
  boxes: 1e-9 in float64, per-side bond masks equal (the 3D port engine
  runs JAX's tables: the JAX walk misplaces feet on these meshes).
- Resume: a JAX ``state_dict`` at an odd step loaded into the port and
  continued equals the JAX uninterrupted run at 1e-9; the port's own
  checkpoint file resumes bit for bit, with one host copy; after a resume
  at an odd step the snapshot callback fires at the global multiples of
  its cadence (the JAX engine lands on multiples of the resumed step
  instead, a fault of the reference that the port does not copy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.engine_simplex import SimplexBody as JSimplexBody
from gcm_tpu.engine_simplex import SimplexMultiEngine as JSimplexMultiEngine
from gcm_tpu.grids.simplex import SimplexGrid as JSimplexGrid
from gcm_tpu.materials import IsotropicMaterial as JIsotropicMaterial
from gcm_tpu.materials import MaterialFields as JMaterialFields
from gcm_tpu.models.spec import get_model as jget_model
from gcm_tpu.solver import simplex_contact as jsc
from gcm_tpu_torch.convert import (
    MATERIAL_LEAVES, bonded_from_numpy, foot_tables_from_numpy,
    material_fields_from_numpy, simplex_interface_maps_from_numpy,
)
from gcm_tpu_torch.engine_simplex import SimplexBody, SimplexMultiEngine
from gcm_tpu_torch.grids.simplex import SimplexGrid
from gcm_tpu_torch.materials import IsotropicMaterial
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.solver import simplex_contact as tsc
from gcm_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint,
)
from test_torch_simplex import (  # noqa: F401  (a module fixture)
    norm_err, private_native_library,
)
from test_torch_simplex_contact import assert_multi_agree

ROCK = dict(rho=1000.0, cp=2000.0, cs=1100.0)
MODELS = {2: "elastic2d", 3: "elastic3d"}


def mismatched(grid_cls, dim):
    """Body a meshed at h, body b at h/2: in 2D the halves of a 16 x 16
    square, in 3D jittered boxes of 16 x 24 x 24."""
    if dim == 2:
        return (grid_cls.box((0, 0), (8.0, 16.0), (9, 9)),
                grid_cls.box((8.0, 0), (16.0, 16.0), (17, 17)))
    return (grid_cls.box((0, 0, 0), (16.0, 24.0, 24.0), (9, 13, 13),
                         jitter=0.2, seed=3),
            grid_cls.box((16.0, 0, 0), (32.0, 24.0, 24.0), (17, 25, 25),
                         jitter=0.2, seed=4))


def pulse_states(grid_a, grid_b, dim):
    """A P pulse in body a, 4 m short of the interface and heading for it
    (tension first), its amplitude peaked at the middle of the plane, so
    the interface breaks there first; random noise in body b."""
    rock = JIsotropicMaterial.from_speeds(**ROCK)
    z = rock.rho * rock.cp
    kappa = rock.lam / (rock.lam + 2 * rock.mu)
    m = jget_model(MODELS[dim])
    p = grid_a.points
    mid = 0.5 * (p.min(0) + p.max(0))
    prof = 1e6 * np.exp(-((p[:, 0] - p[:, 0].max() + 4.0) / 2.0) ** 2
                        - (((p[:, 1:] - mid[1:]) / 6.0) ** 2).sum(1))
    u0a = np.zeros((m.ncomp, grid_a.npoints))
    u0a[m.comp("sxx")] = prof
    for c in ("syy", "szz")[:dim - 1]:
        u0a[m.comp(c)] = kappa * prof
    u0a[m.comp("vx")] = -prof / z
    rng = np.random.default_rng(5)
    u0b = rng.standard_normal((m.ncomp, grid_b.npoints))
    u0b[dim:] *= 1e4
    u0b[:dim] *= 1e4 / z
    return u0a, u0b


def test_pair_contact_maps_match_jax():
    for dim in (2, 3):
        want = jsc.pair_contact_maps(*mismatched(JSimplexGrid, dim), axis=0)
        got = tsc.pair_contact_maps(*mismatched(SimplexGrid, dim), axis=0)
        for f in ("idx_a", "idx_b", "nbr_a", "nbr_b"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        for f in ("w_a", "w_b"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=1e-12)
        conv = simplex_interface_maps_from_numpy(want)
        assert conv.idx_a.dtype == np.int32 and conv.w_a.dtype == np.float64
        assert not tsc.interface_is_conforming(
            got, *mismatched(SimplexGrid, dim))
    a, b = mismatched(SimplexGrid, 2)
    with pytest.raises(ValueError, match="planes disagree"):
        tsc.pair_contact_maps(a, SimplexGrid.box((9.0, 0), (16.0, 16.0),
                                                 (5, 5)), axis=0)


SOLVE_CASES = [("bonded", None, "free"), ("slip", None, "free"),
               ("friction", None, "free"), ("bonded", 1e5, "free"),
               ("bonded", 1e5, "slip"), ("bonded", 1e5, "friction")]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind,strength,broken", SOLVE_CASES)
def test_contact_nc_post_matches_jax(dim, kind, strength, broken):
    name = MODELS[dim]
    jmodel, tmodel = jget_model(name), get_model(name)
    ga, gb = mismatched(JSimplexGrid, dim)
    jmaps = jsc.pair_contact_maps(ga, gb, axis=0)
    tmaps = simplex_interface_maps_from_numpy(jmaps)
    rng = np.random.default_rng(11)
    spec_kw = dict(axis=0, kind=kind, tensile_strength=strength,
                   broken_kind=broken, friction_mu=0.4)
    jargs, targs, views = [], [], []
    for g in (ga, gb):
        N = g.npoints
        jmat = JMaterialFields.from_arrays(
            2500.0 * (1 + 0.2 * rng.random(N)), 1e9 * (1 + rng.random(N)),
            1e9 * (0.5 + rng.random(N)), xp=jnp, dtype=jnp.float64)
        tmat = material_fields_from_numpy(
            {k: np.asarray(getattr(jmat, k)) for k in MATERIAL_LEAVES},
            dtype=torch.float64)
        for _ in range(2):
            u = rng.standard_normal((jmodel.ncomp, N))
            u[dim:] *= 1e6
            jargs.append(jnp.asarray(u))
            targs.append(torch.tensor(u))
        views.append((jmat.axis_view(0, jmodel.stage(0)),
                      tmat.axis_view(0, tmodel.stage(0))))
    bonded = {s: (rng.random(len(getattr(jmaps, f"idx_{s}"))) < 0.6
                  ).astype(np.float64) for s in "ab"}
    jbond = ({s: jnp.asarray(v) for s, v in bonded.items()}
             if strength is not None else None)
    tbond = (bonded_from_numpy({0: bonded}, dtype=torch.float64)[0]
             if strength is not None else None)
    wa, wb, wm = jsc.apply_simplex_contact_nc_post(
        jsc.SimplexContactSpec("a", "b", **spec_kw), jmodel, jmaps, *jargs,
        views[0][0], views[1][0], jbond)
    ga_, gb_, gm = tsc.apply_simplex_contact_nc_post(
        tsc.SimplexContactSpec("a", "b", **spec_kw), tmodel, tmaps, *targs,
        views[0][1], views[1][1], tbond)
    assert norm_err(ga_.numpy(), np.asarray(wa)) < 1e-12
    assert norm_err(gb_.numpy(), np.asarray(wb)) < 1e-12
    if strength is None:
        assert gm is None and wm is None
    else:
        for s in "ab":
            np.testing.assert_array_equal(gm[s].numpy(), np.asarray(wm[s]))
            assert 0 < gm[s].sum() < bonded[s].sum()


def engines(dim, strength=None, broken="free", kind="bonded"):
    """Both packages' engines on the mismatched bodies."""
    ja, jb = mismatched(JSimplexGrid, dim)
    ta, tb = mismatched(SimplexGrid, dim)
    u0a, u0b = pulse_states(ja, jb, dim)
    spec_kw = dict(axis=0, kind=kind, tensile_strength=strength,
                   broken_kind=broken, friction_mu=0.3)
    jeng = JSimplexMultiEngine(
        {"a": JSimplexBody(ja, JIsotropicMaterial.from_speeds(**ROCK),
                           u0=u0a,
                           detector_points=((2.0,) + (6.0,) * (dim - 1),)),
         "b": JSimplexBody(jb, JIsotropicMaterial.from_speeds(**ROCK),
                           u0=u0b)},
        [jsc.SimplexContactSpec("a", "b", **spec_kw)],
        model_name=MODELS[dim], cfl=0.6, dtype=jnp.float64, kernel="jnp")
    tables = (None if dim == 2 else
              {k: foot_tables_from_numpy(v) for k, v in jeng.tables.items()})
    teng = SimplexMultiEngine(
        {"a": SimplexBody(ta, IsotropicMaterial.from_speeds(**ROCK), u0=u0a,
                          detector_points=((2.0,) + (6.0,) * (dim - 1),)),
         "b": SimplexBody(tb, IsotropicMaterial.from_speeds(**ROCK),
                          u0=u0b)},
        [tsc.SimplexContactSpec("a", "b", **spec_kw)],
        model_name=MODELS[dim], cfl=0.6, dtype=torch.float64, device="cpu",
        tables=tables)
    assert list(jeng._ncmaps) == list(teng._ncmaps) == [0]
    return jeng, teng


@pytest.mark.parametrize("dim,strength,broken,nsteps",
                         [(2, None, "free", 10), (2, 3e5, "slip", 12),
                          (3, 3e5, "free", 6)])
def test_nc_engine_matches_jax(dim, strength, broken, nsteps):
    jeng, teng = engines(dim, strength, broken)
    want = jeng.run(nsteps)
    got = teng.run(nsteps)
    assert_multi_agree(got, want)
    np.testing.assert_allclose(got.traces["a"], want.traces["a"], rtol=1e-9,
                               atol=1e-9 * np.abs(want.traces["a"]).max())
    if strength is not None:
        for s in "ab":
            assert 0 < got.bonded[0][s].mean() < 1


def test_forced_maps_on_a_conforming_split_equal_the_paired_solve():
    """Identity maps on a collocated interface reproduce the node-paired
    solve."""
    rng = np.random.default_rng(2)
    ga = SimplexGrid.box((0, 0), (8.0, 16.0), (9, 17))
    gb = SimplexGrid.box((8.0, 0), (16.0, 16.0), (9, 17))
    u0 = [rng.standard_normal((5, g.npoints)) * [[1], [1], [1e5], [1e5],
                                                  [1e5]] for g in (ga, gb)]

    def build():
        rock = IsotropicMaterial.from_speeds(**ROCK)
        return SimplexMultiEngine(
            {"a": SimplexBody(ga, rock, u0=u0[0]),
             "b": SimplexBody(gb, rock, u0=u0[1])},
            [tsc.SimplexContactSpec("a", "b", axis=0)], cfl=0.6,
            dtype=torch.float64, device="cpu")

    ref = build()
    assert list(ref._pairs) == [0] and not ref._ncmaps
    forced = build()
    forced.set_interface_maps(0, tsc.pair_contact_maps(ga, gb, axis=0))
    assert not forced._pairs
    want, got = ref.run(4), forced.run(4)
    for name in ("a", "b"):
        np.testing.assert_allclose(got.bodies[name], want.bodies[name],
                                   rtol=1e-11, atol=1e-9)


def test_jax_checkpoint_resumes_in_the_port():
    """A JAX engine cut at an odd step: its state_dict, per-side masks and
    receiver traces included, continues in the port as the JAX run goes
    on uninterrupted."""
    jfull, _ = engines(2, 3e5, "friction")
    want = jfull.run(14)
    jpart, teng = engines(2, 3e5, "friction")
    jpart.run(7)
    state = jax.tree.map(np.asarray, jpart.state_dict())
    assert set(state["bonded"]) == {"0"} and set(state["bonded"]["0"]) == {
        "a", "b"}
    teng.load_state(state)
    assert teng.start_step == 7
    got = teng.run(14)
    assert_multi_agree(got, want)
    np.testing.assert_allclose(got.traces["a"], want.traces["a"], rtol=1e-9,
                               atol=1e-9 * np.abs(want.traces["a"]).max())
    assert 0 < got.bonded[0]["a"].mean() < 1
    bad = dict(state, points_md5={"a": np.zeros(16, np.uint8)})
    with pytest.raises(ValueError, match="body 'a'"):
        teng.load_state(bad)


def test_port_checkpoint_resumes_bit_for_bit(tmp_path):
    _, full = engines(2, 3e5, "slip")
    want = full.run(12)
    _, part = engines(2, 3e5, "slip")
    part.run(5)
    save_checkpoint(str(tmp_path), 5, part.state_dict())
    assert part.host_copies == [5]
    _, resumed = engines(2, 3e5, "slip")
    resumed.load_state(restore_checkpoint(str(tmp_path)))
    got = resumed.run(12)
    for name in ("a", "b"):
        np.testing.assert_array_equal(got.bodies[name], want.bodies[name])
    for s in "ab":
        np.testing.assert_array_equal(got.bonded[0][s], want.bonded[0][s])
    np.testing.assert_array_equal(got.traces["a"], want.traces["a"])
    assert resumed.host_copies == []


def test_callbacks_land_on_global_multiples_after_an_odd_resume():
    _, part = engines(2)
    part.run(5)
    state = part.state_dict()
    _, eng = engines(2)
    eng.load_state(state)
    seen = []

    def cb(step, us):
        assert set(us) == {"a", "b"} and us["a"] is eng.us["a"]
        seen.append(step)

    eng.run(15, snapshot_cb=cb, snapshot_every=3)   # rounded up to 4
    assert seen == [8, 12]
    assert eng.host_copies == []
