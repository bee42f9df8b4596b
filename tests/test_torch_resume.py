"""Checkpoint and resume of the port's three engines, and their outputs.

- JAX -> port: the JAX engine runs to the cut, its ``state_dict`` (as numpy)
  goes through the port's checkpoint file into a fresh port engine in
  float64, which runs to the end and matches JAX's uninterrupted run at
  1e-9: the state, the damage aux field and the whole detector record for
  ``Engine`` (tests/test_io.py's damage problem, cuts 7 and 6 of 12); the
  state, traces and node fingerprint for ``SimplexEngine`` (a 2D mesh where
  the two packages' point locators agree); the bodies and the bond mask,
  broken, for ``MultiBodyEngine`` (tests/test_io.py's 1D fracture pair,
  cuts 20 and 21 of 40); the multi-body ``write_snapshots`` files are
  byte-identical to the JAX engine's on one restored state.
- The port alone: a resumed run equals the uninterrupted one exactly on two
  co-resident CPU shards, on the pair-fused path from an odd step, and from
  a checkpoint written mid-run by ``run_with_outputs``; checkpoints fire
  without snapshots and the two cadences are independent; a ``.pvd``
  cadence is rounded up to the period; the state leaves the device only at
  the steps where an artifact fires; a callback lands on global multiples
  of its cadence after a resume off that grid.
"""

import dataclasses
import os
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu import task as jtask
from gcm_tpu.engine import Engine as JEngine
from gcm_tpu.engine_multi import MultiBodyEngine as JMultiBodyEngine
from gcm_tpu.engine_simplex import SimplexEngine as JSimplexEngine
from gcm_tpu.materials import IsotropicMaterial as JIsotropicMaterial
from gcm_tpu.scenarios import get_scenario as jget_scenario
from gcm_tpu.solver.contact import ContactSpec as JContactSpec
from gcm_tpu.solver.correctors import DamageCorrector as JDamageCorrector
from gcm_tpu_torch import task as ttask
from gcm_tpu_torch.engine import Engine
from gcm_tpu_torch.engine_multi import MultiBodyEngine
from gcm_tpu_torch.engine_simplex import SimplexEngine, _points_fingerprint
from gcm_tpu_torch.materials import IsotropicMaterial
from gcm_tpu_torch.parallel.sharding import domain_mesh
from gcm_tpu_torch.scenarios import get_scenario
from gcm_tpu_torch.solver.contact import ContactSpec
from gcm_tpu_torch.solver.correctors import DamageCorrector
from gcm_tpu_torch.utils.checkpoint import (
    latest_step, restore_checkpoint, save_checkpoint,
)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


def _through_file(tmp_path, step, state):
    """``state`` saved and restored by the port's checkpoint module."""
    ckdir = str(tmp_path / "ck")
    save_checkpoint(ckdir, step, state)
    return restore_checkpoint(ckdir, state)


def damage_task(T, material, corrector, nsteps, detectors=True):
    """tests/test_io.py's resume problem, from either package's modules."""
    mat = material.from_speeds(rho=1000.0, cp=2000.0, cs=1100.0)
    return T.Task(
        name="resume_test",
        model="elastic2d",
        grid=T.GridSpec((24, 20), (1.0, 1.0)),
        default_material=mat,
        initial=(T.InitialCondition(T.AreaBox((8.0, 6.0), (14.0, 12.0)),
                                    {"sxx": 0.4, "syy": 0.4}),),
        borders={(a, s): T.BorderSpec("absorbing")
                 for a in range(2) for s in (0, 1)},
        sources=(T.RickerSource((12.0, 10.0), ("sxx", "syy"),
                                f0=200.0, t0=0.004, amplitude=50.0),),
        time=T.TimeSpec(cfl=0.8, nsteps=nsteps),
        correctors=(corrector(threshold=0.05, rate=5e4),),
        detectors=(T.DetectorSpec(points=((12.0, 12.0), (20.0, 8.0)))
                   if detectors else None),
    )


def port_damage_task(nsteps, **kw):
    return damage_task(ttask, IsotropicMaterial, DamageCorrector, nsteps,
                       **kw)


def jax_damage_engine(nsteps):
    """The JAX engine in float64, with a float64 damage field (its scan
    cannot start from the float32 one ``init_aux`` gives)."""
    eng = JEngine(damage_task(jtask, JIsotropicMaterial, JDamageCorrector,
                              nsteps), dtype=jnp.float64)
    eng.aux = {"damage": jnp.zeros((24, 20), jnp.float64)}
    return eng


@pytest.mark.parametrize("cut", [7, 6])
def test_engine_resumes_a_jax_checkpoint(tmp_path, cut):
    full = jax_damage_engine(12)
    rfull = full.run()
    assert float(np.asarray(full.aux["damage"]).max()) > 0.01
    part = jax_damage_engine(12)
    part.nsteps = cut
    part.run()
    state = jax.tree.map(np.asarray, part.state_dict())
    assert state["traces"].shape == (cut, 2, 5)

    eng = Engine(port_damage_task(12), device="cpu", dtype=torch.float64)
    eng.load_state(_through_file(tmp_path, cut, state))
    assert eng.start_step == cut
    res = eng.run()
    assert eng._done_step == 12 and res.nsteps == 12
    _close(res.u, rfull.u)
    _close(eng.aux["damage"].numpy(), np.asarray(full.aux["damage"]))
    assert res.traces.shape == (12, 2, 5)
    _close(res.traces, rfull.traces)


@pytest.mark.parametrize("cut", [7, 8])
def test_simplex_engine_resumes_a_jax_checkpoint(tmp_path, cut):
    def jeng():
        return JSimplexEngine.from_task(
            jget_scenario("simplex2d_canyon_layered", n=17, nsteps=15),
            dtype=jnp.float64)

    full, part = jeng(), jeng()
    rfull = full.run()
    part.run(nsteps=cut)
    state = jax.tree.map(np.asarray, part.state_dict())
    eng = SimplexEngine.from_task(
        get_scenario("simplex2d_canyon_layered", n=17, nsteps=15),
        device="cpu", dtype=torch.float64)
    assert np.array_equal(state["points_md5"], _points_fingerprint(eng.grid))
    assert np.array_equal(eng.state_dict()["points_md5"],
                          state["points_md5"])
    eng.load_state(_through_file(tmp_path, cut, state))
    assert eng.start_step == cut
    res = eng.run()
    _close(res.u, rfull.u)
    assert res.traces.shape == rfull.traces.shape == (15, 4, 5)
    _close(res.traces, rfull.traces)
    # a checkpoint of another node numbering is refused
    other = dict(state, points_md5=state["points_md5"][::-1].copy())
    with pytest.raises(ValueError, match="numbering mismatch"):
        eng.load_state(other)


def fracture_pair(T, material, contact, nsteps=40):
    """tests/test_io.py's 1D pair: a tensile pulse in body a breaks its
    bonded interface with body b."""
    mat = material.from_speeds(rho=1000.0, cp=2000.0)
    z = mat.rho * mat.cp
    a = T.Task(name="a", model="elastic1d", grid=T.GridSpec((60,), (1.0,)),
               default_material=mat,
               initial=(T.InitialCondition(T.AreaBox((30.0,), (40.0,)),
                                           {"sxx": 0.2, "v": -0.2 / z}),),
               borders={(0, 0): T.BorderSpec("absorbing")},
               time=T.TimeSpec(cfl=0.9, nsteps=nsteps), order=1)
    b = T.Task(name="b", model="elastic1d", grid=T.GridSpec((60,), (1.0,)),
               default_material=mat,
               borders={(0, 1): T.BorderSpec("absorbing")},
               time=T.TimeSpec(cfl=0.9, nsteps=nsteps), order=1)
    return {"a": a, "b": b}, (contact("a", "b", axis=0, kind="bonded",
                                      tensile_strength=0.05,
                                      broken_kind="free"),)


@pytest.mark.parametrize("cut", [20, 21])
def test_multibody_engine_resumes_a_jax_checkpoint(tmp_path, cut):
    def jeng():
        return JMultiBodyEngine(*fracture_pair(jtask, JIsotropicMaterial,
                                               JContactSpec),
                                dtype=jnp.float64)

    full, part = jeng(), jeng()
    rfull = full.run()
    assert float(rfull.bonded[0]) == 0.0, "the interface must break"
    part.nsteps = cut
    part.run()
    state = jax.tree.map(np.asarray, part.state_dict())
    eng = MultiBodyEngine(*fracture_pair(ttask, IsotropicMaterial,
                                         ContactSpec),
                          device="cpu", dtype=torch.float64)
    eng.load_state(_through_file(tmp_path, cut, state))
    assert eng.start_step == cut and set(eng.bonded) == {0}
    res = eng.run()
    assert float(res.bonded[0]) == 0.0
    for name in ("a", "b"):
        _close(res.bodies[name], rfull.bodies[name])

    # a broken mask, restored, stays broken
    broken = eng.state_dict()
    assert broken["bonded"] == {"0": 0.0} and broken["step"] == 40
    again = MultiBodyEngine(*fracture_pair(ttask, IsotropicMaterial,
                                           ContactSpec, nsteps=44),
                            device="cpu", dtype=torch.float64)
    again.load_state(_through_file(tmp_path, 40, broken))
    assert float(again.run().bonded[0]) == 0.0


def _same_files(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_multibody_snapshots_match_jax(tmp_path):
    """The port's and the JAX engine's ``write_snapshots``, restored to one
    state (the 1D fracture pair once its interface broke), write
    byte-identical ``.vti`` and bond-mask ``.npy`` files; and
    ``write_body_snapshots`` from a run's result writes what
    ``write_snapshots`` writes after that run."""
    from gcm_tpu_torch.engine_multi import write_body_snapshots

    jeng = JMultiBodyEngine(*fracture_pair(jtask, JIsotropicMaterial,
                                           JContactSpec),
                            dtype=jnp.float64)
    jeng.run()
    jeng.write_snapshots(str(tmp_path / "jax"), tag="t")
    state = jax.tree.map(np.asarray, jeng.state_dict())
    eng = MultiBodyEngine(*fracture_pair(ttask, IsotropicMaterial,
                                         ContactSpec, nsteps=44),
                          device="cpu", dtype=torch.float64)
    eng.load_state(state)
    eng.write_snapshots(str(tmp_path / "port"), tag="t")
    _same_files(tmp_path / "jax", tmp_path / "port")
    assert {"a_t.vti", "b_t.vti", "contact0_bonded_t.npy"} == set(
        os.listdir(tmp_path / "port"))

    res = eng.run()
    eng.write_snapshots(str(tmp_path / "engine"))
    write_body_snapshots(str(tmp_path / "result"), "final", eng.tasks,
                         eng.model, res.bodies, res.bonded)
    _same_files(tmp_path / "engine", tmp_path / "result")


def _resumed(build, cut, tmp_path, **load):
    """The run of ``build()`` cut at ``cut``, checkpointed, restored into a
    fresh engine and run to the end: (that engine, its result)."""
    part = build()
    part.nsteps = cut
    part.run()
    eng = build()
    eng.load_state(_through_file(tmp_path, cut, part.state_dict()))
    return eng, eng.run()


def test_mesh_engine_resumes_exactly(tmp_path):
    """On two co-resident CPU shards (the fused SPMD path's plain
    versions): a checkpoint gathers the shards, a resume shards it again."""
    task = dataclasses.replace(
        get_scenario("elastic3d_explosion", n=16, nsteps=8), kernel="fused")

    def build():
        return Engine(task, mesh=domain_mesh(3, ["cpu"] * 2, (2, 1)))

    want = build().run()
    eng, got = _resumed(build, 5, tmp_path)
    assert len(eng.u) == 2 and eng.start_step == 5
    np.testing.assert_array_equal(got.u, want.u)
    assert got.traces.shape == want.traces.shape == (8, 2, 9)
    np.testing.assert_array_equal(got.traces, want.traces)
    assert np.abs(want.u).max() > 0


def test_pair_fused_path_resumes_from_an_odd_step(tmp_path):
    """temporal_block: the resumed run takes one single step to reach an
    even step, then its two-step passes."""
    task = dataclasses.replace(
        get_scenario("elastic3d_layered", n=24, nsteps=10), kernel="fused",
        temporal_block=True, detectors=None)

    def build():
        return Engine(task, device="cpu")

    want = build().run()
    eng, got = _resumed(build, 5, tmp_path)
    assert eng._pair_fused and got.traces is None
    np.testing.assert_array_equal(got.u, want.u)
    assert np.abs(want.u).max() > 0


def test_resume_from_a_mid_run_checkpoint(tmp_path):
    """run_with_outputs' checkpoints hold the state, aux and the filled rows
    of the trace record at their step; a resume from one equals the
    uninterrupted run, traces included."""
    eng = Engine(port_damage_task(12), device="cpu")
    want = eng.run_with_outputs(str(tmp_path), checkpoint_every=4)
    ckdir = str(tmp_path / "checkpoints")
    assert sorted(os.listdir(ckdir)) == ["step_12.npz", "step_4.npz",
                                         "step_8.npz"]
    state = restore_checkpoint(ckdir, step=8)
    assert state["traces"].shape == (8, 2, 5) and int(state["step"]) == 8
    np.testing.assert_array_equal(state["traces"], want.traces[:8])
    resumed = Engine(port_damage_task(12), device="cpu")
    resumed.load_state(state)
    got = resumed.run()
    np.testing.assert_array_equal(got.u, want.u)
    np.testing.assert_array_equal(got.traces, want.traces)
    np.testing.assert_array_equal(resumed.aux["damage"].numpy(),
                                  eng.aux["damage"].numpy())
    assert float(eng.aux["damage"].max()) > 0.01


def test_checkpoints_without_snapshots_and_independent_cadences(tmp_path):
    task = port_damage_task(8)
    assert task.snapshots.every == 0
    Engine(task, device="cpu").run_with_outputs(str(tmp_path),
                                                checkpoint_every=4)
    assert latest_step(str(tmp_path / "checkpoints")) == 8
    assert not (tmp_path / "snapshots").exists()

    both = dataclasses.replace(port_damage_task(8), name="snapck",
                               snapshots=ttask.SnapshotSpec(
                                   every=4, fields=("vx",)))
    out = tmp_path / "both"
    Engine(both, device="cpu").run_with_outputs(str(out), checkpoint_every=2)
    assert sorted(os.listdir(out / "checkpoints")) == [
        "step_4.npz", "step_6.npz", "step_8.npz"]
    assert sorted(os.listdir(out / "snapshots")) == [
        "snapck.pvd", "snapck_000004.vti", "snapck_000008.vti"]
    with open(out / "snapshots" / "snapck_000004.vti", "rb") as f:
        head = f.read(2000)
    assert b'Name="vx"' in head and b'Name="velocity"' in head
    assert b'Name="sxx"' not in head
    assert np.load(out / "snapck.npz")["traces"].shape == (8, 2, 5)


def test_pvd_cadence_rounds_up_to_the_period(tmp_path):
    """every=5 on a symmetrized run fires at 6, 12, 18."""
    task = dataclasses.replace(get_scenario("acoustic1d", n=64, nsteps=20),
                               snapshots=ttask.SnapshotSpec(every=5))
    eng = Engine(task, device="cpu")
    eng.run_with_outputs(str(tmp_path))
    root = ET.parse(tmp_path / "snapshots" / "acoustic1d.pvd").getroot()
    entries = root.findall(".//DataSet")
    assert [e.attrib["file"] for e in entries] == [
        f"acoustic1d_{s:06d}.vti" for s in (6, 12, 18)]
    times = [float(e.attrib["timestep"]) for e in entries]
    assert times == pytest.approx([s * eng.dt for s in (6, 12, 18)])
    assert eng.host_copies == [6, 12, 18]


def test_host_copies_only_where_an_artifact_fires(tmp_path):
    """Snapshots every 6, checkpoints every 4: the callback fires every 2
    steps, the state is copied at 4, 6, 8 and 12 only."""
    task = dataclasses.replace(port_damage_task(12),
                               snapshots=ttask.SnapshotSpec(every=6))
    eng = Engine(task, device="cpu")
    seen = []
    run = eng.run

    def spy(snapshot_cb=None, cb_every=None):
        def cb(step, u):
            assert isinstance(u, torch.Tensor) and u is eng.u
            seen.append(step)
            snapshot_cb(step, u)
        return run(snapshot_cb=cb, cb_every=cb_every)

    eng.run = spy
    eng.run_with_outputs(str(tmp_path), checkpoint_every=4)
    assert seen == [2, 4, 6, 8, 10, 12]
    assert eng.host_copies == [4, 6, 8, 12]


def test_callbacks_land_on_global_multiples_after_a_resume():
    eng = Engine(port_damage_task(12), device="cpu")
    eng.load_state(eng.state_dict() | {"step": 7})
    seen = []
    eng.run(snapshot_cb=lambda n, u: seen.append(n), cb_every=3)
    assert seen == [8, 12]      # every 3 rounds up to 4

    bodies, contacts = fracture_pair(ttask, IsotropicMaterial, ContactSpec)
    multi = MultiBodyEngine(bodies, contacts, device="cpu")
    multi.load_state(multi.state_dict() | {"step": 21})
    steps = []
    multi.run(snapshot_cb=lambda n, us: steps.append((n, sorted(us))),
              snapshot_every=6)
    assert steps == [(24, ["a", "b"]), (30, ["a", "b"]), (36, ["a", "b"])]

    sx = SimplexEngine.from_task(
        get_scenario("simplex2d_canyon_layered", n=9, nsteps=9),
        device="cpu")
    sx.load_state(sx.state_dict() | {"step": 3})
    at = []
    res = sx.run(snapshot_cb=lambda n, u: at.append(n), cb_every=4)
    assert at == [4, 8] and res.traces.shape[0] == 6


def test_nonconforming_masks_resume_exactly(tmp_path):
    """A non-conforming interface (the basin, h against h/2) made
    breakable carries one bond mask per side: the checkpoint keeps both,
    under the contact's key, and a resume from a partly broken pair equals
    the uninterrupted run, bodies, masks and traces."""
    from gcm_tpu_torch.scenarios import elastic2d_basin_refined

    bodies, contacts = elastic2d_basin_refined(n=17, nsteps=8)
    contacts = tuple(dataclasses.replace(c, tensile_strength=1e3,
                                         broken_kind="free")
                     for c in contacts)
    rng = np.random.default_rng(2)

    def build():
        eng = MultiBodyEngine(bodies, contacts, device="cpu",
                              dtype=torch.float64)
        eng.bonded = {0: {s: torch.as_tensor(
            (rng_masks[s] > 0.3).astype(np.float64)) for s in ("a", "b")}}
        return eng

    shapes = {s: tuple(m.shape) for s, m in MultiBodyEngine(
        bodies, contacts, device="cpu").bonded[0].items()}
    rng_masks = {s: rng.random(shape) for s, shape in shapes.items()}
    want = build().run()
    eng, got = _resumed(build, 5, tmp_path)
    state = eng.state_dict()
    assert set(state["bonded"]) == {"0"}
    assert set(state["bonded"]["0"]) == {"a", "b"}
    for s in ("a", "b"):
        np.testing.assert_array_equal(got.bonded[0][s], want.bonded[0][s])
        assert (got.bonded[0][s][rng_masks[s] <= 0.3] == 0).all()
    for k in want.bodies:
        np.testing.assert_array_equal(got.bodies[k], want.bodies[k])
    for k in want.traces:
        assert got.traces[k].shape[0] == 8
        np.testing.assert_array_equal(got.traces[k], want.traces[k])
