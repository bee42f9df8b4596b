"""The port's MultiBodyEngine on a mesh: the canonical order, the per-sweep
form with a split contact axis, and resumes.

- The canonical order under a mesh of one axis (``fused_canonical_spmd``:
  the fused SPMD step per body in (2, 0, 1) / (1, 0, 2), the mesh splitting
  x) is held to JAX ``step_multi`` run unsharded with those axes, to 2e-5
  normalized with bond masks equal: the pattern of
  tests/test_multibody_fast.py's canonical-under-mesh tests, whose JAX
  engine runs float32 as the fused composition does here.
- ``sweep_spmd`` with the contact on the split x axis (the face rows whole
  on the edge shards), and with a y contact on a ``('sy',)`` mesh, is held
  to JAX's unsharded jnp engine in float32, to 1e-5 normalized.
- A JAX meshed engine's ``state_dict`` resumes in the port's meshed engine
  (float64, 1e-9), and a port state moves between sharded and unsharded
  engines.

Shards are co-resident CPU shards; states start random (see
tests/test_torch_multibody_mesh.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.engine_multi import MultiBodyEngine as JMultiBodyEngine
from gcm_tpu.solver.contact import ContactSpec as JContactSpec
from gcm_tpu.solver.multi import step_multi as jstep_multi
from gcm_tpu_torch.engine_multi import MultiBodyEngine
from gcm_tpu_torch.solver.contact import ContactSpec as TContactSpec
from gcm_tpu_torch.solver.correctors import DamageCorrector
from test_torch_multibody import _agree
from test_torch_multibody_mesh import (
    contact_pair, meshes, partly_broken, random_state, start_both,
    with_kernel,
)
from test_torch_step import norm_err

#: the lo/span contact of tests/test_multibody_fast.py's canonical case:
#: asymmetric per transverse axis, so a transposed mapping cannot agree
SPAN = dict(kind="bonded", tensile_strength=4e4, broken_kind="free",
            lo_a=(2, 1), lo_b=(1, 0), span=(8, 9))


@pytest.mark.parametrize("kind", ["bonded", "slip", "fracture", "span"])
def test_canonical_order_under_a_mesh_matches_jax_step_multi(kind):
    (jb, jc), (tb, tc) = contact_pair(12, 4, None if kind == "span"
                                      else kind)
    if kind == "span":
        jc = (JContactSpec("upper", "lower", axis=2, **SPAN),)
        tc = (TContactSpec("upper", "lower", axis=2, **SPAN),)
    _, mesh = meshes("sx4")
    eng = MultiBodyEngine(with_kernel(tb, "fused"), tc, device="cpu",
                          mesh=mesh, canonical_layout=True)
    assert eng.path == "fused_canonical_spmd" and eng._fwd == (2, 0, 1)
    us0, mask = random_state(tb, 9, seed=4), partly_broken(tc, tb)
    eng.load_state({"us": us0, "bonded": {str(k): v for k, v in mask.items()},
                    "step": 0})
    res = eng.run()

    ref = JMultiBodyEngine(jb, jc)      # the JAX engine for its setup
    us = {k: jnp.asarray(v, jnp.float32) for k, v in us0.items()}
    bonded = {k: jnp.asarray(v, jnp.float32) for k, v in mask.items()}
    for n in range(ref.nsteps):
        axes = (2, 0, 1) if n % 2 == 0 else (1, 0, 2)
        us, bonded = jstep_multi(ref.model, us, ref.mats, ref.dt, ref.hs,
                                 ref.order, ref.borders, ref.contacts,
                                 bonded, axes, ref.ncmaps)
        for name, node, comp, amps in ref._srcs:
            us = dict(us)
            us[name] = us[name].at[(comp,) + node].add(amps[n])
    for k in res.bodies:
        w = np.asarray(us[k])
        assert np.abs(res.bodies[k] - w).max() / np.abs(w).max() < 2e-5
    for ci in res.bonded:
        np.testing.assert_array_equal(res.bonded[ci], np.asarray(bonded[ci]))
    if kind in ("fracture", "span"):
        assert res.bonded[0].mean() < mask[0].mean()     # it broke


@pytest.mark.parametrize("kernel", ["fused", "sweep"])
def test_sweep_spmd_form_with_a_split_contact_axis_matches_jax(kernel):
    """The contact on x, which a 2x2 mesh splits: the fused SPMD form does
    not engage (as in JAX), the per-sweep halo stage does, with each face
    row whole on an edge shard; fracture from a partly broken mask."""
    (jb, jc), (tb, tc) = contact_pair(12, 4, "fracture", axis=0)
    _, mesh = meshes("2x2")
    jeng = JMultiBodyEngine(jb, jc)
    eng = MultiBodyEngine(with_kernel(tb, kernel), tc, device="cpu",
                          mesh=mesh)
    assert eng.path == "sweep_spmd"
    start_both(jeng, eng, random_state(tb, 9, seed=5), partly_broken(tc, tb),
               jnp.float32)
    _agree(eng.run(), jeng.run(), "f32")


def test_sweep_spmd_form_on_a_y_mesh_matches_jax():
    """A y contact on a ('sy',) mesh, which splits it, with
    kernel="fused": JAX runs its plain GSPMD step there (its halo stage
    splits only ``sx``); the port runs the per-sweep halo stage with the
    sweep kernel along y, and ends where JAX's unsharded engine ends."""
    (jb, jc), (tb, tc) = contact_pair(12, 4, "fracture", axis=1)
    _, mesh = meshes("sy4")
    jeng = JMultiBodyEngine(jb, jc)
    eng = MultiBodyEngine(with_kernel(tb, "fused"), tc, device="cpu",
                          mesh=mesh)
    assert eng.path == "sweep_spmd" and eng.mesh.axis_names == ("sy",)
    start_both(jeng, eng, random_state(tb, 9, seed=7), partly_broken(tc, tb),
               jnp.float32)
    _agree(eng.run(), jeng.run(), "f32")


def test_jax_meshed_state_resumes_in_the_port_f64():
    """A JAX engine on 2x2 virtual devices checkpointed at step 2 (its
    ``state_dict`` from a run callback, with traces and a partly broken
    mask) resumes in the port's engine on 2x2 CPU shards, which then ends
    where the JAX run ends, at 1e-9."""
    jmesh, mesh = meshes("2x2")
    (jb, jc), (tb, tc) = contact_pair(12, 4, "fracture", detectors=True)
    jeng = JMultiBodyEngine(jb, jc, dtype=jnp.float64, mesh=jmesh)
    jeng.bonded = {0: jnp.asarray(partly_broken(jc, jb)[0])}
    jeng.us = {k: jnp.asarray(v) for k, v in
               random_state(jb, 9, seed=6).items()}
    saved = {}

    def keep(step, _us):
        if step == 2:
            saved.update(jax.tree.map(np.asarray, jeng.state_dict()))

    want = jeng.run(snapshot_cb=keep, snapshot_every=2)
    assert saved["step"] == 2 and saved["traces"]["upper"].shape[0] == 2
    eng = MultiBodyEngine(tb, tc, device="cpu", dtype=torch.float64,
                          mesh=mesh)
    eng.load_state(saved)
    got = eng.run()
    assert got.path == "torch_spmd" and got.traces["upper"].shape[0] == 4
    _agree(got, want, "f64")


def test_port_state_moves_between_sharded_and_unsharded_engines(tmp_path):
    """The fused composition with a damage corrector (its aux sharded) and
    receivers: cut at step 3, a sharded run resumes unsharded and an
    unsharded one sharded, each ending where the uninterrupted sharded run
    does (1e-6 normalized, masks equal, traces whole); the outputs of a
    meshed run copy the state only where they fire and write the gathered
    fields."""
    (_, _), (tb, tc) = contact_pair(12, 6, "fracture", detectors=True)
    tb = {**tb, "upper": dataclasses.replace(tb["upper"], correctors=(
        DamageCorrector(threshold=3e4, rate=50.0),))}
    tb = with_kernel(tb, "fused")
    _, mesh = meshes("2x2")
    start = {"us": random_state(tb, 9, seed=7),
             "bonded": {str(k): v for k, v in partly_broken(tc, tb).items()},
             "step": 0}

    def engine(m, nsteps):
        bodies = {k: dataclasses.replace(t, time=dataclasses.replace(
            t.time, nsteps=nsteps)) for k, t in tb.items()}
        return MultiBodyEngine(bodies, tc, device="cpu", mesh=m)

    whole = engine(mesh, 6)
    whole.load_state(start)
    want = whole.run()
    assert want.path == "fused_spmd"
    dmg = whole.state_dict()["aux"]["upper"]["damage"]
    assert dmg.shape == (12, 12, 8) and dmg.max() > 0
    for first, second in ((mesh, None), (None, mesh)):
        part = engine(first, 3)
        part.load_state(start)
        part.run()
        rest = engine(second, 6)
        rest.load_state(part.state_dict())
        got = rest.run()
        for k, w in want.bodies.items():
            assert norm_err(got.bodies[k], w) < 1e-6
        np.testing.assert_array_equal(got.bonded[0], want.bonded[0])
        assert norm_err(got.traces["upper"].transpose(2, 0, 1),
                        want.traces["upper"].transpose(2, 0, 1)) < 1e-6

    eng = engine(mesh, 6)
    eng.load_state(start)
    res = eng.run_with_outputs(str(tmp_path), snapshot_every=4,
                               checkpoint_every=6)
    assert eng.host_copies == [4, 6]
    for k, w in want.bodies.items():
        assert norm_err(res.bodies[k], w) < 1e-6
    eng.write_snapshots(str(tmp_path), "final")
    assert (tmp_path / "upper_final.vti").exists()
    assert (tmp_path / "snapshots" / "lower_000004.vti").exists()
    assert np.load(tmp_path / "contact0_bonded_final.npy").shape == (12, 12)
