"""The port's MultiBodyEngine against the JAX package's, end to end.

Both engines build the contact scenarios from their own scenario modules
(same parameters) and run on the CPU: the JAX one on its jnp path
(``step_multi``), the port on its plain torch path, or on its fused path
(``kernel="fused"``: the fused wrappers' plain versions per body plus the
face-row fixups). Bodies, detector traces and bond masks must agree: to 1e-9
in float64, to 1e-5 normalized in float32 (the two run the float32 ops in
different fused orders), masks equal. The canonical splitting order is
held to JAX ``step_multi`` run with the matching axes, (2, 0, 1) and
(1, 0, 2), to 2e-5 normalized, as tests/test_multibody_fast.py holds the
JAX canonical engine.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.engine_multi import MultiBodyEngine as JMultiBodyEngine
from gcm_tpu.scenarios import elastic2d_basin_refined as jbasin
from gcm_tpu.scenarios import elastic3d_contact as jcontact
from gcm_tpu.solver.multi import step_multi as jstep_multi
from gcm_tpu_torch.convert import bonded_from_numpy
from gcm_tpu_torch.engine_multi import MultiBodyEngine
from gcm_tpu_torch.ops.fused import fused_step, fused_step_slab
from gcm_tpu_torch.scenarios import elastic2d_basin_refined as tbasin
from gcm_tpu_torch.scenarios import elastic3d_contact as tcontact
from test_torch_step import norm_err


def _agree(got, want, dtype):
    assert got.nsteps == want.nsteps and set(got.bodies) == set(want.bodies)
    if dtype == "f64":
        assert got.dt == pytest.approx(want.dt, rel=1e-15)
    else:
        assert got.dt == pytest.approx(want.dt, rel=1e-6)
    for k, w in want.bodies.items():
        g = got.bodies[k]
        assert g.shape == w.shape and np.abs(w).max() > 0
        if dtype == "f64":
            np.testing.assert_allclose(g, w, rtol=1e-9,
                                       atol=1e-9 * np.abs(w).max())
        else:
            assert norm_err(g, w) < 1e-5
    for k, w in (want.traces or {}).items():
        scale = np.abs(w).max() + 1e-30
        assert np.abs(got.traces[k] - w).max() / scale < (
            1e-9 if dtype == "f64" else 1e-5)
    assert set(got.bonded) == set(want.bonded)
    for ci, w in want.bonded.items():
        if isinstance(w, dict):
            for s in w:
                np.testing.assert_array_equal(got.bonded[ci][s],
                                              np.asarray(w[s]))
        else:
            np.testing.assert_array_equal(got.bonded[ci], np.asarray(w))


def test_contact_engine_matches_jax_f64():
    """elastic3d_contact from a common, partly broken bond mask (so the
    crack faces act from the first step); by step 12 the tension behind the
    compressive front has reached the interface and breaks more of it."""
    jb, jc = jcontact(n=12, nsteps=12)
    tb, tc = tcontact(n=12, nsteps=12)
    mask = (np.random.default_rng(3).random((12, 12)) > 0.3).astype(
        np.float64)
    jeng = JMultiBodyEngine(jb, jc, dtype=jnp.float64)
    jeng.bonded = {0: jnp.asarray(mask)}
    want = jeng.run()
    eng = MultiBodyEngine(tb, tc, device="cpu", dtype=torch.float64)
    assert eng.path == "torch"
    eng.bonded = bonded_from_numpy({0: mask})
    got = eng.run()
    _agree(got, want, "f64")
    assert got.bonded[0].mean() < mask.mean()      # the interface broke


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_basin_engine_matches_jax(dtype):
    """The non-conforming 2D basin (h against h/2 maps), with traces."""
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dtype]
    want = JMultiBodyEngine(*jbasin(n=9, nsteps=8), dtype=jdt).run()
    eng = MultiBodyEngine(*tbasin(n=9, nsteps=8), device="cpu", dtype=tdt)
    assert eng.path == "torch" and 0 in eng.ncmaps
    got = eng.run()
    assert got.traces["basin"].shape == want.traces["basin"].shape
    _agree(got, want, dtype)


@pytest.mark.parametrize("kernel", ["torch", "fused"])
def test_contact_engine_matches_jax_f32(kernel):
    """The plain path, and the fused path (one fused step per body plus the
    face-row fixups) in the default splitting order."""
    want = JMultiBodyEngine(*jcontact(n=12, nsteps=8)).run()
    bodies, contacts = tcontact(n=12, nsteps=8)
    bodies = {k: dataclasses.replace(t, kernel=kernel)
              for k, t in bodies.items()}
    eng = MultiBodyEngine(bodies, contacts, device="cpu")
    assert eng.path == ("fused" if kernel == "fused" else "torch")
    before = fused_step.launches
    got = eng.run()
    assert fused_step.launches == before     # CPU tensors: plain versions
    _agree(got, want, "f32")


@pytest.mark.parametrize("kind,mu,strength", [
    ("bonded", 0.0, 1e5), ("slip", 0.0, None), ("friction", 0.4, None)])
def test_canonical_order_matches_jax_step_multi(kind, mu, strength):
    """canonical_layout=True sweeps (ca, rest) = (2, 0, 1) and its reverse
    on the fused path: JAX step_multi with those axes. 10 steps carry the
    explosion across the interface, so slip and friction, whose normal
    pair is the physical z pair, are tested on a transmitted field. The
    bonded case starts from a common, partly broken mask (the crack faces
    act in the face-row fixups from the first step) and runs 14 steps, past
    the tension that reaches the interface around step 12, so more of it
    breaks."""
    nsteps = 14 if strength else 10
    jb, jcs = jcontact(n=12, nsteps=nsteps)
    tb, tcs = tcontact(n=12, nsteps=nsteps)
    over = dict(kind=kind, friction_mu=mu, tensile_strength=strength)
    jcs = tuple(dataclasses.replace(c, **over) for c in jcs)
    tcs = tuple(dataclasses.replace(c, **over) for c in tcs)
    ref = JMultiBodyEngine(jb, jcs)
    mask = (np.random.default_rng(3).random((12, 12)) > 0.3).astype(
        np.float32)
    if strength:
        ref.bonded = {0: jnp.asarray(mask)}
    us, bonded = dict(ref.us), dict(ref.bonded)
    for n in range(ref.nsteps):
        axes = (2, 0, 1) if n % 2 == 0 else (1, 0, 2)
        us, bonded = jstep_multi(ref.model, us, ref.mats, ref.dt, ref.hs,
                                 ref.order, ref.borders, ref.contacts,
                                 bonded, axes, ref.ncmaps)
        for name, node, comp, amps in ref._srcs:
            us = dict(us)
            us[name] = us[name].at[(comp,) + node].add(amps[n])
    eng = MultiBodyEngine({k: dataclasses.replace(t, kernel="fused")
                           for k, t in tb.items()}, tcs, device="cpu",
                          canonical_layout=True)
    assert eng.path == "fused_canonical" and eng._fwd == (2, 0, 1)
    if strength:
        eng.bonded = bonded_from_numpy({0: mask})
    before = fused_step_slab.launches
    res = eng.run()
    assert fused_step_slab.launches == before
    for k in res.bodies:
        w = np.asarray(us[k])
        assert np.abs(res.bodies[k] - w).max() / (np.abs(w).max()
                                                  + 1e-30) < 2e-5
    assert np.abs(res.bodies["upper"][:3]).max() > 0    # transmitted
    for ci in res.bonded:
        np.testing.assert_array_equal(res.bonded[ci], np.asarray(bonded[ci]))
    if strength:
        assert res.bonded[0].mean() < mask.mean()      # the interface broke


def test_paths_and_refusals():
    bodies, contacts = tcontact(n=12, nsteps=2)
    fused = {k: dataclasses.replace(t, kernel="fused")
             for k, t in bodies.items()}
    assert MultiBodyEngine(fused, contacts, device="cpu").path == "fused"
    # canonical needs a contact axis other than 0
    x_contact = tuple(dataclasses.replace(c, axis=0) for c in contacts)
    assert MultiBodyEngine(fused, x_contact, device="cpu",
                           canonical_layout=True).path == "fused"
    sweep = {k: dataclasses.replace(t, kernel="sweep")
             for k, t in bodies.items()}
    assert MultiBodyEngine(sweep, contacts, device="cpu").path == "sweep"
    basin = tbasin(n=9, nsteps=2)
    assert MultiBodyEngine(
        {k: dataclasses.replace(t, kernel="fused")
         for k, t in basin[0].items()}, basin[1], device="cpu",
        canonical_layout=True).path == "sweep"      # non-conforming
    b16 = {k: dataclasses.replace(t, mat_dtype="bf16")
           for k, t in fused.items()}
    eng = MultiBodyEngine(b16, contacts, device="cpu")
    assert all(m.dtype == torch.bfloat16 for m in eng._mstacks.values())
    with pytest.raises(TypeError, match="DomainMesh"):
        MultiBodyEngine(bodies, contacts, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="float32"):
        MultiBodyEngine(fused, contacts, device="cpu", dtype=torch.float64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiBodyEngine(bodies, contacts)


def test_sweep_path_and_snapshots_match_torch_path():
    """The per-sweep path (raw sweeps plus border and contact fixups) equals
    the plain path; snapshots fire every period-rounded cadence."""
    bodies, contacts = tcontact(n=12, nsteps=8)
    want = MultiBodyEngine(bodies, contacts, device="cpu").run()
    seen = []
    got = MultiBodyEngine({k: dataclasses.replace(t, kernel="sweep")
                           for k, t in bodies.items()}, contacts,
                          device="cpu").run(
        snapshot_cb=lambda n, us: seen.append((n, sorted(us))),
        snapshot_every=3)
    assert seen == [(4, ["lower", "upper"]), (8, ["lower", "upper"])]
    assert got.path == "sweep"
    for k in want.bodies:
        assert norm_err(got.bodies[k], want.bodies[k]) < 2e-6
