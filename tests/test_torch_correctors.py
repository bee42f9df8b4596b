"""The port's ODE correctors and folded epilogue against the JAX package.

- ``MaxwellCorrector`` and ``DamageCorrector`` against
  ``gcm_tpu.solver.correctors`` on the same numpy inputs in float64: the
  same elementwise arithmetic, so they agree to 1e-12.
- The corrector semantics of tests/test_correctors.py, on the port.
- ``fold_corrector_specs`` gives the JAX package's specs.
- The plain epilogue, through ``fused_step`` / ``fused_step_2d`` on CPU
  tensors, against the JAX fused kernels in interpret mode with
  ``correctors=``/``aux=``, over 3 steps in float32: state per-component
  normalized error under 2e-6; the damage aux to rtol 1e-5, atol 1e-6 (the
  atol absorbs threshold-crossing knife-edges in ``max(smax - thr, 0)``),
  the tolerances of tests/test_pallas_fused.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.ops.pallas_fused import fold_corrector_specs as jfold
from gcm_tpu.ops.pallas_fused import fused_step as jfused_step
from gcm_tpu.ops.pallas_fused import fused_step_2d as jfused_step_2d
from gcm_tpu.ops.pallas_fused import stack_mats as jstack_mats
from gcm_tpu.solver import correctors as jcorr
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.fused import (
    corrector_epilogue_reference, fold_corrector_specs, fused_step,
    fused_step_2d, stack_mats)
from gcm_tpu_torch.solver.correctors import (
    DamageCorrector, MaxwellCorrector, _diag_stress_indices,
    _shear_stress_indices)
from test_torch_step import borders_pair, norm_err, problem


def _state(rng, name, shape):
    model = get_model(name)
    u = rng.standard_normal((model.ncomp,) + shape)
    u[model.dim:] *= 1e6
    return model, u


@pytest.mark.parametrize("name", ["elastic3d", "elastic2d", "elastic1d",
                                  "acoustic2d"])
def test_stress_indices_match_jax(name):
    from gcm_tpu.models.spec import get_model as jget_model

    model, jmodel = get_model(name), jget_model(name)
    assert _diag_stress_indices(model) == jcorr._diag_stress_indices(jmodel)
    assert _shear_stress_indices(model) == jcorr._shear_stress_indices(jmodel)


@pytest.mark.parametrize("per_node", [False, True])
@pytest.mark.parametrize("name,shape", [("elastic3d", (4, 5, 6)),
                                        ("elastic2d", (7, 9))])
def test_maxwell_matches_jax_f64(rng, name, shape, per_node):
    model, u = _state(rng, name, shape)
    tau = 0.01 * (0.5 + rng.random(shape)) if per_node else 0.013
    dt = 0.004
    want, _ = jcorr.MaxwellCorrector(tau=tau)(model, jnp.asarray(u), {}, dt)
    got, aux = MaxwellCorrector(tau=torch.tensor(tau) if per_node else tau)(
        model, torch.tensor(u), {}, dt)
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("state_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,shape", [("elastic3d", (4, 5, 6)),
                                        ("elastic2d", (7, 9))])
def test_damage_matches_jax(rng, name, shape, state_dtype):
    """float64 state to 1e-12; a float32 state to f32 round-off. The aux
    starts float32 in both packages and promotes alike."""
    model, u = _state(rng, name, shape)
    u = u.astype(state_dtype)
    d0 = (0.3 * rng.random(shape)).astype(np.float32)
    jc = jcorr.DamageCorrector(threshold=5e5, rate=40.0)
    tc = DamageCorrector(threshold=5e5, rate=40.0)
    jaux = jc.init_aux(model, shape)
    taux = tc.init_aux(model, shape)
    assert taux["damage"].dtype == torch.float32
    assert np.asarray(jaux["damage"]).dtype == np.float32
    jaux = {"damage": jnp.asarray(d0)}
    taux = {"damage": torch.tensor(d0)}
    ju, tu = jnp.asarray(u), torch.tensor(u)
    for _ in range(3):
        ju, jaux = jc(model, ju, jaux, 0.004)
        tu, taux = tc(model, tu, taux, 0.004)
    assert np.asarray(jaux["damage"]).dtype == taux["damage"].numpy().dtype
    tol = 1e-12 if state_dtype == np.float64 else 1e-6
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=tol,
                               atol=tol * np.abs(u).max())
    np.testing.assert_allclose(taux["damage"].numpy(),
                               np.asarray(jaux["damage"]), rtol=tol,
                               atol=tol)
    assert taux["damage"].max() > d0.max()


def test_maxwell_relaxes_deviatoric_keeps_pressure():
    model = get_model("elastic3d")
    u = torch.zeros((9, 4, 4, 4))
    u[4] = 2.0                    # sxy
    for i in (3, 6, 8):           # sxx, syy, szz
        u[i] = 5.0
    out, _ = MaxwellCorrector(tau=0.1)(model, u, {}, dt=0.1)
    np.testing.assert_allclose(out[4].numpy(), 2.0 * np.exp(-1.0), rtol=1e-6)
    for i in (3, 6, 8):
        np.testing.assert_allclose(out[i].numpy(), 5.0, rtol=1e-6)
    assert float(out[:3].abs().max()) == 0.0
    assert float(u[4, 0, 0, 0]) == 2.0   # the input is left as it was


def test_damage_grows_only_in_tension_and_degrades_stress():
    model = get_model("elastic2d")
    u = torch.zeros((5, 2, 2))
    u[2, 0, 0] = 10.0             # tension above threshold at one node
    u[2, 1, 1] = -10.0            # compression elsewhere
    corr = DamageCorrector(threshold=1.0, rate=1.0)
    out, aux = corr(model, u, corr.init_aux(model, (2, 2)), dt=0.05)
    d = aux["damage"].numpy()
    assert d[0, 0] > 0.4 and d[1, 1] == 0.0
    assert float(out[2, 0, 0]) < 10.0 and float(out[2, 1, 1]) == -10.0


def test_damage_does_not_compound_when_frozen():
    """tests/test_correctors.py::test_damage_does_not_compound_when_frozen
    on the port: once d stops growing, repeated steps leave the stress as
    it is (the degradation is incremental, (1-d_new)/(1-d_old))."""
    model = get_model("elastic2d")
    u = torch.zeros((5, 2, 2))
    u[2, 0, 0] = 10.0
    u[3, 0, 0] = 4.0              # shear rides along
    corr = DamageCorrector(threshold=1.0, rate=1.0)
    aux = corr.init_aux(model, (2, 2))
    u1, aux = corr(model, u, aux, dt=0.05)
    d1 = float(aux["damage"][0, 0])
    assert 0.0 < d1 < 1.0
    np.testing.assert_allclose(float(u1[2, 0, 0]), 10.0 * (1 - d1), rtol=1e-6)
    out = u1.clone()
    out[2, 0, 0], out[3, 0, 0] = 0.5, 0.2
    for _ in range(5):
        out, aux = corr(model, out, aux, dt=0.05)
    assert float(aux["damage"][0, 0]) == pytest.approx(d1)
    np.testing.assert_allclose(float(out[2, 0, 0]), 0.5, rtol=1e-6)
    np.testing.assert_allclose(float(out[3, 0, 0]), 0.2, rtol=1e-6)
    out_full, _ = corr(model, u, {"damage": torch.ones((2, 2))}, dt=0.05)
    assert float(out_full[2, 0, 0]) == 0.0


@pytest.mark.parametrize("which", ["maxwell", "damage", "both", "per_node",
                                   "unknown", "none"])
def test_fold_corrector_specs_matches_jax(which):
    dt = 1.7e-4
    per_node = np.full((3, 3), 0.02)
    jsets = {"maxwell": (jcorr.MaxwellCorrector(tau=0.02),),
             "damage": (jcorr.DamageCorrector(threshold=5e5, rate=7.0),),
             "both": (jcorr.MaxwellCorrector(tau=50 * dt),
                      jcorr.DamageCorrector(threshold=5e5, rate=0.1 / dt)),
             "per_node": (jcorr.MaxwellCorrector(tau=jnp.asarray(per_node)),),
             "unknown": (jcorr.MaxwellCorrector(tau=0.02), object()),
             "none": ()}
    tsets = {"maxwell": (MaxwellCorrector(tau=0.02),),
             "damage": (DamageCorrector(threshold=5e5, rate=7.0),),
             "both": (MaxwellCorrector(tau=50 * dt),
                      DamageCorrector(threshold=5e5, rate=0.1 / dt)),
             "per_node": (MaxwellCorrector(tau=torch.tensor(per_node)),),
             "unknown": (MaxwellCorrector(tau=0.02), object()),
             "none": ()}
    assert fold_corrector_specs(tsets[which], dt) == jfold(jsets[which], dt)


def test_epilogue_with_aux_but_no_damage_keeps_aux(rng):
    model, u = _state(rng, "elastic2d", (4, 5))
    aux = torch.zeros((0, 4, 5))
    got, new_aux = corrector_epilogue_reference(
        model, (("maxwell", 0.5),), torch.tensor(u, dtype=torch.float32),
        aux, 0.1)
    assert new_aux.shape == aux.shape
    want, _ = MaxwellCorrector(tau=1.0 / np.log(2.0))(
        model, torch.tensor(u, dtype=torch.float32), {}, 1.0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,shape", [("elastic3d", (12, 16, 8)),
                                        ("elastic2d", (32, 24))])
def test_folded_epilogue_matches_jax_kernel(rng, name, shape):
    model, ju, jmat, tu, tmat, dt = problem(rng, name, shape, np.float32)
    tmodel = get_model(name)
    dim = model.dim
    h = (10.0, 11.0, 9.0)[:dim]
    jb, tb = borders_pair(dim)
    jspecs, jnaux = jfold((jcorr.MaxwellCorrector(tau=40 * dt),
                           jcorr.DamageCorrector(threshold=2e5,
                                                 rate=0.5 / dt)), dt)
    specs, naux = fold_corrector_specs(
        (MaxwellCorrector(tau=40 * dt),
         DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
    assert (specs, naux) == (jspecs, jnaux) and naux == 1
    jms = jstack_mats(model, jmat, compact=True)
    tms = stack_mats(tmodel, tmat)
    d0 = (0.2 * rng.random((1,) + shape)).astype(np.float32)
    gaux, jaux = torch.tensor(d0), jnp.asarray(d0)
    got, want = tu, ju
    launches = (fused_step.launches, fused_step_2d.launches)
    for n in range(3):
        axes = tuple(range(dim))[::(-1 if n % 2 else 1)]
        if dim == 3:
            want, jaux = jfused_step(model, want, jms, dt, h, 2, jb, axes,
                                     bx=4, by=8, interpret=True,
                                     correctors=jspecs, aux=jaux)
            got, gaux = fused_step(tmodel, got, tms, dt, h, 2, tb, axes,
                                   correctors=specs, aux=gaux)
        else:
            want, jaux = jfused_step_2d(model, want, jms, dt, h, 2, jb, axes,
                                        bx=8, interpret=True,
                                        correctors=jspecs, aux=jaux)
            got, gaux = fused_step_2d(tmodel, got, tms, dt, h, 2, tb, axes,
                                      correctors=specs, aux=gaux)
    assert (fused_step.launches, fused_step_2d.launches) == launches
    assert float(gaux.max()) > float(d0.max())
    assert norm_err(got, want) < 2e-6
    np.testing.assert_allclose(gaux.numpy(), np.asarray(jaux), rtol=1e-5,
                               atol=1e-6)


def test_damage_specs_need_aux(rng):
    _, _, _, tu, tmat, dt = problem(rng, "elastic2d", (8, 8), np.float32)
    model = get_model("elastic2d")
    ms = stack_mats(model, tmat)
    with pytest.raises(ValueError, match="aux"):
        fused_step_2d(model, tu, ms, dt, (1.0, 1.0), 2,
                      correctors=(("damage", 1e5, 1.0),))
    with pytest.raises(ValueError, match="aux"):
        fused_step_2d(model, tu, ms, dt, (1.0, 1.0), 2,
                      correctors=(("maxwell", 0.9),),
                      aux=torch.zeros((1, 8, 8)))
