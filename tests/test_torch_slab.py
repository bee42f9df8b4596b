"""The port's slab step, bf16 stacks and temporal blocking against JAX.

``gcm_tpu.ops.pallas_fused.fused_step_slab`` and ``fused_step_2d`` run in
interpret mode on the CPU, as tests/test_bf16_mats.py runs them; the port's
plain versions (``fused_step_slab_reference``, ``fused_step_2d_reference``)
take the same float32 inputs: a float32 or bf16 stack, one step or an
``axes_seq`` pair, and Maxwell + damage folded. Held to the per-component
normalized max error of 2e-6 that the JAX tests hold the TPU kernels to, the
damage aux to rtol 1e-5 / atol 1e-6. The bf16 contract of tests/
test_bf16_mats.py is held on the port's own steps, and the Engine's knobs
(``mat_dtype``, ``temporal_block``, ``canonical_layout``) against the JAX
Engine's jnp path. The CUDA kernels are compared with these plain versions
on the card in tests/test_torch_gpu.py.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.engine import Engine as JEngine
from gcm_tpu.materials import IsotropicMaterial as JIsotropicMaterial
from gcm_tpu.ops.pallas_fused import fold_corrector_specs as jfold
from gcm_tpu.ops.pallas_fused import fused_step_2d as jfused_step_2d
from gcm_tpu.ops.pallas_fused import fused_step_slab as jfused_step_slab
from gcm_tpu.ops.pallas_fused import stack_mats as jstack_mats
from gcm_tpu.scenarios import get_scenario as jget_scenario
from gcm_tpu.solver import correctors as jcorr
from gcm_tpu.task import (
    AreaAll as JAreaAll, BorderSpec as JBorderSpec, GridSpec as JGridSpec,
    InitialCondition as JInitialCondition, Task as JTask,
    TimeSpec as JTimeSpec)
from gcm_tpu_torch.engine import Engine
from gcm_tpu_torch.materials import IsotropicMaterial, MaterialFields
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.fused import (
    fold_corrector_specs, fused_step, fused_step_2d, fused_step_2d_reference,
    fused_step_slab, fused_step_slab_reference, norm_axes_seq, stack_mats)
from gcm_tpu_torch.scenarios import get_scenario
from gcm_tpu_torch.solver import correctors as tcorr
from gcm_tpu_torch.task import (
    AreaAll, BorderSpec, GridSpec, InitialCondition, Task, TimeSpec)
from test_torch_step import borders_pair, norm_err, problem

H3 = (10.0, 12.0, 9.0)


def _stacks(jmodel, jmat, tmat, bf16):
    jms = jstack_mats(jmodel, jmat, compact=True)
    tms = stack_mats(get_model(jmodel.name), tmat,
                     dtype=torch.bfloat16 if bf16 else None)
    return (jms.astype(jnp.bfloat16) if bf16 else jms), tms


@pytest.mark.parametrize("variant", ["f32", "bf16", "axes_seq"])
@pytest.mark.parametrize("order", [1, 2])
def test_slab_reference_matches_jax_kernel(rng, order, variant):
    model, ju, jmat, tu, tmat, dt = problem(rng, "elastic3d", (8, 16, 8),
                                            np.float32)
    jb, tb = borders_pair(3)
    bf16 = variant == "bf16"
    kw = (dict(axes_seq=((0, 1, 2), (2, 1, 0))) if variant == "axes_seq"
          else dict(axes=(2, 1, 0)))
    jms, tms = _stacks(model, jmat, tmat, bf16)
    assert tms.dtype == (torch.bfloat16 if bf16 else torch.float32)
    want = jfused_step_slab(model, ju, jms, dt, H3, order, jb, interpret=True,
                            **kw)
    got = fused_step_slab_reference(get_model("elastic3d"), tu, tms, dt, H3,
                                    order, tb, **kw)
    assert norm_err(got, want) < 2e-6


@pytest.mark.parametrize("bf16", [False, True])
def test_slab_reference_folds_correctors_as_jax(rng, bf16):
    model, ju, jmat, tu, tmat, dt = problem(rng, "elastic3d", (8, 16, 8),
                                            np.float32)
    jb, tb = borders_pair(3)
    jms, tms = _stacks(model, jmat, tmat, bf16)
    jspecs, _ = jfold((jcorr.MaxwellCorrector(tau=40 * dt),
                       jcorr.DamageCorrector(threshold=2e5, rate=0.5 / dt)),
                      dt)
    tspecs, naux = fold_corrector_specs(
        (tcorr.MaxwellCorrector(tau=40 * dt),
         tcorr.DamageCorrector(threshold=2e5, rate=0.5 / dt)), dt)
    assert tspecs == jspecs and naux == 1
    d0 = (0.3 * rng.random((1, 8, 16, 8))).astype(np.float32)
    want, waux = jfused_step_slab(model, ju, jms, dt, H3, 2, jb, (0, 1, 2),
                                  interpret=True, correctors=jspecs,
                                  aux=jnp.asarray(d0))
    got, gaux = fused_step_slab(get_model("elastic3d"), tu, tms, dt, H3, 2,
                                tb, (0, 1, 2), correctors=tspecs,
                                aux=torch.tensor(d0))
    assert norm_err(got, want) < 2e-6
    assert gaux.max() > d0.max()
    np.testing.assert_allclose(gaux.numpy(), np.asarray(waux), rtol=1e-5,
                               atol=1e-6)


#: one 2D step along (1, 0), and two steps a pass in every pair of the two
#: sweep orders
SEQS_2D = [((1, 0),)] + list(itertools.product(((0, 1), (1, 0)), repeat=2))


@pytest.mark.parametrize("seq", SEQS_2D, ids=str)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_2d_reference_matches_jax_kernel(rng, order, bf16, seq):
    model, ju, jmat, tu, tmat, dt = problem(rng, "elastic2d", (16, 24),
                                            np.float32)
    jb, tb = borders_pair(2)
    jms, tms = _stacks(model, jmat, tmat, bf16)
    kw = dict(axes_seq=seq) if len(seq) == 2 else dict(axes=seq[0])
    want = jfused_step_2d(model, ju, jms, dt, (10.0, 12.0), order, jb, bx=8,
                          interpret=True, **kw)
    got = fused_step_2d_reference(get_model("elastic2d"), tu, tms, dt,
                                  (10.0, 12.0), order, tb, **kw)
    assert norm_err(got, want) < 2e-6


def _bf16_problem(rng, shape, exact):
    """Random heterogeneous media, or (``exact``) bf16-representable ones
    (rho, cs, cp powers of two, kappa 1/2), as tests/test_bf16_mats.py."""
    dim = len(shape)
    model = get_model(f"elastic{dim}d")
    if exact:
        rho, cs, cp = (np.full(shape, v) for v in (1024.0, 1024.0, 2048.0))
        mu = rho * cs ** 2
        lam = rho * cp ** 2 - 2 * mu
    else:
        rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
        mu = 1e9 * (0.5 + rng.random(shape))
        lam = 1e9 * (1.0 + rng.random(shape))
    mat = MaterialFields.from_arrays(rho, lam, mu)
    u0 = rng.standard_normal((model.ncomp,) + shape)
    u0[dim:] *= 1e6
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    return model, torch.tensor(u0, dtype=torch.float32), mat, dt


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_bf16_deviation_is_rounding_level(rng, dim, exact):
    shape = (16, 16, 8)[:dim] if dim == 3 else (16, 16)
    model, u, mat, dt = _bf16_problem(rng, shape, exact)
    h = (1.0,) * dim
    ms = stack_mats(model, mat)
    ms16 = stack_mats(model, mat, dtype=torch.bfloat16)
    assert ms16.dtype == torch.bfloat16 and ms16.is_contiguous()
    # torch rounds to nearest even, as the card's __float2bfloat16 does
    assert torch.equal(ms16, ms.to(torch.bfloat16))
    fn = fused_step if dim == 3 else fused_step_2d
    f32 = fn(model, u, ms, dt, h, 2)
    b16 = fn(model, u, ms16, dt, h, 2)
    rel = float((b16 - f32).abs().max() / (f32.abs().max() + 1e-30))
    if exact:
        assert torch.equal(ms16.float(), ms) and rel < 1e-6
    else:
        assert 0.0 < rel < 3e-2


def test_wrappers_route_and_refuse(rng):
    """fused_step hands bf16 stacks and two-step sequences to the slab step;
    folded correctors with two steps, damage without aux and bad sequences
    raise, as in JAX."""
    model, u, mat, dt = _bf16_problem(rng, (6, 7, 5), False)
    ms16 = stack_mats(model, mat, dtype=torch.bfloat16)
    h = (1.0, 1.0, 1.0)
    seq = ((2, 0, 1), (1, 0, 2))
    assert norm_axes_seq(None, seq, 3) == seq
    assert norm_axes_seq((1, 2, 0), None, 3) == ((1, 2, 0),)
    torch.testing.assert_close(
        fused_step(model, u, ms16, dt, h, 2, axes_seq=seq),
        fused_step_slab_reference(model, u, ms16, dt, h, 2, axes_seq=seq),
        rtol=0, atol=0)
    specs = (("maxwell", 0.5),)
    with pytest.raises(ValueError, match="single step"):
        fused_step_slab(model, u, ms16, dt, h, 2, axes_seq=seq,
                        correctors=specs)
    with pytest.raises(ValueError, match="single step"):
        fused_step_2d(get_model("elastic2d"), u[:5, :, :, 0],
                      ms16[:, :, :, 0], dt, h[:2], 2,
                      axes_seq=((0, 1), (1, 0)), correctors=specs)
    with pytest.raises(ValueError, match="aux"):
        fused_step_slab(model, u, ms16, dt, h, 2,
                        correctors=(("damage", 1e5, 1.0),))
    with pytest.raises(ValueError, match="either"):
        fused_step_slab(model, u, ms16, dt, h, 2, axes=(0, 1, 2),
                        axes_seq=seq)
    with pytest.raises(ValueError, match="order"):
        fused_step_slab(model, u, ms16, dt, h, 2, axes_seq=((0, 0, 1),))
    # the kernels run one or two steps a pass; a CPU tensor is refused the
    # same, though the plain version could run more
    with pytest.raises(ValueError, match="one or two steps"):
        fused_step_slab(model, u, ms16, dt, h, 2, axes_seq=seq + seq[:1])


# ------------------------------------------------------------------ engines

@pytest.mark.parametrize("nsteps", [4, 5])
def test_temporal_block_matches_jax_engine(nsteps):
    """The pair-fused body (a two-step pass per symmetrized pair, a
    single step for an odd tail) against the JAX jnp engine."""
    jtask = dataclasses.replace(
        jget_scenario("elastic3d_layered", n=24, nsteps=nsteps),
        detectors=None)
    task = dataclasses.replace(
        get_scenario("elastic3d_layered", n=24, nsteps=nsteps),
        detectors=None, kernel="fused", temporal_block=True)
    want = JEngine(jtask, dtype=jnp.float32).run()
    eng = Engine(task, device="cpu")
    assert eng._pair_fused
    got = eng.run()
    assert norm_err(got.u, want.u) < 1e-5 and np.abs(got.u).max() > 0
    assert not Engine(dataclasses.replace(
        task, detectors=get_scenario("elastic3d_layered").detectors),
        device="cpu")._pair_fused                       # a receiver
    assert not Engine(dataclasses.replace(task, kernel="torch"),
                      device="cpu")._pair_fused         # no fused stack


def _grid_task(pkg, shape, canonical):
    """A smooth stress bump on a uniform grid of ``shape``, for the JAX
    package (``pkg="jax"``) or the port (its fused kernel)."""
    if pkg == "jax":
        M, G, IC, A, B, TS, T = (JIsotropicMaterial, JGridSpec,
                                 JInitialCondition, JAreaAll, JBorderSpec,
                                 JTimeSpec, JTask)
        kw = {}
    else:
        M, G, IC, A, B, TS, T = (IsotropicMaterial, GridSpec,
                                 InitialCondition, AreaAll, BorderSpec,
                                 TimeSpec, Task)
        kw = {"kernel": "fused"}
    dim = len(shape)
    c = [0.5 * (n - 1) for n in shape]

    def bump(*X):
        return 1e6 * np.exp(-sum((x - ci) ** 2 for x, ci in zip(X, c)) / 8)

    return T(name="canon", model=f"elastic{dim}d",
             grid=G(shape=shape, h=(1.0,) * dim),
             default_material=M.from_speeds(rho=2000.0, cp=3000.0, cs=1700.0),
             initial=(IC(A(), values={"sxx": bump, "syy": bump}),),
             borders={(a, s): B("free" if s else "absorbing")
                      for a in range(dim) for s in (0, 1)},
             time=TS(cfl=0.8, nsteps=3), order=2,
             canonical_layout=canonical, **kw)


@pytest.mark.parametrize("shape,fwd", [((128, 8, 12), (1, 2, 0)),
                                       ((128, 24), (1, 0))])
def test_canonical_layout_matches_jax_engine(shape, fwd):
    """The canonical splitting order, run as axes in task layout, against
    the JAX engine's permuted storage (the jnp path; the JAX permutation
    engages on any kernel)."""
    jtask = _grid_task("jax", shape, True)
    task = _grid_task("torch", shape, True)
    jeng = JEngine(jtask, dtype=jnp.float32)
    assert jeng._perm == fwd
    want = jeng.run()
    eng = Engine(task, device="cpu")
    assert eng._fwd == fwd
    assert eng._fused_fn is (fused_step_slab if len(shape) == 3
                             else fused_step_2d)
    got = eng.run()
    assert norm_err(got.u, want.u) < 1e-5 and np.abs(got.u).max() > 0
    # the default order differs measurably: the canonical one is not a no-op
    plain = Engine(dataclasses.replace(task, canonical_layout=False),
                   device="cpu").run()
    assert norm_err(plain.u, want.u) > 1e-5


def test_mat_dtype_flows_to_the_stacks():
    # n=24: at n=16 the scenario's initial ball holds no node
    task = dataclasses.replace(get_scenario("elastic3d_layered", n=24,
                                            nsteps=2), kernel="fused",
                               mat_dtype="bf16")
    eng = Engine(task, device="cpu")
    assert eng._mstack.dtype == torch.bfloat16
    f32 = Engine(dataclasses.replace(task, mat_dtype="f32"), device="cpu")
    assert f32._mstack.dtype == torch.float32
    rel = norm_err(eng.run().u, f32.run().u)
    assert 0.0 < rel < 3e-2
    with pytest.raises(ValueError, match="mat_dtype"):
        dataclasses.replace(task, mat_dtype="bf16 ")
