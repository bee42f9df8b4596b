"""The port's per-sweep module against the JAX package's per-sweep kernel.

``gcm_tpu.ops.pallas_stage.pallas_stage`` runs in interpret mode on the
CPU (``cx=8``, ``pallas_call`` monkeypatched as tests/test_pallas.py does);
the port's ``sweep_stage`` on a CPU tensor runs its plain version,
``solver.gcm.stage``. float32, held to the per-component normalized max
error of 2e-6 that the JAX tests hold the TPU kernel to. The CUDA kernel
itself is compared with its plain version on the card in
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcm_tpu.ops.pallas_stage as ps
from gcm_tpu.materials import MaterialFields as JMaterialFields
from gcm_tpu.task import BorderSpec as JBorderSpec
from gcm_tpu_torch.convert import MATERIAL_LEAVES, material_fields_from_numpy
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.sweep import sweep_stage, sweep_step
from gcm_tpu_torch.solver.gcm import step
from gcm_tpu_torch.task import BorderSpec
from test_torch_step import borders_pair, norm_err, problem

#: the border set of tests/test_pallas.py (3D)
BORDERS_3D = (
    ((0, 0), "free", None), ((0, 1), "absorbing", None),
    ((1, 0), "fixed_force", 1e5), ((1, 1), "free", None),
    ((2, 0), "absorbing", None), ((2, 1), "fixed_velocity", (0.1, -0.2, 0.3)),
)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = ps.pl.pallas_call

    def wrapped(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", wrapped)


def _pair(faces):
    return ({f: JBorderSpec(k, v) for f, k, v in faces},
            {f: BorderSpec(k, v) for f, k, v in faces})


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("order", [1, 2])
def test_sweep_matches_jax_kernel_3d(rng, axis, order):
    model, ju, jmat, tu, tmat, dt = problem(rng, "elastic3d", (16, 16, 256),
                                            np.float32)
    jb, tb = _pair(BORDERS_3D)
    h = (1.0, 1.2, 0.9)
    want = ps.pallas_stage(model, ju, jmat, dt, h, axis, order, jb, cx=8)
    got = sweep_stage(get_model("elastic3d"), tu, tmat, dt, h, axis, order,
                      tb)
    assert norm_err(got, want) < 2e-6


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name", ["elastic2d", "acoustic2d"])
def test_sweep_matches_jax_kernel_2d(rng, name, axis):
    model, ju, jmat, tu, tmat, dt = problem(rng, name, (32, 256), np.float32)
    jb, tb = _pair([((a, s), k, None) for a in (0, 1)
                    for s, k in ((0, "free"), (1, "absorbing"))])
    h = (1.0, 1.3)
    want = ps.pallas_stage(model, ju, jmat, dt, h, axis, 2, jb, cx=8)
    got = sweep_stage(get_model(name), tu, tmat, dt, h, axis, 2, tb)
    assert norm_err(got, want) < 2e-6


def test_sweep_step_on_cpu_is_the_plain_step(rng):
    """A CPU tensor never touches the kernel library: ``sweep_step`` equals
    the plain step and the launch count stays put."""
    _, _, _, tu, tmat, dt = problem(rng, "elastic3d", (5, 6, 7), np.float32)
    _, tb = borders_pair(3)
    model = get_model("elastic3d")
    before = sweep_stage.launches
    got = sweep_step(model, tu, tmat, dt, (1.0, 2.0, 1.5), 3, tb, (2, 1, 0))
    want = step(model, tu, tmat, dt, (1.0, 2.0, 1.5), 3, tb, (2, 1, 0))
    assert sweep_stage.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sweep_refuses_1d(rng):
    jmat = JMaterialFields.from_arrays(np.full(8, 1e3), np.full(8, 1e9),
                                       np.full(8, 1e9), xp=jnp,
                                       dtype=np.float32)
    tmat = material_fields_from_numpy(
        {k: np.asarray(getattr(jmat, k)) for k in MATERIAL_LEAVES})
    with pytest.raises(ValueError, match="2D and 3D"):
        sweep_stage(get_model("elastic1d"), torch.zeros((2, 8)), tmat, 1e-4,
                    (1.0,), 0, 2)
