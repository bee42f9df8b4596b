"""The port's fused 2D step module against the JAX package's 2D kernel.

``gcm_tpu.ops.pallas_fused.fused_step_2d`` runs in interpret mode on the
CPU (``bx=8``), as tests/test_pallas_fused.py runs it; the port's
``fused_step_2d`` on a CPU tensor runs its plain version,
``fused_step_2d_reference``. float32, held to the per-component normalized
max error of 2e-6 that the JAX tests hold the TPU kernel to. The CUDA
kernel itself is compared with its plain version on the card in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from gcm_tpu.ops.pallas_fused import fused_step_2d as jfused_step_2d
from gcm_tpu.ops.pallas_fused import stack_mats as jstack_mats
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops.fused import (
    fused_step, fused_step_2d, fused_step_2d_reference, stack_mats)
from test_torch_step import borders_pair, norm_err, problem


@pytest.mark.parametrize("name", ["elastic2d", "acoustic2d"])
@pytest.mark.parametrize("axes", [(0, 1), (1, 0)])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_fused_2d_reference_matches_jax_kernel(rng, name, axes, order):
    model, ju, jmat, tu, tmat, dt = problem(rng, name, (32, 24), np.float32)
    jb, tb = borders_pair(2)
    h = (10.0, 12.0)
    want = jfused_step_2d(model, ju, jstack_mats(model, jmat, compact=True),
                          dt, h, order, jb, axes, bx=8, interpret=True)
    tmodel = get_model(name)
    got = fused_step_2d_reference(tmodel, tu, stack_mats(tmodel, tmat), dt,
                                  h, order, tb, axes)
    assert norm_err(got, want) < 2e-6


def test_cpu_tensor_runs_plain_version(rng):
    """A CPU tensor never touches the kernel library: the wrapper returns
    the plain version's result (any extents: 37 is no multiple of 8) and
    the launch count stays put."""
    _, _, _, tu, tmat, dt = problem(rng, "elastic2d", (37, 11), np.float32)
    _, tb = borders_pair(2)
    model = get_model("elastic2d")
    ms = stack_mats(model, tmat)
    before = fused_step_2d.launches
    got = fused_step_2d(model, tu, ms, dt, (1.0, 2.0), 2, tb, (1, 0))
    want = fused_step_2d_reference(model, tu, ms, dt, (1.0, 2.0), 2, tb,
                                   (1, 0))
    assert fused_step_2d.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_steps_refuse_the_other_rank(rng):
    _, _, _, tu, tmat, dt = problem(rng, "elastic2d", (8, 8), np.float32)
    model = get_model("elastic2d")
    ms = stack_mats(model, tmat)
    with pytest.raises(ValueError, match="runs 3D"):
        fused_step(model, tu, ms, dt, (1.0, 1.0), 2)
    _, _, _, u3, mat3, dt3 = problem(rng, "elastic3d", (4, 4, 4), np.float32)
    model3 = get_model("elastic3d")
    with pytest.raises(ValueError, match="runs 2D"):
        fused_step_2d(model3, u3, stack_mats(model3, mat3), dt3,
                      (1.0, 1.0, 1.0), 2)
