"""The two-step slab pass in the canonical contact order, and the per-sweep
kernel's binding, on the CPU.

- ``fused_step_slab_reference`` with the canonical pair (2, 0, 1) +
  (1, 0, 2) against JAX ``fused_step_slab`` in interpret mode. The JAX
  kernel sweeps (0, 1, 2) and its reverse only; its engines run the
  canonical order on a layout stored with z first (``permuted_model``, the
  state, materials, spacings and borders transposed), so the JAX side runs
  there and its result is transposed back. Held to the 2e-6 per-component
  normalized error the JAX tests hold the TPU kernels to, with a float32 and
  a bf16 stack.
- The per-sweep kernel keeps a cell's components in registers under a
  component map compiled for each model: its binding holds the runtime model
  to the compiled map and refuses a model it has no map for (with a
  stand-in library, since the CPU has none).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.models.spec import permuted_model
from gcm_tpu.ops.pallas_fused import fused_step_slab as jfused_step_slab
from gcm_tpu.ops.pallas_fused import stack_mats as jstack_mats
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops import fused as ofu
from gcm_tpu_torch.ops import sweep as osw
from gcm_tpu_torch.ops.fused import fused_step_slab_reference, stack_mats
from test_torch_step import borders_pair, norm_err, problem

H3 = (10.0, 12.0, 9.0)
CANON = ((2, 0, 1), (1, 0, 2))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_canonical_pair_reference_matches_jax_kernel(rng, order, bf16):
    model, ju, jmat, tu, tmat, dt = problem(rng, "elastic3d", (8, 12, 16),
                                            np.float32)
    jb, tb = borders_pair(3)
    perm = CANON[0]
    jms = jstack_mats(permuted_model(model, perm),
                      jax.tree.map(lambda x: jnp.transpose(x, perm), jmat),
                      compact=True)
    tms = stack_mats(get_model("elastic3d"), tmat)
    if bf16:
        jms, tms = jms.astype(jnp.bfloat16), tms.to(torch.bfloat16)
    want = jfused_step_slab(
        permuted_model(model, perm),
        jnp.transpose(ju, (0,) + tuple(1 + p for p in perm)), jms, dt,
        tuple(H3[p] for p in perm), order,
        {(perm.index(f[0]), f[1]): b for f, b in jb.items()},
        axes_seq=((0, 1, 2), (2, 1, 0)), interpret=True)
    inv = tuple(perm.index(d) for d in range(3))
    want = np.transpose(np.asarray(want), (0,) + tuple(1 + i for i in inv))
    got = fused_step_slab_reference(get_model("elastic3d"), tu, tms, dt, H3,
                                    order, tb, axes_seq=CANON)
    assert norm_err(got, want) < 2e-6


class _SweepMapLib:
    """Stands in for the kernel library's ``gcm_model_map``: fills
    the map of model ``name`` for every id it knows, optionally with one
    pair's velocity component moved."""

    def __init__(self, name, moved=False):
        self.name, self.moved = name, moved

    def gcm_model_map(self, model_id, addr):
        if model_id not in osw.STREAM_MODELS.values():
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
def test_sweep_binding_holds_the_model_to_the_compiled_map(name):
    model = get_model(name)
    assert osw.STREAM_MODELS[name] in range(4)
    # distinct live stand-ins: the check is remembered a model and library
    good, moved = _SweepMapLib(name), _SweepMapLib(name, moved=True)
    other = _SweepMapLib({"elastic3d": "acoustic3d", "acoustic3d": "elastic3d",
                          "elastic2d": "acoustic2d",
                          "acoustic2d": "elastic2d"}[name])
    ofu.check_compiled_map(good, model, "sweep_stage's kernel")
    for lib in (moved, other):
        with pytest.raises(RuntimeError, match="component map"):
            ofu.check_compiled_map(lib, model, "sweep_stage's kernel")


@pytest.mark.parametrize("name", ["elastic1d", "acoustic1d"])
def test_sweep_binding_refuses_a_model_without_a_map(name):
    """No per-sweep map is compiled for the 1D models: the binding raises
    before it asks the library."""
    with pytest.raises(ValueError, match="compiled for"):
        ofu.check_compiled_map(_SweepMapLib("elastic3d"), get_model(name),
                               "sweep_stage's kernel")
