"""NumPy oracles of the GCM physics (isotropic and orthotropic)."""

from gcm_tpu_torch.oracle.oracle import (  # noqa: F401
    oracle_run, oracle_stage, oracle_step,
)
