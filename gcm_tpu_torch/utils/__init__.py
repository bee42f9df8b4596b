"""Host-side utilities: checkpoints, energy, Jacobians, profiling.

Counterpart of ``gcm_tpu/utils`` (its ``backend.py``, the TPU and
interpret-mode plumbing, has no counterpart here).
"""
