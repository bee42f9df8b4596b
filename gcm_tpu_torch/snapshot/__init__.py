"""Snapshots and seismograms: VTK XML files and detector traces.

Counterpart of ``gcm_tpu/snapshot``: host-side numpy writers whose files are
byte-identical to the JAX package's on the same arrays.
"""

from gcm_tpu_torch.snapshot.seismo import save_seismograms  # noqa: F401
from gcm_tpu_torch.snapshot.vtk import (  # noqa: F401
    snapshot_fields, write_pvd, write_vti, write_vtu,
)
