"""Carry state of the JAX reference across to the port, through numpy.

Both packages then start from identical parameters: the six leaves of a
``gcm_tpu`` ``MaterialFields``, a state array and an engine's corrector aux
fields, handed over as numpy arrays (``np.asarray`` of the JAX arrays).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from gcm_tpu_torch.materials import MaterialFields

MATERIAL_LEAVES = ("cp", "cs", "zp", "zs", "kappa", "rho")


def _tensor(a, device, dtype) -> torch.Tensor:
    # a copy: arrays taken from JAX are read-only
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def material_fields_from_numpy(d: Mapping[str, np.ndarray], device="cpu",
                               dtype=torch.float32) -> MaterialFields:
    """The port's MaterialFields from the six leaves ``cp, cs, zp, zs,
    kappa, rho`` given as numpy arrays (taken as they are, not re-derived)."""
    return MaterialFields(**{k: _tensor(d[k], device, dtype)
                             for k in MATERIAL_LEAVES})


def state_from_numpy(u: np.ndarray, device="cpu",
                     dtype=torch.float32) -> torch.Tensor:
    """A state array ``[ncomp, *spatial]`` as a contiguous tensor."""
    return _tensor(u, device, dtype)


def aux_from_numpy(aux: Mapping[str, np.ndarray], device="cpu",
                   dtype: Optional[torch.dtype] = None
                   ) -> Dict[str, torch.Tensor]:
    """An engine's corrector aux fields (e.g. ``{"damage": d}``) as tensors,
    in the arrays' own dtype unless ``dtype`` is given."""
    return {k: torch.tensor(np.asarray(v), device=device, dtype=dtype)
            for k, v in aux.items()}
