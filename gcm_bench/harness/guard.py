"""The modules that no process of the benchmark may hold: JAX and its
companions, the JAX package and the scripts beside it. Names compare by
their top-level part whole: ``gcm_tpu_torch`` is not ``gcm_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gcm_tpu", "bench", "tools"})


def forbidden(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules this process holds)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
