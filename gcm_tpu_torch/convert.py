"""Carry state of the JAX reference across to the port, through numpy.

Both packages then start from identical parameters: the six leaves of a
``gcm_tpu`` ``MaterialFields`` (structured or per node) or the ten of an
``OrthotropicMaterialFields``, a state array, an
engine's corrector aux fields, on simplex meshes the foot tables and
``NodeBorders``, and for multi-body runs the contacts' bond masks and
non-conforming interface maps (structured and simplex), handed over as
numpy arrays (``np.asarray`` of the JAX arrays).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from gcm_tpu_torch.materials import MaterialFields, OrthotropicMaterialFields

MATERIAL_LEAVES = ("cp", "cs", "zp", "zs", "kappa", "rho")
ORTHO_LEAVES = ("rho", "c11", "c12", "c13", "c22", "c23", "c33", "c44",
                "c55", "c66")


def _tensor(a, device, dtype) -> torch.Tensor:
    # a copy: arrays taken from JAX are read-only
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def material_fields_from_numpy(d: Mapping[str, np.ndarray], device="cpu",
                               dtype=torch.float32) -> MaterialFields:
    """The port's MaterialFields from the six leaves ``cp, cs, zp, zs,
    kappa, rho`` given as numpy arrays (taken as they are, not re-derived)."""
    return MaterialFields(**{k: _tensor(d[k], device, dtype)
                             for k in MATERIAL_LEAVES})


def ortho_material_fields_from_numpy(d: Mapping[str, np.ndarray],
                                     device="cpu", dtype=torch.float32
                                     ) -> OrthotropicMaterialFields:
    """The port's OrthotropicMaterialFields from the ten leaves ``rho, c11
    .. c66`` given as numpy arrays (taken as they are)."""
    return OrthotropicMaterialFields(**{k: _tensor(d[k], device, dtype)
                                        for k in ORTHO_LEAVES})


def state_from_numpy(u: np.ndarray, device="cpu",
                     dtype=torch.float32) -> torch.Tensor:
    """A state array ``[ncomp, *spatial]`` as a contiguous tensor."""
    return _tensor(u, device, dtype)


def foot_tables_from_numpy(tables: Mapping) -> Dict:
    """The port's foot tables from a JAX ``build_foot_tables`` dict (same
    keys): ``ids``, float64 ``weights`` and ``outside`` as numpy arrays;
    the JAX package's compressed stencils are dropped."""
    from gcm_tpu_torch.grids.simplex import FootTables

    return {k: FootTables(ids=np.array(t.ids, np.int32),
                          weights=np.array(t.weights, np.float64),
                          outside=np.array(t.outside, bool))
            for k, t in tables.items()}


def node_borders_from_numpy(kind: np.ndarray, value: np.ndarray):
    """The port's NodeBorders from a JAX ``NodeBorders``' ``kind`` and
    ``value`` arrays."""
    from gcm_tpu_torch.solver.simplex_gcm import NodeBorders

    return NodeBorders(kind=np.array(kind, np.int32),
                       value=np.array(value, np.float64))


def aux_from_numpy(aux: Mapping[str, np.ndarray], device="cpu",
                   dtype: Optional[torch.dtype] = None
                   ) -> Dict[str, torch.Tensor]:
    """An engine's corrector aux fields (e.g. ``{"damage": d}``) as tensors,
    in the arrays' own dtype unless ``dtype`` is given."""
    return {k: torch.tensor(np.asarray(v), device=device, dtype=dtype)
            for k, v in aux.items()}


def bonded_from_numpy(bonded: Mapping[int, object], device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Dict[int, object]:
    """A multi-body engine's bond masks: per contact index a mask, or for a
    non-conforming contact the per-side dict ``{"a": .., "b": ..}``."""
    def one(m):
        return torch.tensor(np.asarray(m), device=device, dtype=dtype)

    return {int(k): ({s: one(v) for s, v in m.items()}
                     if isinstance(m, Mapping) else one(m))
            for k, m in bonded.items()}


def interface_maps_from_numpy(maps):
    """The port's InterfaceMaps from a JAX ``InterfaceMaps`` (or anything
    with its fields): per side ``lo``, ``span`` and the per-axis tables'
    ``idx`` and ``w`` arrays, copied."""
    from gcm_tpu_torch.solver.contact_nc import (
        AxisMap, InterfaceMaps, SideMaps)

    def side(sm):
        return SideMaps(lo=tuple(int(v) for v in sm.lo),
                        span=tuple(int(v) for v in sm.span),
                        from_other=tuple(
                            AxisMap(idx=np.array(m.idx, np.int32),
                                    w=np.array(m.w, np.float64))
                            for m in sm.from_other))

    return InterfaceMaps(a=side(maps.a), b=side(maps.b))


def simplex_interface_maps_from_numpy(maps):
    """The port's SimplexInterfaceMaps from a JAX ``SimplexInterfaceMaps``
    (or anything with its fields): ``idx_*`` and ``nbr_*`` as int32,
    ``w_*`` as float64 numpy arrays, copied."""
    from gcm_tpu_torch.solver.simplex_contact import SimplexInterfaceMaps

    return SimplexInterfaceMaps(
        **{f: np.array(getattr(maps, f), np.int32)
           for f in ("idx_a", "idx_b", "nbr_a", "nbr_b")},
        **{f: np.array(getattr(maps, f), np.float64) for f in ("w_a", "w_b")})
