"""The fused steps on one shard of a domain-decomposed grid.

Counterpart of the kernels of ``gcm_tpu/parallel/fused_spmd.py``
(``_make_interior_call``, ``_make_ring_call``, ``_make_2d_spmd_call``). A
shard's block is cut into the kernels' output tiles; the **interior** tiles
are those whose r-haloed window lies inside the block, the **ring** tiles
all others (:func:`tile_split`). A 3D tile is one x plane by ``TILE_3D[1]``
y rows (the kernel walks x plane by plane), so the 3D ring is r planes
thick along x and one tile along y; a 2D tile is ``TILE_2D`` = 1 x row
(the kernel walks x row by row), so the 2D ring is the r rows at each x
face. The
interior launch reads only the local block and the materials, so it runs
while the halo slabs travel; the ring launch reads the slabs and writes
its tiles into the interior launch's output buffer. Materials come from
the shard's halo-extended stack (``parallel.fused_spmd.extended_mstack``),
compact or orthotropic (the layout follows the stack's height,
``ops.fused.infer_layout``).

The kernels are CUDA C++ for Hopper: ``csrc/fused_spmd.cu`` (3D) and
``csrc/fused_spmd_2d.cu`` (2D, split along x only), compiled for the
component maps of ``ops.fused.STREAM_MODELS``. Each wrapper launches
its kernel for a CUDA tensor (or raises) and runs its plain version,
``*_reference`` below, for a CPU tensor. The plain versions run the port's
``fused_step_reference`` on the block extended by the received slab where
the shard has a neighbour and left as it is where the shard sits on a
domain face (edge replication then reproduces the global edge, and that
side keeps its border condition; a side with a neighbour takes none), crop
the extension, and keep the cells of the interior or the ring tiles.

``fused_spmd_interior.launches``, ``fused_spmd_ring.launches`` and
``fused_spmd_2d.launches`` count kernel launches (``fused_spmd_2d.
ring_launches`` those of its ring mode); the 3D launches also count their
body (``ops.fused.count_stream_body``) while a recording is on.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.fused import (
    _MAXC, _MAXP, _MAXSPEC, _MAXZ, _Params, _params, check_compiled_map,
    corrector_epilogue_reference, count_stream_body, fused_step_reference,
    infer_layout,
)
from gcm_tpu_torch.ops.interp import stencil_radius
from gcm_tpu_torch.solver.correctors import _diag_stress_indices
from gcm_tpu_torch.task import BorderSpec

Borders = Dict[Tuple[int, int], BorderSpec]

#: the kernels' output tiles along x and y (3D: one plane by 8 rows) and
#: along x (2D: one row); the binding checks them against
#: csrc/fused_spmd*.cu at load
TILE_3D = (1, 8)
TILE_2D = 1


# ------------------------------------------------------------------ tiling

def tile_split(n: int, tile: int, r: int) -> Tuple[int, int, int]:
    """``(ntiles, i0, i1)`` along one axis of extent ``n``: ceil(n / tile)
    tiles, the last one ragged, of which ``[i0, i1)`` are interior (their
    r-haloed window lies inside the block); ``(ntiles, 0, 0)`` if none."""
    nt = -(-n // tile)
    i0, i1 = -(-r // tile), (n - r) // tile
    return (nt, i0, i1) if i1 > i0 else (nt, 0, 0)


def split_3d(nxl: int, nyl: int, r: int, tile=TILE_3D) -> Tuple[int, ...]:
    """``(ntx, nty, ix0, ix1, iy0, iy1)``: the shard's tile grid and its
    interior rectangle (empty, all 0, unless interior along both axes)."""
    ntx, ix0, ix1 = tile_split(nxl, tile[0], r)
    nty, iy0, iy1 = tile_split(nyl, tile[1], r)
    if ix1 == 0 or iy1 == 0:
        ix0 = ix1 = iy0 = iy1 = 0
    return ntx, nty, ix0, ix1, iy0, iy1


def interior_mask(shape: Sequence[int], r: int, tile=TILE_3D,
                  device="cpu") -> torch.Tensor:
    """Boolean mask over the block's x/y cells (x only in 2D) of the interior
    tiles."""
    mask = torch.zeros(tuple(shape[:len(tile)]), dtype=torch.bool,
                       device=device)
    if len(tile) == 2:
        _, _, ix0, ix1, iy0, iy1 = split_3d(shape[0], shape[1], r, tile)
        mask[ix0 * tile[0]:ix1 * tile[0], iy0 * tile[1]:iy1 * tile[1]] = True
    else:
        _, ix0, ix1 = tile_split(shape[0], tile[0], r)
        mask[ix0 * tile[0]:ix1 * tile[0]] = True
    return mask


def _keep(mask: torch.Tensor, new: torch.Tensor,
          base: torch.Tensor) -> torch.Tensor:
    """``base`` with the cells under ``mask`` (over its leading spatial
    axes) taken from ``new``, written in place."""
    m = mask.reshape((1,) + tuple(mask.shape)
                     + (1,) * (base.ndim - 1 - mask.ndim))
    return base.copy_(torch.where(m, new, base))


# ---------------------------------------------------------- plain versions

def _gated(borders: Optional[Borders], flags: Sequence[int],
           dim: int) -> Borders:
    """The border conditions of one shard's step: those of the last axis
    always; those of the split axes only on the sides where ``flags`` say
    the shard sits on the domain face."""
    out = {}
    for (a, side), bc in (borders or {}).items():
        if a == dim - 1 or (2 * a + side < len(flags) and flags[2 * a + side]):
            out[(a, side)] = bc
    return out


def fused_spmd_interior_reference(model: Model, u: torch.Tensor,
                                  mext: torch.Tensor, dt: float,
                                  h: Sequence[float], order: int,
                                  borders: Optional[Borders] = None,
                                  axes: Optional[Sequence[int]] = None,
                                  correctors=None,
                                  aux: Optional[torch.Tensor] = None,
                                  out: Optional[torch.Tensor] = None,
                                  aux_out: Optional[torch.Tensor] = None,
                                  tile=TILE_3D):
    """Plain version of the 3D interior kernel: the step of the local block
    with its z borders only, kept on the interior tiles' cells of ``out``
    (zeros if None). Returns ``out``, or ``(out, aux_out)`` with ``aux``."""
    r = stencil_radius(order)
    res = fused_step_reference(model, u, mext[:, r:-r, r:-r], dt, h, order,
                               _gated(borders, (0, 0, 0, 0), 3), axes,
                               correctors, aux)
    mask = interior_mask(u.shape[1:], r, tile, u.device)
    if aux is None:
        return _keep(mask, res, torch.zeros_like(u) if out is None else out)
    out = _keep(mask, res[0], torch.zeros_like(u) if out is None else out)
    aux_out = _keep(mask, res[1],
                    torch.zeros_like(aux) if aux_out is None else aux_out)
    return out, aux_out


def _extended_step(model: Model, u: torch.Tensor, mext: torch.Tensor,
                   slabs, flags: Sequence[int], dt: float,
                   h: Sequence[float], order: int, borders: Optional[Borders],
                   axes, dim: int) -> torch.Tensor:
    """The whole step of one shard from its block and received slabs,
    cropped back to the block (no correctors)."""
    r = stencil_radius(order)
    nxl = u.shape[1]
    lo_x, hi_x = r * (1 - flags[0]), r * (1 - flags[1])
    ue = torch.cat(([slabs[0]] if lo_x else []) + [u]
                   + ([slabs[1]] if hi_x else []), dim=1)
    xs = slice(r - lo_x, r + nxl + hi_x)
    ms = mext[:, xs]
    lo_y = hi_y = 0
    if dim == 3:
        nyl = u.shape[2]
        lo_y, hi_y = r * (1 - flags[2]), r * (1 - flags[3])
        ue = torch.cat(([slabs[2][:, xs]] if lo_y else []) + [ue]
                       + ([slabs[3][:, xs]] if hi_y else []), dim=2)
        ms = ms[:, :, r - lo_y:r + nyl + hi_y]
    res = fused_step_reference(model, ue, ms.contiguous(), dt, h, order,
                               _gated(borders, flags, dim), axes)
    res = res[:, lo_x:lo_x + nxl]
    return res[:, :, lo_y:lo_y + u.shape[2]] if dim == 3 else res


def fused_spmd_ring_reference(model: Model, u: torch.Tensor,
                              mext: torch.Tensor, slabs, flags,
                              base: torch.Tensor, dt: float,
                              h: Sequence[float], order: int,
                              borders: Optional[Borders] = None,
                              axes: Optional[Sequence[int]] = None,
                              correctors=None,
                              aux: Optional[torch.Tensor] = None,
                              base_aux: Optional[torch.Tensor] = None,
                              tile=TILE_3D):
    """Plain version of the 3D ring kernel: the step of the block extended by
    the slabs ``(xlo, xhi, ylo, yhi)`` on the sides with a neighbour
    (``flags``: 1 where the shard sits on the x-lo, x-hi, y-lo, y-hi domain
    face), then the folded correctors, written on the ring tiles' cells of
    ``base`` (and ``base_aux``) in place. Returns ``base``, or ``(base,
    base_aux)`` with ``aux``."""
    res = _extended_step(model, u, mext, slabs, flags, dt, h, order, borders,
                         axes, 3)
    res, new_aux = corrector_epilogue_reference(model, correctors or (), res,
                                                aux, dt)
    ring = ~interior_mask(u.shape[1:], stencil_radius(order), tile, u.device)
    base = _keep(ring, res, base)
    if aux is None:
        return base
    return base, _keep(ring, new_aux, base_aux)


def fused_spmd_2d_reference(model: Model, u: torch.Tensor,
                            mext: torch.Tensor, dt: float,
                            h: Sequence[float], order: int,
                            borders: Optional[Borders] = None,
                            axes: Optional[Sequence[int]] = None,
                            which: str = "interior", slabs=None, flags=None,
                            base: Optional[torch.Tensor] = None,
                            tile: int = TILE_2D) -> torch.Tensor:
    """Plain version of the 2D kernel, ``which="interior"`` (the step of the
    local block with its y borders only, kept on the interior x-tiles of
    ``base``, zeros if None) or ``"ring"`` (the step of the block extended
    by the slabs ``(xlo, xhi)`` where ``flags`` (x-lo, x-hi face) say there
    is a neighbour, kept on the other x-tiles of ``base``, in place)."""
    r = stencil_radius(order)
    base = torch.zeros_like(u) if base is None else base
    inner = interior_mask(u.shape[1:], r, (tile,), u.device)
    if which == "interior":
        res = fused_step_reference(model, u, mext[:, r:-r], dt, h, order,
                                   _gated(borders, (0, 0), 2), axes)
        return _keep(inner, res, base)
    res = _extended_step(model, u, mext, slabs, flags, dt, h, order, borders,
                         axes, 2)
    return _keep(~inner, res, base)


# ------------------------------------------------------------------ kernels

def _check(model: Model, dim: int, u: torch.Tensor, mext: torch.Tensor,
           order: int, axes, specs, tensors) -> int:
    """Raise on anything the kernels do not take; returns r."""
    if model.dim != dim or u.ndim != dim + 1:
        raise ValueError(f"this kernel runs {dim}D models on [C, {dim} "
                         "spatial axes] state")
    if u.shape[0] != model.ncomp or model.ncomp > _MAXC:
        raise ValueError(f"state has {u.shape[0]} components, "
                         f"{model.name} has {model.ncomp}")
    if any(len(st.pairs) > _MAXP or len(st.zeros) > _MAXZ
           for st in model.stages):
        raise ValueError(f"{model.name}: too many pairs or zeros per sweep")
    if order not in (1, 2, 3, 4):
        raise ValueError(f"unsupported interpolation order {order}")
    r = stencil_radius(order)
    if min(u.shape[1:dim]) < r:
        raise ValueError(f"per-shard extents {tuple(u.shape[1:])} smaller "
                         f"than the stencil radius {r}")
    ext = (mext.shape[0],) + tuple(
        n + 2 * r if a < dim - 1 else n for a, n in enumerate(u.shape[1:]))
    infer_layout(model, mext.shape[0])
    if tuple(mext.shape) != ext:
        raise ValueError(f"mext shape {tuple(mext.shape)} is not the "
                         f"extended stack {ext}")
    if sorted(axes) != list(range(dim)):
        raise ValueError(f"axes {axes} is not an order of the {dim} axes")
    if len(specs) > _MAXSPEC:
        raise ValueError(f"at most {_MAXSPEC} folded correctors")
    if any(s[0] == "damage" for s in specs) and not _diag_stress_indices(model):
        raise ValueError(f"{model.name} has no normal stresses to damage")
    if mext.dtype not in ((torch.float32, torch.bfloat16) if dim == 2
                          else (torch.float32,)):
        raise TypeError(f"the {dim}D SPMD kernel takes a "
                        f"{'float32 or bfloat16' if dim == 2 else 'float32'}"
                        " stack")
    for t in [u, mext] + [t for t in tensors if t is not None]:
        if t.dtype != torch.float32 and t is not mext:
            raise TypeError("the SPMD kernels take float32 tensors")
        if t.device != u.device:
            raise ValueError("the shard's tensors lie on different devices")
        if not t.is_contiguous():
            raise ValueError("the SPMD kernels take contiguous tensors")
    return r


def _lib():
    lib = _build.load()
    if ctypes.sizeof(_Params) != lib.gcm_params_size():
        raise RuntimeError("GcmFusedParams layout differs from its binding")
    if ((lib.gcm_fused_spmd_tile(0), lib.gcm_fused_spmd_tile(1)) != TILE_3D
            or lib.gcm_fused_spmd_2d_tile() != TILE_2D):
        raise RuntimeError("the SPMD kernels' tiles differ from TILE_3D/2D")
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise(lib, entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err} "
                           f"({lib.gcm_error_string(err).decode()})")


def _device_ok(u: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if u.device.type == "cpu":
        return False
    if u.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for device {u.device}")
    return True


def _launch_3d(model, u, mext, dt, h, order, borders, axes, correctors,
               aux, out, aux_out, slabs, flags, ring: bool):
    axes = tuple(axes) if axes is not None else (0, 1, 2)
    specs = tuple(correctors) if correctors else ()
    ndamage = sum(s[0] == "damage" for s in specs)
    if ndamage and aux is None:
        raise ValueError("damage correctors need the aux array")
    if aux is not None and (aux.shape[0] != ndamage or aux_out is None):
        raise ValueError(f"aux holds {aux.shape[0]} fields for {ndamage} "
                         "damage correctors, and needs its output buffer")
    tensors = [aux, out, aux_out] + list(slabs or ())
    r = _check(model, 3, u, mext, order, axes, specs, tensors)
    if out.shape != u.shape or (aux is not None
                                and aux_out.shape != aux.shape):
        raise ValueError("the output buffers have the wrong shapes")
    lib = _lib()
    nxl, nyl = u.shape[1], u.shape[2]
    if ring:
        want = [(model.ncomp, r, nyl, u.shape[3])] * 2 + \
               [(model.ncomp, nxl + 2 * r, r, u.shape[3])] * 2
        if [tuple(s.shape) for s in slabs] != want:
            raise ValueError(f"slabs {[tuple(s.shape) for s in slabs]} are "
                             f"not {want}")
    params = _params(model, u.shape[1:], mext.shape[0], dt, h,
                     _gated(borders, flags if ring else (0, 0, 0, 0), 3),
                     axes, specs)
    check_compiled_map(lib, model, "the fused kernels")
    split = (ctypes.c_int * 6)(*split_3d(nxl, nyl, r))
    sl = [_ptr(s) for s in slabs] if ring else [None] * 4
    err = lib.gcm_fused_spmd(
        u.data_ptr(), mext.data_ptr(), _ptr(aux), out.data_ptr(),
        _ptr(aux_out), *sl, split, int(ring), ctypes.addressof(params),
        order, u.device.index, torch.cuda.current_stream(u.device).cuda_stream)
    _raise(lib, "fused_spmd_ring" if ring else "fused_spmd_interior", err)
    count_stream_body(lib, params, order)


def fused_spmd_interior(model: Model, u: torch.Tensor, mext: torch.Tensor,
                        dt: float, h: Sequence[float], order: int,
                        borders: Optional[Borders] = None,
                        axes: Optional[Sequence[int]] = None,
                        correctors=None, aux: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None,
                        aux_out: Optional[torch.Tensor] = None):
    """The fused 3D step on the interior tiles of one shard's block ``u``
    (C, nxl, nyl, nz), with materials from its extended stack ``mext`` (nm,
    nxl+2r, nyl+2r, nz): only z borders apply, the folded ``correctors``
    run on each output cell (``aux`` stacks one field per damage spec).
    Writes the interior tiles of ``out`` (and ``aux_out``), allocated if
    None, and leaves their other cells as they were. Returns ``out``, or
    ``(out, aux_out)`` with ``aux``."""
    if aux is not None and aux_out is None:
        aux_out = torch.empty_like(aux)
    if not _device_ok(u, "fused_spmd_interior"):
        return fused_spmd_interior_reference(model, u, mext, dt, h, order,
                                             borders, axes, correctors, aux,
                                             out, aux_out)
    out = torch.empty_like(u) if out is None else out
    _launch_3d(model, u, mext, dt, h, order, borders, axes, correctors, aux,
               out, aux_out, None, None, ring=False)
    fused_spmd_interior.launches += 1
    return out if aux is None else (out, aux_out)


def fused_spmd_ring(model: Model, u: torch.Tensor, mext: torch.Tensor,
                    slabs, flags: Sequence[int], base: torch.Tensor,
                    dt: float, h: Sequence[float], order: int,
                    borders: Optional[Borders] = None,
                    axes: Optional[Sequence[int]] = None, correctors=None,
                    aux: Optional[torch.Tensor] = None,
                    base_aux: Optional[torch.Tensor] = None):
    """The fused 3D step on the ring tiles of one shard's block, reading
    the received ``slabs`` (xlo, xhi (C, r, nyl, nz); ylo, yhi (C, nxl+2r,
    r, nz)) beyond the block. x/y borders apply only on the sides where
    ``flags`` (x-lo, x-hi, y-lo, y-hi: 1 on a domain face) say so. Writes
    the ring tiles into ``base`` (and ``base_aux``), the interior launch's
    output, in place. Returns ``base``, or ``(base, base_aux)`` with
    ``aux``."""
    if not _device_ok(u, "fused_spmd_ring"):
        return fused_spmd_ring_reference(model, u, mext, slabs, flags, base,
                                         dt, h, order, borders, axes,
                                         correctors, aux, base_aux)
    _launch_3d(model, u, mext, dt, h, order, borders, axes, correctors, aux,
               base, base_aux, tuple(slabs), tuple(flags), ring=True)
    fused_spmd_ring.launches += 1
    return base if aux is None else (base, base_aux)


def fused_spmd_2d(model: Model, u: torch.Tensor, mext: torch.Tensor,
                  dt: float, h: Sequence[float], order: int,
                  borders: Optional[Borders] = None,
                  axes: Optional[Sequence[int]] = None,
                  which: str = "interior", slabs=None, flags=None,
                  base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused 2D step on the interior rows (``which="interior"``: the
    rows r or more from both x faces) or the ring rows (``"ring"``: the
    others, reading ``slabs`` = (xlo, xhi), each (C, r, ny), with x borders
    gated by ``flags`` = (x-lo, x-hi face)) of one shard's block (C, nxl,
    ny), materials from its x-extended stack ``mext`` (nm, nxl+2r, ny;
    float32 or bf16). Writes those rows of ``base`` (allocated if None) in
    place and returns it."""
    if which not in ("interior", "ring"):
        raise ValueError(f"which={which!r} is not 'interior' or 'ring'")
    ring = which == "ring"
    if not _device_ok(u, "fused_spmd_2d"):
        return fused_spmd_2d_reference(model, u, mext, dt, h, order, borders,
                                       axes, which, slabs, flags, base)
    axes = tuple(axes) if axes is not None else (0, 1)
    base = torch.empty_like(u) if base is None else base
    r = _check(model, 2, u, mext, order, axes, (),
               [base] + list(slabs if ring else ()))
    if base.shape != u.shape:
        raise ValueError("base has the wrong shape")
    if ring and [tuple(s.shape) for s in slabs] != \
            [(model.ncomp, r, u.shape[2])] * 2:
        raise ValueError("the 2D slabs are not (C, r, ny)")
    lib = _lib()
    params = _params(model, u.shape[1:], mext.shape[0], dt, h,
                     _gated(borders, flags if ring else (0, 0), 2), axes, ())
    check_compiled_map(lib, model, "the fused kernels")
    _, ix0, ix1 = tile_split(u.shape[1], TILE_2D, r)
    err = lib.gcm_fused_spmd_2d(
        u.data_ptr(), mext.data_ptr(), base.data_ptr(),
        *([s.data_ptr() for s in slabs] if ring else [None, None]),
        ix0, ix1, int(ring), ctypes.addressof(params), order,
        int(mext.dtype == torch.bfloat16), u.device.index,
        torch.cuda.current_stream(u.device).cuda_stream)
    _raise(lib, "fused_spmd_2d", err)
    fused_spmd_2d.launches += 1
    fused_spmd_2d.ring_launches += int(ring)
    return base


def fused_spmd_occupancy(model: Model, u: torch.Tensor, mext: torch.Tensor,
                         dt: float, h: Sequence[float], order: int,
                         borders: Optional[Borders] = None,
                         axes: Optional[Sequence[int]] = None,
                         ring: bool = False) -> Tuple[int, int]:
    """``(blocks_per_sm, smem_bytes)`` that the interior (or ``ring``)
    launch of the 3D or 2D kernel (by ``model.dim``) on this shard gets on
    ``u``'s card: resident blocks an SM at its dynamic shared memory, and
    that shared memory in bytes."""
    dim = model.dim
    axes = tuple(axes) if axes is not None else tuple(range(dim))
    _check(model, dim, u, mext, order, axes, (), ())
    lib = _lib()
    params = _params(model, u.shape[1:], mext.shape[0], dt, h, borders, axes,
                     ())
    check_compiled_map(lib, model, "the fused kernels")
    out = (ctypes.c_int * 2)()
    entry = ("gcm_fused_spmd_occupancy" if dim == 3
             else "gcm_fused_spmd_2d_occupancy")
    _raise(lib, entry, getattr(lib, entry)(
        ctypes.addressof(params), order, int(ring), u.device.index, out))
    return out[0], out[1]


fused_spmd_interior.launches = 0
fused_spmd_ring.launches = 0
fused_spmd_2d.launches = 0
fused_spmd_2d.ring_launches = 0
