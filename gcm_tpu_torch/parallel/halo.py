"""Explicit halo exchange and the per-sweep sharded step.

Counterpart of ``gcm_tpu/parallel/halo.py``. Each shard runs a sweep on its
block extended by an r-deep halo of its neighbours' rows (edge-replicated
at a domain face) and crops the halo off again. Border conditions: the
sweep runs border-free on the extended block; the shards on a domain face
then apply the exactly equivalent post-fixup
(:func:`borders_post`, ``solver.boundary.apply_borders_post`` on each such
shard), which the multi-body engine's per-sweep composition shares.

With ``use_kernel=True`` the sweep is the per-sweep CUDA kernel
(``ops.sweep.sweep_stage``, which runs its plain version on CPU tensors);
with ``use_kernel=False`` it is the plain ``solver.gcm.stage``, the same
function the JAX package computes under a mesh with its jnp path (a GSPMD
program there, a per-shard halo step here).

Materials are static: engines pass per-shard material dicts prepared once
by :func:`extend_mats_once`, so a step exchanges only the state and each
sweep's per-axis view is computed once; plain per-shard material fields
(isotropic or orthotropic) are extended at every sweep. A sharded field is
the list of its per-shard blocks (``parallel.sharding``); on a mesh that
spans processes each rank steps its own shards, and the halo slabs of
another rank's shards come through ``parallel.p2p``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from gcm_tpu_torch.materials import AxisViewCache
from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.ops.interp import stencil_radius
from gcm_tpu_torch.ops.sweep import sweep_stage
from gcm_tpu_torch.parallel.p2p import Move, Transport, tag
from gcm_tpu_torch.parallel.sharding import AXIS_OF, DomainMesh, first_local
from gcm_tpu_torch.solver.boundary import apply_borders_post
from gcm_tpu_torch.solver.gcm import stage as torch_stage
from gcm_tpu_torch.task import BorderSpec

Borders = Dict[Tuple[int, int], BorderSpec]


def _neighbours(mesh: DomainMesh, name: str, k: int):
    """(shard before k, shard after k) along mesh axis ``name``; None at a
    domain face."""
    i, j = mesh.coords(k)
    n = mesh.axis_size(name)
    pos = i if name == "sx" else j

    def at(p):
        if not 0 <= p < n:
            return None
        return mesh.index(p, j) if name == "sx" else mesh.index(i, p)

    return at(pos - 1), at(pos + 1)


def halo_exchange(blocks: Sequence[Optional[torch.Tensor]],
                  mesh: DomainMesh, name: str, ax: int,
                  r: int) -> List[Optional[torch.Tensor]]:
    """Every block of this process extended by r-deep neighbour slabs
    along tensor axis ``ax`` (the one mesh axis ``name`` splits); a shard
    on a domain face gets its edge row replicated. Each extended block has
    ``shape[ax] + 2r``. Slabs of another rank's shards are received (and
    this rank's sent) through ``parallel.p2p``, every rank taking part."""
    f0 = first_local(blocks)
    n = f0.shape[ax]
    slab = tuple(r if a == ax else s for a, s in enumerate(f0.shape))
    lo_hi = [[None, None] for _ in blocks]
    moves = []
    for k in range(mesh.size):
        for side, nb in enumerate(_neighbours(mesh, name, k)):
            if nb is None:
                continue
            k_here, nb_here = mesh.is_local(k), mesh.is_local(nb)
            view = (blocks[nb].narrow(ax, n - r if side == 0 else 0, r)
                    if nb_here else None)
            if k_here and nb_here:    # read in place
                lo_hi[k][side] = view
            elif k_here or nb_here:
                buf = None
                if k_here:
                    buf = lo_hi[k][side] = torch.empty(
                        slab, dtype=f0.dtype, device=blocks[k].device)
                moves.append(Move(nb, k, view, buf,
                                  tag(ax, side, k, mesh.size)))
    if moves:
        Transport(mesh).run(moves)
    out = []
    for f, (lo, hi) in zip(blocks, lo_hi):
        if f is None:
            out.append(None)
            continue
        if lo is None:
            lo = f.narrow(ax, 0, 1).expand_as(f.narrow(ax, 0, r))
        if hi is None:
            hi = f.narrow(ax, n - 1, 1).expand_as(f.narrow(ax, 0, r))
        out.append(torch.cat([lo.to(f.device), f, hi.to(f.device)], dim=ax))
    return out


def _crop(f: torch.Tensor, ax: int, r: int) -> torch.Tensor:
    return f.narrow(ax, r, f.shape[ax] - 2 * r).contiguous()


def _spatial_names(dim: int, mesh: DomainMesh) -> Dict[int, Optional[str]]:
    """The mesh axis that splits each spatial axis (None if unsplit)."""
    names: Dict[int, Optional[str]] = {a: None for a in range(dim)}
    for name in mesh.axis_names:
        if AXIS_OF[name] < max(dim - 1, 1):
            names[AXIS_OF[name]] = name
    if not any(names.values()):
        raise ValueError(f"mesh axes {mesh.axis_names} split no spatial "
                         f"axis of a {dim}-D grid")
    return names


def _extend(mats: Sequence, mesh: DomainMesh, name: str, a: int,
            r: int) -> List:
    """Every shard's material fields (of their own type) extended along
    axis ``a`` by r-deep halos of its neighbours'."""
    leaves = {f.name: halo_exchange(
        [None if m is None else getattr(m, f.name) for m in mats],
        mesh, name, a, r) for f in dataclasses.fields(first_local(mats))}
    return [None if m is None else
            dataclasses.replace(m, **{n: v[k] for n, v in leaves.items()})
            for k, m in enumerate(mats)]


def extend_mats_once(mats: Sequence, mesh: DomainMesh, dim: int,
                     order: int) -> List[Dict]:
    """Per shard ``{"base": mat, "ax<a>": mat extended along axis a, ...}``
    for every split axis a: the materials each sweep reads, exchanged once
    at setup, each an ``AxisViewCache`` so that a sweep's view is computed
    once too."""
    r = stencil_radius(order)
    out = [None if m is None else {"base": AxisViewCache(m)} for m in mats]
    for a, name in _spatial_names(dim, mesh).items():
        if name is None:
            continue
        for d, m in zip(out, _extend(mats, mesh, name, a, r)):
            if d is not None:
                d[f"ax{a}"] = AxisViewCache(m)
    return out


def _raw_stage(model: Model, dt: float, h: Sequence[float], order: int,
               use_kernel: bool):
    if use_kernel:
        return lambda u, mat, axis: sweep_stage(model, u, mat, dt, h, axis,
                                                order, None)
    return lambda u, mat, axis: torch_stage(model, u, mat, dt, h, axis,
                                            order, None)


def _sweep_all(model: Model, mesh: DomainMesh, raw, names, r: int,
               us: Sequence[torch.Tensor], mats: Sequence, axis: int
               ) -> List[torch.Tensor]:
    """One border-free sweep of every shard of this process along
    ``axis`` (None for another rank's)."""
    prepared = isinstance(first_local(mats), dict)
    base = [m["base"] if prepared and m is not None else m for m in mats]
    name = names.get(axis)
    if name is None:
        return [None if u is None else raw(u, m, axis)
                for u, m in zip(us, base)]
    exts = halo_exchange(us, mesh, name, axis + 1, r)
    mat_ext = ([None if m is None else m[f"ax{axis}"] for m in mats]
               if prepared else _extend(base, mesh, name, axis, r))
    return [None if e is None else _crop(raw(e, m, axis), axis + 1, r)
            for e, m in zip(exts, mat_ext)]


def make_spmd_raw_stage(model: Model, mesh: DomainMesh, dt: float,
                        h: Sequence[float], order: int,
                        use_kernel: bool = True):
    """Border-free single sweep across the shards: ``stage(us, mats,
    axis) -> us`` (``mats`` per shard, plain or from
    :func:`extend_mats_once`)."""
    raw = _raw_stage(model, dt, h, order, use_kernel)
    names = _spatial_names(model.dim, mesh)
    r = stencil_radius(order)

    def stage(us, mats, axis: int):
        return _sweep_all(model, mesh, raw, names, r, us, mats, axis)

    return stage


def make_spmd_step(model: Model, mesh: DomainMesh, dt: float,
                   h: Sequence[float], order: int,
                   borders: Optional[Borders] = None,
                   use_kernel: bool = False):
    """Build ``step(us, mats, axes) -> us``: a full step across the shards
    of ``mesh``, one sweep at a time, each with its halo exchange and the
    border post-fixup on the shards at the domain faces."""
    raw = _raw_stage(model, dt, h, order, use_kernel)
    names = _spatial_names(model.dim, mesh)
    r = stencil_radius(order)

    def step(us, mats, axes: Optional[Tuple[int, ...]] = None):
        axes = tuple(range(model.dim)) if axes is None else tuple(axes)
        for axis in axes:
            new = _sweep_all(model, mesh, raw, names, r, us, mats, axis)
            if borders:
                new = borders_post(model, mesh, us, new, mats, axis, borders)
            us = new
        return us

    return step


def borders_post(model: Model, mesh: DomainMesh, us: Sequence[torch.Tensor],
                 new: Sequence[torch.Tensor], mats: Sequence, axis: int,
                 borders: Borders) -> List[torch.Tensor]:
    """The border post-fixup of a border-free sweep along ``axis`` across
    the shards (``solver.boundary.apply_borders_post``): ``us`` before the
    sweep, ``new`` after it, ``mats`` per shard (plain or from
    :func:`extend_mats_once`). Only this process's shards on a domain face
    of ``axis`` are corrected, on that face."""
    name = _spatial_names(model.dim, mesh).get(axis)
    out = list(new)
    for k in mesh.local:
        m = mats[k]
        lo_k, hi_k = ((None, None) if name is None
                      else _neighbours(mesh, name, k))
        if lo_k is None or hi_k is None:   # on a domain face
            out[k] = apply_borders_post(
                model, us[k], new[k], m["base"] if isinstance(m, dict) else m,
                axis, borders, (lo_k is None, hi_k is None))
    return out
