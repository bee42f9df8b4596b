"""The fused full step across shards: halo slabs and interior/ring overlap.

Counterpart of ``gcm_tpu/parallel/fused_spmd.py`` (its host side; the
kernels are ``ops/fused_spmd.py``). One step of one shard is split into an
**interior** launch (the tiles whose windows stay inside the local block)
and a **ring** launch (the perimeter tiles, which read the neighbours'
slabs and write into the interior launch's output). On a card the slab
copies run on a side stream of each device while the interior launches run
on the compute stream; the ring launches wait for the copies' event.

- The slabs are exchanged in two corner-complete phases
  (:func:`exchange_slabs`): x slabs first, then y strips built from the
  x-extended edge rows, so tile corners are covered. At a true domain face
  a slab is the replicated edge row. The copies go into buffers allocated
  once per mesh and block shape. On a mesh that spans processes each rank
  steps its own shards, and the slabs that cross a rank boundary go
  through ``parallel.p2p`` (the y phase after the x phase has arrived).
- Materials are static: each shard's stack (compact or orthotropic) is
  laid out once, at setup, from the global materials with an r-deep halo
  of its neighbours' (or, at domain faces, replicated) materials
  (:func:`extended_mstack`), so no step moves materials and no rank
  exchanges them.
- Border conditions apply inside the kernels, gated by each shard's face
  flags (:func:`face_flags`).

The TPU's 8-deep 2D slabs (``H2``) and its ``nxl % 8`` rule are gone: slabs
are r rows deep and shards take any extents of at least r. A sharded state
is the list of its per-shard blocks (``parallel.sharding``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.ops.fused import fused_step, fused_step_2d, stack_mats
from gcm_tpu_torch.ops.fused_spmd import (
    fused_spmd_2d, fused_spmd_interior, fused_spmd_ring, split_3d,
    tile_split, TILE_2D,
)
from gcm_tpu_torch.ops.interp import stencil_radius
from gcm_tpu_torch.parallel.p2p import Move, Transport, tag
from gcm_tpu_torch.parallel.sharding import (
    DomainMesh, block_shape, first_local)
from gcm_tpu_torch.task import BorderSpec
from gcm_tpu_torch.utils.profiling import span

Borders = Dict[Tuple[int, int], BorderSpec]


def face_flags(mesh: DomainMesh, k: int) -> Tuple[int, int, int, int]:
    """(x-lo, x-hi, y-lo, y-hi): 1 where shard k sits on that domain face
    (an axis the mesh does not split is a face on both sides)."""
    i, j = mesh.coords(k)
    nsx, nsy = mesh.axis_size("sx"), mesh.axis_size("sy")
    return int(i == 0), int(i == nsx - 1), int(j == 0), int(j == nsy - 1)


# ------------------------------------------------------------- slab exchange

class SlabExchange:
    """The halo slabs of one mesh's state, in buffers allocated once.

    ``dim`` 3: per shard ``xlo, xhi`` (C, r, nyl, nz) and ``ylo, yhi`` (C,
    nxl+2r, r, nz); ``dim`` 2: ``xlo, xhi`` (C, r, ny); None for another
    rank's shard. Calling it fills them from the shards' blocks; on a card
    the copies run on a side stream per device, and :meth:`wait` makes each
    device's current stream wait for them. (A copy between two cards runs
    where PyTorch runs peer copies, synchronised with both.) Slabs from or
    to another rank's shards move through a ``parallel.p2p.Transport``: the
    call then starts the x phase, and :meth:`wait` completes it and runs
    the y phase, so the caller launches what needs no slab in between.
    """

    def __init__(self, mesh: DomainMesh, shape: Sequence[int], r: int,
                 dtype: torch.dtype, dim: int):
        self.mesh, self.r, self.dim = mesh, r, dim
        C, nxl = shape[0], shape[1]
        self.nxl = nxl
        xs = (C, r) + tuple(shape[2:])
        ys = (C, nxl + 2 * r, r) + tuple(shape[3:])
        self.slabs = []
        for k, dev in enumerate(mesh.devices):
            if not mesh.is_local(k):
                self.slabs.append(None)
                continue
            bufs = [torch.empty(xs, dtype=dtype, device=dev) for _ in "lh"]
            if dim == 3:
                bufs += [torch.empty(ys, dtype=dtype, device=dev)
                         for _ in "lh"]
            self.slabs.append(tuple(bufs))
        self._devs = [d for d in mesh.unique_devices() if d.type == "cuda"]
        self._side = {d: torch.cuda.Stream(d) for d in self._devs}
        self._ev = {d: [torch.cuda.Event() for _ in range(3)]
                    for d in self._devs}
        self._tr = Transport(mesh, self._side)
        self._pending = None

    def _barrier(self, which: int, streams) -> None:
        """Every side stream waits for event ``which`` of every device,
        recorded on ``streams[device]``."""
        for d in self._devs:
            self._ev[d][which].record(streams(d))
        for d in self._devs:
            for d2 in self._devs:
                self._side[d].wait_event(self._ev[d2][which])

    def _x_moves(self, blocks) -> List[Move]:
        """Each shard's x slabs: the neighbour's r rows next to it, or its
        own edge row where it sits on the domain face."""
        mesh, r, moves = self.mesh, self.r, []
        last = mesh.axis_size("sx") - 1
        for k in range(mesh.size):
            i, j = mesh.coords(k)
            for side in (0, 1):
                edge = i == (0, last)[side]
                src = k if edge else mesh.index(i + (-1, 1)[side], j)
                if not (mesh.is_local(src) or mesh.is_local(k)):
                    continue
                view = None
                if mesh.is_local(src):
                    u = blocks[src]
                    view = ((u[:, :1], u[:, -1:]) if edge
                            else (u[:, -r:], u[:, :r]))[side]
                buf = self.slabs[k][side] if mesh.is_local(k) else None
                moves.append(Move(src, k, view, buf,
                                  tag(0, side, k, mesh.size)))
        return moves

    def _y_moves(self, blocks) -> List[Move]:
        """Each shard's y strips, each in three parts: the x-extended rows
        of the neighbour next to it (its x slabs and block), or its own
        edge row where it sits on the domain face."""
        mesh, r, nxl, moves = self.mesh, self.r, self.nxl, []
        last = mesh.axis_size("sy") - 1
        cols = (slice(0, r), slice(r, r + nxl), slice(r + nxl, None))
        for k in range(mesh.size):
            i, j = mesh.coords(k)
            for side in (0, 1):
                if j == (0, last)[side]:
                    src, rows = k, (slice(0, 1), slice(-1, None))[side]
                else:
                    src = mesh.index(i, j + (-1, 1)[side])
                    rows = (slice(-r, None), slice(0, r))[side]
                if not (mesh.is_local(src) or mesh.is_local(k)):
                    continue
                parts = [None] * 3
                if mesh.is_local(src):
                    xlo, xhi = self.slabs[src][:2]
                    parts = [t[:, :, rows] for t in (xlo, blocks[src], xhi)]
                dst = self.slabs[k][2 + side] if mesh.is_local(k) else None
                for p in range(3):
                    moves.append(Move(
                        src, k, parts[p], None if dst is None
                        else dst[:, cols[p]],
                        tag(1, 3 * side + p, k, mesh.size)))
        return moves

    def _y_phase(self, blocks) -> None:
        if self.dim == 3:
            if len(self._devs) > 1:
                self._barrier(1, lambda d: self._side[d])
            self._tr.run(self._y_moves(blocks))

    def __call__(self, blocks: Sequence[Optional[torch.Tensor]]
                 ) -> List[Optional[Tuple]]:
        """Fill the slabs from ``blocks`` (one per shard, None for another
        rank's); returns them, one tuple per shard. On a mesh that spans
        processes this starts the x phase, and :meth:`wait` completes the
        fill."""
        with span("gcm.exchange.fill"):
            self._barrier(0, torch.cuda.current_stream)
            x = self._tr.start(self._x_moves(blocks))
            if self.mesh.spans_processes:
                self._pending = (blocks, x)
            else:
                self._y_phase(blocks)
            return self.slabs

    def wait(self) -> None:
        """Complete the fill, and make each card's current stream wait for
        it."""
        with span("gcm.exchange.wait"):
            if self._pending is not None:
                blocks, x = self._pending
                self._pending = None
                self._tr.finish(x)
                self._y_phase(blocks)
            for d in self._devs:
                self._ev[d][2].record(self._side[d])
                torch.cuda.current_stream(d).wait_event(self._ev[d][2])


def exchange_slabs(blocks: Sequence[Optional[torch.Tensor]],
                   mesh: DomainMesh, r: int, dim: int = 3
                   ) -> List[Optional[Tuple]]:
    """The corner-complete two-phase halo-slab exchange of a sharded state:
    per shard of this process ``(xlo, xhi, ylo, yhi)`` (``dim`` 3) or
    ``(xlo, xhi)`` (2), in new buffers (None for another rank's shard;
    every rank takes part)."""
    u = first_local(blocks)
    ex = SlabExchange(mesh, u.shape, r, u.dtype, dim)
    slabs = ex(blocks)
    ex.wait()
    return slabs


# ------------------------------------------------------------ material layout

def _edge_pad(t: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    """``t`` extended along ``dim`` by r copies of its edge rows."""
    n = t.shape[dim]
    lo = t.narrow(dim, 0, 1).expand_as(t.narrow(dim, 0, r))
    hi = t.narrow(dim, n - 1, 1).expand_as(t.narrow(dim, 0, r))
    return torch.cat([lo, t, hi], dim=dim)


def extended_mstack(model: Model, mat, mesh: DomainMesh, order: int,
                    dtype: Optional[torch.dtype] = None
                    ) -> List[Optional[torch.Tensor]]:
    """Per-shard halo-extended stacks ``(nm, nxl+2r, nyl+2r, nz)`` (3D) or
    ``(nm, nxl+2r, ny)`` (2D), built once at setup from the stacked global
    materials (``ops.fused.stack_mats``: compact for ``MaterialFields``,
    orthotropic for ``OrthotropicMaterialFields``) with their edge rows
    replicated at the domain faces, as the slab exchange lays out the
    state's; rounded to ``dtype`` if given (bf16 only in 2D: the 3D SPMD
    kernels keep float32 stacks, as in JAX). None for another rank's
    shard: every process holds the global materials."""
    r = stencil_radius(order)
    g = stack_mats(model, mat)
    nb = block_shape(mesh, g.shape[1:])
    g = _edge_pad(g, 1, r)
    if model.dim == 3:
        g = _edge_pad(g, 2, r)
    out = []
    for k in range(mesh.size):
        if not mesh.is_local(k):
            out.append(None)
            continue
        i, j = mesh.coords(k)
        idx = (slice(None), slice(i * nb[0], (i + 1) * nb[0] + 2 * r))
        if model.dim == 3:
            idx += (slice(j * nb[1], (j + 1) * nb[1] + 2 * r),)
        m = g[idx].to(mesh.devices[k]).contiguous()
        out.append(m if dtype is None else m.to(dtype).contiguous())
    return out


def extended_mstack_2d(model: Model, mat, mesh: DomainMesh, order: int,
                       dtype: Optional[torch.dtype] = None
                       ) -> List[torch.Tensor]:
    """The 2D form of :func:`extended_mstack`: x-extended stacks, float32
    or (``dtype=torch.bfloat16``) bf16."""
    if model.dim != 2:
        raise ValueError("extended_mstack_2d takes a 2D model")
    return extended_mstack(model, mat, mesh, order, dtype)


# ------------------------------------------------------------------ the steps

def _crop_once(r: int, dim: int):
    """The un-extended stack of a 1-shard mesh, cut once per stack."""
    memo = {}

    def crop(mext):
        if memo.get("src") is not mext:
            idx = (slice(None),) + (slice(r, -r),) * (dim - 1)
            memo["src"], memo["val"] = mext, mext[idx].contiguous()
        return memo["val"]

    return crop


def make_fused_spmd_step(model: Model, mesh: DomainMesh, dt: float,
                         h: Sequence[float], order: int,
                         borders: Optional[Borders] = None,
                         force_spmd: bool = False, correctors=None):
    """Build ``step(us, mexts, axes[, aux]) -> us [or (us, aux)]``: the
    fused 3D step across the shards of ``mesh``.

    ``us`` holds the shards' blocks, ``mexts`` their extended stacks
    (:func:`extended_mstack`, same order), ``aux`` (with damage
    ``correctors``, specs of ``ops.fused.fold_corrector_specs``) one
    ``(naux, nxl, nyl, nz)`` stack per shard; the folded correctors run in
    both launches. ``axes`` is any order of the three axes: (0, 1, 2) and
    (2, 1, 0) on a single body, and on contact bodies also the canonical
    order under a one-axis mesh, (ca, rest) and its reverse ((2, 0, 1) and
    (1, 0, 2) for a z contact, ``engine_multi.MultiBodyEngine``).

    On a one-shard mesh the step is the single-card ``fused_step``;
    ``force_spmd=True`` keeps the interior/ring split on any mesh.
    """
    if model.dim != 3:
        raise ValueError("fused spmd step supports 3D models only")
    r = stencil_radius(order)
    specs = tuple(correctors) if correctors else ()
    naux = sum(1 for sp in specs if sp[0] == "damage")
    one = mesh.size == 1 and not force_spmd
    crop = _crop_once(r, 3)
    flags = [face_flags(mesh, k) for k in range(mesh.size)]
    exchanges: Dict[Tuple, SlabExchange] = {}

    def step(us, mexts, axes: Optional[Tuple[int, ...]] = None, aux=None):
        axes = tuple(axes) if axes is not None else (0, 1, 2)
        if sorted(axes) != [0, 1, 2]:
            raise ValueError(f"unsupported axes order {axes}: not an "
                             "order of the 3 axes")
        if naux and aux is None:
            raise ValueError("damage correctors need the aux array")
        kw = dict(correctors=specs or None)
        if one:
            if naux:
                u, a = fused_step(model, us[0], crop(mexts[0]), dt, h, order,
                                  borders, axes, aux=aux[0], **kw)
                return [u], [a]
            return [fused_step(model, us[0], crop(mexts[0]), dt, h, order,
                               borders, axes, **kw)]
        u0 = first_local(us)
        C, nxl, nyl, nz = u0.shape
        if nxl < r or nyl < r:
            raise ValueError(
                f"fused spmd step: per-shard extents {nxl}x{nyl} smaller "
                f"than the stencil radius {r}; use larger shards or the "
                "per-sweep path")
        key = (tuple(u0.shape), u0.dtype)
        ex = exchanges.get(key)
        if ex is None:
            ex = exchanges[key] = SlabExchange(mesh, u0.shape, r, u0.dtype,
                                               3)
        slabs = ex(us)
        interior = split_3d(nxl, nyl, r)[3] > 0
        outs, aouts = [None] * len(us), [None] * len(us)
        for k in mesh.local:
            u, a = us[k], aux[k] if naux else None
            if interior:
                res = fused_spmd_interior(model, u, mexts[k], dt, h, order,
                                          borders, axes, aux=a, **kw)
            else:   # every tile is on the ring
                res = (torch.empty_like(u), torch.empty_like(a)) if naux \
                    else torch.empty_like(u)
            outs[k] = res[0] if naux else res
            aouts[k] = res[1] if naux else None
        ex.wait()
        for k in mesh.local:
            fused_spmd_ring(model, us[k], mexts[k], slabs[k], flags[k],
                            outs[k], dt, h, order, borders, axes,
                            aux=aux[k] if naux else None,
                            base_aux=aouts[k], **kw)
        return (outs, aouts) if naux else outs

    return step


def make_fused_spmd_step_2d(model: Model, mesh: DomainMesh, dt: float,
                            h: Sequence[float], order: int,
                            borders: Optional[Borders] = None,
                            force_spmd: bool = False):
    """Build ``step(us, mexts, axes) -> us``: the fused 2D step across the
    shards of a mesh that splits x only (``'sx'``), with ``mexts`` from
    :func:`extended_mstack_2d`. The same interior/ring overlap as 3D; no
    correctors are folded, as in the JAX package. On a one-shard mesh the
    step is ``fused_step_2d`` unless ``force_spmd``."""
    if model.dim != 2:
        raise ValueError("make_fused_spmd_step_2d supports 2D models only")
    if "sy" in mesh.axis_names:
        raise ValueError("the 2D step splits x ('sx') only")
    r = stencil_radius(order)
    one = mesh.size == 1 and not force_spmd
    crop = _crop_once(r, 2)
    flags = [face_flags(mesh, k)[:2] for k in range(mesh.size)]
    exchanges: Dict[Tuple, SlabExchange] = {}

    def step(us, mexts, axes: Optional[Tuple[int, ...]] = None):
        axes = tuple(axes) if axes is not None else (0, 1)
        if axes not in ((0, 1), (1, 0)):
            raise ValueError(f"unsupported axes order {axes}")
        if one:
            return [fused_step_2d(model, us[0], crop(mexts[0]), dt, h, order,
                                  borders, axes)]
        u0 = first_local(us)
        nxl = u0.shape[1]
        if nxl < r:
            raise ValueError(
                f"fused 2D spmd step: per-shard nx={nxl} smaller than the "
                f"stencil radius {r}")
        key = (tuple(u0.shape), u0.dtype)
        ex = exchanges.get(key)
        if ex is None:
            ex = exchanges[key] = SlabExchange(mesh, u0.shape, r, u0.dtype,
                                               2)
        slabs = ex(us)
        interior = tile_split(nxl, TILE_2D, r)[2] > 0
        outs = [None] * len(us)
        for k in mesh.local:
            outs[k] = (fused_spmd_2d(model, us[k], mexts[k], dt, h, order,
                                     borders, axes, "interior") if interior
                       else torch.empty_like(us[k]))
        ex.wait()
        for k in mesh.local:
            outs[k] = fused_spmd_2d(model, us[k], mexts[k], dt, h, order,
                                    borders, axes, "ring", slabs[k], flags[k],
                                    outs[k])
        return outs

    return step
