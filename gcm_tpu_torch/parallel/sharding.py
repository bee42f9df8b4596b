"""Spatial domain decomposition over a mesh of shards.

Counterpart of ``gcm_tpu/parallel/sharding.py``. The JAX package places one
global array on a ``jax.sharding.Mesh`` and ``shard_map`` hands each device
its block; here a :class:`DomainMesh` names the torch device of each shard,
and a sharded field is the list of its blocks, one per shard in mesh order
(row-major over ``('sx', 'sy')``). A device may hold several shards: a 2x2
mesh on ``["cuda:0"] * 4`` runs the real exchange and kernels on one card,
as the JAX tests run their meshes on virtual CPU devices.

By default one process drives every shard, as JAX drives every local
device. A mesh may also span the ranks of a process group
(``parallel.multihost``): ``DomainMesh.ranks`` names the rank that holds
each shard, and a sharded field is then, on each rank, the list indexed by
shard with the blocks of that rank's shards and None for the others', so
mesh indices keep their meaning. After ``multihost.initialize()``,
:func:`domain_mesh` lays the mesh over every rank's devices in rank order,
as ``jax.devices()`` lists a slice's chips; explicit ``devices`` and
``ranks`` build any layout (one mesh row a process, several shards a card).

Mesh axes are named after the spatial axes they split: ``'sx'`` splits the
first, ``'sy'`` the second (3D only). The last spatial axis is never split.
Extents must divide evenly among the shards, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from gcm_tpu_torch.parallel import multihost
from gcm_tpu_torch.parallel.p2p import Move, Transport, gather_blocks

#: spatial axis each mesh axis splits
AXIS_OF = {"sx": 0, "sy": 1}


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into two near-square factors (a*b == n, a >= b)."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


@dataclasses.dataclass(frozen=True)
class DomainMesh:
    """The devices of a grid of shards: ``devices[k]`` holds shard k, in
    row-major order over ``shape`` (one entry per name in ``axis_names``).
    ``ranks[k]`` is the rank of the process that holds shard k (None: this
    process holds every shard); ``devices[k]`` names the device as that
    rank sees it. A process drives one device of a mesh that spans
    processes (it may hold several shards there)."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    ranks: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        me = multihost.rank()
        if self.ranks is not None:
            object.__setattr__(self, "ranks",
                               tuple(int(r) for r in self.ranks))
            if len(self.ranks) != len(self.devices):
                raise ValueError(f"{len(self.ranks)} ranks for "
                                 f"{len(self.devices)} devices")
        #: the shards this process holds, in mesh order
        object.__setattr__(self, "local", tuple(
            k for k in range(len(self.devices))
            if self.ranks is None or self.ranks[k] == me))
        if self.spans_processes and len(self.unique_devices()) > 1:
            raise ValueError(f"rank {me} holds shards on "
                             f"{self.unique_devices()}: a process drives one "
                             "device of a mesh that spans processes")
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axes "
                             f"{self.axis_names}")
        if not set(self.axis_names) <= set(AXIS_OF):
            raise ValueError(f"mesh axes {self.axis_names} are not among "
                             f"{tuple(AXIS_OF)}")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        """Shards along mesh axis ``name`` (1 if the mesh lacks it)."""
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    def coords(self, k: int) -> Tuple[int, int]:
        """(i, j): shard k's position along 'sx' and 'sy'."""
        nsy = self.axis_size("sy")
        return k // nsy, k % nsy

    def index(self, i: int, j: int) -> int:
        """The shard at position (i, j) along 'sx' and 'sy'."""
        return i * self.axis_size("sy") + j

    def is_local(self, k: int) -> bool:
        """Whether this process holds shard k."""
        return self.ranks is None or k in self.local

    @property
    def spans_processes(self) -> bool:
        """Whether another process holds a shard of the mesh."""
        return len(self.local) < len(self.devices)

    def unique_devices(self) -> List[torch.device]:
        """The distinct devices of this process's shards, in order of first
        use."""
        return list(dict.fromkeys(self.devices[k] for k in self.local))


def domain_mesh(dim: int, devices: Optional[Sequence] = None,
                shape: Optional[Tuple[int, ...]] = None,
                ranks: Optional[Sequence[int]] = None) -> DomainMesh:
    """A mesh over the shardable spatial axes of a ``dim``-D grid.

    dim 3 gives ``('sx', 'sy')``, near-square unless ``shape`` is given;
    dim 1 and 2 give ``('sx',)`` over the first axis. ``devices`` defaults
    to every visible CUDA device, and in a process group to every rank's
    device in rank order (each shard held by its device's rank); given, it
    may name a device more than once, and ``ranks`` (default: this process
    for every shard) names the rank that holds each.
    """
    if devices is None and multihost.in_group():
        per = multihost.all_gather_object(
            [str(d) for d in multihost.local_devices()])
        devices = [d for ds in per for d in ds]
        ranks = [r for r, ds in enumerate(per) for _ in ds]
    elif devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("domain_mesh: torch sees no CUDA device; pass "
                               "the devices, e.g. ['cpu'] * 4")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(devices)
    ranks = None if ranks is None else tuple(ranks)
    n = len(devices)
    if dim >= 3:
        a, b = _factor2(n) if shape is None else shape
        return DomainMesh(devices, (a, b), ("sx", "sy"), ranks)
    if shape is not None and math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} for {n} devices")
    return DomainMesh(devices, (n,), ("sx",), ranks)


def block_shape(mesh: DomainMesh, spatial: Sequence[int]) -> Tuple[int, ...]:
    """Extents of every shard's block of a field of spatial extents
    ``spatial``; raises unless the split axes divide evenly."""
    out = list(spatial)
    for name in mesh.axis_names:
        a, n = AXIS_OF[name], mesh.axis_size(name)
        if a >= max(len(spatial) - 1, 1):
            raise ValueError(f"mesh axis {name!r} would split the last "
                             f"spatial axis of a {len(spatial)}-D grid")
        if spatial[a] % n:
            raise ValueError(f"grid {tuple(spatial)} not divisible by mesh "
                             f"{mesh.shape} along axis {a}")
        out[a] = spatial[a] // n
    return tuple(out)


def shard_field(f: torch.Tensor, mesh: DomainMesh,
                lead: int = 1) -> List[Optional[torch.Tensor]]:
    """Per-shard contiguous blocks of ``f`` on their devices (None for the
    shards another process holds); ``lead`` leading axes (components) are
    not spatial."""
    nb = block_shape(mesh, f.shape[lead:])
    blocks = []
    for k, dev in enumerate(mesh.devices):
        if not mesh.is_local(k):
            blocks.append(None)
            continue
        i, j = mesh.coords(k)
        idx = [slice(None)] * f.ndim
        idx[lead] = slice(i * nb[0], (i + 1) * nb[0])
        if "sy" in mesh.axis_names:
            idx[lead + 1] = slice(j * nb[1], (j + 1) * nb[1])
        blocks.append(f[tuple(idx)].to(dev).contiguous())
    return blocks


def shard_state(u: torch.Tensor, mesh: DomainMesh) -> List[torch.Tensor]:
    """The state ``[C, *spatial]`` split into per-shard blocks."""
    return shard_field(u, mesh, lead=1)


def shard_mats(mat, mesh: DomainMesh) -> List:
    """Per-shard material fields, of ``mat``'s own type (isotropic or
    orthotropic); None for the shards another process holds."""
    leaves = {f.name: shard_field(getattr(mat, f.name), mesh, lead=0)
              for f in dataclasses.fields(mat)}
    return [dataclasses.replace(mat, **{k: v[s] for k, v in leaves.items()})
            if mesh.is_local(s) else None for s in range(mesh.size)]


def first_local(xs: Sequence):
    """The first entry of a per-shard list that this process holds."""
    return next(x for x in xs if x is not None)


def gather_state(blocks: Sequence[Optional[torch.Tensor]], mesh: DomainMesh,
                 lead: int = 1, device=None) -> torch.Tensor:
    """Join per-shard blocks back into the global field, on ``device``
    (default: this process's first block's). On a mesh that spans
    processes every rank takes part and gets the whole field."""
    if mesh.spans_processes:
        device = (first_local(blocks).device if device is None
                  else torch.device(device))
        blocks = gather_blocks(blocks, mesh, device)
    return _join(blocks, mesh, range(mesh.axis_size("sx")),
                 range(mesh.axis_size("sy")), lead, device)


def _join(parts, mesh: DomainMesh, xs, ys, lead: int, device):
    """The parts of the shards at positions ``xs`` x ``ys`` (indexed by
    shard), joined along the axes the mesh splits, on ``device``."""
    device = (parts[mesh.index(xs[0], ys[0])].device if device is None
              else torch.device(device))
    rows = []
    for i in xs:
        row = [parts[mesh.index(i, j)].to(device) for j in ys]
        rows.append(torch.cat(row, dim=lead + 1) if len(row) > 1 else row[0])
    return torch.cat(rows, dim=lead) if len(rows) > 1 else rows[0]


def place(mesh: DomainMesh, block: Sequence[int], node: Sequence[int]
          ) -> Tuple[int, Tuple[int, ...]]:
    """``(shard, local node)`` of a global spatial node, for blocks of
    extents ``block``."""
    i = node[0] // block[0]
    if len(node) == 1:
        return mesh.index(i, 0), (node[0] - i * block[0],)
    j = node[1] // block[1]
    return mesh.index(i, j), (node[0] - i * block[0],
                              node[1] - j * block[1]) + tuple(node[2:])


def _face_positions(mesh: DomainMesh, axis: int, side: int):
    """The shard positions along 'sx' and 'sy' whose blocks hold the face
    ``(axis, side)``: the edge row along the mesh axis that splits
    ``axis``, every position along the other."""
    pos = []
    for name in ("sx", "sy"):
        n = mesh.axis_size(name)
        pos.append([(0, n - 1)[side]] if AXIS_OF[name] == axis
                   else list(range(n)))
    return pos


def _face_slice(f: torch.Tensor, ax: int, side: int, depth: int):
    n = f.shape[ax]
    return f.narrow(ax, n - depth if side else 0, depth)


def gather_faces(requests: Sequence[Tuple], mesh: DomainMesh, device=None,
                 transport: Optional[Transport] = None) -> List[torch.Tensor]:
    """For each request ``(blocks, axis, side, depth, lead)``, the
    ``depth``-deep slab at the global face ``(axis, side)`` of a sharded
    field (``side`` 0 the low face, 1 the high one; ``lead`` dimensions
    before the spatial ones), joined on ``device`` (default: the first
    shard's, on a mesh that spans processes this process's first). Along a
    split axis the face lies on the edge shards, and ``depth`` must not
    exceed their blocks. On a mesh that spans processes, the parts another
    rank holds arrive in one exchange for them all (``parallel.p2p``: each
    part is sent to every rank that lacks it; ``transport`` keeps its
    buffers across calls), and every rank joins each slab as one process
    would: in the same order and type, so what is computed from it is the
    same on every rank."""
    spans = mesh.spans_processes
    if spans:
        ranks = sorted(set(mesh.ranks))
        #: the shard a rank's received parts are addressed to: its first
        home = {q: mesh.ranks.index(q) for q in ranks}
        me = mesh.ranks[mesh.local[0]]
    moves, joins = [], []
    for blocks, axis, side, depth, lead in requests:
        xs, ys = _face_positions(mesh, axis, side)
        if spans:
            like = _face_slice(first_local(blocks), lead + axis, side, depth)
            dev = like.device if device is None else torch.device(device)
        else:
            dev = mesh.devices[0] if device is None else device
        parts = {}
        for i in xs:
            for j in ys:
                k = mesh.index(i, j)
                parts[k] = (_face_slice(blocks[k], lead + axis, side, depth)
                            if mesh.is_local(k) else torch.empty(
                                like.shape, dtype=like.dtype, device=dev))
                for q in ranks if spans else ():
                    if q != mesh.ranks[k]:
                        moves.append(Move(
                            k, home[q],
                            parts[k] if mesh.is_local(k) else None,
                            parts[k] if q == me else None, len(moves)))
        joins.append((parts, xs, ys, lead, dev))
    if moves:
        (transport or Transport(mesh)).run(moves)
    return [_join(parts, mesh, xs, ys, lead, dev)
            for parts, xs, ys, lead, dev in joins]


def scatter_face(blocks: Sequence[Optional[torch.Tensor]], mesh: DomainMesh,
                 axis: int, side: int, rows: torch.Tensor,
                 lead: int = 1) -> None:
    """Write the global face slab ``rows`` (as :func:`gather_faces` gives
    it, of any depth) into this process's blocks that hold face ``(axis,
    side)``, in place."""
    xs, ys = _face_positions(mesh, axis, side)
    depth = rows.shape[lead + axis]
    for i in xs:
        for j in ys:
            if not mesh.is_local(mesh.index(i, j)):
                continue
            b = blocks[mesh.index(i, j)]
            part = rows
            for name, p in (("sx", i), ("sy", j)):
                a = AXIS_OF[name]
                if a != axis and a < b.ndim - lead:
                    n = b.shape[lead + a]
                    part = part.narrow(lead + a, p * n, n)
            _face_slice(b, lead + axis, side, depth).copy_(part)
