"""Spatial domain decomposition over a mesh of shards.

Counterpart of ``gcm_tpu/parallel/sharding.py``. The JAX package places one
global array on a ``jax.sharding.Mesh`` and ``shard_map`` hands each device
its block; here a :class:`DomainMesh` names the torch device of each shard,
and a sharded field is the list of its blocks, one per shard in mesh order
(row-major over ``('sx', 'sy')``). One process drives every shard, as JAX
drives every local device. A device may hold several shards: a 2x2 mesh on
``["cuda:0"] * 4`` runs the real exchange and kernels on one card, as the
JAX tests run their meshes on virtual CPU devices.

Mesh axes are named after the spatial axes they split: ``'sx'`` splits the
first, ``'sy'`` the second (3D only). The last spatial axis is never split.
Extents must divide evenly among the shards, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

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
    row-major order over ``shape`` (one entry per name in ``axis_names``)."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
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

    def unique_devices(self) -> List[torch.device]:
        """The distinct devices of the mesh, in order of first use."""
        return list(dict.fromkeys(self.devices))


def domain_mesh(dim: int, devices: Optional[Sequence] = None,
                shape: Optional[Tuple[int, ...]] = None) -> DomainMesh:
    """A mesh over the shardable spatial axes of a ``dim``-D grid.

    dim 3 gives ``('sx', 'sy')``, near-square unless ``shape`` is given;
    dim 1 and 2 give ``('sx',)`` over the first axis. ``devices`` defaults
    to every visible CUDA device; it may name a device more than once.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("domain_mesh: torch sees no CUDA device; pass "
                               "the devices, e.g. ['cpu'] * 4")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if dim >= 3:
        a, b = _factor2(n) if shape is None else shape
        return DomainMesh(tuple(devices), (a, b), ("sx", "sy"))
    if shape is not None and math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} for {n} devices")
    return DomainMesh(tuple(devices), (n,), ("sx",))


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
                lead: int = 1) -> List[torch.Tensor]:
    """Per-shard contiguous blocks of ``f`` on their devices; ``lead``
    leading axes (components) are not spatial."""
    nb = block_shape(mesh, f.shape[lead:])
    blocks = []
    for k, dev in enumerate(mesh.devices):
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
    orthotropic)."""
    leaves = {f.name: shard_field(getattr(mat, f.name), mesh, lead=0)
              for f in dataclasses.fields(mat)}
    return [dataclasses.replace(mat, **{k: v[s] for k, v in leaves.items()})
            for s in range(mesh.size)]


def gather_state(blocks: Sequence[torch.Tensor], mesh: DomainMesh,
                 lead: int = 1, device=None) -> torch.Tensor:
    """Join per-shard blocks back into the global field, on ``device``
    (default: the first block's)."""
    device = blocks[0].device if device is None else torch.device(device)
    nsx, nsy = mesh.axis_size("sx"), mesh.axis_size("sy")
    rows = []
    for i in range(nsx):
        row = [blocks[mesh.index(i, j)].to(device) for j in range(nsy)]
        rows.append(torch.cat(row, dim=lead + 1) if nsy > 1 else row[0])
    return torch.cat(rows, dim=lead) if nsx > 1 else rows[0]
