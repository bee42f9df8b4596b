"""The contact phases' face access on the shards of a mesh.

``solver.multi.WholeFaces`` reads and writes the faces of bodies held as
one tensor each; :class:`ShardedFaces` does the same for bodies held as
per-shard blocks (``parallel.sharding``), so that the contact algebra of
``solver.multi`` and ``solver.contact_nc`` runs unchanged on a mesh and
only the gather and the write-back know how a body is sharded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from gcm_tpu_torch.materials import AxisViewCache
from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.parallel.halo import borders_post as halo_borders_post
from gcm_tpu_torch.parallel.sharding import gather_face, scatter_face
from gcm_tpu_torch.solver.multi import WholeFaces


class ShardedFaces(WholeFaces):
    """``WholeFaces`` for bodies held as per-shard blocks on ``mesh``
    (``mats``: each body's per-shard material fields, plain or from
    ``parallel.halo.extend_mats_once``). The faces and slabs a contact phase
    reads are put together on the first shard's device
    (``parallel.sharding.gather_face``), the rows it writes go back into
    the shards' blocks (``scatter_face``), and the material faces are
    gathered once. The border post-fixup runs on the shards at the domain
    faces (``parallel.halo.borders_post``). Bond masks stay whole on the
    first shard's device."""

    def __init__(self, model: Model, mesh, mats: Dict[str, Sequence]):
        super().__init__(model, mats)
        self.mesh = mesh
        self._mat_faces: Dict[Tuple, AxisViewCache] = {}

    def _mat_face(self, name: str, axis: int, side: int, depth: int):
        key = (name, axis, side, depth)
        if key not in self._mat_faces:
            ms = [m["base"].mat if isinstance(m, dict) else m
                  for m in self.mats[name]]
            self._mat_faces[key] = AxisViewCache(dataclasses.replace(
                ms[0], **{f.name: gather_face(
                    [getattr(m, f.name) for m in ms], self.mesh, axis, side,
                    depth, lead=0) for f in dataclasses.fields(ms[0])}))
        return self._mat_faces[key]

    def face(self, name, u, axis, side):
        return gather_face(u, self.mesh, axis, side, 1)

    def face_view(self, name, axis, side):
        return self._mat_face(name, axis, side, 1).axis_view(
            axis, self.model.stage(axis))

    def put_face(self, name, u, axis, side, new):
        return self.put_row(name, u, axis, side, new)

    def slab(self, name, u, axis, side, depth):
        return gather_face(u, self.mesh, axis, side, depth)

    def mat_slab(self, name, axis, side, depth):
        return self._mat_face(name, axis, side, depth).mat

    def put_row(self, name, u, axis, side, row):
        scatter_face(u, self.mesh, axis, side, row)
        return u

    def borders_post(self, name, u, u_raw, axis, bcs):
        return halo_borders_post(self.model, self.mesh, u, u_raw,
                                 self.mats[name], axis, bcs)
