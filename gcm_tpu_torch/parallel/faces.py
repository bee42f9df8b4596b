"""The contact phases' face access on the shards of a mesh.

``solver.multi.WholeFaces`` reads and writes the faces of bodies held as
one tensor each; :class:`ShardedFaces` does the same for bodies held as
per-shard blocks (``parallel.sharding``), so that the contact algebra of
``solver.multi`` and ``solver.contact_nc`` runs unchanged on a mesh and
only the gather and the write-back know how a body is sharded.

On a mesh that spans processes every rank gathers the whole slabs a phase
reads (one exchange a phase, ``parallel.sharding.gather_faces``), runs the
contact algebra on them as one process would, and writes back only the
rows of its own blocks: every rank computes the same floats, so the bond
masks stay whole and identical on every rank with no exchange of their
own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from gcm_tpu_torch.materials import AxisViewCache
from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.parallel.halo import borders_post as halo_borders_post
from gcm_tpu_torch.parallel.p2p import Transport
from gcm_tpu_torch.parallel.sharding import (
    first_local, gather_faces, scatter_face,
)
from gcm_tpu_torch.solver.multi import WholeFaces


class ShardedFaces(WholeFaces):
    """``WholeFaces`` for bodies held as per-shard blocks on ``mesh``
    (``mats``: each body's per-shard material fields, plain or from
    ``parallel.halo.extend_mats_once``). The faces and slabs a contact phase
    reads are put together on the first shard's device (on a mesh that
    spans processes: on every rank's own, all of a phase's in one exchange),
    the rows it writes go back into this process's blocks
    (``scatter_face``), and the material faces are gathered once
    (:meth:`prepare`). The border post-fixup runs on the shards at the
    domain faces (``parallel.halo.borders_post``). Bond masks stay whole on
    the first shard's device."""

    def __init__(self, model: Model, mesh, mats: Dict[str, Sequence]):
        super().__init__(model, mats)
        self.mesh = mesh
        self._mat_faces: Dict[Tuple, AxisViewCache] = {}
        #: a phase's transport (its host buffers kept across steps), by the
        #: faces the phase reads
        self._transports: Dict[Tuple, Transport] = {}

    def _gather(self, requests, lead: int, key: Tuple):
        transport = self._transports.get(key)
        if transport is None and self.mesh.spans_processes:
            transport = self._transports[key] = Transport(self.mesh)
        return gather_faces([r + (lead,) for r in requests], self.mesh,
                            transport=transport)

    def prepare(self, keys: Sequence[Tuple[str, int, int, int]]) -> None:
        """Gather the material faces ``(body, axis, side, depth)`` not yet
        held, in one exchange."""
        keys = [k for k in dict.fromkeys(keys) if k not in self._mat_faces]
        if not keys:
            return
        reqs, made = [], []
        for name, axis, side, depth in keys:
            ms = [None if m is None else
                  m["base"].mat if isinstance(m, dict) else m
                  for m in self.mats[name]]
            like = first_local(ms)
            names = [f.name for f in dataclasses.fields(like)]
            reqs += [([None if m is None else getattr(m, f) for m in ms],
                      axis, side, depth) for f in names]
            made.append((like, names))
        got = iter(self._gather(reqs, 0, ("mat",) + tuple(keys)))
        for key, (like, names) in zip(keys, made):
            self._mat_faces[key] = AxisViewCache(dataclasses.replace(
                like, **{f: next(got) for f in names}))

    def _mat_face(self, name: str, axis: int, side: int, depth: int):
        key = (name, axis, side, depth)
        self.prepare([key])
        return self._mat_faces[key]

    def faces(self, requests):
        return self.slabs([r + (1,) for r in requests])

    def face_view(self, name, axis, side):
        return self._mat_face(name, axis, side, 1).axis_view(
            axis, self.model.stage(axis))

    def put_face(self, name, u, axis, side, new):
        return self.put_row(name, u, axis, side, new)

    def slabs(self, requests):
        return self._gather([(u, axis, side, depth)
                             for _, u, axis, side, depth in requests], 1,
                            tuple((n, a, s, d) for n, _, a, s, d in requests))

    def mat_slab(self, name, axis, side, depth):
        return self._mat_face(name, axis, side, depth).mat

    def put_row(self, name, u, axis, side, row):
        scatter_face(u, self.mesh, axis, side, row)
        return u

    def borders_post(self, name, u, u_raw, axis, bcs):
        return halo_borders_post(self.model, self.mesh, u, u_raw,
                                 self.mats[name], axis, bcs)
