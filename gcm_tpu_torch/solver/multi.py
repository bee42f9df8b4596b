"""Multi-body stepping: per-body sweeps stitched by contact solves.

Counterpart of ``gcm_tpu/solver/multi.py``. All bodies advance each sweep
together; on sweeps along a contact's axis the two bodies' interface faces
exchange outgoing invariants and take the contact solve instead of a border
condition. Bodies share the model and the interpolation order; each has
its own grid, materials and border conditions. Interfaces are conforming
(collocated nodes, optionally offset sub-rectangles ``lo_a``/``lo_b``/
``span``) or non-conforming, through the static maps of
``solver.contact_nc`` (``ncmaps``, per contact index).

Three compositions, the same physics:

- :func:`step_multi`: the contact solve inside each sweep (the semantics of
  record, plain torch);
- :func:`step_multi_fast`: a raw sweep per body (the per-sweep kernel), then
  borders and contacts as exact face-slab fixups;
- :func:`step_multi_fused`: a whole fused step per body, then the contact
  face rows recomputed from the pre-step state (:func:`apply_contact_fixups`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from gcm_tpu_torch.materials import MaterialFields
from gcm_tpu_torch.models.spec import Model
from gcm_tpu_torch.ops.interp import stencil_radius
from gcm_tpu_torch.ops.stage import (
    apply_zero_invariants, reconstruct_pair, stage_pair_updates,
)
from gcm_tpu_torch.solver.boundary import (
    apply_borders_post, correct_pair_at_face,
)
from gcm_tpu_torch.solver.contact import (
    ContactSpec, apply_contact, apply_contact_post,
)
from gcm_tpu_torch.solver.contact_nc import apply_contact_nc_post
from gcm_tpu_torch.solver.gcm import stage
from gcm_tpu_torch.task import BorderSpec
from gcm_tpu_torch.utils.profiling import count, enabled, span

BodyStates = Dict[str, torch.Tensor]
BondedState = Dict[int, object]     # contact index -> interface mask(s)
BodyBorders = Dict[str, Dict[Tuple[int, int], BorderSpec]]


def _full_contact_faces(contacts: Sequence[ContactSpec], axis: int,
                        ncmaps) -> set:
    """(body, axis, side) of the faces a conforming whole-face contact on
    ``axis`` consumes: the body's own border condition is skipped there.
    Partial-overlap contacts keep the face's condition, and the contact
    solve then overwrites only the overlap."""
    faces = set()
    for ci, c in enumerate(contacts):
        if c.axis == axis and c.span is None and ci not in ncmaps:
            faces.add((c.body_a, axis, 1))
            faces.add((c.body_b, axis, 0))
    return faces


def stage_multi(model: Model, us: BodyStates,
                mats: Dict[str, MaterialFields], dt: float,
                hs: Dict[str, Sequence[float]], axis: int, order: int,
                borders: BodyBorders, contacts: Sequence[ContactSpec],
                bonded: BondedState, ncmaps: Optional[Dict[int, object]] = None
                ) -> Tuple[BodyStates, BondedState]:
    """One sweep along ``axis`` for every body, with contact coupling."""
    ncmaps = ncmaps or {}
    st = model.stage(axis)
    # 1. raw invariant updates per body
    views = {name: mats[name].axis_view(axis, st) for name in us}
    pair_ws = {name: stage_pair_updates(model, u, views[name],
                                        dt / hs[name][axis], axis, order)
               for name, u in us.items()}
    full_faces = _full_contact_faces(contacts, axis, ncmaps)

    # 2. border corrections on every face no whole-face contact consumes
    for name in us:
        for k, (w_l, w_r, p) in pair_ws[name].items():
            z = views[name].pair_z[k]
            for side in (0, 1):
                if (name, axis, side) in full_faces:
                    continue
                bc = borders.get(name, {}).get((axis, side))
                if bc is not None:
                    val = bc.pair_value(p.traction_axis, st.axis)
                    w_l, w_r = correct_pair_at_face(w_l, w_r, z, model.sign,
                                                    bc, axis, side, val)
            pair_ws[name][k] = (w_l, w_r, p)

    # 3. conforming contact solves on this axis (normal pair first; they
    # overwrite the overlap sub-slabs)
    new_bonded = dict(bonded)
    for ci, c in enumerate(contacts):
        if c.axis != axis or ci in ncmaps:
            continue
        pa, pb, nb = apply_contact(c, model.dim, pair_ws[c.body_a],
                                   pair_ws[c.body_b], views[c.body_a],
                                   views[c.body_b], bonded.get(ci),
                                   normal_axis=st.axis)
        pair_ws[c.body_a], pair_ws[c.body_b] = pa, pb
        if nb is not None:
            new_bonded[ci] = nb

    # 4. reconstruction
    out: BodyStates = {}
    for name, u in us.items():
        comps: Dict[int, torch.Tensor] = {}
        for k, (w_l, w_r, p) in pair_ws[name].items():
            A_new, B_new = reconstruct_pair(w_l, w_r, views[name].pair_z[k],
                                            u[p.vel], model.sign)
            comps[p.sigma] = A_new
            comps[p.vel] = B_new
        apply_zero_invariants(model, u, comps, views[name], axis)
        out[name] = torch.stack([comps.get(i, u[i])
                                 for i in range(model.ncomp)])

    # 5. non-conforming contacts: per-side mapped solves as fixups
    for ci, c in enumerate(contacts):
        if c.axis != axis or ci not in ncmaps:
            continue
        ua, ub, nb = apply_contact_nc_post(
            c, model, ncmaps[ci], us[c.body_a], out[c.body_a], us[c.body_b],
            out[c.body_b], views[c.body_a], views[c.body_b], bonded.get(ci))
        out[c.body_a], out[c.body_b] = ua, ub
        if nb is not None:
            new_bonded[ci] = nb
    return out, new_bonded


def step_multi(model: Model, us: BodyStates, mats: Dict[str, MaterialFields],
               dt: float, hs: Dict[str, Sequence[float]], order: int,
               borders: BodyBorders, contacts: Sequence[ContactSpec],
               bonded: BondedState, axes: Optional[Sequence[int]] = None,
               ncmaps: Optional[Dict[int, object]] = None
               ) -> Tuple[BodyStates, BondedState]:
    """One multi-body step: :func:`stage_multi` along each of ``axes``."""
    for a in (axes if axes is not None else range(model.dim)):
        us, bonded = stage_multi(model, us, mats, dt, hs, a, order, borders,
                                 contacts, bonded, ncmaps)
    return us, bonded


# ------------------------------------------------------------ face access

def _slab_idx(dim: int, a: int, side: int, n: int) -> Tuple:
    """Index of the ``n``-deep slab at face ``(a, side)`` of a state."""
    sl = [slice(None)] * dim
    sl[a] = slice(-n, None) if side == 1 else slice(0, n)
    return (slice(None),) + tuple(sl)


def _mat_slice(mat, idx: Tuple):
    """The fields of ``mat`` (isotropic or orthotropic) cut to ``idx``."""
    return dataclasses.replace(mat, **{f.name: getattr(mat, f.name)[idx]
                                       for f in dataclasses.fields(mat)})


class WholeFaces:
    """How the contact phases read and write the bodies' faces when each
    body is one tensor (``mats``: each body's material fields, or their
    ``AxisViewCache``). A post-fixup reads the whole body and its whole
    per-axis view and gives the whole new body; the fused composition's
    fixups read views of the face slabs and write the face rows in place.
    ``parallel.faces.ShardedFaces`` does the same on the shards of a mesh,
    so the contact algebra never sees how a body is held."""

    def __init__(self, model: Model, mats: Dict[str, object]):
        self.model, self.mats = model, mats

    def faces(self, requests):
        """What a post-fixup phase reads of face ``(axis, side)`` of ``u``,
        for each request ``(name, u, axis, side)``, fetched together: here
        the whole ``u``."""
        return [u for _, u, _, _ in requests]

    def face_view(self, name: str, axis: int, side: int):
        """The material view along ``axis`` that goes with :meth:`faces`."""
        return self.mats[name].axis_view(axis, self.model.stage(axis))

    def put_face(self, name: str, u, axis: int, side: int, new):
        """``u`` with the post-fixed face ``new`` (of :meth:`faces`) in
        place."""
        return new

    def slabs(self, requests):
        """The ``depth``-deep slab of ``u`` at face ``(axis, side)`` for
        each request ``(name, u, axis, side, depth)``: every slab a phase
        reads, fetched together."""
        return [u[_slab_idx(self.model.dim, axis, side, depth)]
                for _, u, axis, side, depth in requests]

    def mat_slab(self, name: str, axis: int, side: int, depth: int):
        """The material fields of a slab of :meth:`slabs`."""
        return _mat_slice(self.mats[name],
                          _slab_idx(self.model.dim, axis, side, depth)[1:])

    def put_row(self, name: str, u, axis: int, side: int, row):
        """``u`` with its face row at ``(axis, side)`` overwritten by
        ``row``, in place."""
        u[_slab_idx(self.model.dim, axis, side, 1)] = row
        return u

    def borders_post(self, name: str, u, u_raw, axis: int, bcs):
        """The border post-fixup of a border-free sweep of body ``name``."""
        return apply_borders_post(self.model, u, u_raw, self.mats[name],
                                  axis, bcs)


def stage_multi_fast(model: Model, us: BodyStates,
                     mats: Dict[str, MaterialFields], axis: int,
                     borders: BodyBorders, contacts: Sequence[ContactSpec],
                     bonded: BondedState, raw_stage,
                     ncmaps: Optional[Dict[int, object]] = None,
                     faces: Optional[WholeFaces] = None
                     ) -> Tuple[BodyStates, BondedState]:
    """One sweep with a raw kernel sweep per body and fixups:
    ``raw_stage(name, u, axis)`` sweeps one body with no borders (the
    per-sweep kernel); borders and contacts then follow as slab fixups
    (``apply_borders_post``, ``apply_contact_post``,
    ``apply_contact_nc_post``), exact because the reconstruction is
    invertible. ``faces`` says how the bodies are held (default: whole
    tensors, :class:`WholeFaces` of ``mats``)."""
    ncmaps = ncmaps or {}
    faces = faces or WholeFaces(model, mats)
    full_faces = _full_contact_faces(contacts, axis, ncmaps)
    out: BodyStates = {}
    for name, u in us.items():
        u_raw = raw_stage(name, u, axis)
        bcs = {f: b for f, b in borders.get(name, {}).items()
               if f[0] == axis and (name,) + f not in full_faces}
        out[name] = (faces.borders_post(name, u, u_raw, axis, bcs) if bcs
                     else u_raw)
    new_bonded = dict(bonded)
    for ci, c in enumerate(contacts):
        if c.axis != axis:
            continue
        sides = ((c.body_a, 1), (c.body_b, 0))
        olda, newa, oldb, newb = faces.faces(
            [(n, v[n], axis, s) for n, s in sides for v in (us, out)])
        va, vb = (faces.face_view(n, axis, s) for n, s in sides)
        if ci in ncmaps:
            ua, ub, nb = apply_contact_nc_post(
                c, model, ncmaps[ci], olda, newa, oldb, newb, va, vb,
                bonded.get(ci))
        else:
            ua, ub, nb = apply_contact_post(c, model, olda, newa, oldb, newb,
                                            va, vb, bonded.get(ci))
        for (n, s), new in zip(sides, (ua, ub)):
            out[n] = faces.put_face(n, out[n], axis, s, new)
        if nb is not None:
            new_bonded[ci] = nb
    return out, new_bonded


def step_multi_fast(model: Model, us: BodyStates,
                    mats: Dict[str, MaterialFields], borders: BodyBorders,
                    contacts: Sequence[ContactSpec], bonded: BondedState,
                    raw_stage, axes: Optional[Sequence[int]] = None,
                    ncmaps: Optional[Dict[int, object]] = None,
                    faces: Optional[WholeFaces] = None
                    ) -> Tuple[BodyStates, BondedState]:
    """One step of :func:`stage_multi_fast` along each of ``axes``."""
    for a in (axes if axes is not None else range(model.dim)):
        us, bonded = stage_multi_fast(model, us, mats, a, borders, contacts,
                                      bonded, raw_stage, ncmaps, faces)
    return us, bonded


def fused_contacts_ok(model: Model, shapes: Dict[str, Tuple[int, ...]],
                      contacts: Sequence[ContactSpec], order: int,
                      ncmaps: Optional[Dict[int, object]] = None) -> bool:
    """Whether :func:`step_multi_fused`'s face-row fixups are exact for this
    contact topology: conforming contacts only; per body, contacts on one
    axis (two axes couple at the shared face-edge line); at most one
    contact per face; every contacted body deeper than the r+1 fixup slab
    along the axis."""
    if ncmaps:
        return False
    depth = stencil_radius(order) + 1
    body_axes: Dict[str, set] = {}
    seen_faces = set()
    for c in contacts:
        for name, side in ((c.body_a, 1), (c.body_b, 0)):
            body_axes.setdefault(name, set()).add(c.axis)
            face = (name, c.axis, side)
            if face in seen_faces:
                return False
            seen_faces.add(face)
            if shapes[name][c.axis] <= depth:
                return False
    return all(len(s) == 1 for s in body_axes.values())


def step_multi_fused(model: Model, us: BodyStates,
                     mats: Dict[str, MaterialFields], dt: float,
                     hs: Dict[str, Sequence[float]], order: int,
                     borders: BodyBorders, contacts: Sequence[ContactSpec],
                     bonded: BondedState, fused_body,
                     axes: Optional[Sequence[int]] = None,
                     faces: Optional[WholeFaces] = None
                     ) -> Tuple[BodyStates, BondedState]:
    """A whole step per body in one pass, then the contact face rows.

    ``fused_body(name, u, axes)`` runs a body's full step (its non-contact
    borders in place, a raw edge clamp at whole-face contacts): the fused
    kernel, or the fused SPMD step across the shards of a mesh. Only the
    interface face row of the sweep along the contact axis reads
    out-of-domain values, and the later sweeps never move data across that
    axis, so every other cell is already right; the face row is recomputed
    from the pre-step state on an (r+1)-deep slab by
    :func:`apply_contact_fixups`. Eligibility is :func:`fused_contacts_ok`.
    """
    axes = tuple(axes) if axes is not None else tuple(range(model.dim))
    out = {name: fused_body(name, u, axes) for name, u in us.items()}
    return apply_contact_fixups(model, us, out, mats, dt, hs, order, borders,
                                contacts, bonded, axes, faces)


def apply_contact_fixups(model: Model, us: BodyStates, out: BodyStates,
                         mats: Dict[str, MaterialFields], dt: float,
                         hs: Dict[str, Sequence[float]], order: int,
                         borders: BodyBorders,
                         contacts: Sequence[ContactSpec],
                         bonded: BondedState, axes: Tuple[int, ...],
                         faces: Optional[WholeFaces] = None
                         ) -> Tuple[BodyStates, BondedState]:
    """The face-row phase of :func:`step_multi_fused`, on the pre-step
    states ``us`` and the raw fused outputs ``out`` (whose face rows it
    overwrites in place): per contact, redo the sweeps before the contact
    axis on an (r+1)-deep slab of each body (transverse borders apply, the
    slab's inner cut is no face), sweep the contact axis there, apply the
    contact solve to the face row, and redo the later sweeps on that row.
    The slabs keep the task layout: each sweep runs along its own tensor
    dimension (the JAX package moves the contact axis first, for the TPU's
    lanes; both are exact). ``faces`` reads the slabs and writes the rows
    back (default: whole tensors, :class:`WholeFaces` of ``mats``; on a
    mesh ``parallel.faces.ShardedFaces`` gathers the slabs from the shards and
    scatters the rows into them), so only it knows how a body is held."""
    with span("gcm.contact.fixups"):
        axes = tuple(axes)
        depth = stencil_radius(order) + 1
        dim = model.dim
        faces = faces or WholeFaces(model, mats)
        out = dict(out)
        new_bonded = dict(bonded)
        # every slab of the pre-step states the phase reads, fetched at
        # once: the phase writes only into ``out``
        slabs = list(faces.slabs([(name, us[name], c.axis, side, depth)
                                  for c in contacts for name, side in
                                  ((c.body_a, 1), (c.body_b, 0))]))
        if enabled():
            count("gcm.contact.face_nodes",
                  sum(t.numel() // (t.shape[0] * depth) for t in slabs))
            count("gcm.contact.slab_bytes",
                  sum(t.numel() * t.element_size() for t in slabs))
        slabs = iter(slabs)
        for ci, c in enumerate(contacts):
            a = c.axis
            pos = axes.index(a)
            before, after = axes[:pos], axes[pos + 1:]
            st = model.stage(a)
            pre, swept, matsl = {}, {}, {}
            for name, side in ((c.body_a, 1), (c.body_b, 0)):
                usl = next(slabs)
                msl = faces.mat_slab(name, a, side, depth)
                bcs_t = {f: b for f, b in borders.get(name, {}).items()
                         if f[0] != a}
                for b_ax in before:
                    usl = stage(model, usl, msl, dt, hs[name], b_ax, order,
                                bcs_t)
                pre[name], matsl[name] = usl, msl
                # the contact-axis sweep: only the face row is used; a
                # partial overlap applies the face's own border first
                # (stage_multi's order: the border, then the contact solve on
                # the overlap)
                bc_face = borders.get(name, {}).get((a, side))
                bcs_a = ({(a, side): bc_face} if bc_face is not None
                         and c.span is not None else None)
                swept[name] = stage(model, usl, msl, dt, hs[name], a, order,
                                    bcs_a)

            ua_fix, ub_fix, nb = apply_contact_post(
                c, model, pre[c.body_a], swept[c.body_a], pre[c.body_b],
                swept[c.body_b], matsl[c.body_a].axis_view(a, st),
                matsl[c.body_b].axis_view(a, st), bonded.get(ci))
            if nb is not None:
                new_bonded[ci] = nb
            for name, ufix in ((c.body_a, ua_fix), (c.body_b, ub_fix)):
                side = 1 if name == c.body_a else 0
                # the face row of the slab: its last row on body_a's high
                # face, its first on body_b's low face
                fidx = _slab_idx(dim, a, side, 1)
                frow = ufix[fidx]
                mrow = _mat_slice(matsl[name], fidx[1:])
                bcs_t = {f: b for f, b in borders.get(name, {}).items()
                         if f[0] != a}
                for b_ax in after:
                    frow = stage(model, frow, mrow, dt, hs[name], b_ax,
                                 order, bcs_t)
                out[name] = faces.put_row(name, out[name], a, side, frow)
    return out, new_bonded
