"""A cell's run as the reference sees it, worked out from the configuration
and the seed's draws alone, and the comparisons that decide ``correct``.

:class:`Problem` derives again what the program derives: each node's
medium from the layers, the time step from the CFL number, the source's
amplitude at every step and the receivers' nodes. It then follows steps
of the run from a state in blocks (a box around the source, or slabs
across the grid with a halo), and holds the program's output against its
own:

- ``start``: the program's state after its first steps from rest, in a box
  around the source that the steps cannot leave (the source injection, the
  medium and the time step);
- ``state``: the program's state ``k`` steps after a state it handed over,
  on every node of every body (the kernel step with its borders, the
  contact solve);
- ``traces``: its receivers' records of those steps;
- ``bonds``: the nodes where its bond masks differ from the reference's.

Each error is per component the largest gap over the largest magnitude of
the reference's component, and the largest over the components.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from gcm_bench.reference.elastic import (
    Block, Contact, Medium, axes_of_step, components, radius, ricker, sweep,
)

_FACE_NAMES = {f"{'xyz'[a]}{s}": (a, s) for a in range(3) for s in (0, 1)}
#: nodes of every body in one slab of the end check, about (a slab is one
#: or more planes across the slab axis)
_SLAB_NODES = 1 << 24


class _Stats:
    """Per component the largest gap and the largest reference value."""

    def __init__(self, ncomp: int):
        self.gap = np.zeros(ncomp)
        self.ref = np.zeros(ncomp)

    def add(self, prog: torch.Tensor, ref: torch.Tensor) -> None:
        d = (prog.to(ref.dtype) - ref).abs()
        C = ref.shape[0]
        self.gap = np.maximum(self.gap, d.reshape(C, -1).amax(1)
                              .double().cpu().numpy())
        self.ref = np.maximum(self.ref, ref.abs().reshape(C, -1).amax(1)
                              .double().cpu().numpy())

    def error(self) -> float:
        scale = np.where(self.ref > 0, self.ref, max(self.ref.max(), 1e-300))
        return float((self.gap / scale).max())


class Problem:
    """The reference's view of one run: ``config`` (a configuration file's
    content) and ``draws`` (:func:`gcm_bench.harness.draws.draw`), in the
    floating type ``dtype`` on ``device``."""

    def __init__(self, config: Dict, draws: Dict, dtype=torch.float64,
                 device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        self.order = int(config["order"])
        self.symmetrize = bool(config["symmetrize"])
        self.fwd = tuple(config["sweep_order"])
        self.comps = components(len(self.fwd))
        self.bodies: Dict[str, Dict] = {}
        cps = []
        for name, body in config["bodies"].items():
            shape = tuple(body["shape"])
            h = tuple(L / (n - 1) for L, n in zip(body["lengths"], shape))
            med = self._medium(body, draws["materials"][name], shape, h)
            cps.append(float(med.cp.max()))
            faces = {_FACE_NAMES[k]: v for k, v in body["borders"].items()}
            self.bodies[name] = dict(shape=shape, h=h, med=med, faces=faces)
        self.dt = float(config["cfl"]) * min(
            min(b["h"]) for b in self.bodies.values()) / max(cps)
        self.contacts = [Contact(c["body_a"], c["body_b"], c["axis"],
                                 c.get("tensile_strength"))
                         for c in config["contacts"]]
        wav = config["source_wavelet"]
        self.wavelet = (float(wav["f0"]), float(wav["t0"]),
                        float(wav["amplitude"]))
        self.source = (draws["source"]["body"],
                       [self.comps.index(c) for c in wav["components"]],
                       tuple(draws["source"]["node"]))
        rec = draws["receivers"]
        self.receivers = (rec["body"], [tuple(n) for n in rec["nodes"]])

    def _medium(self, body: Dict, mats: Dict, shape, h) -> Medium:
        """Each node's medium: the default, then each layer in turn over
        the nodes whose coordinate along its axis lies in ``[lo, hi]``."""
        dim = len(shape)
        axes = {layer["axis"] for layer in body.get("layers", ())}
        if len(axes) > 1:
            raise ValueError("the reference layers a body along one axis")
        d = mats["default"]
        if not axes:
            vals = [torch.full((1,) * dim, float(d[k]), dtype=self.dtype,
                               device=self.device)
                    for k in ("rho", "cp", "cs")]
            return Medium.from_speeds(*vals)
        ax = next(iter(axes))
        coord = body["origin"][ax] + h[ax] * np.arange(shape[ax],
                                                       dtype=np.float64)
        fields = {k: np.full(shape[ax], float(d[k])) for k in d}
        for layer, m in zip(body["layers"], mats["layers"]):
            inside = (coord >= layer["lo"]) & (coord <= layer["hi"])
            for k in fields:
                fields[k][inside] = m[k]
        view = [1] * dim
        view[ax] = shape[ax]
        vals = [torch.as_tensor(fields[k], device=self.device)
                .to(self.dtype).reshape(view) for k in ("rho", "cp", "cs")]
        return Medium.from_speeds(*vals)

    # ------------------------------------------------------------ stepping

    def amplitude(self, n: int) -> float:
        """The source's addition after step ``n`` (0-based): the wavelet at
        the step's end time, times the time step."""
        t = np.float64(n + 1) * self.dt
        return float(ricker(np.asarray(t), *self.wavelet)) * self.dt

    def _advance(self, blocks: Dict[str, Block], bonded, lo: Dict, n0: int,
                 k: int, record=None):
        """Steps ``n0 .. n0+k-1`` of the blocks, whose first node sits at
        ``lo[body]`` of the body's grid; ``record(step, blocks)`` after
        each."""
        sb, comps, node = self.source
        for n in range(n0, n0 + k):
            for a in axes_of_step(n, self.fwd, self.symmetrize):
                bonded = sweep(blocks, self.contacts, bonded, self.dt, a,
                               self.order)
            if sb in blocks:
                local = tuple(i - o for i, o in zip(node, lo[sb]))
                u = blocks[sb].u
                if all(0 <= i < s for i, s in zip(local, u.shape[1:])):
                    amp = self.amplitude(n)
                    for c in comps:
                        u[(c,) + local] += amp
            if record is not None:
                record(n, blocks)
        return bonded

    def _block(self, name: str, u, box: List[Tuple[int, int]]) -> Block:
        b = self.bodies[name]
        med = b["med"]
        faces = {}
        for a, (s, e) in enumerate(box):
            med = med.cut(a, s, e)
            for side, at_face in ((0, s == 0), (1, e == b["shape"][a])):
                if at_face and (a, side) in b["faces"]:
                    faces[(a, side)] = b["faces"][(a, side)]
        return Block(u=u, med=med, h=b["h"], faces=faces)

    # ------------------------------------------------------------ checks

    def start_box(self, steps: int) -> List[Tuple[int, int]]:
        """The box of the source's body that ``steps`` steps from rest
        cannot leave: the source node and the stencil's reach a step along
        every axis, and one node more."""
        sb, _, node = self.source
        shape = self.bodies[sb]["shape"]
        R = radius(self.order) * steps + 1
        box = [(max(0, i - R), min(n, i + R + 1)) for i, n in zip(node,
                                                                   shape)]
        for c in self.contacts:
            for name, side in ((c.body_a, 1), (c.body_b, 0)):
                s, e = box[c.axis]
                at_face = s == 0 if side == 0 else e == shape[c.axis]
                if name == sb and at_face:
                    raise ValueError("the start box reaches a contact face: "
                                     "draw the source farther from it")
        return box

    def start_error(self, prog_box: np.ndarray, steps: int,
                    control=None) -> Dict[str, float]:
        """``start``: the program's state in :meth:`start_box` after
        ``steps`` steps from rest against the reference's; with
        ``control`` (a :class:`Problem` in a lower type) also the
        control's."""
        box = self.start_box(steps)
        sb = self.source[0]
        shape = (len(self.comps),) + tuple(e - s for s, e in box)
        lo = {sb: tuple(s for s, _ in box)}
        out = {}
        ref = None
        for who, prob in (("reference", self), ("control", control)):
            if prob is None:
                continue
            blk = prob._block(sb, torch.zeros(shape, dtype=prob.dtype,
                                              device=prob.device), box)
            prob._advance({sb: blk}, {}, lo, 0, steps)
            if who == "reference":
                ref = blk.u
                st = _Stats(len(self.comps))
                st.add(torch.as_tensor(prog_box).to(self.device), ref)
                out["program"] = st.error()
            else:
                st = _Stats(len(self.comps))
                st.add(blk.u.to(self.device), ref)
                out["control"] = st.error()
        return out

    def slab_axis(self) -> int:
        """The axis the end check cuts into slabs: one no contact is on."""
        used = {c.axis for c in self.contacts}
        return min(a for a in range(len(self.fwd)) if a not in used)

    def end_errors(self, before: Dict, after: Dict, n0: int, k: int,
                   control=None) -> Dict[str, Dict[str, float]]:
        """``state``, ``traces`` and ``bonds``: the reference follows steps
        ``n0 .. n0+k-1`` from the program's state ``before`` (``{"us":
        {body: [C, *shape]}, "bonded": {contact index: mask}}``, host
        arrays) and holds ``after`` (the same keys, the state after those
        steps, and ``"traces"``: the receivers' ``[k, npoints, C]`` rows of
        those steps) against its own; with ``control`` (a
        :class:`Problem` in a lower type) it reads the control the same
        way. The bodies are cut into slabs along :meth:`slab_axis` of
        about ``_SLAB_NODES`` nodes, each with a halo the steps' reach
        cannot cross."""
        ax = self.slab_axis()
        halo = radius(self.order) * k + 1
        C = len(self.comps)
        plane = sum(math.prod(b["shape"]) // b["shape"][ax]
                    for b in self.bodies.values())
        width = max(1, _SLAB_NODES // plane)
        n_ax = {b["shape"][ax] for b in self.bodies.values()}
        if len(n_ax) != 1:
            raise ValueError("the bodies' extents along the slab axis differ")
        n_ax = n_ax.pop()
        # the program's states, on the reference's device once
        dev_before = {n: torch.from_numpy(np.asarray(v)).to(self.device)
                      for n, v in before["us"].items()}
        dev_after = {n: torch.from_numpy(np.asarray(v)).to(self.device)
                     for n, v in after["us"].items()}
        who = [("program", None), ("control", control)]
        stats = {w: _Stats(C) for w, p in who if w == "program" or p}
        bond_gaps = {w: 0 for w in stats}
        rb, rnodes = self.receivers
        rec_ref = np.zeros((k, len(rnodes), C))
        rec_ctl = np.zeros((k, len(rnodes), C))
        for s in range(0, n_ax, width):
            e = min(n_ax, s + width)
            hs, he = max(0, s - halo), min(n_ax, e + halo)
            outs = {}
            for tag, prob in (("reference", self), ("control", control)):
                if prob is None:
                    continue
                blocks, lo = {}, {}
                for name, b in self.bodies.items():
                    box = [(0, n) for n in b["shape"]]
                    box[ax] = (hs, he)
                    sl = [slice(None)] * len(b["shape"])
                    sl[ax] = slice(hs, he)
                    u = dev_before[name][(slice(None),) + tuple(sl)].to(
                        device=prob.device, dtype=prob.dtype,
                        memory_format=torch.contiguous_format)
                    blocks[name] = prob._block(name, u, box)
                    lo[name] = tuple(bx[0] for bx in box)
                bonded = {ci: torch.as_tensor(np.ascontiguousarray(
                    _cut_mask(m, self.contacts[ci], ax, hs, he))).to(
                    device=prob.device, dtype=prob.dtype)
                    for ci, m in before.get("bonded", {}).items()}
                recs = rec_ref if tag == "reference" else rec_ctl

                def record(n, blks, recs=recs):
                    for i, nd in enumerate(rnodes):
                        if s <= nd[ax] < e:
                            loc = list(nd)
                            loc[ax] -= hs
                            val = blks[rb].u[(slice(None),) + tuple(loc)]
                            recs[n - n0, i] = val.double().cpu().numpy()
                bonded = prob._advance(blocks, bonded, lo, n0, k, record)
                outs[tag] = (blocks, bonded)
            ref_blocks, ref_bonded = outs["reference"]
            for name, b in self.bodies.items():
                keep = [slice(None)] * (1 + len(b["shape"]))
                keep[1 + ax] = slice(s - hs, s - hs + (e - s))
                sl = [slice(None)] * (1 + len(b["shape"]))
                sl[1 + ax] = slice(s, e)
                ref = ref_blocks[name].u[tuple(keep)]
                prog = dev_after[name][tuple(sl)]
                stats["program"].add(prog, ref)
                if "control" in outs:
                    stats["control"].add(outs["control"][0][name].u[
                        tuple(keep)].to(self.device), ref)
            for ci, m in ref_bonded.items():
                c = self.contacts[ci]
                sel = _mask_keep(c, ax, s - hs, e - hs)
                ref_m = (m[sel] > 0.5).cpu().numpy()
                prog_m = _cut_mask(after["bonded"][ci], c, ax, s, e) > 0.5
                bond_gaps["program"] += int((ref_m != prog_m).sum())
                if "control" in outs:
                    ctl = outs["control"][1][ci][sel] > 0.5
                    bond_gaps["control"] += int(
                        (ctl.cpu().numpy() != ref_m).sum())
        res = {"state": {w: st.error() for w, st in stats.items()}}
        if rnodes:
            scale = np.where(stats["program"].ref > 0, stats["program"].ref,
                             1e-300)
            res["traces"] = {"program": float((np.abs(
                np.asarray(after["traces"], np.float64) - rec_ref)
                / scale).max())}
            if control is not None:
                res["traces"]["control"] = float(
                    (np.abs(rec_ctl - rec_ref) / scale).max())
        if self.contacts and before.get("bonded"):
            res["bonds"] = dict(bond_gaps)
        return res


def _mask_axis(c: Contact, ax: int) -> int:
    """The axis of a contact's mask (the face's axes, without the
    contact's) that is the slab axis ``ax``."""
    return ax if ax < c.axis else ax - 1


def _cut_mask(m, c: Contact, ax: int, s: int, e: int):
    sl = [slice(None)] * np.ndim(m)
    sl[_mask_axis(c, ax)] = slice(s, e)
    return m[tuple(sl)]


def _mask_keep(c: Contact, ax: int, s: int, e: int):
    sl = [slice(None)] * 2
    sl[_mask_axis(c, ax)] = slice(s, e)
    return tuple(sl)
