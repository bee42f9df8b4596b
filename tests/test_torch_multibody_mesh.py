"""The port's MultiBodyEngine on a mesh against the JAX package's.

The port holds every body in per-shard blocks on co-resident CPU shards
(``parallel.sharding.DomainMesh`` over ``"cpu"``); JAX runs on the 8
virtual CPU devices of tests/conftest.py. The forms (``eng.path``) and what
each is held to:

- ``fused_spmd`` (the plain versions of the interior and ring kernels per
  body, then the face-row fixups on put-together slabs), float32: JAX's
  unsharded jnp engine, to 1e-5 normalized;
- ``torch_spmd`` (the per-sweep halo stage with the plain sweep), float64:
  JAX's jnp engine on the same mesh (one GSPMD program), to 1e-9;
- ``sweep_spmd`` (the same stage with the sweep kernel's plain version),
  float32: JAX's unsharded jnp engine, to 1e-5 normalized.

Each starts from a smooth random state (stresses ~1e5, so the interface
acts from the first step) and a partly broken bond mask where the contact
breaks; bond masks must be equal. JAX's interpret-mode kernels on a mesh
are not run (too slow here): JAX engines built with its kernels only show
which form JAX resolves. tests/test_torch_multibody_mesh_canon.py holds the
canonical order under a mesh, the per-sweep form and the resumes.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import gcm_tpu.materials as jmaterials
import gcm_tpu.solver.contact as jcontact_mod
import gcm_tpu.task as jtask_mod
import gcm_tpu_torch.materials as tmaterials
import gcm_tpu_torch.solver.contact as tcontact_mod
import gcm_tpu_torch.task as ttask_mod
from gcm_tpu.engine_multi import MultiBodyEngine as JMultiBodyEngine
from gcm_tpu.parallel.sharding import domain_mesh as jdomain_mesh
from gcm_tpu.scenarios import elastic2d_basin_refined as jbasin
from gcm_tpu.scenarios import elastic3d_contact as jcontact
from gcm_tpu.solver.correctors import MaxwellCorrector as JMaxwell
from gcm_tpu_torch import cli
from gcm_tpu_torch.engine_multi import MultiBodyEngine
from gcm_tpu_torch.parallel.sharding import (
    DomainMesh, domain_mesh, gather_faces, gather_state, place, scatter_face,
    shard_state,
)
from gcm_tpu_torch.scenarios import elastic2d_basin_refined as tbasin
from gcm_tpu_torch.scenarios import elastic3d_contact as tcontact
from gcm_tpu_torch.solver.correctors import MaxwellCorrector as TMaxwell
from gcm_tpu_torch.utils.checkpoint import restore_checkpoint
from test_torch_multibody import _agree
from test_torch_step import norm_err

#: contact name -> ContactSpec fields
KINDS = {"bonded": dict(kind="bonded"),
         "slip": dict(kind="slip"),
         "fracture": dict(kind="bonded", tensile_strength=4e4,
                          broken_kind="free")}


def meshes(name):
    """(JAX mesh over the virtual devices, port mesh over CPU shards) of
    ``name``: "2x2" and "4x1" have the axes ('sx', 'sy'), "sx<n>" and
    "sy<n>" the one axis they name, over n shards."""
    devs = jax.devices("cpu")
    if name in ("2x2", "4x1"):
        shape = (2, 2) if name == "2x2" else (4, 1)
        return (jdomain_mesh(3, devs[:4], shape),
                domain_mesh(3, ["cpu"] * 4, shape))
    axis, n = ("sx" if name.startswith("sx") else "sy"), int(name[2:])
    return (Mesh(np.asarray(devs[:n]), (axis,)),
            DomainMesh(("cpu",) * n, (n,), (axis,)))


def random_state(bodies, ncomp, seed=0):
    """Per body a smooth random state: velocities ~1, stresses ~1e5."""
    rng = np.random.default_rng(seed)
    us = {}
    for name, task in bodies.items():
        u = rng.standard_normal((ncomp,) + task.grid.shape)
        for a in range(1, u.ndim):
            u = 0.25 * np.roll(u, 1, a) + 0.5 * u + 0.25 * np.roll(u, -1, a)
        u[task.grid.dim:] *= 1e5
        us[name] = u
    return us


def partly_broken(contacts, bodies, seed=3):
    """A common initial bond mask (30% broken) per fracture contact."""
    rng = np.random.default_rng(seed)
    out = {}
    for ci, c in enumerate(contacts):
        if c.tensile_strength is not None:
            shape = c.span or tuple(
                s for a, s in enumerate(bodies[c.body_a].grid.shape)
                if a != c.axis)
            out[ci] = (rng.random(shape) > 0.3).astype(np.float64)
    return out


def start_both(jeng, eng, us, bonded, jdtype):
    """Give the JAX and the port engine the same state and masks (None:
    each keeps its own fresh masks)."""
    if bonded is None:
        jb, tb = jeng.bonded, eng.bonded
    else:
        jb = tb = bonded
    jeng.load_state({"us": {k: jnp.asarray(v, jdtype) for k, v in us.items()},
                     "bonded": {str(k): jax.tree.map(
                         lambda m: jnp.asarray(m, jdtype), v)
                         for k, v in jb.items()},
                     "step": 0})
    eng.load_state({"us": us, "bonded": {str(k): v for k, v in tb.items()},
                    "step": 0})


def contact_pair(n, nsteps, kind=None, axis=2, detectors=False):
    """elastic3d_contact in both packages (JAX's, port's), the contact made
    ``kind`` on ``axis``, and receivers on shard edges of the upper body."""
    out = []
    for build, task_mod in ((jcontact, jtask_mod), (tcontact, ttask_mod)):
        bodies, contacts = build(n=n, nsteps=nsteps)
        over = dict(KINDS[kind], axis=axis) if kind else dict(axis=axis)
        contacts = tuple(dataclasses.replace(
            c, **{"tensile_strength": None, **over}) for c in contacts)
        if detectors:
            L = 1000.0
            up = bodies["upper"]
            bodies = {**bodies, "upper": dataclasses.replace(
                up, detectors=task_mod.DetectorSpec(points=(
                    (L / 2, L / 2, 0.0), (0.1 * L, 0.9 * L, 50.0))))}
        out.append((bodies, contacts))
    return out


def with_kernel(bodies, kernel):
    return {k: dataclasses.replace(t, kernel=kernel)
            for k, t in bodies.items()}


def pair_2d(nc: bool, n: int = 8, nsteps: int = 4):
    """Two elastic2d bodies side by side along x, every extent even: body a
    (n x 6) and body b, conforming (n x 6) or non-conforming (n x 12 over
    the same height, h against 5h/11), bonded across a's high-x face; in
    both packages (JAX's, port's)."""
    out = []
    for task_mod, mat_mod, contact_mod in (
            (jtask_mod, jmaterials, jcontact_mod),
            (ttask_mod, tmaterials, tcontact_mod)):
        rock = mat_mod.IsotropicMaterial.from_speeds(2500.0, 4000.0, 2300.0)
        soft = mat_mod.IsotropicMaterial.from_speeds(2000.0, 2500.0, 1200.0)
        h = 10.0
        borders = {(a, s): task_mod.BorderSpec("absorbing")
                   for a in (0, 1) for s in (0, 1)}
        time = task_mod.TimeSpec(cfl=0.8, nsteps=nsteps)
        a = task_mod.Task(
            name="a", model="elastic2d",
            grid=task_mod.GridSpec(shape=(n, 6), h=(h, h)),
            default_material=rock, borders=dict(borders), time=time,
            order=2)
        gb = (task_mod.GridSpec(shape=(n, 12), h=(h, 5 * h / 11),
                                origin=((n - 1) * h, 0.0)) if nc else
              task_mod.GridSpec(shape=(n, 6), h=(h, h),
                                origin=((n - 1) * h, 0.0)))
        b = task_mod.Task(name="b", model="elastic2d", grid=gb,
                          default_material=soft, borders=dict(borders),
                          time=time, order=2)
        out.append(({"a": a, "b": b},
                    (contact_mod.ContactSpec("a", "b", axis=0,
                                             kind="bonded",
                                             tensile_strength=4e4),)))
    return out


# ---------------------------------------------------------- face slabs

@pytest.mark.parametrize("mesh_name", ["2x2", "4x1", "sy4"])
def test_face_slabs_gather_and_scatter_back(mesh_name):
    """``gather_faces`` gives the global face slab, also along a split axis
    (there only the edge shards hold it); ``scatter_face`` writes a slab
    back as writing the global field would; ``place`` finds a node's
    shard and local index."""
    _, mesh = meshes(mesh_name)
    u = torch.arange(3 * 8 * 12 * 5, dtype=torch.float64).reshape(3, 8, 12, 5)
    blocks = shard_state(u, mesh)
    block = blocks[0].shape[1:]
    for axis in range(3):
        for side in (0, 1):
            for depth in (1, 2):
                sl = [slice(None)] * 4
                sl[1 + axis] = slice(-depth, None) if side else slice(depth)
                got = gather_faces([(blocks, axis, side, depth, 1)], mesh)[0]
                assert torch.equal(got, u[tuple(sl)])
                want, bs = u.clone(), [b.clone() for b in blocks]
                want[tuple(sl)] = -got - 1
                scatter_face(bs, mesh, axis, side, -got - 1)
                assert torch.equal(gather_state(bs, mesh), want)
    for node in ((0, 0, 0), (7, 11, 4), (4, 6, 2), (3, 5, 1)):
        k, local = place(mesh, block, node)
        assert torch.equal(blocks[k][(slice(None),) + local],
                           u[(slice(None),) + node])


# --------------------------------------------------------------- the forms

def _jax_form(jeng):
    form = ("fused" if jeng._fused_multi is not None else
            "sweep" if jeng._raw_stage is not None else "torch")
    return form, jeng._perm


#: (mesh, kernel, contact axis, canonical_layout) -> JAX's choice, held
#: against the port's on elastic3d_contact
RESOLVE = [("2x2", "fused", 2, False), ("2x2", "fused", 2, True),
           ("4x1", "fused", 2, True), ("4x1", "fused", 1, False),
           ("sx4", "fused", 2, False), ("sx4", "fused", 2, True),
           ("sy4", "fused", 2, True), ("sx2", "fused", 0, True),
           ("2x2", "fused", 1, False), ("2x2", "sweep", 2, False),
           ("2x2", "torch", 2, True), ("sy4", "sweep", 2, False)]


@pytest.mark.parametrize("case", RESOLVE, ids=str)
def test_forms_resolve_as_in_jax(case):
    """The port picks the form JAX picks (JAX engines built with its
    kernels, not run), and under the canonical order the JAX permutation as
    its splitting order: a 2x2 or 4x1 mesh keeps (0, 1, 2), a one-axis mesh
    takes (ca, rest) and splits x. One difference is meant: where JAX runs
    its plain GSPMD step for a kernel because its halo stage splits only
    the leading axis ``sx`` (a ``('sy',)`` mesh), the port's halo stage
    splits any axis and runs the sweep kernel (``sweep_spmd``)."""
    mesh_name, kernel, axis, canon = case
    jmesh, mesh = meshes(mesh_name)
    (jb, jc), (tb, tc) = contact_pair(12, 2, axis=axis)
    jkernel = {"fused": "pallas_fused", "sweep": "pallas",
               "torch": "jnp"}[kernel]
    jeng = JMultiBodyEngine(with_kernel(jb, jkernel), jc, mesh=jmesh,
                            canonical_layout=canon)
    eng = MultiBodyEngine(with_kernel(tb, kernel), tc, device="cpu",
                          mesh=mesh, canonical_layout=canon)
    form, perm = _jax_form(jeng)
    if form == "torch" and kernel != "torch":
        assert "sx" not in jmesh.axis_names
        form = "sweep"
    assert eng.path == (form + ("_canonical" if perm else "") + "_spmd")
    assert eng._fwd == (perm or (0, 1, 2))
    if perm:
        assert eng.mesh.axis_names == ("sx",)
    assert all(isinstance(u, list) and len(u) == mesh.size
               for u in eng.us.values())


@pytest.mark.parametrize("mesh_name,kind", [("2x2", "fracture"),
                                            ("4x1", "slip"),
                                            ("sx4", "bonded")])
def test_fused_spmd_form_matches_jax_f32(mesh_name, kind):
    """The sharded fused composition, with receivers on shard edges and the
    lower body's source on a shard boundary."""
    _, mesh = meshes(mesh_name)
    (jb, jc), (tb, tc) = contact_pair(12, 6, kind, detectors=True)
    jeng = JMultiBodyEngine(jb, jc)
    eng = MultiBodyEngine(with_kernel(tb, "fused"), tc, device="cpu",
                          mesh=mesh)
    assert eng.path == "fused_spmd"
    start_both(jeng, eng, random_state(tb, 9), partly_broken(tc, tb),
               jnp.float32)
    got = eng.run()
    assert got.path == "fused_spmd" and got.traces["upper"].shape == (6, 2, 9)
    want = jeng.run()
    _agree(got, want, "f32")
    if kind == "fracture":
        assert got.bonded[0].mean() < partly_broken(tc, tb)[0].mean()


def test_torch_spmd_form_matches_jax_mesh_f64():
    """kernel="torch" on 2x2 shards, with fracture, a Maxwell corrector on
    each shard after the fixups, receivers and the source: JAX's jnp engine
    on the same mesh (GSPMD), float64."""
    jmesh, mesh = meshes("2x2")
    (jb, jc), (tb, tc) = contact_pair(12, 4, "fracture", detectors=True)
    jb = {**jb, "lower": dataclasses.replace(
        jb["lower"], correctors=(JMaxwell(tau=0.05),))}
    tb = {**tb, "lower": dataclasses.replace(
        tb["lower"], correctors=(TMaxwell(tau=0.05),))}
    jeng = JMultiBodyEngine(jb, jc, dtype=jnp.float64, mesh=jmesh)
    eng = MultiBodyEngine(tb, tc, device="cpu", dtype=torch.float64,
                          mesh=mesh)
    assert eng.path == "torch_spmd"
    start_both(jeng, eng, random_state(tb, 9, seed=1), partly_broken(tc, tb),
               jnp.float64)
    _agree(eng.run(), jeng.run(), "f64")


@pytest.mark.parametrize("nc", [False, True], ids=["conforming",
                                                   "non-conforming"])
def test_2d_pair_on_sx2_matches_jax(nc):
    """Two 2D bodies bonded across x, on sx = 2 shards: the contact axis is
    the split one, so each face row lies whole on an edge shard (a's last,
    b's first). A 2D body never takes the fused SPMD form (as in JAX);
    kernel="torch" is held to JAX's jnp engine on the same mesh in float64,
    kernel="sweep" (the sweep kernel's plain version) to the port's
    unsharded per-sweep path in float32, 1e-6 normalized, masks equal."""
    (jb, jc), (tb, tc) = pair_2d(nc)
    jmesh = jdomain_mesh(2, jax.devices("cpu")[:2])
    mesh = domain_mesh(2, ["cpu"] * 2)
    us, bonded = random_state(tb, 5, seed=2), {}
    jeng = JMultiBodyEngine(jb, jc, dtype=jnp.float64, mesh=jmesh)
    eng = MultiBodyEngine(tb, tc, device="cpu", dtype=torch.float64,
                          mesh=mesh)
    assert eng.path == "torch_spmd" and bool(eng.ncmaps) == nc
    assert isinstance(eng.bonded[0], dict) == nc     # per-side masks
    start_both(jeng, eng, us, None, jnp.float64)
    got, want = eng.run(), jeng.run()
    _agree(got, want, "f64")
    for ci, m in got.bonded.items():
        masks = m.values() if isinstance(m, dict) else [m]
        assert min(float(v.mean()) for v in masks) < 1.0   # it broke

    runs = []
    for m in (mesh, None):
        eng = MultiBodyEngine(with_kernel(tb, "sweep"), tc, device="cpu",
                              mesh=m)
        eng.load_state({"us": us, "bonded": dict(eng.bonded), "step": 0})
        runs.append(eng.run())
    got, want = runs
    assert got.path == "sweep_spmd" and want.path == "sweep"
    for k, w in want.bodies.items():
        assert norm_err(got.bodies[k], w) < 1e-6
    for ci, w in want.bonded.items():
        for s in (w if isinstance(w, dict) else [None]):
            np.testing.assert_array_equal(
                got.bonded[ci][s] if s else got.bonded[ci],
                w[s] if s else w)


# ---------------------------------------------------------------- refusals

def test_uneven_extents_and_other_refusals():
    """The reference basin is 2n-1 wide, so no n shards: JAX's device_put
    and the port both refuse it. The port also refuses a mesh that would
    split the last spatial axis of a 2D body, devices that disagree with
    ``device``, and anything but a DomainMesh."""
    devs = jax.devices("cpu")
    with pytest.raises(ValueError, match="divisible"):
        JMultiBodyEngine(*jbasin(n=9, nsteps=2),
                         mesh=jdomain_mesh(2, devs[:2]))
    with pytest.raises(ValueError, match="not divisible.*device_put"):
        MultiBodyEngine(*tbasin(n=9, nsteps=2),
                        mesh=domain_mesh(2, ["cpu"] * 2))
    (_, _), (tb, tc) = pair_2d(False)
    with pytest.raises(ValueError, match="last spatial axis"):
        MultiBodyEngine(tb, tc, mesh=DomainMesh(("cpu",) * 2, (2,), ("sy",)))
    with pytest.raises(ValueError, match="disagrees"):
        MultiBodyEngine(tb, tc, device="cuda:1",
                        mesh=domain_mesh(2, ["cpu"] * 2))
    with pytest.raises(TypeError, match="DomainMesh"):
        MultiBodyEngine(tb, tc, mesh=("cpu", "cpu"))


def test_cli_contact_run_on_a_mesh_gives_the_unsharded_numbers(tmp_path,
                                                               capsys):
    """``run elastic3d_contact --mesh 2,2 --device cpu``: a 2-axis mesh, so
    the default splitting order, as in JAX; its state and masks equal the
    unsharded run with ``--no-canonical-layout``, and the summary names the
    mesh and the path."""
    base = ["run", "elastic3d_contact", "--n", "12", "--nsteps", "4",
            "--device", "cpu", "--checkpoint-every", "4"]
    outs = {}
    for tag, extra in (("mesh", ["--mesh", "2,2"]),
                       ("whole", ["--no-canonical-layout"])):
        out = str(tmp_path / tag)
        assert cli.main(base + ["--outdir", out] + extra) == 0
        outs[tag] = (json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1]), out)
    summary, out = outs["mesh"]
    assert summary["mesh"] == "2,2" and summary["path"] == "torch_spmd"
    assert outs["whole"][0]["path"] == "torch"
    got = restore_checkpoint(os.path.join(out, "checkpoints"))
    want = restore_checkpoint(os.path.join(outs["whole"][1], "checkpoints"))
    for k in want["us"]:
        np.testing.assert_allclose(got["us"][k], want["us"][k], rtol=1e-6,
                                   atol=1e-6 * np.abs(want["us"][k]).max())
    np.testing.assert_array_equal(got["bonded"]["0"], want["bonded"]["0"])
    assert np.abs(got["us"]["lower"]).max() > 0
