"""``MultiBodyEngine(mesh=)`` on a mesh that spans two processes.

Two gloo ranks run the contact engine on meshes whose CPU shards they
share: ``elastic3d_contact`` n=12 on 2x2 with ranks ``[0, 0, 1, 1]`` (one
mesh row a rank) in its three forms, ``"fused"`` in float32
(``fused_spmd``), ``"torch"`` in float64 with a Maxwell corrector on the
lower body (``torch_spmd``) and ``"sweep"`` in float32 (``sweep_spmd``);
the canonical order on a one-axis sx=4 mesh (``fused_canonical_spmd``);
and two 2D bodies bonded across x on sx=2 with ranks ``[0, 1]``, conforming
and non-conforming. Each starts from a smooth random state and a partly
broken bond mask, with receivers on shard edges of the upper body. Every
rank's bodies, bond masks and traces must equal the same run in one
process on the same mesh exactly (max abs difference 0); that run is held
to JAX by tests/test_torch_multibody_mesh*.py, and the float64 2x2 case is
also held here to JAX's ``MultiBodyEngine`` on its virtual devices (1e-9,
masks equal). The workers are this file (``python
tests/test_torch_multihost_contact.py <mode> ...``, see
tests/test_torch_multihost.py), and import no JAX.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

#: case -> (mesh, kernel, dtype, bodies): "3d" elastic3d_contact n=12,
#: "2d" / "2d_nc" the conforming / non-conforming 2D pair
CASES = {"fused_2x2": ("2x2", "fused", "f32", "3d"),
         "torch_2x2": ("2x2", "torch", "f64", "3d"),
         "sweep_2x2": ("2x2", "sweep", "f32", "3d"),
         "canonical_sx4": ("sx4", "fused", "f32", "3d"),
         "pair2d_sx2": ("sx2", "torch", "f64", "2d"),
         "pair2d_nc_sx2": ("sx2", "torch", "f64", "2d_nc"),
         "pair2d_nc_sweep_sx2": ("sx2", "sweep", "f32", "2d_nc")}
#: the path each case resolves to
PATHS = {"fused_2x2": "fused_spmd", "torch_2x2": "torch_spmd",
         "sweep_2x2": "sweep_spmd", "canonical_sx4": "fused_canonical_spmd",
         "pair2d_sx2": "torch_spmd", "pair2d_nc_sx2": "torch_spmd",
         "pair2d_nc_sweep_sx2": "sweep_spmd"}
NSTEPS = 6
#: the ranks of each mesh's shards: one mesh row a rank
RANKS = {"2x2": (0, 0, 1, 1), "sx4": (0, 0, 1, 1), "sx2": (0, 1)}


def contact_3d(kernel, maxwell=False):
    """elastic3d_contact n=12, its contact made a 4e4 Pa fracture on z
    (tests/test_torch_multibody_mesh.py::contact_pair), two receivers on
    shard edges of the upper body, optionally a Maxwell corrector on the
    lower one."""
    from gcm_tpu_torch.scenarios import elastic3d_contact
    from gcm_tpu_torch.solver.correctors import MaxwellCorrector
    from gcm_tpu_torch.task import DetectorSpec

    bodies, contacts = elastic3d_contact(n=12, nsteps=NSTEPS)
    contacts = tuple(dataclasses.replace(
        c, kind="bonded", tensile_strength=4e4, broken_kind="free", axis=2)
        for c in contacts)
    L = 1000.0
    bodies = {**bodies, "upper": dataclasses.replace(
        bodies["upper"], detectors=DetectorSpec(points=(
            (L / 2, L / 2, 0.0), (0.1 * L, 0.9 * L, 50.0))))}
    if maxwell:
        bodies["lower"] = dataclasses.replace(
            bodies["lower"], correctors=(MaxwellCorrector(tau=0.05),))
    return _kernel(bodies, kernel), contacts


def pair_2d(nc, kernel, n=8):
    """tests/test_torch_multibody_mesh.py::pair_2d: two elastic2d bodies
    bonded across a's high-x face with a 4e4 Pa strength, b conforming (n x
    6) or not (n x 12 over the same height), a receiver on each."""
    from gcm_tpu_torch import task as T
    from gcm_tpu_torch.materials import IsotropicMaterial
    from gcm_tpu_torch.solver.contact import ContactSpec

    rock = IsotropicMaterial.from_speeds(2500.0, 4000.0, 2300.0)
    soft = IsotropicMaterial.from_speeds(2000.0, 2500.0, 1200.0)
    h = 10.0
    borders = {(a, s): T.BorderSpec("absorbing")
               for a in (0, 1) for s in (0, 1)}
    time = T.TimeSpec(cfl=0.8, nsteps=NSTEPS)
    a = T.Task(name="a", model="elastic2d",
               grid=T.GridSpec(shape=(n, 6), h=(h, h)),
               default_material=rock, borders=dict(borders), time=time,
               order=2, detectors=T.DetectorSpec(points=((3 * h, 2 * h),)))
    gb = (T.GridSpec(shape=(n, 12), h=(h, 5 * h / 11),
                     origin=((n - 1) * h, 0.0)) if nc else
          T.GridSpec(shape=(n, 6), h=(h, h), origin=((n - 1) * h, 0.0)))
    b = T.Task(name="b", model="elastic2d", grid=gb, default_material=soft,
               borders=dict(borders), time=time, order=2,
               detectors=T.DetectorSpec(points=(((n + 4) * h, 3 * h),)))
    return _kernel({"a": a, "b": b}, kernel), (
        ContactSpec("a", "b", axis=0, kind="bonded", tensile_strength=4e4),)


def _kernel(bodies, kernel):
    return {k: dataclasses.replace(t, kernel=kernel)
            for k, t in bodies.items()}


def mesh_of(name, ranks=None, device="cpu"):
    """The mesh ``name`` (2x2, sx4 or sx2) of shards on ``device``;
    ``ranks``: its shards' ranks (None: this process holds them all)."""
    from gcm_tpu_torch.parallel.sharding import DomainMesh, domain_mesh

    if name == "2x2":
        return domain_mesh(3, [device] * 4, (2, 2), ranks)
    if name == "sx4":
        return DomainMesh((device,) * 4, (4,), ("sx",), ranks)
    return domain_mesh(2, [device] * 2, None, ranks)


def start_state(bodies, ncomp, seed):
    """Per body a smooth random state (velocities ~1, stresses ~1e5, as
    tests/test_torch_multibody_mesh.py::random_state) and per fracture
    contact a bond mask 30% broken (per side where the maps do not
    conform): a ``state_dict`` at step 0."""
    rng = np.random.default_rng(seed)
    us = {}
    for name, task in bodies.items():
        u = rng.standard_normal((ncomp,) + task.grid.shape)
        for a in range(1, u.ndim):
            u = 0.25 * np.roll(u, 1, a) + 0.5 * u + 0.25 * np.roll(u, -1, a)
        u[task.grid.dim:] *= 1e5
        us[name] = u
    return {"us": us, "step": 0}


def build(case, ranks=None):
    """The case's engine on its mesh, from its start state, with its bond
    masks partly broken."""
    import torch

    from gcm_tpu_torch.engine_multi import MultiBodyEngine

    mesh, kernel, dtype, kind = CASES[case]
    if kind == "3d":
        bodies, contacts = contact_3d(kernel, maxwell=kernel == "torch")
    else:
        bodies, contacts = pair_2d(kind == "2d_nc", kernel)
    eng = MultiBodyEngine(bodies, contacts, device="cpu",
                          dtype={"f32": torch.float32,
                                 "f64": torch.float64}[dtype],
                          mesh=mesh_of(mesh, ranks),
                          canonical_layout=mesh == "sx4")
    state = start_state(bodies, eng.model.ncomp, list(CASES).index(case))
    rng = np.random.default_rng(3)
    bonded = {}
    for ci, m in eng.bonded.items():
        sides = m if isinstance(m, dict) else {None: m}
        got = {s: (rng.random(tuple(v.shape)) > 0.3).astype(np.float64)
               for s, v in sides.items()}
        bonded[str(ci)] = got if isinstance(m, dict) else got[None]
    eng.load_state(dict(state, bonded=bonded))
    return eng


def flat(res, eng=None):
    """A run's bodies, masks, traces and path as flat arrays, and with
    ``eng`` which of its shards this process held."""
    out = {f"body_{k}": v for k, v in res.bodies.items()}
    for ci, m in res.bonded.items():
        for s, v in (m.items() if isinstance(m, dict) else [("", m)]):
            out[f"bonded_{ci}_{s}"] = v
    out.update({f"traces_{k}": v for k, v in (res.traces or {}).items()})
    out["path"] = np.asarray(res.path)
    if eng is not None:
        out["held"] = np.asarray([u is not None for u in eng.us[next(iter(
            eng.us))]])
    return out


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """Every case run once on two ranks; rank 0's and rank 1's results."""
    from test_torch_multihost import spawn

    d = tmp_path_factory.mktemp("multihost_contact")
    spawn(__file__, "contact", d)
    return [dict(np.load(d / f"runs_{r}.npz")) for r in (0, 1)]


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_contact_equals_one_process(two_rank_runs, case):
    eng = build(case)
    want = flat(eng.run(), eng)
    assert str(want["path"]) == PATHS[case]
    ranks = RANKS[CASES[case][0]]
    for r, run in enumerate(two_rank_runs):
        got = {k[len(case) + 1:]: v for k, v in run.items()
               if k.startswith(case + "/")}
        assert set(got) == set(want)
        assert got["held"].tolist() == [q == r for q in ranks]
        for k, w in want.items():
            if k != "held":
                np.testing.assert_array_equal(got[k], w, err_msg=k)
                assert got[k].dtype == w.dtype
    masks = [v for k, v in want.items() if k.startswith("bonded_")]
    assert masks and min(float(m.mean()) for m in masks) < 0.7  # it broke
    assert all(np.abs(v).max() > 0 for k, v in want.items()
               if k.startswith("traces_"))


def test_two_rank_contact_matches_jax_f64(two_rank_runs):
    """The float64 2x2 case against JAX's MultiBodyEngine on the same mesh
    of its virtual devices (one GSPMD program), from the same state and
    masks: 1e-9, masks equal."""
    import jax
    import jax.numpy as jnp

    from gcm_tpu.engine_multi import MultiBodyEngine as JMultiBodyEngine
    from gcm_tpu.parallel.sharding import domain_mesh as jdomain_mesh
    from gcm_tpu.solver.correctors import MaxwellCorrector as JMaxwell
    from test_torch_multibody import _agree
    from test_torch_multibody_mesh import contact_pair

    (jb, jc), _ = contact_pair(12, NSTEPS, "fracture", detectors=True)
    jb = {**jb, "lower": dataclasses.replace(
        jb["lower"], correctors=(JMaxwell(tau=0.05),))}
    jeng = JMultiBodyEngine(jb, jc, dtype=jnp.float64, mesh=jdomain_mesh(
        3, jax.devices("cpu")[:4], (2, 2)))
    state = build("torch_2x2").state_dict()
    jeng.load_state({"us": {k: jnp.asarray(v) for k, v in
                            state["us"].items()},
                     "bonded": {k: jnp.asarray(v) for k, v in
                                state["bonded"].items()}, "step": 0})
    want = jeng.run()
    run = two_rank_runs[1]
    got = {k[len("torch_2x2/"):]: v for k, v in run.items()
           if k.startswith("torch_2x2/")}
    _agree(SimpleNamespace(
        nsteps=want.nsteps, dt=jeng.dt,
        bodies={k: got[f"body_{k}"] for k in ("upper", "lower")},
        traces={"upper": got["traces_upper"]},
        bonded={0: got["bonded_0_"]}), want, "f64")


#: the card's case (tests/test_torch_gpu.py -k two_ranks): elastic3d_contact
#: n=32 on 2x2 shards of cuda:0 from a partly broken bond mask, the fused
#: and the per-sweep forms, the fused one also cut at CARD_CUT and resumed
#: through a checkpoint file
CARD_STEPS = {"fused": 32, "sweep": 32}
CARD_CUT = 17


def card_engine(kernel, ranks=None):
    import torch

    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.scenarios import elastic3d_contact

    bodies, contacts = elastic3d_contact(n=32, nsteps=CARD_STEPS[kernel])
    eng = MultiBodyEngine(_kernel(bodies, kernel), contacts,
                          mesh=mesh_of("2x2", ranks, "cuda:0"))
    eng.bonded = {0: torch.as_tensor(card_mask(), device=eng.device)}
    return eng


def card_mask():
    """The card case's bond mask at the start, 30% broken."""
    return (np.random.default_rng(3).random((32, 32)) > 0.3).astype(
        np.float32)


def card_runs(ranks=None, ckdir=None):
    """Both forms' results and this process's launches of the kernels in
    each; with ``ckdir``, the fused run cut at CARD_CUT, its checkpoint
    written there and every rank resuming from it."""
    from gcm_tpu_torch.parallel.multihost import files_written, writes_files
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_interior, fused_spmd_ring)
    from gcm_tpu_torch.ops.sweep import sweep_stage
    from gcm_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    fns = (fused_spmd_interior, fused_spmd_ring, sweep_stage)
    out = {}
    for kernel in CARD_STEPS:
        eng = card_engine(kernel, ranks)
        for fn in fns:
            fn.launches = 0
        out.update({f"{kernel}/{k}": v for k, v in flat(eng.run()).items()})
        out[f"{kernel}/launches"] = np.asarray([fn.launches for fn in fns])
    if ckdir is not None:
        part = card_engine("fused", ranks)
        part.nsteps = CARD_CUT
        part.run()
        state = part.state_dict()
        if writes_files(part.mesh):
            save_checkpoint(ckdir, CARD_CUT, state)
        files_written(part.mesh)
        again = card_engine("fused", ranks)
        again.load_state(restore_checkpoint(ckdir))
        out.update({f"resumed/{k}": v for k, v in flat(again.run()).items()})
    return out


def _save_card_runs(_mesh_of, d):
    import torch.distributed as dist

    out = card_runs((0, 0, 1, 1), os.path.join(d["dir"], "checkpoints"))
    np.savez(os.path.join(d["dir"], f"card_{dist.get_rank()}.npz"), **out)
    return np.zeros(0), []


def _save_runs(_mesh_of, d):
    import torch.distributed as dist

    out = {}
    for case in CASES:
        eng = build(case, RANKS[CASES[case][0]])
        for k, v in flat(eng.run(), eng).items():
            out[f"{case}/{k}"] = v
    np.savez(os.path.join(d["dir"], f"runs_{dist.get_rank()}.npz"), **out)
    return np.zeros(0), []


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_multihost import worker_main

    worker_main(sys.argv[1:], {"contact": _save_runs,
                               "card": _save_card_runs})
