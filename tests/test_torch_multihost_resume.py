"""Checkpoints, outputs and resume on a mesh that spans two processes.

Two gloo ranks, one mesh row (two CPU shards of a 2x2 mesh) a rank, run
both structured engines through ``run_with_outputs``: ``Engine`` on
``elastic3d_explosion`` n=24 (``kernel="fused"``, f32, a ``.vti`` of vz
every 4 steps, checkpoints every 4, 12 steps) and ``MultiBodyEngine`` on the
fused 2x2 contact case of tests/test_torch_multihost_contact.py (a partly
broken bond mask, snapshots and checkpoints every 2, 6 steps). Each runs
uninterrupted, then cut and resumed from its own checkpoint directory,
every rank reading the file. The same sequence runs in one process on the
same mesh, and:

- a cut and resumed run equals the uninterrupted one exactly, on every
  rank (state, masks, traces), and each rank records the same host copies;
- each checkpointed step leaves one file for the whole run (no per-rank
  files, no ``*.tmp.npz``), with the contents of the one-process run's;
- the snapshots (``.vti``, ``.pvd``) and seismograms (``.bin``, ``.json``)
  are byte-identical to the one-process run's (an ``.npz`` holds the same
  arrays: a zip member records its write time);
- a two-rank checkpoint resumes in one process, and a one-process
  checkpoint on two ranks, each equal to the uninterrupted run;
- a JAX engine's ``state_dict`` as numpy arrays (float64, cut at the odd
  step 5) loads on two ranks (``kernel="torch"``) and ends within 1e-9 of
  JAX's uninterrupted run.

The workers are this file (``python tests/test_torch_multihost_resume.py
<mode> ...``, see tests/test_torch_multihost.py), and import no JAX.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

KINDS = ("engine", "multibody")
NSTEPS = {"engine": 12, "multibody": 6}
#: each kind's cut (a checkpointed step) and the one-process checkpoint's
#: (an odd step) resumed on two ranks
CUT = {"engine": 8, "multibody": 4}
ONE_CUT = {"engine": 7, "multibody": 3}
JAX_CUT = 5


def explosion(kernel="fused"):
    from gcm_tpu_torch.scenarios import get_scenario
    from gcm_tpu_torch.task import SnapshotSpec

    return dataclasses.replace(
        get_scenario("elastic3d_explosion", n=24, nsteps=NSTEPS["engine"]),
        kernel=kernel, snapshots=SnapshotSpec(every=4, fields=("vz",)))


def make(kind, ranks=None, dtype=None, kernel="fused"):
    """A fresh engine of ``kind`` on the 2x2 CPU mesh (``ranks``: its
    shards' ranks)."""
    import torch

    from gcm_tpu_torch.engine import Engine
    from test_torch_multihost_contact import build, mesh_of

    if kind == "engine":
        return Engine(explosion(kernel), mesh=mesh_of("2x2", ranks),
                      dtype=dtype or torch.float32)
    return build("fused_2x2", ranks)


def outputs(eng, kind, outdir):
    if kind == "engine":
        return eng.run_with_outputs(outdir, checkpoint_every=4)
    return eng.run_with_outputs(outdir, snapshot_every=2, checkpoint_every=2)


def result(res, kind):
    """A run's result as flat arrays."""
    if kind == "engine":
        return {"u": res.u, "traces": res.traces}
    from test_torch_multihost_contact import flat

    return flat(res)


def sequence(kind, root, ranks=None):
    """The uninterrupted run and the cut and resumed one, with their
    outputs under ``root``: ``{name: array}``."""
    from gcm_tpu_torch.utils.checkpoint import restore_checkpoint

    full = make(kind, ranks)
    out = {f"full/{k}": v for k, v in
           result(outputs(full, kind, os.path.join(root, f"{kind}_full")),
                  kind).items()}
    cut = os.path.join(root, f"{kind}_cut")
    part = make(kind, ranks)
    part.nsteps = CUT[kind]
    outputs(part, kind, cut)
    again = make(kind, ranks)
    again.load_state(restore_checkpoint(os.path.join(cut, "checkpoints")))
    out.update({f"resumed/{k}": v for k, v in
                result(outputs(again, kind, cut), kind).items()})
    for name, eng in (("full", full), ("part", part), ("again", again)):
        out[f"host_copies/{name}"] = np.asarray(eng.host_copies)
    return out


def one_process_checkpoint(kind, directory):
    """A one-process run cut at ``ONE_CUT`` saved as a checkpoint."""
    from gcm_tpu_torch.utils.checkpoint import save_checkpoint

    part = make(kind)
    part.nsteps = ONE_CUT[kind]
    part.run()
    save_checkpoint(directory, ONE_CUT[kind], part.state_dict())


def files(root):
    """Every file under ``root`` by its path there."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), root)] = os.path.join(
                d, n)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs (one-process checkpoints, a JAX state), the two ranks'
    results and files, and the same sequence in one process."""
    import jax
    import jax.numpy as jnp

    from gcm_tpu.engine import Engine as JEngine
    from gcm_tpu.scenarios import get_scenario as jget_scenario
    from gcm_tpu_torch.utils.checkpoint import save_checkpoint
    from test_torch_multihost import spawn

    d = tmp_path_factory.mktemp("multihost_resume")
    for kind in KINDS:
        one_process_checkpoint(kind, str(d / f"one_{kind}"))
    jtask = jget_scenario("elastic3d_explosion", n=24,
                          nsteps=NSTEPS["engine"])
    jfull = JEngine(jtask, dtype=jnp.float64).run()
    jpart = JEngine(jtask, dtype=jnp.float64)
    jpart.nsteps = JAX_CUT
    jpart.run()
    save_checkpoint(str(d / "jax"), JAX_CUT,
                    jax.tree.map(np.asarray, jpart.state_dict()))
    (d / "ranks").mkdir()
    spawn(__file__, "resume", d / "ranks")
    got = [dict(np.load(d / "ranks" / f"runs_{r}.npz")) for r in (0, 1)]
    want = {kind: sequence(kind, str(d / "one_process")) for kind in KINDS}
    return dict(dir=d, got=got, want=want, jax=jfull)


@pytest.mark.parametrize("kind", KINDS)
def test_two_rank_resume_equals_the_uninterrupted_run(runs, kind):
    want = runs["want"][kind]
    for got in runs["got"]:
        for key, w in want.items():
            np.testing.assert_array_equal(got[f"{kind}/{key}"], w,
                                          err_msg=key)
        for key in want:
            if key.startswith("full/"):
                np.testing.assert_array_equal(
                    got[f"{kind}/resumed/{key[5:]}"], want[key])
    assert want["host_copies/part"].tolist() == (
        [4, 8] if kind == "engine" else [2, 4])
    if kind == "multibody":    # the pre-broken mask broke further
        assert float(want["resumed/bonded_0_"].mean()) < 0.7


@pytest.mark.parametrize("kind", KINDS)
def test_one_checkpoint_file_a_step_and_the_one_process_files(runs, kind):
    """One checkpoint file a step with the one-process run's contents;
    snapshots and seismograms byte-identical to its files."""
    from gcm_tpu_torch.utils.checkpoint import restore_checkpoint

    root = runs["dir"]
    for run in (f"{kind}_full", f"{kind}_cut"):
        got, want = (files(root / where / run)
                     for where in ("ranks", "one_process"))
        assert sorted(got) == sorted(want)
        steps = (4, 8, 12) if kind == "engine" else (2, 4, 6)
        assert sorted(f for f in got if f.startswith("checkpoints")) == (
            sorted(os.path.join("checkpoints", f"step_{s}.npz")
                   for s in steps))
        assert any(f.endswith(".vti") for f in got)
        assert any(f.endswith(".pvd") for f in got)
        for rel, path in got.items():
            if rel.endswith(".npz"):
                with np.load(path) as a, np.load(want[rel]) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for k in a.files:
                        np.testing.assert_array_equal(a[k], b[k])
            else:
                with open(path, "rb") as a, open(want[rel], "rb") as b:
                    assert a.read() == b.read(), rel
        ck = restore_checkpoint(os.path.join(root / "ranks" / run,
                                             "checkpoints"))
        assert int(ck["step"]) == NSTEPS[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_move_between_two_ranks_and_one_process(runs, kind):
    """The two ranks' checkpoint at the cut resumes in one process, and
    the one-process checkpoint at an odd step on the two ranks, each equal
    to the uninterrupted run."""
    from gcm_tpu_torch.utils.checkpoint import restore_checkpoint

    want = runs["want"][kind]
    eng = make(kind)
    eng.load_state(restore_checkpoint(
        str(runs["dir"] / "ranks" / f"{kind}_full" / "checkpoints"),
        step=CUT[kind]))
    for key, v in result(eng.run(), kind).items():
        np.testing.assert_array_equal(v, want[f"full/{key}"], err_msg=key)
    for got in runs["got"]:
        for key, v in want.items():
            if key.startswith("full/"):
                np.testing.assert_array_equal(got[f"{kind}/one/{key[5:]}"],
                                              v, err_msg=key)


def test_a_jax_state_loads_on_two_ranks(runs):
    want = runs["jax"]
    for got in runs["got"]:
        for name, w in (("u", want.u), ("traces", want.traces)):
            g = got[f"jax/{name}"]
            assert g.shape == w.shape and g.dtype == np.float64
            np.testing.assert_allclose(g, w, rtol=1e-9,
                                       atol=1e-9 * np.abs(w).max())
    assert np.abs(want.traces).max() > 0


def _save_runs(_mesh_of, d):
    import torch
    import torch.distributed as dist

    from gcm_tpu_torch.utils.checkpoint import restore_checkpoint

    ranks = (0, 0, 1, 1)
    out = {}
    root = os.path.dirname(d["dir"])
    for kind in KINDS:
        for k, v in sequence(kind, d["dir"], ranks).items():
            out[f"{kind}/{k}"] = v
        eng = make(kind, ranks)
        eng.load_state(restore_checkpoint(os.path.join(root, f"one_{kind}")))
        out.update({f"{kind}/one/{k}": v
                    for k, v in result(eng.run(), kind).items()})
    eng = make("engine", ranks, torch.float64, "torch")
    eng.load_state(restore_checkpoint(os.path.join(root, "jax")))
    res = eng.run()
    out.update({"jax/u": res.u, "jax/traces": res.traces})
    np.savez(os.path.join(d["dir"], f"runs_{dist.get_rank()}.npz"), **out)
    return np.zeros(0), []


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_multihost import worker_main

    worker_main(sys.argv[1:], {"resume": _save_runs})
