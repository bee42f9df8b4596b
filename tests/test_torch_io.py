"""The port's output files, checkpoint module, energy, Jacobians and CLI.

- ``snapshot/vtk.py`` and ``snapshot/seismo.py`` write the same bytes as
  the JAX package's writers on the same numpy arrays (the .npz members
  compared, the zip's own timestamps aside).
- ``utils/checkpoint.py``: a round trip of nested state, ``latest_step``,
  the newest three steps kept, an atomic write whose interrupted temporary
  file the next save removes, a template without traces.
- ``utils/energy.py`` against JAX's at float64 1e-12, and decaying under
  absorbing borders; ``models/spec.py`` diagonalizing ``utils/linal.py``'s
  Jacobians (as tests/test_linal.py holds the JAX package).
- ``python -m gcm_tpu_torch run`` with ``--outdir``, ``--snapshot-every``,
  ``--checkpoint-every``, then ``--resume`` (the seismograms of the resumed
  run equal an uninterrupted run's) and ``--profile``; the simplex and
  contact runners with the same flags.
"""

import json
import os
import subprocess
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.models.spec import get_model as jget_model
from gcm_tpu.snapshot import seismo as jseismo
from gcm_tpu.snapshot import vtk as jvtk
from gcm_tpu.utils.energy import elastic_energy as jelastic_energy
from gcm_tpu_torch import cli
from gcm_tpu_torch.materials import IsotropicMaterial, MaterialFields
from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.snapshot import seismo, vtk
from gcm_tpu_torch.solver.gcm import step
from gcm_tpu_torch.task import BorderSpec
from gcm_tpu_torch.utils import checkpoint
from gcm_tpu_torch.utils.energy import elastic_energy
from gcm_tpu_torch.utils.linal import invariant_matrix, jacobian

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


@pytest.mark.parametrize("shape", [(5, 4, 3), (6, 7), (9,)])
def test_vti_bytes_match_jax(tmp_path, rng, shape):
    model = get_model({3: "elastic3d", 2: "elastic2d", 1: "elastic1d"}[
        len(shape)])
    u = rng.standard_normal((model.ncomp,) + shape).astype(np.float32)
    fields = vtk.snapshot_fields(model, u)
    assert fields.keys() == jvtk.snapshot_fields(model, u).keys()
    args = (shape, (1.0, 2.5, 3.0)[:len(shape)], (0.5, -1.0, 2.0)[:len(shape)])
    vtk.write_vti(str(tmp_path / "t.vti"), *args, fields)
    jvtk.write_vti(str(tmp_path / "j.vti"), *args, fields)
    _same_bytes(tmp_path / "t.vti", tmp_path / "j.vti")


@pytest.mark.parametrize("dim", [2, 3])
def test_vtu_and_pvd_bytes_match_jax(tmp_path, rng, dim):
    pts = rng.random((7, dim))
    cells = rng.integers(0, 7, (4, dim + 1))
    fields = {"p": rng.standard_normal(7).astype(np.float32),
              "velocity": rng.standard_normal((dim, 7)),
              "damage": rng.random(7).astype(np.float32)}
    vtk.write_vtu(str(tmp_path / "t.vtu"), pts, cells, fields)
    jvtk.write_vtu(str(tmp_path / "j.vtu"), pts, cells, fields)
    _same_bytes(tmp_path / "t.vtu", tmp_path / "j.vtu")
    series = [(0.0125, "a&b_000002.vtu"), (0.025, "a<b_000004.vtu")]
    vtk.write_pvd(str(tmp_path / "t.pvd"), series)
    jvtk.write_pvd(str(tmp_path / "j.pvd"), series)
    _same_bytes(tmp_path / "t.pvd", tmp_path / "j.pvd")


def test_seismograms_match_jax(tmp_path, rng):
    tr = rng.standard_normal((10, 2, 5))
    args = (tr, 0.01, [(1.0, 2.0), (3.0, 4.0)], ["a", "b", "c", "d", "e"])
    seismo.save_seismograms(str(tmp_path / "t"), "rec", *args)
    jseismo.save_seismograms(str(tmp_path / "j"), "rec", *args)
    for ext in (".bin", ".json"):
        _same_bytes(tmp_path / "t" / f"rec{ext}", tmp_path / "j" / f"rec{ext}")
    with zipfile.ZipFile(tmp_path / "t" / "rec.npz") as zt, \
            zipfile.ZipFile(tmp_path / "j" / "rec.npz") as zj:
        assert zt.namelist() == zj.namelist()
        for name in zt.namelist():
            assert zt.read(name) == zj.read(name), name
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / "t" / "rec.bin", "<f4"),
        tr.astype(np.float32).ravel())


def test_checkpoint_round_trip_and_latest_step(tmp_path):
    ckdir = str(tmp_path / "ck")
    assert checkpoint.latest_step(ckdir) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(ckdir)
    state = {"u": torch.arange(12.0).reshape(3, 4), "step": 7,
             "aux": {}, "bonded": {"0": np.ones((2, 2)),
                                   "1": {"a": np.zeros(3), "b": np.ones(4)}},
             "us": {"lower": np.full((2, 3), 2.0, np.float32)},
             "traces": np.zeros((0, 2, 9), np.float32)}
    checkpoint.save_checkpoint(ckdir, 7, state)
    assert checkpoint.latest_step(ckdir) == 7
    got = checkpoint.restore_checkpoint(ckdir, state)
    assert set(got) == set(state) and got["aux"] == {}
    np.testing.assert_array_equal(got["u"], state["u"].numpy())
    assert int(got["step"]) == 7 and got["step"].ndim == 0
    np.testing.assert_array_equal(got["bonded"]["1"]["b"], np.ones(4))
    assert got["us"]["lower"].dtype == np.float32
    assert got["traces"].shape == (0, 2, 9)
    # a template without traces never picks them up
    nodet = {k: v for k, v in state.items() if k != "traces"}
    assert "traces" not in checkpoint.restore_checkpoint(ckdir, nodet)
    with pytest.raises(ValueError, match="'/'"):
        checkpoint.save_checkpoint(ckdir, 8, {"a/b": np.zeros(1)})


def test_checkpoints_rotate_and_write_atomically(tmp_path, monkeypatch):
    ckdir = tmp_path / "ck"
    for s in (2, 4, 6, 8, 10):
        checkpoint.save_checkpoint(str(ckdir), s, {"step": s})
    assert sorted(os.listdir(ckdir)) == ["step_10.npz", "step_6.npz",
                                         "step_8.npz"]
    # a process killed between the write and the rename leaves its
    # temporary file and the earlier checkpoints as they were
    with monkeypatch.context() as m:
        def killed(src, dst):
            raise KeyboardInterrupt
        m.setattr(checkpoint.os, "replace", killed)
        with pytest.raises(KeyboardInterrupt):
            checkpoint.save_checkpoint(str(ckdir), 12, {"step": 12})
    orphans = [f for f in os.listdir(ckdir) if f.endswith(".tmp.npz")]
    assert len(orphans) == 1
    assert checkpoint.latest_step(str(ckdir)) == 10
    assert int(checkpoint.restore_checkpoint(str(ckdir))["step"]) == 10
    # the next save removes the orphan
    checkpoint.save_checkpoint(str(ckdir), 12, {"step": 12})
    assert sorted(os.listdir(ckdir)) == ["step_10.npz", "step_12.npz",
                                         "step_8.npz"]


@pytest.mark.parametrize("period,snap,ck,every,last,fires,snaps,cks", [
    (2, 5, 0, 6, 18, [6, 12, 18], [6, 12, 18], []),
    (2, 60, 40, 20, 120, [40, 60, 80, 120], [60, 120], [40, 80, 120]),
    (2, 0, 3, 4, 12, [4, 8, 12], [], [4, 8, 12]),
    (1, 5, 3, 1, 12, [3, 5, 6, 9, 10, 12], [5, 10], [6, 9, 12]),
])
def test_output_callback_cadences(tmp_path, period, snap, ck, every, last,
                                  fires, snaps, cks):
    """Independent cadences rounded up to the period, the callback at
    their gcd; one state_dict at each step where either is due and none
    elsewhere, handed to the snapshot writer and the checkpoint."""
    taken, written = [], []

    def state_dict():
        taken.append(step)
        return {"step": step}

    cb, got = checkpoint.output_callback(
        str(tmp_path), period, snap, ck, state_dict,
        lambda n, state: written.append((n, int(state["step"]))))
    assert got == every
    for step in range(every, last + 1, every):
        cb(step, None)
    assert taken == fires
    assert written == [(n, n) for n in snaps]
    ckdir = tmp_path / "checkpoints"
    assert (sorted(int(f[5:-4]) for f in os.listdir(ckdir))
            if ckdir.exists() else []) == cks
    assert checkpoint.output_callback(str(tmp_path), 2, 0, 0, state_dict,
                                      None) == (None, 0)


def test_trace_record_across_a_resume(rng):
    """Restored rows, then a run's rows from two buffers (two shards, each
    with its receivers' positions), assembled mid-run and at the end; a
    run from step 0 drops the restored rows."""
    head = rng.standard_normal((3, 4, 2))
    rec = checkpoint.TraceRecord(4, 2)
    rec.restore(head)
    bufs = [(torch.zeros(5, 3, 2, dtype=torch.float64), np.array([0, 2, 3])),
            (torch.zeros(5, 1, 2, dtype=torch.float64), np.array([1]))]
    rec.start(bufs, resumed=True)
    rows = rng.standard_normal((5, 4, 2))
    for r in range(2):
        rec.put(r, torch.from_numpy(rows[r, [0, 2, 3]]),
                torch.from_numpy(rows[r, [1]]))
    np.testing.assert_array_equal(rec.assemble(),
                                  np.concatenate([head, rows[:2]]))
    for r in range(2, 5):
        rec.put(r, torch.from_numpy(rows[r, [0, 2, 3]]),
                torch.from_numpy(rows[r, [1]]))
    np.testing.assert_array_equal(rec.assemble(),
                                  np.concatenate([head, rows]))
    rec.start([(torch.zeros(2, 4, 2), slice(None))], resumed=False)
    assert rec.assemble().shape == (0, 4, 2)
    rec.restore(np.zeros((0, 4, 2)))
    assert rec.head is None
    empty = checkpoint.TraceRecord(4, 2)
    assert empty.assemble().shape == (0, 4, 2)


@pytest.mark.parametrize("name,shape", [("elastic1d", (40,)),
                                        ("elastic2d", (12, 9)),
                                        ("acoustic2d", (12, 9)),
                                        ("elastic3d", (6, 5, 4))])
def test_energy_matches_jax(rng, name, shape):
    model = get_model(name)
    u = rng.standard_normal((model.ncomp,) + shape)
    u[model.dim:] *= 1e6
    rho = 1000.0 * (1.0 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    mu = (np.zeros(shape) if name.startswith("acoustic")
          else 1e9 * (0.5 + rng.random(shape)))
    h = (2.0, 1.5, 0.5)[:len(shape)]
    want = float(jelastic_energy(jget_model(name), jnp.asarray(u),
                                 jnp.asarray(rho), jnp.asarray(lam),
                                 jnp.asarray(mu), h=h))
    t = [torch.from_numpy(a) for a in (u, rho, lam, mu)]
    got = elastic_energy(model, *t, h=h)
    assert got.dtype == torch.float64 and got.ndim == 0
    assert float(got) == pytest.approx(want, rel=1e-12)
    assert float(elastic_energy(model, *t)) == pytest.approx(
        want / np.prod(h), rel=1e-12)


@pytest.mark.parametrize("name", ["elastic2d", "acoustic2d"])
def test_energy_decays_with_absorbing_borders(rng, name):
    model = get_model(name)
    shape = (32, 28)
    u = rng.standard_normal((model.ncomp,) + shape)
    for a in range(1, 3):
        u = 0.25 * np.roll(u, 1, a) + 0.5 * u + 0.25 * np.roll(u, -1, a)
    u[model.dim:] *= 1e6
    rho, cp, cs = 1000.0, 2000.0, (0.0 if name == "acoustic2d" else 1100.0)
    mu = rho * cs ** 2
    lam = rho * cp ** 2 - 2 * mu
    ones = np.ones(shape)
    mat = MaterialFields.from_arrays(rho * ones, lam * ones, mu * ones,
                                     dtype=torch.float64)
    t = [torch.as_tensor(a * ones) for a in (rho, lam, mu)]
    borders = {(a, s): BorderSpec("absorbing") for a in range(2)
               for s in (0, 1)}
    u = torch.from_numpy(u)
    energies = [float(elastic_energy(model, u, *t, h=(1.0, 1.0)))]
    for n in range(30):
        u = step(model, u, mat, 0.5 / cp, (1.0, 1.0), 2, borders,
                 (0, 1) if n % 2 == 0 else (1, 0))
        energies.append(float(elastic_energy(model, u, *t, h=(1.0, 1.0))))
    e = np.asarray(energies)
    assert (np.diff(e) <= 1e-9 * e[0]).all()
    assert e[-1] < 0.9 * e[0]


MATS = [
    IsotropicMaterial.from_speeds(rho=1000.0, cp=1500.0),            # fluid
    IsotropicMaterial.from_speeds(rho=2500.0, cp=4000.0, cs=2300.0),  # rock
    IsotropicMaterial(rho=1200.0, lam=3.1e9, mu=0.9e9),
]
LINAL_CASES = [
    ("acoustic1d", 0), ("acoustic2d", 0), ("acoustic2d", 1),
    ("acoustic3d", 2), ("elastic1d", 0),
    ("elastic2d", 0), ("elastic2d", 1),
    ("elastic3d", 0), ("elastic3d", 1), ("elastic3d", 2),
]


@pytest.mark.parametrize("model_name,axis", LINAL_CASES)
@pytest.mark.parametrize("mat", MATS[1:])
def test_spec_diagonalizes_the_jacobians(model_name, axis, mat):
    """Each closed-form invariant of models/spec.py is a left eigenvector
    of the dense Jacobian, with the analytic spectrum."""
    model = get_model(model_name)
    if model_name.startswith("acoustic"):
        mat = IsotropicMaterial(rho=mat.rho, lam=mat.lam + 2 * mat.mu, mu=0.0)
    A = jacobian(model, mat, axis)
    L, lams = invariant_matrix(model, mat, axis)
    assert L.shape[0] == model.ncomp
    assert abs(np.linalg.det(L)) > 1e-12
    resid = L @ A - np.diag(lams) @ L
    assert np.abs(resid).max() / (np.abs(L @ A).max() + 1e-30) < 1e-12
    np.testing.assert_allclose(sorted(lams), sorted(np.linalg.eigvals(A).real),
                               rtol=1e-9, atol=1e-6 * max(mat.cp, 1))


def test_fluid_jacobian_drops_the_shear_pairs():
    model = get_model("acoustic3d")
    L, lams = invariant_matrix(model, MATS[0], 0)
    assert sorted(lams) == pytest.approx([-1500.0, 0.0, 0.0, 1500.0])


def test_profiling_helpers(tmp_path):
    from gcm_tpu_torch.utils.profiling import count, span, trace

    with trace(None):
        pass
    assert not os.listdir(tmp_path)
    assert span("gcm_step_region") is span("other")   # off: one no-op
    with trace(str(tmp_path / "t")):
        with span("gcm_step_region"):
            torch.ones(8).sum()
            count("gcm_items", 3)
    with open(tmp_path / "t" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "gcm_step_region" in names
    with open(tmp_path / "t" / "spans.json") as f:
        spans = json.load(f)
    assert spans["spans"]["gcm_step_region"]["calls"] == 1
    assert spans["counters"] == {"gcm_items": 3} and spans["dropped"] == 0


def _cli(args, tmp_path):
    proc = subprocess.run([sys.executable, "-m", "gcm_tpu_torch", *args],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_outputs_resume_and_profile(tmp_path):
    """A run with snapshots and checkpoints, then the same run resumed from
    its newest checkpoint to more steps, whose seismograms hold the whole
    record and equal an uninterrupted run's, then a profiled run."""
    run = ["run", "elastic3d_explosion", "--n", "12", "--device", "cpu"]
    first = _cli(run + ["--nsteps", "6", "--outdir", "out",
                        "--snapshot-every", "3", "--checkpoint-every", "2"],
                 tmp_path)
    assert first["outdir"] == "out" and first["resumed_from"] is None
    out = tmp_path / "out"
    assert sorted(os.listdir(out / "checkpoints")) == [
        "step_2.npz", "step_4.npz", "step_6.npz"]
    assert sorted(os.listdir(out / "snapshots")) == [
        "elastic3d_explosion.pvd", "elastic3d_explosion_000004.vti"]
    resumed = _cli(run + ["--nsteps", "10", "--outdir", "out", "--resume"],
                   tmp_path)
    assert resumed["resumed_from"] == 6 and resumed["nsteps"] == 10
    whole = _cli(run + ["--nsteps", "10", "--outdir", "whole"], tmp_path)
    assert whole["resumed_from"] is None
    got = np.load(out / "elastic3d_explosion.npz")["traces"]
    want = np.load(tmp_path / "whole" / "elastic3d_explosion.npz")["traces"]
    assert got.shape == want.shape == (10, 2, 9)
    np.testing.assert_array_equal(got, want)
    _cli(run + ["--nsteps", "2", "--outdir", "prof", "--profile"], tmp_path)
    with open(tmp_path / "prof" / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gcm.setup", "gcm.step", "gcm.run.gather"} <= names
    with open(tmp_path / "prof" / "trace" / "spans.json") as f:
        spans = json.load(f)["spans"]
    assert spans["gcm.step"]["calls"] == 2
    assert spans["gcm.setup"]["calls"] == 1


def test_cli_simplex_and_contact_outputs(tmp_path, capsys):
    out = str(tmp_path / "sx")
    args = ["run", "simplex2d_canyon_layered", "--n", "9", "--nsteps", "5",
            "--device", "cpu", "--outdir", out, "--snapshot-every", "2",
            "--checkpoint-every", "4"]
    assert cli.main(args) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["outdir"] == out and summary["resumed_from"] is None
    assert sorted(os.listdir(os.path.join(out, "snapshots"))) == [
        "simplex2d_canyon_layered.pvd",
        "simplex2d_canyon_layered_000002.vtu",
        "simplex2d_canyon_layered_000004.vtu"]
    assert os.listdir(os.path.join(out, "checkpoints")) == ["step_4.npz"]
    assert os.path.exists(os.path.join(out,
                                       "simplex2d_canyon_layered_final.vtu"))
    assert cli.main(args[:5] + ["7"] + args[6:] + ["--resume"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "resumed_from"] == 4

    out = str(tmp_path / "contact")
    args = ["run", "elastic3d_contact", "--n", "8", "--nsteps", "4",
            "--device", "cpu", "--outdir", out, "--snapshot-every", "2",
            "--checkpoint-every", "2"]
    assert cli.main(args) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["path"] == "torch" and summary["resumed_from"] is None
    snaps = sorted(os.listdir(os.path.join(out, "snapshots")))
    assert snaps == ["lower.pvd", "lower_000002.vti", "lower_000004.vti",
                     "upper.pvd", "upper_000002.vti", "upper_000004.vti"]
    assert {"lower_final.vti", "upper_final.vti",
            "contact0_bonded_final.npy"} <= set(os.listdir(out))
    assert cli.main(args[:5] + ["6"] + args[6:] + ["--resume"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "resumed_from"] == 4
