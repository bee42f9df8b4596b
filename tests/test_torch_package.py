"""Package-level contracts of the PyTorch port.

- Every ``gcm_tpu_torch`` module imports with JAX made unimportable.
- ``chip_smoke.py`` refuses to run without a CUDA device, and, alone in a
  directory, without the package: non-zero exit, no result line.
- ``python -m gcm_tpu_torch`` lists scenarios and runs one on the CPU,
  printing its JSON summary, on any ``--kernel`` path, on a ``--mesh``, and
  a multi-body contact scenario in the canonical order.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import gcm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gcm_tpu_torch.__path__,
                                               "gcm_tpu_torch.")]
assert {"gcm_tpu_torch.ops.sweep", "gcm_tpu_torch.solver.correctors",
        "gcm_tpu_torch.grids.simplex", "gcm_tpu_torch.grids.locate",
        "gcm_tpu_torch.solver.simplex_gcm", "gcm_tpu_torch.ops.simplex",
        "gcm_tpu_torch.engine_simplex", "gcm_tpu_torch.ops.fused_spmd",
        "gcm_tpu_torch.parallel.sharding", "gcm_tpu_torch.parallel.halo",
        "gcm_tpu_torch.parallel.fused_spmd", "gcm_tpu_torch.parallel.faces",
        "gcm_tpu_torch.parallel.multihost", "gcm_tpu_torch.parallel.p2p",
        "gcm_tpu_torch.solver.contact",
        "gcm_tpu_torch.solver.contact_nc", "gcm_tpu_torch.solver.multi",
        "gcm_tpu_torch.engine_multi", "gcm_tpu_torch.oracle.oracle",
        "gcm_tpu_torch.oracle.oracle_ortho", "gcm_tpu_torch.snapshot.vtk",
        "gcm_tpu_torch.snapshot.seismo", "gcm_tpu_torch.utils.checkpoint",
        "gcm_tpu_torch.utils.energy", "gcm_tpu_torch.utils.linal",
        "gcm_tpu_torch.utils.profiling",
        "gcm_tpu_torch.solver.simplex_contact",
        "gcm_tpu_torch.bench"} <= set(names), names
for name in names:
    importlib.import_module(name)
assert not any(k in ("jax", "gcm_tpu") or k.startswith(("jax.", "gcm_tpu."))
               for k in sys.modules if sys.modules[k] is not None), \\
    sorted(k for k in sys.modules if "jax" in k or k.startswith("gcm_tpu."))
print(len(names))
"""


def _run(args, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, timeout=timeout,
                          capture_output=True, text=True)


def test_every_module_imports_without_jax():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 42


def _assert_refused(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    _assert_refused(_run(["chip_smoke.py"]))


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    _assert_refused(_run(["chip_smoke.py"], cwd=tmp_path))


def test_cli_list_and_run_on_cpu(tmp_path):
    proc = _run(["-m", "gcm_tpu_torch", "list"])
    assert proc.returncode == 0, proc.stderr
    assert [line.split()[0] for line in proc.stdout.splitlines()] == [
        "acoustic1d", "elastic2d_ps", "elastic2d_viscoelastic",
        "elastic3d_explosion", "elastic3d_layered",
        "simplex2d_canyon_layered", "simplex3d_layered",
        "elastic2d_basin_refined", "elastic3d_contact"]
    assert proc.stdout.count("(multi-body") == 2
    proc = _run(["-m", "gcm_tpu_torch", "run", "elastic3d_explosion",
                 "--n", "12", "--nsteps", "2", "--device", "cpu",
                 "--outdir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["kernel"] == "torch"
    assert summary["device"] == "cpu"
    assert summary["nsteps"] == 2
    assert summary["shape"] == [12, 12, 8]
    assert summary["points_per_second"] > 0 and summary["dt"] > 0
    assert summary["outdir"] == str(tmp_path)
    assert summary["resumed_from"] is None
    assert (tmp_path / "elastic3d_explosion.npz").exists()


def test_cli_runs_the_sweep_path_on_cpu(tmp_path):
    proc = _run(["-m", "gcm_tpu_torch", "run", "elastic2d_viscoelastic",
                 "--n", "16", "--nsteps", "3", "--kernel", "sweep",
                 "--device", "cpu", "--outdir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["kernel"] == "sweep" and summary["shape"] == [16, 16]


def test_cli_runs_a_mesh_on_cpu(tmp_path):
    proc = _run(["-m", "gcm_tpu_torch", "run", "elastic3d_explosion",
                 "--n", "16", "--nsteps", "2", "--kernel", "fused",
                 "--device", "cpu", "--mesh", "2,2", "--outdir",
                 str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["kernel"] == "fused" and summary["mesh"] == "2,2"
    proc = _run(["-m", "gcm_tpu_torch", "run", "elastic2d_ps", "--n", "16",
                 "--nsteps", "2", "--device", "cpu", "--mesh", "2,2",
                 "--outdir", str(tmp_path)])
    assert proc.returncode != 0 and "x only" in proc.stderr


def test_cli_runs_a_contact_scenario_on_cpu(tmp_path):
    proc = _run(["-m", "gcm_tpu_torch", "run", "elastic3d_contact", "--n",
                 "12", "--nsteps", "2", "--kernel", "fused", "--device",
                 "cpu", "--outdir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["path"] == "fused_canonical"
    assert summary["bonded_mean"] == {"0": 1.0}
    assert summary["mat_dtype"] == ["f32"] and summary["launches"] == {}
    proc = _run(["-m", "gcm_tpu_torch", "run", "elastic3d_contact", "--n",
                 "12", "--nsteps", "2", "--kernel", "fused", "--device",
                 "cpu", "--no-canonical-layout", "--outdir", str(tmp_path)])
    assert json.loads(proc.stdout.strip().splitlines()[-1])["path"] == \
        "fused"
