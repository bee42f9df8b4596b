"""The port's benchmark (``gcm_tpu_torch/bench.py``) against ``bench.py``.

Its problems are held to the JAX package's own: the flagship problem of
``__graft_entry__._flagship`` (state equal, fields and dt to 1e-12, a plain
step to 1e-10 in float64 and 1e-5 in float32), the visco path's folded
correctors and dt (``bench.py``'s visco worker), and the simplex meshes
(``tools/simplex_setup_cache.py``'s jittered unit box, ``bench.py``'s
simplex contact bodies) point for point and cell for cell at reduced sizes.
The JSON lines are assembled as ``bench.py``'s ``main`` assembles them from
the same per-path times. On the CPU only ``--path torch`` runs; the kernel
paths raise, naming the card.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench as jbench
from gcm_tpu.grids.simplex import SimplexGrid as JSimplexGrid
from gcm_tpu.ops.pallas_fused import (
    fold_corrector_specs as jfold_corrector_specs)
from gcm_tpu.solver.correctors import (
    DamageCorrector as JDamageCorrector, MaxwellCorrector as JMaxwellCorrector)
from gcm_tpu_torch import bench
from gcm_tpu_torch.convert import MATERIAL_LEAVES
from gcm_tpu_torch.ops.fused import fold_corrector_specs
from gcm_tpu_torch.solver.gcm import step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (8, 6, 5)


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flagship_matches_jax(dtype):
    """``flagship`` is ``__graft_entry__._flagship``: the same state, the
    same fields and dt, and the same plain step from them."""
    jfwd, ju0, jmat = graft._flagship(SMALL, dtype=getattr(jnp, dtype))
    p = bench.flagship(SMALL, dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(p.u0.numpy(), np.asarray(ju0))
    for name in MATERIAL_LEAVES:
        _close(getattr(p.mat, name).numpy(), np.asarray(getattr(jmat, name)),
               1e-12 if dtype == "float64" else 1e-6)
    z = np.linspace(0.0, 1.0, SMALL[2])
    _close(p.dt, 0.8 * 10.0 / float((2100.0 + 3100.0 * z).max()), 1e-12)
    got = step(p.model, p.u0, p.mat, p.dt, p.h, p.order, p.borders)
    want = np.asarray(jfwd(ju0, jmat))
    scale = np.abs(want).reshape(9, -1).max(1) + 1e-30
    err = (np.abs(got.numpy() - want).reshape(9, -1).max(1) / scale).max()
    assert err < (1e-10 if dtype == "float64" else 1e-5), err


def test_visco_specs_and_dt_match_jax():
    """The visco path's dt and folded Maxwell + damage specs are those of
    ``bench.py``'s visco worker (``bench.py:390-398``)."""
    for shape in (SMALL, bench.SHAPE):
        z = np.linspace(0.0, 1.0, shape[2])[None, None, :]
        jdt = 0.8 * min((10.0,) * 3) / float((2100.0 + 3100.0 * z).max())
        assert bench.visco_dt(shape) == jdt
    dt = bench.visco_dt(bench.SHAPE)
    want = jfold_corrector_specs(
        (JMaxwellCorrector(tau=50 * jdt),
         JDamageCorrector(threshold=5e5, rate=0.1 / jdt)), jdt)
    assert fold_corrector_specs(bench.visco_correctors(dt), dt) == want
    assert want[1] == 1


@pytest.mark.parametrize("n, half", [(9, 5), (12, 6)])
def test_simplex_contact_bodies_match_jax(n, half):
    """``bench.py:249-273`` at a reduced size: the grids' points and cells
    exactly, the random stresses from the same stream, the contact."""
    bodies, contacts = bench.simplex_contact_bodies(n, half)
    rng = np.random.default_rng(0)
    want = {"a": JSimplexGrid.box((0, 0, 0), (0.5, 1, 1), (half, n, n),
                                  jitter=0.12),
            "b": JSimplexGrid.box((0.5, 0, 0), (1.0, 1, 1),
                                  (n - half + 1, n, n), jitter=0.12)}
    for name, g in want.items():
        got = bodies[name].grid
        np.testing.assert_array_equal(got.points, g.points)
        np.testing.assert_array_equal(got.cells, g.cells)
        u0 = np.zeros((9, g.npoints), np.float32)
        u0[3:] = 1e5 * rng.standard_normal((6, g.npoints)).astype(np.float32)
        np.testing.assert_array_equal(bodies[name].u0, u0)
        assert bodies[name].material.rho == 2500.0
    (c,) = contacts
    assert (c.body_a, c.body_b, c.axis, c.kind, c.tensile_strength) == (
        "a", "b", 0, "bonded", 5e5)


@pytest.mark.parametrize("n", [7, 9])
def test_simplex_box_matches_jax(n):
    """The simplex path's unit box is ``tools/simplex_setup_cache.py``'s
    (``load_or_build``: jitter 0.15, seed 0)."""
    got = bench.simplex_box(n)
    want = JSimplexGrid.box((0, 0, 0), (1.0, 1.0, 1.0), (n, n, n),
                            jitter=0.15)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.cells, want.cells)


#: per-path records with distinct times: JAX's worker records and the
#: port's, the same numbers under each package's names
T = {"torch": 3.1e-2, "sweep": 1.7e-3, "fused": 1.3e-3, "visco": 1.41e-3}
SPREAD = {"torch": 0.0123, "sweep": 0.0456, "fused": 0.0078}
CONTACT = {"t_step": 3.3e-2, "npoints": 2 * 256 * 256 * 128}
SIMPLEX = {"t_step": 2.2e-4, "npoints": 35937, "t_step_n65": 1.9e-4,
           "npoints_n65": 274625, "t_step_n65_torch": 3.7e-3}
SCT = {"t_step": 2.4e-3, "npoints": 120050}
JNAMES = {"torch": "jnp", "sweep": "pallas", "fused": "fused"}


def _jax_line(monkeypatch, shape, only=None):
    """``bench.py``'s line from the records above, its workers stubbed."""
    recs = {
        **{JNAMES[p]: {"path": JNAMES[p], "t_step": T[p],
                       "spread": SPREAD[p]} for p in bench.PATHS},
        "visco": {"path": "visco", "t_step": T["visco"], "spread": 0.01},
        "contact": {"path": "contact", "t_step": CONTACT["t_step"],
                    "spread": 0.02, "npoints": CONTACT["npoints"],
                    "multi_path": "fused_canonical"},
        "simplex": {"path": "simplex", "t_step": SIMPLEX["t_step"],
                    "npoints": SIMPLEX["npoints"], "simplex_path": "fused",
                    "t_step_n65": SIMPLEX["t_step_n65"],
                    "npoints_n65": SIMPLEX["npoints_n65"],
                    "simplex_path_n65": "fused", "t_step_jnp": 4.0e-3,
                    "t_step_n65_jnp": SIMPLEX["t_step_n65_torch"]},
        "simplex_contact": {"path": "simplex_contact",
                            "t_step": SCT["t_step"],
                            "npoints": SCT["npoints"],
                            "simplex_contact_path": "fused",
                            "t_step_jnp": 1.2e-2},
    }
    monkeypatch.setattr(jbench, "_run_path_with_retry", lambda path, _: (
        recs[path]["t_step"], None, recs[path]))
    buf = io.StringIO()
    with redirect_stdout(buf):
        jbench.main(shape, only)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("shape", [bench.SHAPE, (64, 48, 32)])
def test_summary_line_assembles_as_bench_py(monkeypatch, shape):
    """The same per-path times give ``bench.py``'s keys in its order, plus
    ``device``; the same numbers after its rounding (``vs_baseline`` =
    best / torch); the port's path names as values."""
    recs = {p: {"t_step": T[p], "spread": SPREAD[p]} for p in bench.PATHS}
    recs["visco"] = {"t_step": T["visco"], "spread": 0.01}
    recs["contact"] = dict(CONTACT, path="fused_canonical")
    recs["simplex"] = dict(SIMPLEX, path_n65="simplex")
    recs["simplex_contact"] = dict(SCT, path="simplex")
    got = bench.summary_line(shape, recs, "NVIDIA H100 80GB HBM3, 700.00 W")
    want = _jax_line(monkeypatch, shape)
    assert list(got) == list(want) + ["device"]
    names = {"path": "fused", "contact_path": "fused_canonical",
             "simplex_path_n65": "simplex", "simplex_contact_path": "simplex"}
    assert {k: v for k, v in got.items() if k in names} == names
    assert {k: v for k, v in want.items() if k in names} == dict(
        names, simplex_path_n65="fused", simplex_contact_path="fused")
    for k, v in want.items():
        if k not in names:
            assert got[k] == v, k
    assert got["vs_baseline"] == round(T["torch"] / T["fused"], 3)
    assert got["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.mark.parametrize("path", bench.PATHS)
def test_path_line_assembles_as_bench_py(monkeypatch, path):
    shape = (32, 16, 8)
    want = _jax_line(monkeypatch, shape, JNAMES[path])
    got = bench.path_line(shape, path, T[path], SPREAD[path], "cpu")
    assert got == dict(want, path=path, device="cpu")


def test_timing_warms_interleaves_and_takes_the_median():
    """One warm-up call each, then rounds of one call of each path in turn;
    the median and spread of ``bench.py``'s ``_repeat_timed``."""
    calls = []

    def loop(name):
        return bench._Loop(lambda s: calls.append(name) or s, None, 1, 1)

    ts = bench.interleaved({n: loop(n) for n in "abc"}, torch.device("cpu"))
    assert calls == list("abc") * (1 + bench.REPS)
    assert [len(v) for v in ts.values()] == [bench.REPS] * 3
    samples = iter([3.0, 1.0, 2.5])
    assert bench.median_spread([3.0, 1.0, 2.5]) == jbench._repeat_timed(
        lambda: next(samples))


def test_torch_loop_runs_k_steps_of_the_flagship():
    """A timed call of the torch path is K_STEPS plain steps, each from the
    state the last one left, as ``bench.py``'s scan of ``_flagship``."""
    p = bench.flagship(SMALL, dtype=torch.float64)
    loop = bench.structured_loops(p, ("torch",))["torch"]
    loop()
    assert loop.steps == bench.K_STEPS
    jfwd, ju, jmat = graft._flagship(SMALL, dtype=jnp.float64)
    for _ in range(bench.K_STEPS):
        ju = jfwd(ju, jmat)
    np.testing.assert_allclose(loop.state.numpy(), np.asarray(ju),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("args", [["-m", "gcm_tpu_torch", "bench"],
                                  ["-m", "gcm_tpu_torch.bench"]])
def test_torch_path_runs_on_cpu(args):
    proc = subprocess.run(
        [sys.executable, *args, "--device", "cpu", "--shape", "12,12,8",
         "--path", "torch"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] > 0 and np.isfinite(line["value"])
    assert (line["path"], line["shape"], line["device"]) == (
        "torch", [12, 12, 8], "cpu")


@pytest.mark.parametrize("path", ["fused", "sweep", "best"])
def test_kernel_paths_refused_on_cpu(path):
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        bench.main((12, 12, 8), path, "cpu")


def test_cli_refuses_kernel_path_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "gcm_tpu_torch", "bench", "--device", "cpu",
         "--shape", "12,12,8", "--path", "fused"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "needs a CUDA card" in proc.stderr


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main((12, 12, 8), "torch")


@pytest.mark.parametrize("scale, holds", [(0.0, True), (1e-6, True),
                                          (1e-3, False)])
def test_hold_to_plain_holds_the_kernel_form_to_its_twin(scale, holds):
    """A kernel form's end state passes within ``PATH_TOL`` of its plain
    twin's, per component over that component's largest magnitude, and
    fails the run beyond it."""
    rng = np.random.default_rng(3)
    want = torch.tensor(rng.standard_normal((9, 40)))
    want[3:] *= 1e6
    got = want.clone()
    got[5, 7] += scale * want[5].abs().max()
    assert bench.normalized_err(got, want) == pytest.approx(scale, rel=1e-6,
                                                            abs=1e-15)
    if holds:
        assert bench.hold_to_plain("x", [want, got], [want, want]) < \
            bench.PATH_TOL
    else:
        with pytest.raises(RuntimeError, match="from its plain twin"):
            bench.hold_to_plain("x", [want, got], [want, want])


@pytest.mark.parametrize("kb, holds", [
    ({0: torch.tensor([1.0, 1.0, 0.0])}, True),
    ({0: torch.tensor([1.0, 0.0, 0.0])}, False),
    ({0: None}, False)])
def test_hold_bonds_needs_equal_masks(kb, holds):
    pb = {0: torch.tensor([1.0, 1.0, 0.0])}
    if holds:
        bench.hold_bonds("x", kb, pb)
    else:
        with pytest.raises(RuntimeError, match="bond mask"):
            bench.hold_bonds("x", kb, pb)


def test_structured_twins_end_on_one_step():
    """The structured paths' loops start from one state and, interleaved,
    make the same calls: their end states are comparable, as ``main``
    compares them (here each wrapper runs its plain version)."""
    p = bench.flagship(SMALL)
    loops = bench.structured_loops(p, bench.PATHS)
    bench.interleaved(loops, torch.device("cpu"))
    assert not torch.equal(loops["torch"].state, p.u0)
    for name in ("sweep", "fused"):
        assert bench.hold_to_plain(name, [loops[name].state],
                                   [loops["torch"].state]) < bench.PATH_TOL
