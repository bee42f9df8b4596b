"""Tests of the benchmark's harness and reference, on the CPU at tiny
sizes: ``python -m pytest gcm_bench/tests``. They import neither JAX nor
the JAX package."""

import json
import shutil
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where torch sees none")


def make_root(tmp: Path, n: int = 16) -> Path:
    """A checkout holding this benchmark with every configuration cut to
    ``n`` nodes along x and y (the traffic's boxes held inside the small
    grids), for runs on the CPU."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "gcm_bench").mkdir(parents=True)
    for sub in ("metrics", "traffic"):
        shutil.copytree(PACKAGE / sub, tmp / "gcm_bench" / sub)
    (tmp / "gcm_bench" / "configs").mkdir()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["n"] = n
        for body in cfg["bodies"].values():
            nz = max(n // 2, 8)
            body["shape"] = [n, n, nz]
            if cfg["engine"] == "multi":
                body["lengths"][2] = (nz - 1) * body["lengths"][0] / (n - 1)
        (tmp / c["file"]).write_text(json.dumps(cfg))
    # a tiny contact grid: the warm-up's box must not reach the interface
    t = tmp / "gcm_bench" / "traffic" / "contact_run.json"
    d = json.loads(t.read_text())
    d.update(warmup_steps=4, source_box={"x": [250.0, 750.0],
                                         "y": [250.0, 750.0],
                                         "z": [200.0, 350.0]})
    t.write_text(json.dumps(d))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def small_root(tmp_path):
    return make_root(tmp_path, 16)


@pytest.fixture
def contact_root(tmp_path):
    return make_root(tmp_path, 32)
