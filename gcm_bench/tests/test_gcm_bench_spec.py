"""BENCHMARK.json against the rules of its format, and the harness finding a
cell, a configuration and a metric from added files alone."""

import json

from conftest import ROOT

from gcm_bench.harness.cell import execute
from gcm_bench.harness.spec import Spec, check_names


def test_names_and_units_use_the_allowed_characters():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert check_names(bench) == []
    bad = dict(bench, per_layer=bench["per_layer"] + [
        {"name": "a b", "unit": "tokens per second", "better": "higher",
         "source": "host_clock", "layer": "x", "moves": "points_per_s"}])
    assert set(check_names(bad)) == {"a b", "tokens per second"}


def test_benchmark_file_keeps_its_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    spec = Spec(ROOT)
    for w in bench["workloads"]:
        assert spec.per_layer(w), w["name"]
        e2e_names = {m["name"] for m in spec.end_to_end(w)}
        assert {"setup_s", "peak_device_gib"} < e2e_names
        assert len(e2e_names) == 3, e2e_names
        cfg = spec.config(w)
        assert cfg["name"] == w["config"]
        assert spec.traffic(w)["name"] == w["traffic"]
        for m in spec.per_layer(w):
            assert m["moves"] in e2e_names, (w["name"], m["name"])
            assert callable(spec.reader(m).read)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("gcm_bench/")
        lim = json.loads((ROOT / c["file"]).read_text())["limits"]
        assert all(v is not None for v in lim.values()), c["name"]


def test_a_new_cell_configuration_and_metric_need_only_files(small_root):
    """A cell on an added configuration, with an added per-layer metric
    whose reader is a new file: found, run and reported by name."""
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    cfg = json.loads((small_root / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "elastic3d_explosion-n12"
    cfg["n"] = 12
    cfg["bodies"]["body"]["shape"] = [12, 12, 8]
    new_file = "gcm_bench/configs/elastic3d_explosion-n12.json"
    (small_root / new_file).write_text(json.dumps(cfg))
    bench["configs"].append({"name": cfg["name"], "source": "x",
                             "file": new_file, "reduced": ["n"],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny", "config": cfg["name"],
                               "traffic": "explosion_run", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny")
    bench["per_layer"].append({
        "name": "window_steps_seen", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "engine loop",
        "moves": "points_per_s", "workloads": ["tiny"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (small_root / "gcm_bench" / "metrics" / "window_steps_seen.py"
     ).write_text("def read(ctx):\n    return ctx['window_steps']\n")
    spec = Spec(small_root)
    cell = spec.cell("tiny")
    assert [m["name"] for m in spec.per_layer(cell)] == ["window_steps_seen"]
    out = execute(spec, cell, 7, 0.2, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["window_steps_seen"]["value"] >= 2
    out = execute(spec, cell, 8, 0.2, False, "cpu")
    assert set(out["metrics"]) == {"points_per_s", "peak_device_gib",
                                   "setup_s"}
