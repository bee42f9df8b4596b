"""The byte and roofline arithmetic, the trace's reductions and the
per-layer readers, on numbers worked out by hand."""

import json

import pytest
from conftest import ROOT

from gcm_bench.harness import roofline
from gcm_bench.harness.profile import merged, union_s
from gcm_bench.harness.spec import Spec


def _config(name):
    return json.loads((ROOT / f"gcm_bench/configs/{name}.json").read_text())


def test_a_3d_float32_step_moves_88_bytes_a_node():
    cfg = _config("elastic3d_explosion-n512")
    assert roofline.bytes_per_node(cfg) == 2 * 9 * 4 + 4 * 4 == 88
    assert roofline.bytes_per_step_card(cfg) == 88 * 512 * 512 * 256
    assert roofline.least_step_s(cfg) == pytest.approx(
        88 * 512 * 512 * 256 / 3.35e12)
    assert roofline.least_step_s(cfg) == pytest.approx(1.7628e-3, rel=1e-4)


def test_the_busiest_card_holds_a_quarter_of_the_mesh():
    cfg = _config("elastic3d_explosion-n768-mesh2x2")
    assert roofline.bytes_per_step_card(cfg) == 88 * 384 ** 3
    assert roofline.least_step_s(cfg) == pytest.approx(1.4873e-3, rel=1e-4)


def test_contact_counts_both_bodies():
    cfg = _config("elastic3d_contact-n512")
    assert roofline.bytes_per_step_card(cfg) == 2 * 88 * 512 * 512 * 256


def test_busy_time_counts_overlaps_once():
    spans = [(0.0, 10.0), (5.0, 15.0), (20.0, 30.0), (21.0, 22.0)]
    assert union_s(spans) == pytest.approx(25e-6)
    assert merged(spans) == [(0.0, 15.0), (20.0, 30.0)]
    assert union_s([]) == 0.0


def _ctx(cell, busy, events, window_s, steps=10):
    """The context of a traced stretch of ``steps`` steps after an
    untraced window of 100 steps in ``window_s`` seconds."""
    spec = Spec(ROOT)
    return {"config": spec.config(spec.cell(cell)), "trace": {
        "busy_s": busy, "events": events, "window_s": 1.0},
        "traced_steps": steps, "window_steps": 100, "window_s": window_s,
        "timed_ms": {}, "cards": sorted(busy)}


def test_readers_of_the_trace():
    spec = Spec(ROOT)
    mods = {m["name"]: spec.reader(m) for m in spec.bench["per_layer"]}
    read = {name: mod.read for name, mod in mods.items()}
    for name in ("kernel_roofline", "device_idle_share",
                 "launches_per_step"):
        # a quantity's metrics in several cells share one reader file
        assert mods[name].__file__ == mods[name + ".contact"].__file__
        assert mods[name].__file__ == mods[name + ".mesh"].__file__
    least = roofline.least_step_s(_config("elastic3d_explosion-n512"))
    # busy 2 x least a step; a window step of 5 ms
    ctx = _ctx("explosion512", {0: 10 * 2 * least}, {0: 40}, 0.5)
    assert read["kernel_roofline"](ctx) == pytest.approx(50.0)
    assert read["device_idle_share"](ctx) == pytest.approx(
        100 * (1 - 2 * least / 0.005))
    assert read["launches_per_step"](ctx) == 4.0
    # the cards busy 2, 4, 3 and 3 ms a step; a window step of 10 ms
    four = _ctx("explosion768-cards4", {0: 0.02, 1: 0.04, 2: 0.03, 3: 0.03},
                {0: 10, 1: 20, 2: 30, 3: 40}, 1.0)
    least4 = roofline.least_step_s(
        _config("elastic3d_explosion-n768-mesh2x2"))
    assert read["kernel_roofline.mesh"](four) == pytest.approx(
        100 * least4 / 0.004)
    assert read["device_idle_share.mesh"](four) == pytest.approx(70.0)
    assert read["launches_per_step.mesh"](four) == 2.5
    none = _ctx("explosion512", {0: 0.0}, {0: 0}, 0.5)
    assert read["kernel_roofline"](none) is None
    assert read["device_idle_share"](none) is None
    assert read["launches_per_step"](none) is None


def test_readers_of_the_timed_functions():
    spec = Spec(ROOT)
    read = {m["name"]: spec.reader(m) for m in spec.bench["per_layer"]}
    fix = read["contact_fixup_host_ms"]
    ctx = {"timed_ms": {fix.WRAP[0]: 1500.0}, "window_steps": 100}
    assert fix.read(ctx) == 15.0
    ex = read["slab_exchange_host_ms"]
    ctx = {"timed_ms": {ex.WRAP[0]: 100.0, ex.WRAP[1]: 150.0},
           "window_steps": 100}
    assert ex.read(ctx) == 2.5
    assert ex.read({"timed_ms": {}, "window_steps": 100}) is None
