"""The untraced run, whose window gives the end-to-end metrics, never turns
the program's tracer on (``gcm_tpu_torch.utils.profiling``): its spans
stay the shared no-op object from the set-up to the checks."""

import pytest

from gcm_bench.harness import program
from gcm_bench.harness.cell import execute
from gcm_bench.harness.spec import Spec
from gcm_tpu_torch.utils import profiling


@pytest.mark.parametrize("cell", ["explosion512", "contact512",
                                  "explosion768-cards4"])
def test_an_untraced_run_leaves_the_tracer_off(request, monkeypatch, cell):
    spec = Spec(request.getfixturevalue(
        "contact_root" if cell == "contact512" else "small_root"))
    seen = []

    def refuse(*a, **kw):
        raise AssertionError("the untraced run turned the tracer on")

    def run(engine, callback, every):
        def cb(step, u):
            seen.append(profiling.enabled())
            callback(step, u)
        return engine_run(engine, cb, every)

    engine_run = program.run
    monkeypatch.setattr(profiling, "recording", refuse)
    monkeypatch.setattr(program, "run", run)
    out = execute(spec, spec.cell(cell), 11, 0.2, False, "cpu")
    assert out["correct"], out["checks"]
    assert seen and not any(seen)
    assert not profiling.enabled()
