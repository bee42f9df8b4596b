"""``correct`` comes out false for the control and for each fault that a
cell can have, with the timed path broken underneath a whole run on the
CPU at a tiny size (the harness's look for a card skipped), and true for
the sound program."""

import pytest
import torch

import gcm_tpu_torch.engine as engine_mod
import gcm_tpu_torch.engine_multi as multi_mod
from gcm_bench.harness.cell import execute
from gcm_bench.harness.spec import Spec
from gcm_tpu_torch.parallel import fused_spmd

CELLS = ["explosion512", "contact512", "explosion768-cards4"]


def _spec(request, cell):
    return Spec(request.getfixturevalue(
        "contact_root" if cell == "contact512" else "small_root"))


def _run(spec, cell, seed=5, control=False):
    return execute(spec, spec.cell(cell), seed, 0.2, False, "cpu",
                   control=control)


def _broken(fn, fault):
    """``fn`` (a body's whole step) with a fault planted in its output."""
    def step(model, u, *a, **kw):
        if fault == "unchanged":
            return u.clone()
        out = fn(model, u, *a, **kw)
        if fault == "half":           # half of the grid left out
            out[:, out.shape[1] // 2:] = u[:, out.shape[1] // 2:]
        elif fault == "altered":      # one answer altered where produced
            c = out.shape[0] - 1
            out[(c, 3, 3, 3)] += 0.01 * float(out[c].abs().max()) + 1.0
        return out
    return step


def _plant(monkeypatch, cell, fault):
    if cell == "explosion768-cards4":
        make = engine_mod.make_fused_spmd_step

        def make_broken(*a, **kw):
            step = make(*a, **kw)

            def broken(us, mexts, axes, **k):
                if fault == "unchanged":
                    return [u.clone() for u in us]
                outs = step(us, mexts, axes, **k)
                if fault == "half":
                    outs[-1] = us[-1].clone()
                elif fault == "altered":
                    outs[0][(8, 3, 3, 3)] += 1.0 + 0.01 * float(
                        outs[0][8].abs().max())
                return outs
            return broken
        monkeypatch.setattr(engine_mod, "make_fused_spmd_step", make_broken)
    elif cell == "contact512":
        monkeypatch.setattr(multi_mod, "fused_step_slab", _broken(
            multi_mod.fused_step_slab, fault))
    else:
        monkeypatch.setattr(engine_mod, "fused_step", _broken(
            engine_mod.fused_step, fault))


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(request, cell):
    out = _run(_spec(request, cell), cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(request, cell):
    """The reference in bfloat16 in the program's place, judged by the
    rule that decides ``correct``, comes out not correct (the verdict the
    card's control runs print), beside the sound program's correct."""
    out = _run(_spec(request, cell), cell, control=True)
    assert out["correct"], out["checks"]
    assert not out["control"]["correct"], out["control"]["checks"]
    assert out["control"]["failed"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(request, monkeypatch, cell, fault):
    _plant(monkeypatch, cell, fault)
    out = _run(_spec(request, cell), cell)
    assert not out["correct"], out["checks"]


def test_the_exchange_left_out_is_not_correct(request, monkeypatch):
    """The slabs between shards never filled: each shard's ring reads
    zeros where its neighbours' rows belong."""
    def no_exchange(self, blocks):
        for slabs in self.slabs:
            for s in slabs or ():
                s.zero_()
        return self.slabs
    monkeypatch.setattr(fused_spmd.SlabExchange, "__call__", no_exchange)
    cell = "explosion768-cards4"
    out = _run(_spec(request, cell), cell)
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
def test_the_control_on_the_card_is_not_correct(small_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at a card's size runs "
                    "through gcm_bench/control.py")
    spec = Spec(small_root)
    out = execute(spec, spec.cell("explosion512"), 5, 0.2, False, "cuda",
                  control=True)
    assert not out["control"]["correct"], out["control"]["checks"]


@pytest.mark.parametrize("box", [((3, 9), (0, 4), (2, 5)),
                                 ((0, 12), (5, 10), (0, 6)),
                                 ((7, 12), (6, 8), (1, 2))])
def test_the_start_box_is_cut_from_the_shards_it_crosses(box):
    """The warm-up's box, put together from the blocks of a 2x2 mesh as a
    ``run()`` callback receives them, equals the same box of the whole
    state."""
    from types import SimpleNamespace

    from gcm_bench.harness.program import box_of
    from gcm_tpu_torch.parallel.sharding import domain_mesh, shard_state

    shape = (12, 10, 6)
    u = torch.randn((9,) + shape, dtype=torch.float32)
    mesh = domain_mesh(3, [torch.device("cpu")] * 4, (2, 2))
    eng = SimpleNamespace(mesh=mesh, task=SimpleNamespace(
        grid=SimpleNamespace(shape=shape)))
    got = box_of(eng, shard_state(u, mesh), "body", box)
    want = u[(slice(None),) + tuple(slice(s, e) for s, e in box)].numpy()
    assert got.shape == want.shape
    assert (got == want).all()
    one = SimpleNamespace(mesh=None)
    assert (box_of(one, {"lower": u}, "lower", box) == want).all()
