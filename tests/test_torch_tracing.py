"""The port's tracer (``gcm_tpu_torch.utils.profiling``): off it hands out
one shared no-op span and records nothing; on, the engines' steps, the
contact fixups, the slab exchange and the set-up leave the spans and
counters their shapes call for, on the CPU at tiny sizes."""

import dataclasses

import torch

from gcm_tpu_torch.engine import Engine
from gcm_tpu_torch.engine_multi import MultiBodyEngine
from gcm_tpu_torch.ops.interp import stencil_radius
from gcm_tpu_torch.parallel import fused_spmd as pfs
from gcm_tpu_torch.parallel.p2p import Move, Transport
from gcm_tpu_torch.parallel.sharding import domain_mesh, shard_state
from gcm_tpu_torch.scenarios import elastic3d_contact, get_scenario
from gcm_tpu_torch.utils import profiling
from gcm_tpu_torch.utils.profiling import Record, count, recording, span


def _explosion(nsteps=4):
    return get_scenario("elastic3d_explosion", n=12, nsteps=nsteps)


def _by_name(rec, name):
    return [s for s in rec.spans if s[1] == name]


def test_off_hands_out_one_no_op_and_records_nothing():
    assert not profiling.enabled()
    off = span("gcm.step", step=0)
    assert off is span("anything") and off is not None
    with off:
        count("gcm.anything", 5)
    Engine(_explosion(), device="cpu").run()
    assert not profiling.enabled()
    with recording() as rec:
        assert profiling.enabled() and span("a") is not off
        with recording() as inner:
            with span("b"):
                pass
        with span("a"):
            pass
    assert span("a") is off
    assert list(rec.stats) == ["a"] and list(inner.stats) == ["b"]


def test_an_explosion_run_gives_one_step_span_a_step():
    with recording() as rec:
        Engine(_explosion(), device="cpu").run()
    steps = _by_name(rec, "gcm.step")
    assert sorted(s[5] for s in steps) == [0, 1, 2, 3]
    assert all(s[4] == -1 for s in steps)
    by_id = {s[0]: s for s in rec.spans}
    for sid, name, t0, t1, parent, step in rec.spans:
        assert t0 <= t1
        if parent != -1:
            p = by_id[parent]
            assert p[2] <= t0 and t1 <= p[3], (name, p[1])
            assert step == p[5], name
    for name in ("gcm.step.sources", "gcm.step.receivers"):
        spans = _by_name(rec, name)
        assert sorted(s[5] for s in spans) == [0, 1, 2, 3]
        assert {by_id[s[4]][1] for s in spans} == {"gcm.step"}
    (setup,) = _by_name(rec, "gcm.setup")
    kids = {s[1] for s in rec.spans if s[4] == setup[0]}
    assert kids == {"gcm.setup.materials", "gcm.setup.stack",
                    "gcm.setup.state", "gcm.setup.sources"}
    assert len(_by_name(rec, "gcm.run.gather")) == 1
    summary = rec.summary()["spans"]
    for name, s in summary.items():
        assert 0 <= s["self_ms"] <= s["total_ms"], name
    assert summary["gcm.step"]["calls"] == 4
    assert rec.dropped == 0 and rec.counters == {}


def test_a_record_keeps_raw_events_up_to_its_cap(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_EVENTS", 3)
    with recording() as rec:
        for k in range(5):
            with span("s", step=k):
                count("c", 2)
    assert isinstance(rec, Record)
    assert len(rec.spans) == 3 and len(rec.counts) == 3
    assert rec.dropped == 4
    assert rec.stats["s"][0] == 5 and rec.counters == {"c": 10}
    assert [c[2] for c in rec.counts] == [0, 1, 2]


def test_contact_fixups_once_a_step_and_their_face_counts():
    bodies, contacts = elastic3d_contact(n=12, nsteps=4)
    bodies = {k: dataclasses.replace(t, kernel="fused")
              for k, t in bodies.items()}
    with recording() as rec:
        eng = MultiBodyEngine(bodies, contacts, device="cpu",
                              canonical_layout=True)
        eng.run()
    assert eng.path == "fused_canonical"
    fix = _by_name(rec, "gcm.contact.fixups")
    assert sorted(s[5] for s in fix) == [0, 1, 2, 3]
    by_id = {s[0]: s for s in rec.spans}
    assert {by_id[s[4]][1] for s in fix} == {"gcm.step"}
    # a z contact: each body's face is nx * ny nodes, its slab C x depth
    # rows of them in float32
    nx, ny, _ = bodies["upper"].grid.shape
    depth = stencil_radius(bodies["upper"].order) + 1
    faces = [c for c in rec.counts if c[0] == "gcm.contact.face_nodes"]
    assert [(n, step) for _, n, step in faces] == [
        (2 * nx * ny, k) for k in range(4)]
    assert rec.counters["gcm.contact.slab_bytes"] == (
        4 * 2 * eng.model.ncomp * depth * nx * ny * 4)
    assert len(_by_name(rec, "gcm.step.sources")) == 4
    assert _by_name(rec, "gcm.callback") == []


def test_slab_exchange_counts_its_copies_and_bytes():
    C, nx, ny, nz, r = 9, 16, 12, 4, 1
    u = torch.randn(C, nx, ny, nz)
    mesh = domain_mesh(3, ["cpu"] * 4, (2, 2))
    nxl, nyl = nx // 2, ny // 2
    with recording() as rec:
        pfs.exchange_slabs(shard_state(u, mesh), mesh, r)
    # x phase: two slabs (C, r, nyl, nz) a shard; y phase: two strips
    # (C, nxl + 2r, r, nz) a shard, each moved in three parts
    strips = 4 * 2 * (C * r * nyl * nz + C * (nxl + 2 * r) * r * nz)
    assert rec.counters == {"gcm.exchange.copies": 4 * 2 + 4 * 2 * 3,
                            "gcm.exchange.local_bytes": 4 * strips,
                            "gcm.exchange.peer_bytes": 0,
                            "gcm.exchange.sent_bytes": 0}
    assert [s[1] for s in rec.spans] == ["gcm.exchange.fill",
                                         "gcm.exchange.wait"]
    # a copy between two devices of this process counts as peer bytes
    tr = Transport(domain_mesh(3, ["cpu"] * 2, (2, 1)))
    view = torch.ones(C, r, 5, nz)
    with recording() as rec:
        tr.start([Move(0, 1, view, torch.empty_like(view), 0),
                  Move(1, 0, view, torch.empty_like(view, device="meta"),
                       1)])
    assert rec.counters["gcm.exchange.copies"] == 2
    assert rec.counters["gcm.exchange.local_bytes"] == view.numel() * 4
    assert rec.counters["gcm.exchange.peer_bytes"] == view.numel() * 4


def test_spans_are_events_of_an_active_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        Engine(_explosion(2), device="cpu").run()
    assert not {e.name for e in prof.events()
                if e.name.startswith("gcm.")}
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording():
        Engine(_explosion(2), device="cpu").run()
    names = {e.name for e in prof.events()}
    assert {"gcm.setup", "gcm.setup.state", "gcm.step", "gcm.step.sources",
            "gcm.step.receivers", "gcm.run.gather"} <= names
