"""``Engine(mesh=)`` on a mesh that spans two processes.

Two gloo ranks run the engine on a mesh whose shards they share, one mesh
row (two CPU shards) a rank: ``elastic3d_explosion`` n=24 on 2x2 (its
source and its receivers on shard edges, the receivers on both ranks) and
``elastic2d_viscoelastic`` n=32 on sx=4 (source on a shard edge, Maxwell
after it, the one receiver on rank 1), each with ``kernel="torch"`` in
float64 and ``kernel="fused"`` in float32. Every rank's ``run()`` must
return the state and traces of the same run in one process on the same
mesh exactly (max abs difference 0); that run is held to JAX by
tests/test_torch_spmd_engine.py. The workers are this file
(``python tests/test_torch_multihost_engine.py <mode> ...``, see
tests/test_torch_multihost.py), and import no JAX.

On such a mesh each rank builds its own shards of ``Engine`` and
``MultiBodyEngine``, and nothing refuses outputs, checkpoints or contact
(tests/test_torch_multihost_resume.py and test_torch_multihost_contact.py
hold what they give).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

#: (scenario, n, nsteps, mesh shape)
CASES = [("elastic3d_explosion", 24, 6, (2, 2)),
         ("elastic2d_viscoelastic", 32, 10, (4,))]
KERNELS = [("torch", "f64"), ("fused", "f32")]


def _engine(case, kernel, dtype, mesh):
    import torch

    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.scenarios import get_scenario

    scenario, n, nsteps, _ = case
    task = dataclasses.replace(get_scenario(scenario, n=n, nsteps=nsteps),
                               kernel=kernel)
    return Engine(task, mesh=mesh, dtype={"f64": torch.float64,
                                          "f32": torch.float32}[dtype])


def _mesh(case, ranks=None):
    from gcm_tpu_torch.parallel.sharding import domain_mesh

    shape = case[3]
    return domain_mesh(len(shape) + 1, ["cpu"] * 4,
                       shape if len(shape) == 2 else None, ranks)


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """Every case run once on two ranks; rank 0's and rank 1's results."""
    from test_torch_multihost import spawn

    d = tmp_path_factory.mktemp("multihost_engine")
    spawn(__file__, "engine", d)
    return [dict(np.load(d / f"runs_{r}.npz")) for r in (0, 1)]


@pytest.mark.parametrize("kernel,dtype", KERNELS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_two_rank_engine_equals_one_process(two_rank_runs, case, kernel,
                                            dtype):
    want = _engine(case, kernel, dtype, _mesh(case)).run()
    key = f"{case[0]}_{kernel}"
    for got in two_rank_runs:
        assert got[f"{key}_kernel"] == kernel
        np.testing.assert_array_equal(got[f"{key}_u"], want.u)
        np.testing.assert_array_equal(got[f"{key}_traces"], want.traces)
        assert got[f"{key}_u"].dtype == want.u.dtype
    assert np.abs(want.traces).max() > 0


def test_what_has_no_form_across_processes_raises(two_rank_runs):
    """Nothing refuses a mesh whose shards two ranks hold (one mesh row
    each): ``Engine`` and ``MultiBodyEngine`` build each rank's own shards
    (None for the other rank's), and ``run_with_outputs``, ``state_dict``
    and ``load_state`` run on both ranks (what they give is held by
    tests/test_torch_multihost_resume.py and _contact.py)."""
    for r, got in enumerate(two_rank_runs):
        mine = [q == r for q in (0, 0, 1, 1)]
        for key in ("engine_u", "engine_carry", "multibody_upper",
                    "multibody_mats"):
            assert got[f"held_{key}"].tolist() == mine, key
        assert got["held_bonded"].tolist() == [12, 12]   # whole
        assert int(got["state_step"]) == 2
        assert got["state_u"].shape == (9, 24, 24, 12)
        assert got["multibody_path"] == "torch_spmd"    # "auto" on CPUs
        assert got["multibody_files"].tolist() == [
            "contact0_bonded_final.npy", "lower_final.vti",
            "upper_final.vti"]
        assert got["outputs_files"].tolist() == (
            ["checkpoints/step_2.npz", "elastic3d_explosion.bin",
             "elastic3d_explosion.json", "elastic3d_explosion.npz"])


def _worker_forms(mesh_of, d):
    """What each rank holds of the engines on a mesh that spans both, and
    what ``run_with_outputs``, ``state_dict`` and ``load_state`` give."""
    from gcm_tpu_torch.engine_multi import MultiBodyEngine
    from gcm_tpu_torch.scenarios import elastic3d_contact

    mesh = mesh_of(3, (2, 2))
    eng = _engine(CASES[0], "fused", "f32", mesh)
    out = {"held_engine_u": [u is not None for u in eng.u],
           "held_engine_carry": [m is not None for m in eng._carry]}
    outdir = os.path.join(d["dir"], "forms")
    eng.nsteps = 2
    eng.run_with_outputs(outdir, checkpoint_every=2)
    state = eng.state_dict()
    eng.load_state(state)
    out.update(state_step=state["step"], state_u=state["u"],
               outputs_files=sorted(
                   os.path.relpath(os.path.join(p, n), outdir)
                   for p, _, ns in os.walk(outdir) for n in ns))
    multi = MultiBodyEngine(*elastic3d_contact(n=12, nsteps=2), mesh=mesh)
    multi.load_state(multi.state_dict())
    multi.run()
    snapdir = os.path.join(d["dir"], "forms_multi")
    multi.write_snapshots(snapdir)
    out.update(held_multibody_upper=[u is not None
                                     for u in multi.us["upper"]],
               held_multibody_mats=[m is not None
                                    for m in multi.mats["upper"]],
               held_bonded=list(multi.bonded[0].shape),
               multibody_path=multi.path,
               multibody_files=sorted(os.listdir(snapdir)))
    return out


def _worker_engine(mesh_of, d):
    """Every case on the two-rank mesh: state, traces and kernel of each,
    from this rank's run()."""
    out = {}
    for case in CASES:
        for kernel, dtype in KERNELS:
            mesh = mesh_of(len(case[3]) + 1,
                           case[3] if len(case[3]) == 2 else None)
            eng = _engine(case, kernel, dtype, mesh)
            res = eng.run()
            key = f"{case[0]}_{kernel}"
            out.update({f"{key}_u": res.u, f"{key}_traces": res.traces,
                        f"{key}_kernel": res.kernel})
    return out


def _save_runs(mesh_of, d):
    import torch.distributed as dist

    out = _worker_engine(mesh_of, d)
    out.update(_worker_forms(mesh_of, d))
    np.savez(os.path.join(d["dir"], f"runs_{dist.get_rank()}.npz"), **out)
    return np.zeros(0), []


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_multihost import worker_main

    worker_main(sys.argv[1:], {"engine": _save_runs})
