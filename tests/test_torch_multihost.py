"""One run across several processes: ``parallel.multihost`` and the sharded
steps on a mesh whose shards two gloo ranks hold.

The single-process tests port ``tests/test_multihost.py``: ``initialize()``
is a strict no-op without a launcher (``WORLD_SIZE=1`` plays the part of
JAX's ``TPU_WORKER_HOSTNAMES=localhost``), and the process info describes
this process. The two-process tests run JAX's two problems
(``tests/test_multihost.py:34-97`` and ``:100-169``: same shapes, seeds,
borders and steps) on two ranks of two CPU shards each, one mesh row a
rank, so the halo slabs cross the process boundary through
``parallel.p2p``: the plain per-sweep step (``make_spmd_step``) on
``('sx',)`` in float64 against JAX's ``solver.gcm.step`` at rtol 1e-10 /
atol 1e-9, and the fused SPMD step (``make_fused_spmd_step``, its kernels'
plain versions) on 2x2 in float32 against JAX's jnp step at normalized
1e-5. The inputs are made with numpy here and handed to the workers as a
``.npz``.

This file is also the workers' program (``python tests/test_torch_multihost.py
<mode> <coordinator> <nproc> <rank> <dir>``), which imports neither JAX nor
the JAX package: only the test functions do.
"""

import contextlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a worker may take, and a rank waits for the others
WORKER_TIMEOUT = 240


@contextlib.contextmanager
def reserved_port():
    """A free local port, held bound (not listening, ``SO_REUSEADDR``)
    until the block ends. Meanwhile no other process's bind or outgoing
    connection can take it, while rank 0's store, whose listener sets
    ``SO_REUSEADDR`` too, binds it. A port picked and released at once
    could be taken by another process before rank 0 binds it."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        yield s.getsockname()[1]


def spawn(script: str, mode: str, workdir: str, nproc: int = 2,
          timeout: float = WORKER_TIMEOUT) -> None:
    """Run ``script`` as ``nproc`` ranks of a gloo group at a reserved
    local port; fails with their output unless every rank exits 0 in
    time."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    with reserved_port() as port:
        procs = [subprocess.Popen(
            [sys.executable, script, mode, f"127.0.0.1:{port}", str(nproc),
             str(rank), str(workdir)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(nproc)]
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + "\nTIMEOUT"
            logs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(
        log[-3000:] for log in logs)


# ------------------------------------------------------------ one process

def test_initialize_is_noop_on_single_host(monkeypatch):
    from gcm_tpu_torch.parallel import multihost

    for name in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False
    assert not multihost.in_group()


def test_world_size_one_does_not_trigger(monkeypatch):
    """torchrun sets MASTER_ADDR for one process too; that is no group."""
    from gcm_tpu_torch.parallel import multihost

    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize() is False
    assert not multihost.in_group()


def test_shutdown_outside_a_group_does_nothing():
    from gcm_tpu_torch.parallel import multihost

    multihost.shutdown()
    assert not multihost.in_group()


def test_process_info_single_process():
    from gcm_tpu_torch.parallel import multihost

    info = multihost.process_info()
    assert info["process_index"] == 0
    assert info["process_count"] == 1
    assert info["local_devices"] >= 1
    assert info["global_devices"] == info["local_devices"]


def test_torchrun_environment_joins_the_group(tmp_path):
    """Under ``torchrun --nproc-per-node 2`` a bare ``initialize()`` finds
    the group in the environment. ``--standalone``: torchrun's agent binds
    a free port for its store and holds it, and ``initialize``'s
    ``tcp://`` store attaches to that store as a client
    (``TORCHELASTIC_USE_AGENT_STORE``). The script ends without leaving
    the group: ``initialize`` registered ``shutdown`` to run at exit."""
    script = tmp_path / "ranks.py"
    script.write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "sys.modules['jax'] = None\n"
        "from gcm_tpu_torch.parallel import multihost\n"
        "assert os.environ['TORCHELASTIC_USE_AGENT_STORE'] == 'True'\n"
        "assert multihost.initialize(backend='gloo')\n"
        "info = multihost.process_info()\n"
        f"open({str(tmp_path)!r} + f'/info_{{multihost.rank()}}', 'w')"
        ".write(repr(sorted(info.items())))\n")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--standalone", str(script)],
        cwd=ROOT, capture_output=True, text=True, timeout=WORKER_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for r in (0, 1):
        assert (tmp_path / f"info_{r}").read_text() == (
            f"[('global_devices', 2), ('local_devices', 1), "
            f"('process_count', 2), ('process_index', {r})]")


def test_default_backend_needs_a_card(monkeypatch):
    """No quiet move to the CPU: without a card the default backend
    raises, naming gloo."""
    import torch

    from gcm_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("WORLD_SIZE", "RANK", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with reserved_port() as port:
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            multihost.initialize(f"127.0.0.1:{port}", 2, 0)
        with pytest.raises(ValueError, match="world size and rank"):
            multihost.initialize(f"127.0.0.1:{port}", backend="gloo")


# ------------------------------------------------------------ two processes

def _material(shape):
    rng = np.random.default_rng(0)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    return rng, rho, lam, mu


def test_two_process_spmd_step(tmp_path):
    """tests/test_multihost.py:34-97: elastic2d (32, 16), float64, 4
    steps, all borders absorbing, on ('sx',) over 4 shards of two ranks."""
    import jax.numpy as jnp

    from gcm_tpu.materials import MaterialFields
    from gcm_tpu.models.spec import get_model
    from gcm_tpu.solver.gcm import step
    from gcm_tpu.task import BorderSpec

    model = get_model("elastic2d")
    rng, rho, lam, mu = _material((32, 16))
    u0 = rng.standard_normal((model.ncomp, 32, 16))
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    np.savez(tmp_path / "in.npz", u0=u0, rho=rho, lam=lam, mu=mu, dt=dt)
    spawn(__file__, "spmd2d", tmp_path)

    mat = MaterialFields.from_arrays(rho, lam, mu, xp=jnp, dtype=jnp.float64)
    borders = {(a, s): BorderSpec("absorbing")
               for a in range(2) for s in (0, 1)}
    want = jnp.asarray(u0)
    for n in range(4):
        axes = (0, 1) if n % 2 == 0 else (1, 0)
        want = step(model, want, mat, dt, (1.0, 1.0), 2, borders, axes)
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(got["u"], np.asarray(want), rtol=1e-10,
                               atol=1e-9)
    assert got["info"].tolist() == [0, 2, 1, 2]


def test_two_process_fused_spmd_step(tmp_path):
    """tests/test_multihost.py:100-169: elastic3d (48, 64, 8), float32, 4
    steps, free and absorbing borders, on 2x2 with one mesh row a rank (the
    x slabs and the y strips' corners cross the process boundary)."""
    import jax.numpy as jnp

    from gcm_tpu.materials import MaterialFields
    from gcm_tpu.models.spec import get_model
    from gcm_tpu.solver.gcm import step
    from gcm_tpu.task import BorderSpec

    model = get_model("elastic3d")
    rng, rho, lam, mu = _material((48, 64, 8))
    u0 = rng.standard_normal((model.ncomp, 48, 64, 8)).astype(np.float32)
    u0[3:] *= 1e6
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    np.savez(tmp_path / "in.npz", u0=u0, rho=rho, lam=lam, mu=mu, dt=dt)
    spawn(__file__, "fused3d", tmp_path)

    mat = MaterialFields.from_arrays(rho, lam, mu, xp=jnp, dtype=jnp.float32)
    want = jnp.asarray(u0)
    for n in range(4):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        want = step(model, want, mat, dt, (1.0, 1.0, 1.0), 2,
                    {f: BorderSpec(k) for f, k in FUSED_BORDERS}, axes)
    want = np.asarray(want)
    got = np.load(tmp_path / "out.npz")["u"]
    scale = np.abs(want).reshape(9, -1).max(1) + 1e-30
    err = np.abs(got - want).reshape(9, -1).max(1) / scale
    assert err.max() < 1e-5, err


def test_ranks_started_together_build_once(tmp_path):
    """Three processes that find no library build it once: the others wait
    on the build lock and load what the first built."""
    script = tmp_path / "build_race.py"
    script.write_text(BUILD_RACE)
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert (tmp_path / "compiles").read_text() == "x"
    assert sorted(o.split()[-1] for o in outs) == ["built", "loaded",
                                                   "loaded"]


#: the stand-in compile of the build race: slow, counted, then the library
BUILD_RACE = """
import sys, time
from pathlib import Path
sys.path.insert(0, ".")
from gcm_tpu_torch.ops import _build

tmp = Path(sys.argv[1])
_build.BUILD_DIR = tmp / "kernels"
_build.library_path = lambda: _build.BUILD_DIR / "lib.so"

def compile_(out):
    with open(tmp / "compiles", "a") as f:
        f.write("x")
    time.sleep(1.0)
    out.write_bytes(b"")
    return "log"

_build._compile = compile_
path, log = _build.build()
print("built" if log else "loaded")
"""

FUSED_BORDERS = (((0, 0), "free"), ((0, 1), "absorbing"),
                 ((1, 0), "absorbing"), ((1, 1), "free"),
                 ((2, 0), "absorbing"), ((2, 1), "absorbing"))


# ------------------------------------------------------------------ workers

def _worker_spmd2d(mesh_of, d):
    import torch

    from gcm_tpu_torch.materials import MaterialFields
    from gcm_tpu_torch.models.spec import get_model
    from gcm_tpu_torch.parallel import multihost
    from gcm_tpu_torch.parallel.halo import make_spmd_step
    from gcm_tpu_torch.parallel.sharding import (
        domain_mesh, gather_state, shard_mats, shard_state)
    from gcm_tpu_torch.task import BorderSpec

    # the default mesh after initialize: every rank's device, in rank order
    default = domain_mesh(2)
    assert default.ranks == (0, 1) and default.spans_processes
    mesh = mesh_of(2, None)
    model = get_model("elastic2d")
    mat = MaterialFields.from_arrays(d["rho"], d["lam"], d["mu"],
                                     device="cpu", dtype=torch.float64)
    borders = {(a, s): BorderSpec("absorbing")
               for a in range(2) for s in (0, 1)}
    step = make_spmd_step(model, mesh, float(d["dt"]), (1.0, 1.0), 2,
                          borders)
    us = shard_state(torch.as_tensor(d["u0"]), mesh)
    mats = shard_mats(mat, mesh)
    for n in range(4):
        us = step(us, mats, (0, 1) if n % 2 == 0 else (1, 0))
    info = multihost.process_info()
    return gather_state(us, mesh, device="cpu").numpy(), [
        info[k] for k in ("process_index", "process_count", "local_devices",
                          "global_devices")]


def _worker_fused3d(mesh_of, d):
    import torch

    from gcm_tpu_torch.materials import MaterialFields
    from gcm_tpu_torch.models.spec import get_model
    from gcm_tpu_torch.parallel.fused_spmd import (
        extended_mstack, make_fused_spmd_step)
    from gcm_tpu_torch.parallel.sharding import gather_state, shard_state
    from gcm_tpu_torch.task import BorderSpec

    mesh = mesh_of(3, (2, 2))
    model = get_model("elastic3d")
    mat = MaterialFields.from_arrays(d["rho"], d["lam"], d["mu"],
                                     device="cpu", dtype=torch.float32)
    step = make_fused_spmd_step(
        model, mesh, float(d["dt"]), (1.0, 1.0, 1.0), 2,
        {f: BorderSpec(k) for f, k in FUSED_BORDERS})
    us = shard_state(torch.as_tensor(d["u0"]), mesh)
    mexts = extended_mstack(model, mat, mesh, 2)
    assert [m is None for m in mexts] == [not mesh.is_local(k)
                                          for k in range(4)]
    for n in range(4):
        us = step(us, mexts, (0, 1, 2) if n % 2 == 0 else (2, 1, 0))
    return gather_state(us, mesh, device="cpu").numpy(), []


def fused_card_steps(mesh, d, nsteps=2):
    """``nsteps`` fused SPMD steps of the problem ``d`` on ``mesh`` (its
    shards on cuda:0): the gathered state and this process's launches of
    the interior and ring kernels."""
    import torch

    from gcm_tpu_torch.materials import MaterialFields
    from gcm_tpu_torch.models.spec import get_model
    from gcm_tpu_torch.ops.fused_spmd import (
        fused_spmd_interior, fused_spmd_ring)
    from gcm_tpu_torch.parallel.fused_spmd import (
        extended_mstack, make_fused_spmd_step)
    from gcm_tpu_torch.parallel.sharding import gather_state, shard_state
    from gcm_tpu_torch.task import BorderSpec

    dev = torch.device("cuda", 0)
    model = get_model("elastic3d")
    mat = MaterialFields.from_arrays(d["rho"], d["lam"], d["mu"],
                                     device=dev, dtype=torch.float32)
    step = make_fused_spmd_step(
        model, mesh, float(d["dt"]), (1.0, 1.0, 1.0), 2,
        {f: BorderSpec(k) for f, k in FUSED_BORDERS})
    us = shard_state(torch.as_tensor(d["u0"], device=dev), mesh)
    mexts = extended_mstack(model, mat, mesh, 2)
    fused_spmd_interior.launches = fused_spmd_ring.launches = 0
    for n in range(nsteps):
        us = step(us, mexts, (0, 1, 2) if n % 2 == 0 else (2, 1, 0))
    launches = [fused_spmd_interior.launches, fused_spmd_ring.launches]
    return gather_state(us, mesh, device="cpu").numpy(), launches


def _worker_card(mesh_of, d):
    """The fused SPMD step on cuda:0, one mesh row a rank."""
    return fused_card_steps(mesh_of(3, (2, 2), "cuda:0"), d)


def worker_main(argv, workers) -> None:
    """``<mode> <coordinator> <nproc> <rank> <dir>``: join the gloo group,
    run ``workers[mode](mesh_of, inputs)`` (``inputs``: the arrays of
    ``<dir>/in.npz`` and ``"dir"``) and save what it returns, ``(u,
    info)``: rank 0 as ``<dir>/out.npz``, every rank its info as
    ``<dir>/info_<rank>.npy``. ``mesh_of(dim, shape, device="cpu")`` is
    the mesh of 4 shards on ``device``, one mesh row (two shards) a
    rank."""
    sys.modules["jax"] = None            # the workers import no JAX
    sys.path.insert(0, ROOT)
    import torch

    from gcm_tpu_torch.parallel import multihost
    from gcm_tpu_torch.parallel.sharding import domain_mesh

    mode, coord, nproc, rank, workdir = argv
    torch.set_num_threads(2)
    # The first float32 torch.sqrt of a fresh process can come back at
    # rsqrt precision (all of it ~3.5e-5 off) on x86 CPU builds of PyTorch
    # under load (seen with 2.13.0+cpu on AVX-512, about one process in a
    # hundred; later calls are exact). The engines take the wave speeds'
    # sqrt at construction, and the ranks are held to one process bit for
    # bit, so each rank makes that first call on a throwaway tensor.
    torch.sqrt(torch.full((4096,), 2.0))
    assert multihost.initialize(coord, int(nproc), int(rank),
                                backend="gloo", timeout=WORKER_TIMEOUT)

    def mesh_of(dim, shape, device="cpu"):
        return domain_mesh(dim, [device] * 4, shape, ranks=[0, 0, 1, 1])

    inputs = os.path.join(workdir, "in.npz")
    d = dict(np.load(inputs)) if os.path.exists(inputs) else {}
    u, info = workers[mode](mesh_of, dict(d, dir=workdir))
    if int(rank) == 0:
        np.savez(os.path.join(workdir, "out.npz"), u=u, info=info)
    np.save(os.path.join(workdir, f"info_{rank}.npy"), np.asarray(info))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    assert not {"jax", "gcm_tpu"} & {k.split(".")[0] for k, v in
                                     sys.modules.items() if v is not None}


if __name__ == "__main__":
    worker_main(sys.argv[1:], {"spmd2d": _worker_spmd2d,
                               "fused3d": _worker_fused3d,
                               "card": _worker_card})
