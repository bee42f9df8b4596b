#!/usr/bin/env python3
"""Phase 19 or 20 of ``chip_smoke.py`` (one run across two processes)
alone, on the cards this machine has, after building the kernels.

    python3 tools/torch_multiproc.py            # phase 19
    python3 tools/torch_multiproc.py --contact  # phase 20
    python3 tools/torch_multiproc.py --nccl     # only (a) under NCCL
    python3 tools/torch_multiproc.py --probe    # what the backends take

The default runs ``chip_smoke.multiproc_paths``: two gloo ranks on cuda:0
for (a)-(c), each against its one-process run, and with two or more cards
(a) again under NCCL, one rank a card. ``--contact`` runs
``chip_smoke.multiproc_contact_paths`` instead: the contact path and the
outputs across two gloo ranks on cuda:0. ``--nccl`` runs only phase 19's
(a) under NCCL (needs two cards) against its one-process run. ``--probe`` asks
each backend to move a CUDA tensor between two ranks on cuda:0 (an
isend/irecv pair, a broadcast) and prints what it did: a refusal is a
finding, not a failure of the script. Prints the cards' names and power
limits first, and the kernels' ``multiproc_*`` (``multiproc_contact_*``)
entries last.
"""

import argparse
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _probe_rank(backend, rank, coord):
    """One rank of the probe: send rank-stamped CUDA tensors both ways."""
    import torch
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    torch.cuda.set_device(0)
    peer = 1 - rank
    sent = torch.arange(12.0, device="cuda") + 100 * rank
    got = torch.zeros(12, device="cuda")
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, sent, peer, tag=3),
            dist.P2POp(dist.irecv, got, peer, tag=3)]):
        w.wait()
    want = torch.arange(12.0, device="cuda") + 100 * peer
    print(f"{backend} rank {rank}: isend/irecv of a CUDA tensor "
          f"{'delivered' if torch.equal(got, want) else 'WRONG'}", flush=True)
    b = torch.full((4,), float(rank), device="cuda")
    dist.broadcast(b, src=1)
    print(f"{backend} rank {rank}: broadcast of a CUDA tensor "
          f"{b.tolist()}", flush=True)
    dist.destroy_process_group()


def probe():
    """Both backends, two ranks on cuda:0: each rank's output or error."""
    for backend in ("gloo", "nccl"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{s.getsockname()[1]}"
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--probe-rank", backend, str(r),
             coord], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
        for r, p in enumerate(procs):
            try:
                out = p.communicate(timeout=120)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + "\nTIMEOUT"
            lines = [ln for ln in out.splitlines()
                     if ln.strip() and "socket.cpp" not in ln]
            print(f"--- {backend} rank {r}, exit {p.returncode}")
            for ln in lines[-4:]:
                print(f"  {ln.strip()[:300]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nccl", action="store_true")
    ap.add_argument("--contact", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--probe-rank", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.probe_rank:
        backend, rank, coord = args.probe_rank
        return _probe_rank(backend, int(rank), coord)

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_multiproc: torch sees no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    if args.probe:
        return probe()

    import chip_smoke as cs
    from gcm_tpu_torch.engine import Engine
    from gcm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    result = {k: {} for k in ("fused_spmd_interior", "fused_spmd_ring",
                              "sweep_stage", "fused_spmd_2d")}
    if args.nccl:
        if torch.cuda.device_count() < 2:
            sys.exit("torch_multiproc: --nccl needs two cards")
        _, task, dim, shape = cs._mp_cases()[0]
        mesh = cs._mp_mesh(dim, shape, [torch.device("cuda", 0)] * 4)
        Engine(cs._short(task), mesh=mesh).run()
        want = Engine(task, mesh=mesh).run()
        torch.cuda.empty_cache()
        root = tempfile.mkdtemp(prefix="multiproc_",
                                dir=os.path.join(ROOT, "build"))
        try:
            cs._mp_nccl(root, want)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    elif args.contact:
        cs.multiproc_contact_paths(cs.Counts(), result)
    else:
        cs.multiproc_paths(cs.Counts(), result)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
