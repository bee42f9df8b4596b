#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` (one process, a mesh over distinct cards)
alone, on the cards this machine has, after building the kernels.

    python3 tools/torch_multicard.py           # phase 22
    python3 tools/torch_multicard.py --nccl    # and phase 20's (f)

Runs ``chip_smoke.multicard_paths``: with four or more cards (a)-(e), each
run against the same mesh with every shard on cuda:0 bit for bit; with two
or three, (a) on 2x1 cards and the 2D path on sx=2; with one it prints
``phase 22: not run (1 card)``. ``--nccl`` then also runs phase 20's
contact runs (a)-(c) by two ranks under NCCL, one a card (``chip_smoke.
_mpc_nccl``), against their one-process runs on cuda:0 (needs two cards).
Prints the cards' names and power limits first, and the kernels'
``multicard_*`` entries last.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nccl", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_multicard: torch sees no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)

    import chip_smoke as cs
    from gcm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    result = {k: {} for k in ("fused_spmd_interior", "fused_spmd_ring",
                              "sweep_stage", "fused_spmd_2d")}
    cs.multicard_paths(cs.Counts(), result)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.nccl:
        if torch.cuda.device_count() < 2:
            sys.exit("torch_multicard: --nccl needs two cards")
        t0 = time.perf_counter()
        refs = cs._mpc_refs()
        root = tempfile.mkdtemp(prefix="multicard_nccl_",
                                dir=os.path.join(ROOT, "build"))
        try:
            cs._mpc_nccl(root, refs)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(f"(f): {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
