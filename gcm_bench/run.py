"""Run one cell of the benchmark once and print its result.

    python3 -m gcm_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and its per-layer metrics come
from ``BENCHMARK.json`` and the files beside this module. Standard error
gets the set-up's and the window's figures, then as its last lines each
number compared beside its limit; the last line of standard output is one
JSON object: ``correct``, ``attempted`` and ``failed`` (the checks),
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.
Without the cards the cell asks for, or holding a forbidden module once the
window has closed, it exits non-zero and prints no result.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# every build and kernel cache at a fixed path inside the checkout (the
# program builds its own library under build/kernels there)
_BUILD = Path(__file__).resolve().parents[1] / "build"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_BUILD / "triton")


def _power_limits():
    """Each card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gcm_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gcm_bench.harness.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA cards; torch "
              f"sees {have}", file=sys.stderr)
        return 3
    from gcm_bench.harness.cell import execute
    from gcm_bench.harness.guard import forbidden

    out = execute(spec, cell, args.seed, args.seconds, bool(args.trace),
                  "cuda", _T_START)
    bad = forbidden()
    if bad:
        print(f"the run holds forbidden modules: {bad}", file=sys.stderr)
        return 4
    dev = out.pop("device")
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0), **dev,
                     "cards": _power_limits()}
    out["checks"] = out.pop("checks")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
