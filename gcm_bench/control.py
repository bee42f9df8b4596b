"""The readings that the limits of ``correct`` are set from, on the card:
for each seed, one run of the cell with a short window, and every check
read twice, for the program and for the control (the reference computed in
bfloat16, the nearest type below the configuration's float32, in the
program's place), each judged by the rule that decides ``correct``
(``cell.judge``). One process for all the seeds; each line of the output
file is one seed's checks and verdicts: the program's ``correct`` and the
control's, which has to come out false. The benchmark's own runs do not
run this.

    python3 -m gcm_bench.control --workload <name> --seeds 1,2,3 \
        --seconds 2 --out <file.jsonl>
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gcm_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    from gcm_bench.harness.cell import execute
    from gcm_bench.harness.spec import Spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    spec = Spec()
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = execute(spec, cell, seed, args.seconds, False, "cuda",
                      control=True)
        rec = {"workload": args.workload, "seed": seed,
               "correct": out["correct"], "checks": out["checks"],
               "control": out["control"], "metrics": out["metrics"],
               "wall_s": time.perf_counter() - t0}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        for d in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
