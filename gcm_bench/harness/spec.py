"""The benchmark as data: ``BENCHMARK.json`` at the root of the checkout,
and beside the harness one file for each configuration
(``configs/<name>.json``, named by the configuration's ``file``), traffic
mix (``traffic/<name>.json``) and per-layer metric (``metrics/<name>.py``;
the metrics of one quantity in several cells, ``<name>.<part>``, share
``<name>.py``). A cell, a configuration or a metric is added with files
and entries; no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

#: the checkout's root: the directory that holds this package
ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files it
    names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.package = self.root / "gcm_bench"

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {cell['config']!r}")

    def traffic(self, cell: Dict) -> Dict:
        return json.loads((self.package / "traffic"
                           / f"{cell['traffic']}.json").read_text())

    def end_to_end(self, cell: Dict) -> List[Dict]:
        return [m for m in self.bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: Dict) -> List[Dict]:
        """The per-layer metrics whose ``workloads`` list the cell."""
        return [m for m in self.bench["per_layer"]
                if cell["name"] in m["workloads"]]

    def reader(self, metric: Dict) -> ModuleType:
        """The reader of a per-layer metric: ``metrics/<stem>.py``, the
        stem its name up to the first dot."""
        stem = metric["name"].split(".")[0]
        path = self.package / "metrics" / f"{stem}.py"
        mod_name = "gcm_bench_metric_" + re.sub(r"\W", "_", stem)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def check_names(bench: Dict) -> List[str]:
    """The names and units of ``bench`` that break the benchmark's rules of
    characters (empty when none does)."""
    bad = []
    names = [c["name"] for c in bench["configs"]]
    names += [w[k] for w in bench["workloads"]
              for k in ("name", "config", "traffic")]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    bad += [n for n in names if not NAME.match(n)]
    bad += [m["unit"] for m in metrics if not UNIT.match(m["unit"])]
    for group in (bench["configs"], bench["workloads"], metrics):
        seen = [x["name"] for x in group]
        bad += sorted({n for n in seen if seen.count(n) > 1})
    return bad
