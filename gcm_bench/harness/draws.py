"""What the seed draws: the data of a run, never its shapes.

From ``--seed`` the generator draws, for a configuration and a traffic mix:
each material's density and wave speeds within ``perturb`` of the
configuration's values, the source node inside the traffic's box (in
metres, on the source's body), and the receiver nodes on a plane of the
receivers' body. Grid, model, order, borders, splitting and path stay as
the configuration states them. The program and the reference are handed
the same draws; positions lie on nodes, so both find the same node.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


def rng_of(seed: int) -> np.random.Generator:
    """The generator of a seed: any whole number, large ones too."""
    return np.random.default_rng(np.random.SeedSequence(abs(int(seed))))


def spacing(body: Dict):
    """Grid spacing of a body: its lengths over its intervals."""
    return tuple(L / (n - 1) for L, n in zip(body["lengths"], body["shape"]))


def _node_in(rng, lo: float, hi: float, origin: float, h: float,
             n: int) -> int:
    a = max(0, math.ceil((lo - origin) / h - 1e-9))
    b = min(n - 1, math.floor((hi - origin) / h + 1e-9))
    if b < a:
        raise ValueError(f"no node in [{lo}, {hi}] m")
    return int(rng.integers(a, b + 1))


def draw(config: Dict, traffic: Dict, seed: int) -> Dict:
    """The seeded data of one run of ``config`` under ``traffic``."""
    rng = rng_of(seed)
    p = float(traffic["perturb"])

    def scale(m):
        f = 1.0 + rng.uniform(-p, p, size=3)
        return {"rho": m["rho"] * f[0], "cp": m["cp"] * f[1],
                "cs": m["cs"] * f[2]}

    materials = {}
    for name, body in config["bodies"].items():
        layers = [scale(layer) for layer in body.get("layers", ())]
        materials[name] = {"layers": layers, "default": scale(body["default"])}

    def node(body, box, fixed=None):
        h = spacing(body)
        out = []
        for a, ax in enumerate("xyz"[:len(body["shape"])]):
            if fixed is not None and a == fixed[0]:
                out.append(fixed[1] % body["shape"][a])
                continue
            lo, hi = box[ax]
            out.append(_node_in(rng, lo, hi, body["origin"][a], h[a],
                                body["shape"][a]))
        pos = tuple(body["origin"][a] + i * h[a] for a, i in enumerate(out))
        return tuple(out), pos

    wav = config["source_wavelet"]
    sbody = config["bodies"][wav["body"]]
    snode, spos = node(sbody, traffic["source_box"])
    rec = traffic.get("receivers") or {}
    rnodes, rpos = [], []
    rbody = rec.get("body", wav["body"])
    for _ in range(int(rec.get("count", 0))):
        nd, ps = node(config["bodies"][rbody], rec["box"],
                      fixed=(rec["axis"], rec["index"]))
        rnodes.append(nd)
        rpos.append(ps)
    return {"materials": materials,
            "source": {"body": wav["body"], "node": snode, "position": spos},
            "receivers": {"body": rbody, "nodes": rnodes,
                          "positions": rpos}}
