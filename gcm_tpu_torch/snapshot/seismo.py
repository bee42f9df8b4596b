"""Seismogram (detector trace) output.

Counterpart of ``gcm_tpu/snapshot/seismo.py``: receiver traces, recorded on
the device by the engine, are saved host-side as an .npz with metadata, a
flat little-endian float32 binary (.bin) for external tools, and a .json
that describes the binary.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np


def save_seismograms(
    directory: str,
    name: str,
    traces: np.ndarray,               # [nsteps, npoints, ncomp]
    dt: float,
    points: Sequence[Sequence[float]],
    comp_names: Sequence[str],
) -> str:
    """Write ``<directory>/<name>.npz|.bin|.json``; returns the .npz path."""
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(directory, name)
    np.savez(
        base + ".npz",
        traces=traces.astype(np.float32),
        dt=np.float64(dt),
        points=np.asarray(points, np.float64),
        components=np.asarray(comp_names),
    )
    traces.astype("<f4").tofile(base + ".bin")
    with open(base + ".json", "w") as f:
        json.dump(
            {
                "dt": dt,
                "nsteps": int(traces.shape[0]),
                "npoints": int(traces.shape[1]),
                "ncomp": int(traces.shape[2]),
                "points": [list(map(float, p)) for p in points],
                "components": list(comp_names),
                "binary": os.path.basename(base) + ".bin",
                "layout": "steps x points x components, little-endian f32",
            },
            f, indent=2,
        )
    return base + ".npz"
