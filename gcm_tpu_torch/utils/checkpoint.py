"""Checkpoint and resume of simulation state, in numpy ``.npz`` files.

Counterpart of ``gcm_tpu/utils/checkpoint.py``. One file a step,
``<directory>/step_<n>.npz``, holds the whole state an engine's
``state_dict()`` returns: fields, corrector aux, bond masks, the step
counter, detector traces and a simplex mesh's node fingerprint. Nested
dicts are flattened to ``/``-joined keys (an empty dict leaves the key with
a trailing ``/``), tensors are copied to the host, and ``restore_checkpoint``
returns the nested dict of numpy arrays.

A save writes a temporary file and renames it over the step's file, so a
process killed mid-write leaves the previous checkpoints intact; it first
deletes the temporary files such a process left behind, and keeps the
newest ``max_to_keep`` steps.
"""

from __future__ import annotations

import glob
import math
import os
import re
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

from gcm_tpu_torch.parallel import multihost

_STEP_FILE = re.compile(r"step_(\d+)\.npz")


def _host(v) -> np.ndarray:
    if hasattr(v, "detach"):                  # a torch tensor
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]):
    if not tree and prefix:
        out[prefix] = np.zeros(0)
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if "/" in str(k):
            raise ValueError(f"checkpoint key {key!r} holds '/'")
        if isinstance(v, Mapping):
            _flatten(v, key + "/", out)
        else:
            out[key] = _host(v)


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if leaf:
            node[leaf] = v
    return tree


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in
                  map(_STEP_FILE.fullmatch, os.listdir(directory)) if m)


def save_checkpoint(directory: str, step: int, state: Mapping[str, Any],
                    max_to_keep: int = 3) -> str:
    """Save ``state`` (a dict of arrays, tensors and dicts of them) as
    step ``step``; returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    for orphan in glob.glob(os.path.join(directory, "*.tmp.npz")):
        os.unlink(orphan)
    flat: Dict[str, np.ndarray] = {}
    _flatten(state, "", flat)
    path = os.path.join(directory, f"step_{int(step)}.npz")
    # must end in .npz, or np.savez appends the suffix itself
    tmp = os.path.join(directory, f"step_{int(step)}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.unlink(os.path.join(directory, f"step_{old}.npz"))
    return path


def latest_step(directory: str) -> Optional[int]:
    """The newest saved step, or None (also for a missing directory)."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str,
                       state_like: Optional[Mapping[str, Any]] = None,
                       step: Optional[int] = None) -> Dict[str, Any]:
    """The state saved at ``step`` (default: the newest). Given
    ``state_like`` (an engine's ``state_dict()``), only its top-level keys
    are returned: a template without ``traces`` never picks up a saved
    detector record."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    with np.load(os.path.join(directory, f"step_{int(step)}.npz")) as z:
        out = _unflatten({k: z[k] for k in z.files})
    if state_like is not None:
        out = {k: v for k, v in out.items() if k in state_like}
    return out


class TraceRecord:
    """The detector record of a run that can resume: the rows restored from
    a checkpoint (the steps before the run's start), then this run's rows,
    written a step at a time into buffers on the device. ``assemble()``
    gives the record of every completed step, mid-run too, so a checkpoint
    taken from a ``run`` callback holds the traces up to its step.

    A run's buffers are pairs ``(tensor [rows, k, ncomp], positions)``: the
    tensor holds the receivers at ``positions`` of the ``ndet`` (one buffer
    of them all, or one a shard on a mesh)."""

    def __init__(self, ndet: int, ncomp: int):
        self.ndet, self.ncomp = ndet, ncomp
        self.head: Optional[np.ndarray] = None
        self.bufs: list = []
        self.rows = 0

    def restore(self, head) -> None:
        """The rows of a restored ``traces`` (None or empty: none)."""
        self.head = (np.asarray(head) if head is not None and np.size(head)
                     else None)

    def start(self, bufs, resumed: bool) -> None:
        """A run's empty buffers; a run from step 0 drops restored rows."""
        if not resumed:
            self.head = None
        self.bufs, self.rows = list(bufs), 0

    def put(self, row: int, *values) -> None:
        """The receivers of the run's ``row``-th step, one value a buffer."""
        for (buf, _), v in zip(self.bufs, values):
            buf[row] = v
        self.rows = row + 1

    def assemble(self, gather: Optional[Callable] = None) -> np.ndarray:
        """``[steps, ndet, ncomp]`` on the host: the restored rows, then
        the filled rows of this run. ``gather`` (a run that spans
        processes: ``parallel.multihost.all_gather_object``) collects every
        rank's filled buffers, each rank holding its own receivers."""
        parts = [] if self.head is None else [self.head]
        filled = [(b[:self.rows].cpu().numpy(), pos) for b, pos in self.bufs]
        if gather is not None:
            filled = [f for part in gather(filled) for f in part]
        if filled:
            rows = np.empty((self.rows, self.ndet, self.ncomp),
                            filled[0][0].dtype)
            for vals, pos in filled:
                rows[:, pos] = vals
            parts.append(rows)
        if not parts:
            return np.zeros((0, self.ndet, self.ncomp), np.float32)
        return np.concatenate(parts, axis=0)


def output_callback(outdir: str, period: int, snapshot_every: int,
                    checkpoint_every: int, state_dict: Callable[[], Dict],
                    snapshot: Callable[[int, Dict], None], mesh=None):
    """The ``run()`` callback of an engine's ``run_with_outputs``, and its
    cadence: ``(callback, every)``, ``(None, 0)`` when both are off.

    Snapshots and checkpoints are independent, each rounded up to the
    symmetrization period (every=5 fires every 6 steps of a symmetrized
    run, never every 4; 0 is off), and the callback fires at their gcd. At
    a step where either is due it takes one ``state_dict()`` (one copy of
    the state to the host), hands it to ``snapshot(step, state)`` and saves
    it in ``<outdir>/checkpoints``, as due; at any other step it does
    nothing, so the state stays on the device. A run on a ``mesh`` that
    spans processes calls it on every rank: each takes the
    ``state_dict()``, only the rank that ``multihost.writes_files`` names
    writes, and ``multihost.files_written`` then holds every rank until the
    files are complete.
    """
    snap, ck = (-(-c // period) * period if c else 0
                for c in (snapshot_every, checkpoint_every))
    every = math.gcd(snap, ck)
    if not every:
        return None, 0
    ckdir = os.path.join(outdir, "checkpoints")
    writer = multihost.writes_files(mesh)

    def callback(step: int, _u) -> None:
        due_snap = snap and step % snap == 0
        due_ck = ck and step % ck == 0
        if not (due_snap or due_ck):
            return
        state = state_dict()
        if writer and due_snap:
            snapshot(step, state)
        if writer and due_ck:
            save_checkpoint(ckdir, step, state)
        multihost.files_written(mesh)

    return callback, every
