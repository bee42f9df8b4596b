"""Point-to-point moves of halo slabs between the shards of a mesh.

A phase of an exchange is a list of :class:`Move`: a source shard's view is
copied into a destination shard's buffer. Every rank builds the same list,
in the same order, and acts on its part: a move between two of its own
shards is a copy, a move from one of its shards to another rank's is a
send, the reverse a receive, and a move between two other ranks' shards is
skipped. The sends and receives of a phase are posted together in one
``torch.distributed.batch_isend_irecv``, tagged by (phase, side,
destination shard), so no rank waits on a send that was never posted.

The backend is the process group's own:

- ``nccl`` moves device tensors, on the process group's stream, ordered
  after the stream the copies are made on (the caller's side stream);
- ``gloo`` moves host tensors: the slabs of CUDA shards pass through
  pinned host buffers, device-to-host after the producing stream,
  host-to-device on the consumer's stream (gloo cannot send device memory);
  CPU shards' slabs go as they are.

Views that are not contiguous are copied into a contiguous buffer of the
transport first. Buffers are kept by the transport across calls.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from gcm_tpu_torch.utils.profiling import count, enabled

#: tags a phase: sides (and parts of a side) of a destination shard
SIDES = 8


class Move(NamedTuple):
    """Copy ``view`` (of shard ``src``) into ``buf`` (of shard ``dst``):
    ``view`` is None where another rank holds ``src``, ``buf`` where
    another holds ``dst``."""

    src: int
    dst: int
    view: Optional[torch.Tensor]
    buf: Optional[torch.Tensor]
    tag: int


def tag(phase: int, side: int, dst: int, nshards: int) -> int:
    """The tag of a move into side ``side`` (< SIDES) of shard ``dst`` in
    phase ``phase``."""
    return (phase * SIDES + side) * nshards + dst


class Transport:
    """Carries out the moves of a mesh's exchanges (see the module).

    ``streams`` maps a device to the stream its copies run on (a side
    stream); a device without one uses its current stream.
    """

    def __init__(self, mesh, streams: Optional[Dict] = None):
        self.mesh = mesh
        self.streams = dict(streams or {})
        self.backend = dist.get_backend() if mesh.spans_processes else None
        self._bufs: Dict = {}

    def _stream(self, dev: torch.device):
        return self.streams.get(dev) or torch.cuda.current_stream(dev)

    def _on(self, dev: torch.device):
        return (torch.cuda.stream(self._stream(dev)) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _staged(self, dev: torch.device) -> bool:
        """Whether moves from or to ``dev`` pass through host memory."""
        return self.backend == "gloo" and dev.type == "cuda"

    def _buffer(self, key, like: torch.Tensor) -> torch.Tensor:
        """A contiguous buffer for ``like``'s values: in pinned host memory
        where gloo moves a CUDA tensor's, else beside it."""
        staged = self._staged(like.device)
        buf = self._bufs.get(key)
        if (buf is None or buf.shape != like.shape
                or buf.dtype != like.dtype):
            buf = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
                   if staged else torch.empty(like.shape, dtype=like.dtype,
                                              device=like.device))
            self._bufs[key] = buf
        return buf

    def start(self, moves: Sequence[Move]):
        """Make the phase's local copies and stage its sends (on the
        devices' streams); post its sends and receives unless they pass
        through host memory, which :meth:`finish` posts once the staging
        copies are done. Returns what :meth:`finish` takes."""
        local = self.mesh.is_local
        if enabled():
            self._count(moves)
        ops, recvs, dev = [], [], None
        for m in moves:
            if local(m.src) and local(m.dst):
                with self._on(m.buf.device):
                    m.buf.copy_(m.view)
            elif local(m.src):
                t, dev = m.view, m.view.device
                if self._staged(dev) or not t.is_contiguous():
                    s = self._buffer(("send", m.tag), t)
                    with self._on(dev):
                        s.copy_(t, non_blocking=True)
                    t = s
                ops.append(dist.P2POp(dist.isend, t, self.mesh.ranks[m.dst],
                                      tag=m.tag))
            elif local(m.dst):
                t, dev = m.buf, m.buf.device
                if self._staged(dev) or not t.is_contiguous():
                    t = self._buffer(("recv", m.tag), t)
                    recvs.append((t, m.buf))
                ops.append(dist.P2POp(dist.irecv, t, self.mesh.ranks[m.src],
                                      tag=m.tag))
        works = (None if not ops or self._staged(dev)
                 else self._post(ops, dev))
        return ops, works, recvs, dev

    def _count(self, moves: Sequence[Move]) -> None:
        """The tracer's counters of a phase: the copies made in this
        process, their bytes on one device and between two, and the bytes
        sent to other ranks."""
        local = self.mesh.is_local
        copies = same = peer = sent = 0
        for m in moves:
            if local(m.src) and local(m.dst):
                copies += 1
                n = m.view.numel() * m.view.element_size()
                if m.view.device == m.buf.device:
                    same += n
                else:
                    peer += n
            elif local(m.src):
                sent += m.view.numel() * m.view.element_size()
        count("gcm.exchange.copies", copies)
        count("gcm.exchange.local_bytes", same)
        count("gcm.exchange.peer_bytes", peer)
        count("gcm.exchange.sent_bytes", sent)

    def _post(self, ops, dev) -> List:
        with self._on(dev):
            return dist.batch_isend_irecv(ops)

    def finish(self, pending) -> None:
        """Complete a phase: post its host-staged moves (after the staging
        copies and the previous phase's reads of the host buffers are
        done), wait for every move (under NCCL: the device's stream waits;
        under gloo: the host), then copy what arrived into its
        destinations on the devices' streams."""
        ops, works, recvs, dev = pending
        if not ops:
            return
        if works is None:
            self._stream(dev).synchronize()
            works = self._post(ops, dev)
        with self._on(dev):
            for w in works:
                w.wait()
            for src, dst in recvs:
                dst.copy_(src, non_blocking=True)

    def run(self, moves: Sequence[Move]) -> None:
        """One phase, started and finished."""
        self.finish(self.start(moves))


def gather_blocks(blocks: Sequence[Optional[torch.Tensor]], mesh,
                  device) -> List[torch.Tensor]:
    """Every shard's block on every rank, on ``device``: each is broadcast
    from the rank that holds it (through host memory under gloo). Every
    block has the shape and type of this rank's first."""
    like = next(b for b in blocks if b is not None)
    backend = dist.get_backend()
    comm = like.device if backend == "nccl" else torch.device("cpu")
    out = []
    for k, b in enumerate(blocks):
        t = (b.to(comm).contiguous() if mesh.is_local(k) else
             torch.empty(like.shape, dtype=like.dtype, device=comm))
        dist.broadcast(t, src=mesh.ranks[k])
        out.append(t.to(device))
    return out
