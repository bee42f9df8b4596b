"""Point location on a Delaunay mesh: a bounded visibility walk, vectorised.

Replaces ``gcm_tpu/native/walk_locate`` (``gcm_native.cpp``) for the port.
The walk is the same: each query starts from a given cell (the foot's own
node's incident cell, ``Delaunay.vertex_to_simplex``), computes its
barycentric coordinates there from scipy's ``transform``, and steps to the
neighbour across the face of the most negative coordinate, until every
coordinate is at least ``-EPS`` (found) or the step leaves the hull
(outside). A cell with a singular transform steps to its first neighbour.

What differs is the bound. The reference walks up to ``ncells + 16`` steps,
and a foot that leaves the hull through the lattice's flat boundary slivers
can cycle that long and then be reported outside, though scipy places some
of them inside a cell. Here every query still unresolved after
``max_steps`` steps is answered by scipy's ``find_simplex`` and
``transform``, the reference's own fallback. A query the reference walk
resolves within the bound gets the same cell here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: inside tolerance of a barycentric coordinate (gcm_native.cpp)
EPS = 1e-12
#: walk steps before a query goes to scipy's locator
MAX_STEPS = 64


def _scipy_locate(tri, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """scipy's ``find_simplex`` with barycentric coordinates (0 outside)."""
    dim = queries.shape[1]
    cells = tri.find_simplex(queries).astype(np.int32)
    ok = cells >= 0
    T = tri.transform[np.where(ok, cells, 0)]
    b = np.einsum("nij,nj->ni", T[:, :dim, :], queries - T[:, dim, :])
    bary = np.concatenate([b, 1.0 - b.sum(1, keepdims=True)], axis=1)
    bary[~ok] = 0.0
    return cells, bary


def walk_locate(tri, queries: np.ndarray, starts: np.ndarray,
                max_steps: int = MAX_STEPS
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Locate ``queries [nq, dim]`` on the scipy Delaunay ``tri``.

    Returns ``(cells [nq] int32, -1 outside; bary [nq, dim+1] float64, 0
    outside; steps [nq] int64)``: ``steps`` counts the walk's steps of each
    query, ``max_steps`` for the queries that scipy answered.
    """
    queries = np.ascontiguousarray(queries, np.float64)
    nq, dim = queries.shape
    ncells = len(tri.simplices)
    transform, neighbors = tri.transform, tri.neighbors
    cell = np.asarray(starts, np.int64).copy()
    cell[(cell < 0) | (cell >= ncells)] = 0
    out_cell = np.full(nq, -1, np.int32)
    out_bary = np.zeros((nq, dim + 1))
    steps = np.full(nq, max_steps, np.int64)
    active = np.arange(nq)
    for step in range(max_steps):
        if not len(active):
            break
        c = cell[active]
        T = transform[c]
        b = np.einsum("nij,nj->ni", T[:, :dim, :], queries[active] - T[:, dim, :])
        finite = np.isfinite(b).all(axis=1)
        bary = np.concatenate([b, 1.0 - b.sum(1, keepdims=True)], axis=1)
        low = np.where(bary < -EPS, bary, np.inf)
        worst = np.argmin(low, axis=1)
        inside = finite & np.isinf(low).all(axis=1)
        nbr = neighbors[c]
        # a singular cell steps to its first neighbour; a cell without one
        # ends the walk outside, as the reference's does
        first = np.argmax(nbr >= 0, axis=1)
        nxt = np.where(finite, nbr[np.arange(len(c)), worst],
                       nbr[np.arange(len(c)), first])
        done = inside | (nxt < 0)
        hit = active[inside]
        out_cell[hit] = c[inside]
        out_bary[hit] = bary[inside]
        steps[active[done]] = step
        cell[active] = np.where(done, c, nxt)
        active = active[~done]
    if len(active):
        out_cell[active], out_bary[active] = _scipy_locate(tri, queries[active])
    return out_cell, out_bary, steps
