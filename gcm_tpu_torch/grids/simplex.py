"""Simplex (tri/tet) meshes with precomputed characteristic gather tables.

Counterpart of ``gcm_tpu/grids/simplex.py``, host side only (numpy and
scipy). With static dt and static materials the characteristic foot of
every (node, axis, wave, direction) is fixed for the whole run, so the
containing cells and barycentric weights are located once, here, and every
sweep is a static gather + weighted sum over node arrays
(``solver/simplex_gcm.py``, ``ops/simplex.py``).

Feet that fall outside the hull mark *incoming* invariants at the border;
the sweep overwrites those from the border condition.

Node numbering is the JAX package's, including the ``"lex"`` locality
reorder of ``from_cells``: per-node states of the two packages compare
index for index. The stencil compression of the foot tables is not ported:
it exists only because the TPU has no fast gathers, and the CUDA kernel
reads the ``ids``/``weights`` tables as they are. Delaunay meshes locate
their feet with ``grids.locate.walk_locate`` (a bounded walk with scipy's
locator behind it) instead of the JAX package's C++ walk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from gcm_tpu_torch.grids.locate import walk_locate


def _axis_bins(vals: np.ndarray, rel_gap: float = 0.35) -> np.ndarray:
    """Cluster a 1-D coordinate set into plane bins by gap detection: any
    sorted gap above ``rel_gap * max_gap`` starts a new bin."""
    order = np.argsort(vals, kind="stable")
    sv = vals[order]
    bins = np.empty(len(vals), np.int64)
    if len(vals) < 2:
        bins[:] = 0
        return bins
    g = np.diff(sv)
    gmax = g.max() if len(g) else 0.0
    if gmax <= 0:
        bins[:] = 0
        return bins
    starts = np.concatenate([[True], g > max(rel_gap * gmax, 1e-12)])
    bins[order] = np.cumsum(starts) - 1
    return bins


def locality_order(points: np.ndarray, cells: Optional[np.ndarray] = None,
                   strategy: str = "lex") -> np.ndarray:
    """Node permutation (``new_points = points[order]``): ``"lex"`` sorts
    per-axis gap-clustered plane bins lexicographically (axis 0 primary),
    ``"rcm"`` is reverse Cuthill-McKee over the node adjacency."""
    points = np.asarray(points, np.float64)
    n, dim = points.shape
    if strategy == "rcm":
        if cells is None:
            raise ValueError("rcm ordering needs the cell array")
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        d1 = cells.shape[1]
        i = np.repeat(cells, d1, axis=1).ravel()
        j = np.tile(cells, (1, d1)).ravel()
        A = sp.coo_matrix((np.ones(len(i), np.int8), (i, j)),
                          shape=(n, n)).tocsr()
        return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                          np.int64)
    if strategy != "lex":
        raise ValueError(f"unknown ordering strategy {strategy!r}")
    bins = [_axis_bins(points[:, a]) for a in range(dim)]
    # primary key = axis 0 (np.lexsort's LAST key is primary)
    return np.lexsort(tuple(bins[::-1]))


@dataclasses.dataclass
class SimplexGrid:
    """An unstructured simplex mesh: points [N, dim], cells [M, dim+1].

    - ``from_points`` / ``box``: Delaunay of a point cloud (convex domains),
      located by the bounded walk;
    - ``from_cells`` / ``box_minus`` / ``load_msh``: an explicit simplicial
      complex (non-convex bodies, holes), located by the incidence-candidate
      locator; locality-reordered by default, with ``node_order`` mapping
      external per-node data into grid order
      (``data_grid = data_orig[..., grid.node_order]``).
    """

    points: np.ndarray
    cells: np.ndarray
    delaunay: Optional[object] = None     # scipy.spatial.Delaunay if built
    #: original index of each node (None unless the constructor reordered)
    node_order: Optional[np.ndarray] = None
    _locator: Optional["_ComplexLocator"] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def npoints(self) -> int:
        return self.points.shape[0]

    @staticmethod
    def from_points(points: np.ndarray) -> "SimplexGrid":
        from scipy.spatial import Delaunay

        points = np.asarray(points, np.float64)
        tri = Delaunay(points)
        return SimplexGrid(points=points, cells=tri.simplices.copy(),
                           delaunay=tri)

    @staticmethod
    def from_cells(points: np.ndarray, cells: np.ndarray,
                   reorder: "str | bool | None" = "lex") -> "SimplexGrid":
        """Wrap an explicit simplicial complex; ``reorder`` (default "lex")
        renumbers the nodes by :func:`locality_order`, None keeps them."""
        points = np.asarray(points, np.float64)
        cells = np.asarray(cells, np.int32)
        if cells.ndim != 2 or cells.shape[1] != points.shape[1] + 1:
            raise ValueError(
                f"cells must be [M, dim+1]={points.shape[1] + 1}, "
                f"got {cells.shape}")
        if cells.min() < 0 or cells.max() >= len(points):
            raise ValueError("cell vertex index out of range")
        node_order = None
        if reorder:
            order = locality_order(points, cells,
                                   strategy=("lex" if reorder is True
                                             else reorder))
            inv = np.empty(len(points), np.int64)
            inv[order] = np.arange(len(points))
            points = points[order]
            cells = inv[cells].astype(np.int32)
            node_order = order
        return SimplexGrid(points=points, cells=cells, delaunay=None,
                           node_order=node_order)

    @staticmethod
    def box(lo: Sequence[float], hi: Sequence[float], n: Sequence[int],
            jitter: float = 0.0, seed: int = 0) -> "SimplexGrid":
        """Triangulated box: structured node lattice, optionally jittered in
        the interior by ``jitter`` lattice steps from ``seed``."""
        axes = [np.linspace(l, h, k) for l, h, k in zip(lo, hi, n)]
        pts = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")],
                       axis=-1)
        if jitter > 0:
            rng = np.random.default_rng(seed)
            steps = [(h - l) / (k - 1) for l, h, k in zip(lo, hi, n)]
            interior = np.ones(len(pts), bool)
            for a, (l, h) in enumerate(zip(lo, hi)):
                interior &= (pts[:, a] > l + 1e-9) & (pts[:, a] < h - 1e-9)
            pts[interior] += (rng.uniform(-jitter, jitter,
                                          (interior.sum(), len(lo)))
                              * np.asarray(steps))
        return SimplexGrid.from_points(pts)

    @staticmethod
    def box_minus(lo: Sequence[float], hi: Sequence[float], n: Sequence[int],
                  holes: Sequence[object] = (), jitter: float = 0.0,
                  seed: int = 0,
                  reorder: "str | bool | None" = "lex") -> "SimplexGrid":
        """Lattice triangulation of a box with the cells removed whose
        centroid lies inside any of ``holes`` (``task.Area`` objects); unused
        points are dropped. With holes the result goes through
        :meth:`from_cells` and its reorder."""
        base = SimplexGrid.box(lo, hi, n, jitter=jitter, seed=seed)
        if not holes:
            return base
        centroids = base.points[base.cells].mean(axis=1)
        keep = np.ones(len(base.cells), bool)
        for hole in holes:
            keep &= ~hole.contains(centroids)
        cells = base.cells[keep]
        used = np.unique(cells)
        remap = -np.ones(base.npoints, np.int64)
        remap[used] = np.arange(len(used))
        return SimplexGrid.from_cells(base.points[used], remap[cells],
                                      reorder=reorder)

    def hull_mask(self) -> np.ndarray:
        """Boolean mask of border nodes: vertices of faces that belong to
        exactly one cell (any simplicial complex)."""
        m = np.zeros(self.npoints, bool)
        m[np.unique(self.boundary_faces())] = True
        return m

    def boundary_faces(self) -> np.ndarray:
        """Faces [F, dim] that belong to exactly one cell."""
        d1 = self.cells.shape[1]
        faces = []
        for drop in range(d1):
            f = np.delete(self.cells, drop, axis=1)
            faces.append(np.sort(f, axis=1))
        faces = np.concatenate(faces, axis=0)
        uniq, counts = np.unique(faces, axis=0, return_counts=True)
        return uniq[counts == 1]


@dataclasses.dataclass
class _ComplexLocator:
    """Point location on an arbitrary simplicial complex: the cells incident
    to a query's k nearest mesh vertices, tested by barycentric containment
    with precomputed per-cell affine maps. A query in a notch matches no
    candidate and is reported outside."""

    kdtree: object                  # cKDTree over mesh points
    v2c: np.ndarray                 # [N, deg] padded incident cells, -1 pad
    Tinv: np.ndarray                # [M, dim, dim] inverse edge matrices
    v0: np.ndarray                  # [M, dim] first vertex of each cell
    ok: np.ndarray                  # [M] non-degenerate cell mask

    @staticmethod
    def build(points: np.ndarray, cells: np.ndarray) -> "_ComplexLocator":
        from scipy.spatial import cKDTree

        n, dim = points.shape
        m = len(cells)
        flat_v = cells.ravel()
        flat_c = np.repeat(np.arange(m, dtype=np.int32), dim + 1)
        order = np.argsort(flat_v, kind="stable")
        sv, sc = flat_v[order], flat_c[order]
        counts = np.bincount(sv, minlength=n)
        deg = int(counts.max()) if m else 1
        v2c = np.full((n, deg), -1, np.int32)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        col = np.arange(len(sv)) - starts[sv]
        v2c[sv, col] = sc
        # per-cell affine maps: columns of T are edge vectors v_i - v_0
        V = points[cells]                              # [M, dim+1, dim]
        T = np.transpose(V[:, 1:, :] - V[:, :1, :], (0, 2, 1))
        det = np.linalg.det(T)
        ok = np.abs(det) > 1e-300
        Tsafe = np.where(ok[:, None, None], T, np.eye(dim)[None])
        return _ComplexLocator(
            kdtree=cKDTree(points), v2c=v2c,
            Tinv=np.linalg.inv(Tsafe), v0=V[:, 0, :], ok=ok)

    def locate(self, queries: np.ndarray, k: int = 8,
               tol: float = 1e-9) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (cells [nq] int32, -1 outside; bary [nq, dim+1])."""
        queries = np.asarray(queries, np.float64)
        nq, dim = queries.shape
        k = min(k, len(self.v2c))
        out_cell = np.full(nq, -1, np.int32)
        out_bary = np.zeros((nq, dim + 1), np.float64)
        chunk = max(1, int(2**22 // max(self.v2c.shape[1] * k, 1)))
        for s in range(0, nq, chunk):
            q = queries[s:s + chunk]                    # [B, dim]
            _, nn = self.kdtree.query(q, k=k)
            if k == 1:
                nn = nn[:, None]
            cand = self.v2c[nn].reshape(len(q), -1)     # [B, K]
            valid = cand >= 0
            cc = np.where(valid, cand, 0)
            rel = q[:, None, :] - self.v0[cc]           # [B, K, dim]
            b = np.einsum("bkij,bkj->bki", self.Tinv[cc], rel)
            bary = np.concatenate(
                [1.0 - b.sum(-1, keepdims=True), b], axis=-1)
            inside = (bary >= -tol).all(-1) & valid & self.ok[cc]
            first = inside.argmax(axis=1)
            hit = inside.any(axis=1)
            rows = np.arange(len(q))
            out_cell[s:s + chunk] = np.where(
                hit, cand[rows, first], -1).astype(np.int32)
            out_bary[s:s + chunk] = np.where(
                hit[:, None], bary[rows, first], 0.0)
        return out_cell, out_bary


def load_msh(path: str,
             reorder: "str | bool | None" = "lex") -> SimplexGrid:
    """Load a Gmsh ASCII .msh (v2.2) mesh: 4-node tetrahedra (type 4) if
    present, else 3-node triangles (type 2, projected to 2D). ``reorder``
    as in :meth:`SimplexGrid.from_cells`."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    ids, coords = [], []
    tris, tets = [], []
    i = 0
    while i < len(lines):
        if lines[i] == "$Nodes":
            n = int(lines[i + 1])
            for j in range(n):
                parts = lines[i + 2 + j].split()
                ids.append(int(parts[0]))
                coords.append([float(x) for x in parts[1:4]])
            i += 2 + n
        elif lines[i] == "$Elements":
            n = int(lines[i + 1])
            for j in range(n):
                parts = [int(x) for x in lines[i + 2 + j].split()]
                etype, ntags = parts[1], parts[2]
                verts = parts[3 + ntags:]
                if etype == 2:
                    tris.append(verts)
                elif etype == 4:
                    tets.append(verts)
            i += 2 + n
        else:
            i += 1
    if not ids:
        raise ValueError(f"no $Nodes section in {path}")
    id_map = {nid: k for k, nid in enumerate(ids)}
    pts = np.asarray(coords, np.float64)
    if tets:
        cells = np.asarray([[id_map[v] for v in c] for c in tets], np.int32)
        return SimplexGrid.from_cells(pts, cells, reorder=reorder)
    if tris:
        cells = np.asarray([[id_map[v] for v in c] for c in tris], np.int32)
        return SimplexGrid.from_cells(pts[:, :2], cells, reorder=reorder)
    raise ValueError(f"no triangles/tetrahedra in {path}")


@dataclasses.dataclass
class FootTables:
    """Gather tables for one (axis, wave, direction):

    - ``ids``     [N, K] int32 node indices (self-index where the foot is
                  outside the hull); K = dim+1 at order 1
    - ``weights`` [N, K] float64 interpolation weights (0 where outside)
    - ``outside`` [N] bool: the foot left the hull (incoming invariant)
    """

    ids: np.ndarray
    weights: np.ndarray
    outside: np.ndarray


def _monomial_multi_indices(dim: int, degree: int):
    """All exponent tuples alpha with |alpha| <= degree, constant first."""
    out = [(0,) * dim]
    for total in range(1, degree + 1):
        def gen(prefix, rem, axes_left):
            if axes_left == 1:
                out.append(prefix + (rem,))
                return
            for e in range(rem + 1):
                gen(prefix + (e,), rem - e, axes_left - 1)
        gen((), total, dim)
    return out


def _mls_quadratic_weights(points: np.ndarray, feet: np.ndarray,
                           nbr_idx: np.ndarray, ridge: float = 1e-10,
                           degree: int = 2,
                           gamma: float = 0.0) -> np.ndarray:
    """Least-squares polynomial reconstruction weights, vectorized:
    ``w = Om A (A^T Om A + ridge I)^{-1} e_0`` with A the scaled monomial
    matrix (total degree <= ``degree``) of each foot's K neighbours and Om
    optional Gaussian distance weights (``gamma > 0``)."""
    rel = points[nbr_idx] - feet[:, None, :]          # [N, K, dim]
    scale = np.maximum(np.linalg.norm(rel, axis=2).mean(axis=1), 1e-300)
    rel = rel / scale[:, None, None]
    dim = rel.shape[2]
    cols = []
    for alpha in _monomial_multi_indices(dim, degree):
        c = np.ones(rel.shape[:2])
        for a, e in enumerate(alpha):
            if e:
                c = c * rel[:, :, a] ** e
        cols.append(c)
    A = np.stack(cols, axis=2)                        # [N, K, M]
    M = A.shape[2]
    if gamma > 0.0:
        r2 = (rel ** 2).sum(2)
        om = np.exp(-gamma * r2
                    / np.maximum(r2.mean(1, keepdims=True), 1e-300))
    else:
        om = np.ones(rel.shape[:2])
    G = np.einsum("nk,nkm,nkl->nml", om, A, A) + ridge * np.eye(M)
    e0 = np.zeros((len(A), M, 1))
    e0[:, 0, 0] = 1.0
    try:
        X = np.linalg.solve(G, e0)[..., 0]            # [N, M]
    except np.linalg.LinAlgError:
        # np.linalg.lstsq is 2-D only: degrade row by row
        X = np.empty((len(G), M))
        for i in range(len(G)):
            X[i] = np.linalg.lstsq(G[i].astype(np.float64),
                                   e0[i], rcond=None)[0][:, 0]
    return om * np.einsum("nkm,nm->nk", A, X)


def _locate_feet(grid: SimplexGrid, locate, cells_arr, c: np.ndarray,
                 axis: int, direction: int, dt: float,
                 order: int = 1) -> FootTables:
    """Locate and weight the feet ``x + direction*c*dt*e_axis``.

    ``order>=2`` upgrades interior feet to K-point least-squares tables
    (:func:`_mls_quadratic_weights`); rows whose neighbourhood fails the
    order conditions keep the barycentric weights (padded to K columns),
    and border feet behave as at order 1.
    """
    N, dim = grid.npoints, grid.dim
    self_ids = np.arange(N, dtype=np.int32)
    feet = grid.points.copy()
    feet[:, axis] += direction * c * dt
    cells, weights = locate(feet)
    outside = cells < 0
    cc = np.where(outside, 0, cells)
    verts = cells_arr[cc]                            # [N, dim+1]
    # sliver cells can give weights slightly outside [0, 1] or non-finite
    # transforms: clamp and renormalize, so every interpolation is a convex
    # combination
    weights = np.where(np.isfinite(weights), weights, 0.0)
    weights = np.clip(weights, 0.0, 1.0)
    wsum = weights.sum(axis=1, keepdims=True)
    degenerate = wsum[:, 0] <= 1e-12
    if degenerate.any():
        # fall back to the cell vertex nearest to the foot
        dcell = np.linalg.norm(
            grid.points[verts] - feet[:, None, :], axis=2)
        nearest = np.argmin(dcell, axis=1)
        onehot = np.eye(dim + 1)[nearest]
        weights = np.where(degenerate[:, None], onehot, weights)
        wsum = weights.sum(axis=1, keepdims=True)
    weights = weights / wsum
    ids = np.where(outside[:, None], self_ids[:, None], verts)
    weights = np.where(outside[:, None], 0.0, weights)

    if order >= 2:
        from scipy.spatial import cKDTree

        degree = min(order, 3)
        K = {2: (10, 16), 3: (16, 40)}[degree][dim - 2]
        K = min(K, N)
        _, nbr = cKDTree(grid.points).query(feet, k=K)
        if K == 1:
            nbr = nbr[:, None]
        w2 = _mls_quadratic_weights(
            grid.points, feet, nbr, degree=degree,
            gamma=2.0 if degree >= 3 else 0.0)
        # order conditions (scaled coords are O(1)): sum w = 1, and every
        # moment about the foot up to ``degree`` vanishes, else fall back
        rel = grid.points[nbr] - feet[:, None, :]
        sc = np.maximum(np.linalg.norm(rel, axis=2).mean(axis=1), 1e-300)
        rel = rel / sc[:, None, None]
        ok = np.ones(len(w2), dtype=bool)
        for alpha in _monomial_multi_indices(dim, degree):
            mono = np.ones(rel.shape[:2])
            for a, e in enumerate(alpha):
                if e:
                    mono = mono * rel[:, :, a] ** e
            target = 1.0 if sum(alpha) == 0 else 0.0
            ok &= np.abs((w2 * mono).sum(1) - target) < 1e-6
        use2 = ok & ~outside
        pad_ids = np.concatenate(
            [ids, np.repeat(self_ids[:, None], K - ids.shape[1], axis=1)],
            axis=1)
        w_pad = np.pad(weights, ((0, 0), (0, K - weights.shape[1])))
        ids = np.where(use2[:, None], nbr, pad_ids)
        weights = np.where(use2[:, None], w2, w_pad)

    return FootTables(
        ids=ids.astype(np.int32),
        # float64: the pair transform multiplies weights by the impedance
        # (~1e6-1e7), amplifying rounding; the sweeps cast at use
        weights=weights,
        outside=outside,
    )


def _walk_context(grid: SimplexGrid):
    """Point-location closure for the grid: (locate(feet), cells_arr).
    Delaunay grids walk from each node's own incident cell; explicit
    complexes use the incidence-candidate locator."""
    tri = grid.delaunay
    if tri is not None:
        starts = tri.vertex_to_simplex.astype(np.int32)
        return (lambda feet: walk_locate(tri, feet, starts)[:2],
                tri.simplices)
    if grid._locator is None:
        grid._locator = _ComplexLocator.build(grid.points, grid.cells)
    return grid._locator.locate, grid.cells


def build_foot_tables(
    grid: SimplexGrid,
    speeds: Dict[str, np.ndarray],     # wave -> per-node speed [N]
    dt: float,
    waves: Sequence[str] = ("p", "s"),
    order: int = 1,
) -> Dict[Tuple[int, str, int], FootTables]:
    """Tables for every (axis, wave, direction) with a positive speed:
    foot = x + direction * c * dt * e_axis. The invariant riding speed -c
    has its foot at direction +1, speed +c at direction -1."""
    locate, cells_arr = _walk_context(grid)
    out: Dict[Tuple[int, str, int], FootTables] = {}
    for a in range(grid.dim):
        for w in waves:
            if w not in speeds:
                continue
            c = np.asarray(speeds[w], np.float64)
            if not np.any(c > 0):
                continue
            for direction in (+1, -1):
                out[(a, w, direction)] = _locate_feet(
                    grid, locate, cells_arr, c, a, direction, dt, order)
    return out


def build_foot_tables_for_model(
    grid: SimplexGrid, model, mat, dt: float, order: int = 1
) -> Dict[Tuple[int, int, int], FootTables]:
    """Per-pair tables keyed ``(axis, pair_index, direction)``, speeds from
    the material's ``axis_view`` (numpy or torch fields)."""
    locate, cells_arr = _walk_context(grid)
    out: Dict[Tuple[int, int, int], FootTables] = {}
    for a in range(grid.dim):
        view = mat.axis_view(a, model.stage(a))
        for k, c in enumerate(view.pair_c):
            c = np.asarray(c.cpu() if hasattr(c, "cpu") else c, np.float64)
            if not np.any(c > 0):
                continue
            for direction in (+1, -1):
                out[(a, k, direction)] = _locate_feet(
                    grid, locate, cells_arr, c, a, direction, dt, order)
    return out
