"""The SPMD tilings of the port (3D: one x plane by 8 y rows; 2D: one x
row), on the CPU.

The 3D interior and ring kernels walk x plane by plane, so their tile is
``ops.fused_spmd.TILE_3D`` = (1, 8): the interior is every plane r or more
from the shard's x faces, times the 8-row y tiles whose r-halo lies inside
the block. The 2D kernel walks x row by row, so its tile is ``TILE_2D`` =
1: the interior is the rows [r, nxl - r), the ring the r rows at each x
face. These tests hold ``tile_split``/``split_3d``/``interior_mask`` to
those definitions on ragged and thin shards, check that the interior and
ring launches' plain versions together equal the plain fused step of the
whole domain (float64, 1e-12 normalized, every sweep order), and that the
binding refuses a component map other than the one compiled into the
kernels (with a stand-in library, since the CPU has none).
"""

import ctypes

import pytest
import torch

from gcm_tpu_torch.models.spec import get_model
from gcm_tpu_torch.ops import fused as ofu
from gcm_tpu_torch.ops import fused_spmd as ofs
from gcm_tpu_torch.ops.fused import fused_step_reference, stack_mats
from gcm_tpu_torch.parallel import fused_spmd as pfs
from gcm_tpu_torch.parallel.sharding import gather_state, shard_state
from test_torch_sharded import BORDERS, _borders, _mesh, _problem
from test_torch_step import norm_err

#: shard extents (nxl, nyl): ragged against the 8-row tile, thinner than
#: a tile, thinner than the halo
SHARDS = [(128, 128), (35, 19), (24, 20), (3, 8), (4, 18), (2, 2), (1, 9),
          (70, 7)]


def _fits(i, n, tile, r):
    return i * tile - r >= 0 and (i + 1) * tile + r <= n


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("shard", SHARDS, ids=str)
def test_split_3d_partitions_the_shard(shard, r):
    """Interior cells are exactly the whole tiles of the (1, 8) grid whose
    r-haloed window lies inside the block along x and along y (and none
    unless both have some); the ring is every other cell."""
    nxl, nyl = shard
    assert ofs.TILE_3D == (1, 8)
    ntx, nty, ix0, ix1, iy0, iy1 = ofs.split_3d(nxl, nyl, r)
    assert (ntx, nty) == (nxl, -(-nyl // 8))
    xs = [i for i in range(ntx) if _fits(i, nxl, 1, r)]
    ys = [j for j in range(nty) if _fits(j, nyl, 8, r)]
    if xs and ys:
        assert (ix0, ix1, iy0, iy1) == (xs[0], xs[-1] + 1, ys[0], ys[-1] + 1)
        assert xs == list(range(r, nxl - r))
    else:
        assert (ix0, ix1, iy0, iy1) == (0, 0, 0, 0)
    mask = ofs.interior_mask((nxl, nyl, 5), r)
    want = torch.zeros(nxl, nyl, dtype=torch.bool)
    for i in xs if ys else ():
        for j in ys:
            want[i, j * 8:(j + 1) * 8] = True
    assert torch.equal(mask, want)
    # every interior cell's r-haloed x/y window lies inside the block
    x, y = torch.nonzero(mask, as_tuple=True)
    assert bool(((x >= r) & (x + r < nxl) & (y >= r) & (y + r < nyl)).all())


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("nxl", [512, 128, 35, 6, 5, 4, 3, 2, 1])
def test_split_2d_is_the_rows_away_from_the_faces(nxl, r):
    """With TILE_2D = 1 the interior is exactly the rows [r, nxl - r)
    (none when nxl <= 2r) and the ring every other row: 2r of a 512-row
    shard, under 1%."""
    assert ofs.TILE_2D == 1
    nt, i0, i1 = ofs.tile_split(nxl, ofs.TILE_2D, r)
    assert nt == nxl
    assert (i0, i1) == ((r, nxl - r) if nxl > 2 * r else (0, 0))
    mask = ofs.interior_mask((nxl, 7), r, (ofs.TILE_2D,))
    want = torch.zeros(nxl, dtype=torch.bool)
    want[r:nxl - r] = nxl > 2 * r
    assert torch.equal(mask, want)
    if nxl == 512:
        assert int((~mask).sum()) == 2 * r


def test_ring_is_thinner_than_the_box_tiles():
    """On a 128^2 shard at r = 1 the ring holds 2272 of 16384 cells a z
    column (13.9%), against 3840 (23.4%) with the earlier 8x8 box tiles."""
    ring = int((~ofs.interior_mask((128, 128), 1)).sum())
    boxes = int((~ofs.interior_mask((128, 128), 1, (8, 8))).sum())
    assert (ring, boxes) == (128 * 128 - 126 * 112, 128 * 128 - 112 * 112)


# (global shape, mesh shape, order, axes): ragged and thin shards, interior
# and ring-only splits, x first, in the middle and last in the sweep order;
# in 2D (one mesh axis) both sweep orders at orders 1-4 on shards with an
# interior, and on shards too thin for one (nxl <= 2r)
CASES = [((70, 38, 45), (2, 2), 2, (0, 1, 2)),
         ((70, 38, 45), (2, 2), 3, (2, 0, 1)),
         ((96, 20, 16), (4, 1), 1, (1, 0, 2)),
         ((8, 36, 9), (2, 2), 1, (2, 1, 0)),
         ((8, 36, 9), (2, 2), 4, (1, 2, 0)),
         ((6, 16, 5), (2, 2), 2, (0, 2, 1)),
         ((4, 4, 5), (2, 2), 1, (2, 0, 1)),
         ((24, 17, 6), (1, 1), 2, (1, 0, 2)),
         ((64, 20), (4,), 1, (0, 1)),
         ((70, 13), (2,), 2, (1, 0)),
         ((20, 9), (4,), 3, (0, 1)),
         ((40, 6), (8,), 4, (1, 0)),
         ((8, 11), (4,), 1, (1, 0)),
         ((12, 7), (4,), 2, (0, 1)),
         ((16, 5), (4,), 3, (1, 0)),
         ((30, 3), (2,), 4, (0, 1))]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_interior_and_ring_references_make_the_step(rng, case):
    """Each shard's interior plain version (into a NaN buffer) and then its
    ring plain version fill every cell once and together equal the plain
    fused step of the whole domain, float64."""
    shape, mshape, order, axes = case
    dim = len(shape)
    model, u, mat, dt = _problem(rng, f"elastic{dim}d", shape)
    h = (1.0, 1.1, 0.9)[:dim]
    mesh = _mesh(dim, mshape)
    r = ofs.stencil_radius(order)
    mext = pfs.extended_mstack(model, mat, mesh, order)
    us = shard_state(u, mesh)
    slabs = pfs.exchange_slabs(us, mesh, r, dim=dim)
    bc = BORDERS if dim == 3 else _borders(2)
    tile = ofs.TILE_3D if dim == 3 else (ofs.TILE_2D,)
    outs = []
    for k, uk in enumerate(us):
        args = (model, uk, mext[k], dt, h, order, bc, axes)
        nan = torch.full_like(uk, float("nan"))
        flags = pfs.face_flags(mesh, k)
        if dim == 3:
            got = ofs.fused_spmd_interior_reference(*args, out=nan)
        else:
            got = ofs.fused_spmd_2d_reference(*args, "interior", base=nan)
        inner = ofs.interior_mask(uk.shape[1:], r, tile)
        assert not torch.isnan(got[:, inner]).any()
        assert torch.isnan(got[:, ~inner]).all()
        if dim == 3:
            got = ofs.fused_spmd_ring_reference(
                model, uk, mext[k], slabs[k], flags, got, *args[3:])
        else:
            got = ofs.fused_spmd_2d_reference(*args, "ring", slabs[k],
                                              flags[:2], got)
        assert not torch.isnan(got).any()
        outs.append(got)
    want = fused_step_reference(model, u, stack_mats(model, mat), dt, h,
                                order, bc, axes)
    assert norm_err(gather_state(outs, mesh), want) < 1e-12


class _MapLib:
    """Stands in for the kernel library's ``gcm_model_map``: fills
    the map of a model, optionally with one stress index moved."""

    def __init__(self, name, moved=False):
        self.name, self.moved = name, moved

    def gcm_model_map(self, model_id, addr):
        if model_id not in ofu.STREAM_MODELS.values():
            return 1
        model = get_model(self.name)
        dim = model.dim
        src = ofu._params(model, (4,) * dim, len(ofu.mat_layout(model)), 1.0,
                          (1.0,) * dim, None, tuple(range(dim)), ())
        if self.moved:
            src.pair_sigma[1][0] += 1
        ctypes.memmove(addr, ctypes.addressof(src), ctypes.sizeof(src))
        return 0


#: each compiled model and the other one of its dimension
OTHER = {"elastic3d": "acoustic3d", "acoustic3d": "elastic3d",
         "elastic2d": "acoustic2d", "acoustic2d": "elastic2d"}


@pytest.mark.parametrize("name", sorted(OTHER))
def test_binding_holds_the_model_to_the_compiled_map(name):
    """The 3D and 2D streamed bodies: a library whose map of the model's
    id differs (a moved stress, the other model of the dimension) is
    refused, and a model compiled into none (1D) too."""
    model = get_model(name)
    dim = model.dim
    params = ofu._params(model, (8,) * dim, len(ofu.mat_layout(model)), 1.0,
                         (1.0,) * dim, None, tuple(range(dim))[::-1], ())
    assert params.model == ofu.STREAM_MODELS[name]
    # distinct live stand-ins: the check is remembered a model and library
    good, moved = _MapLib(name), _MapLib(name, moved=True)
    other = _MapLib(OTHER[name])
    ofu.check_compiled_map(good, model, "the fused kernels")
    for lib in (moved, other):
        with pytest.raises(RuntimeError, match="component map"):
            ofu.check_compiled_map(lib, model, "the fused kernels")
    elastic1d = get_model("elastic1d")
    p1 = ofu._params(elastic1d, (8,), len(ofu.mat_layout(elastic1d)), 1.0,
                     (1.0,), None, (0,), ())
    assert p1.model == -1
    with pytest.raises(ValueError, match="compiled for"):
        ofu.check_compiled_map(good, elastic1d, "the fused kernels")
