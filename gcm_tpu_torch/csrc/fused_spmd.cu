// The fused 3D step on one shard of a domain-decomposed grid (CUDA C++,
// sm_90a), as two launches: the interior tiles and the ring tiles.
//
// Replaces the Pallas TPU kernels gcm_tpu/parallel/fused_spmd.py::
// _make_interior_call and _make_ring_call (both built by _pallas_build). Their
// plain PyTorch versions are gcm_tpu_torch/ops/fused_spmd.py::
// fused_spmd_interior_reference and fused_spmd_ring_reference, which they
// must match. The step itself (three sweeps walking x plane by plane,
// border algebra, folded correctors) is the single-card kernel's, on the
// body its form compiles to (gcm_common.cuh: stream_step_owned for
// elastic3d at orders 1-2 on a compact stack, stream_step otherwise; see
// fused_step_slab.cu for what bounds each); only the sources of the
// planes and the materials differ.
//
// What bounds it on an H100: memory, as fused_step. Per point of the shard
// and step it reads the 9 state components and 4 compact material fields and
// writes 9 components, about 88 bytes against 3.35 TB/s (96 with a damage
// corrector); the ring launch adds the halo slabs it reads, 2r rows of the
// shard's x and y faces (C * r * 2 (nyl + nxl + 2r) * nz floats), and the
// halo extension of the material stack. An orthotropic extended stack has
// 13 fields instead of 4 (124 bytes a point), read through the same
// per-pair and per-zero stack rows of the parameters. On top of the bound:
// the (y, z) halo each tile recomputes, the 2r planes each x chunk
// recomputes, and, in the ring launch, the branches of the slab reads.
//
// What the design does about it:
// - A tile is one x plane by 8 y rows (TILE_3D = (1, 8) of ops/
//   fused_spmd.py; gcm_fused_spmd_tile) by 32 z: the interior is every
//   plane r or more from the shard's x faces, times the y tiles whose r-halo
//   lies inside the block (ops/fused_spmd.py::tile_split; the binding passes
//   the rectangle [ix0, ix1) x [iy0, iy1)). A block walks a chunk of the
//   interior's x range through the one-step body, so the ring is r
//   planes thick along x and one 8-row tile along y: ~14% of a 128^2
//   shard's cells at r = 1 (8x8 box tiles would make it ~23%). The
//   interior launch reads only the local block (staged with cp.async)
//   and the materials, so it runs while the slabs travel; its x/y reads
//   never reach the clamp.
// - The ring launch walks three bands of x: the planes before ix0 and from
//   ix1 on, all y tiles, and the planes between, the y tiles outside
//   [iy0, iy1); a block finds its band, chunk and y tile from its index in
//   closed form (ring_block). Its planes come through SlabSrc, staged with
//   cp.async from the local block inside and the received slabs outside;
//   y slabs span the x-extended range, so corner cells come from them. It
//   writes into the interior launch's output buffer: the tiles are
//   disjoint. Its chunks are cut for the middle band beside the two r-plane
//   bands' blocks (stream_chunk).
// - Materials come from the shard's halo-extended stack (nm, nxl+2r,
//   nyl+2r, nz), built once at setup (ExtMat): no material exchange per step.
// - Border conditions: z borders apply on both launches; x/y borders only on
//   a ring row at the shard's first or last row, and only where the shard
//   sits on that domain face. The binding folds the face flags into the
//   border kinds of each shard's launch (a side with a neighbour gets kind
//   -1), so one kernel serves every shard.
// Speed work left for later: one launch for all co-resident shards.

#include "gcm_common.cuh"

namespace {

// The shard's tile grid (ntx x nty tiles: ntx planes, nty 8-row tiles) and
// its interior rectangle (all 0 when empty).
struct TileSplit {
    int ntx, nty, ix0, ix1, iy0, iy1;
};

struct Slabs {
    const float* xlo;
    const float* xhi;
    const float* ylo;
    const float* yhi;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Blocks of the ring launch with x chunks of ch planes: the band of planes
// before ix0 (all y tiles), the band between ix0 and ix1 (the y tiles left
// and right of the rectangle) and the band from ix1 on (all y tiles). An
// empty rectangle makes the last band the whole block.
__host__ __device__ inline int ring_blocks(const TileSplit& t, int ch) {
    const int side = t.iy0 + (t.nty - t.iy1);
    return cdiv(t.ix0, ch) * t.nty + cdiv(t.ix1 - t.ix0, ch) * side +
           cdiv(t.ntx - t.ix1, ch) * t.nty;
}

// The k-th block of the ring launch: its planes [xa, xb) and y tile iy.
__device__ inline void ring_block(const TileSplit& t, int ch, int k, int* xa,
                                  int* xb, int* iy) {
    const int top = cdiv(t.ix0, ch) * t.nty;
    if (k < top) {
        *xa = (k / t.nty) * ch;
        *xb = min(*xa + ch, t.ix0);
        *iy = k % t.nty;
        return;
    }
    k -= top;
    const int side = t.iy0 + (t.nty - t.iy1);
    const int mid = cdiv(t.ix1 - t.ix0, ch) * side;
    if (k < mid) {
        *xa = t.ix0 + (k / side) * ch;
        *xb = min(*xa + ch, t.ix1);
        const int q = k % side;
        *iy = q < t.iy0 ? q : t.iy1 + (q - t.iy0);
        return;
    }
    k -= mid;
    *xa = t.ix1 + (k / t.nty) * ch;
    *xb = min(*xa + ch, t.ntx);
    *iy = k % t.nty;
}

template <int ORDER, class M, bool RING, class AX, bool OWNED>
__global__ void __launch_bounds__(STREAM_NT,
                                  StreamBody<ORDER, M, AX, OWNED>::MINB)
fused_spmd_kernel(const float* __restrict__ u, const float* __restrict__ mext,
                  const float* __restrict__ aux_in, float* __restrict__ out,
                  float* __restrict__ aux_out, Slabs sl, TileSplit ts,
                  int ch, GcmFusedParams p) {
    extern __shared__ float smem[];
    constexpr int R = Stencil<ORDER>::R;
    int xa, xb, iy;
    if constexpr (RING) {
        ring_block(ts, ch, blockIdx.y, &xa, &xb, &iy);
    } else {
        xa = ts.ix0 + (int)blockIdx.z * ch;
        xb = min(xa + ch, ts.ix1);
        iy = ts.iy0 + blockIdx.y;
    }
    const int n0 = p.n[0], n1 = p.n[1], n2 = p.n[2];
    const long long N = (long long)n0 * n1 * n2;
    const ExtMat<float> mat{mext, n0, n1, n2, R, R,
                            (long long)(n0 + 2 * R) * (n1 + 2 * R) * n2};
    const StepOut so{out, aux_in, aux_out, N};
    const int y0 = iy * STREAM_TY, z0 = (int)blockIdx.x * STREAM_TZ;
    const auto body = [&](const auto& src) {
        if constexpr (OWNED)
            stream_step_owned<ORDER, M, AX>(p, src, mat, xa, xb, y0, z0,
                                            smem, so);
        else
            stream_step<ORDER, M, AX>(p, src, mat, xa, xb, y0, z0, smem, so);
    };
    if constexpr (RING)
        body(SlabSrc{u, sl.xlo, sl.xhi, sl.ylo, sl.yhi, n0, n1, n2, R, N});
    else
        body(GlobalSrc{u, n0, n1, n2, N});
}

// Launches one of the two launches (occ == nullptr), or reports the
// occupancy it gets.
template <int ORDER, class M, bool RING, class AX, bool OWNED>
cudaError_t launch_body(const float* u, const float* mext,
                        const float* aux_in, float* out, float* aux_out,
                        const Slabs& sl, const TileSplit& ts,
                        const GcmFusedParams& p, int device,
                        cudaStream_t stream, StreamOccupancy* occ) {
    using L = StreamBody<ORDER, M, AX, OWNED>;
    const auto kernel = fused_spmd_kernel<ORDER, M, RING, AX, OWNED>;
    int bps = 0;
    cudaError_t err = stream_blocks_per_sm(kernel, L::BYTES, &bps);
    if (err != cudaSuccess) return err;
    if (occ != nullptr) {
        *occ = StreamOccupancy{bps, L::BYTES};
        return cudaSuccess;
    }
    const int nzt = cdiv(p.n[2], STREAM_TZ);
    dim3 grid;
    if (RING) {
        // chunks cut for the long middle band beside the two r-plane bands
        // (the whole block when the rectangle is empty)
        const bool empty = ts.ix1 == 0;
        const int side = ts.iy0 + (ts.nty - ts.iy1);
        const int ch = stream_chunk(
            empty ? ts.ntx : ts.ix1 - ts.ix0,
            (long long)(empty ? ts.nty : side) * nzt, Stencil<ORDER>::R, bps,
            device, empty ? 0 : 2LL * ts.nty * nzt);
        grid = dim3(nzt, ring_blocks(ts, ch), 1);
        if (grid.y == 0) return cudaSuccess;
        kernel<<<grid, STREAM_NT, L::BYTES, stream>>>(
            u, mext, aux_in, out, aux_out, sl, ts, ch, p);
    } else {
        const int len = ts.ix1 - ts.ix0, nyt = ts.iy1 - ts.iy0;
        if (len <= 0 || nyt <= 0) return cudaSuccess;
        const int ch = stream_chunk(len, (long long)nyt * nzt,
                                    Stencil<ORDER>::R, bps, device);
        grid = dim3(nzt, nyt, cdiv(len, ch));
        kernel<<<grid, STREAM_NT, L::BYTES, stream>>>(
            u, mext, aux_in, out, aux_out, sl, ts, ch, p);
    }
    return cudaGetLastError();
}

// One of the two launches on the body its form compiles to (stream_body).
template <int ORDER, class M, bool RING, class AX>
cudaError_t launch_spmd(const float* u, const float* mext,
                        const float* aux_in, float* out, float* aux_out,
                        const Slabs& sl, const TileSplit& ts,
                        const GcmFusedParams& p, int device,
                        cudaStream_t stream, StreamOccupancy* occ) {
    if constexpr (owned_form<ORDER, M>()) {
        if (compact_rows(p))
            return launch_body<ORDER, M, RING, AX, true>(
                u, mext, aux_in, out, aux_out, sl, ts, p, device, stream,
                occ);
    }
    return launch_body<ORDER, M, RING, AX, false>(
        u, mext, aux_in, out, aux_out, sl, ts, p, device, stream, occ);
}

template <bool RING>
cudaError_t dispatch(int order, const float* u, const float* mext,
                     const float* aux_in, float* out, float* aux_out,
                     const Slabs& sl, const TileSplit& ts,
                     const GcmFusedParams& p, int device, cudaStream_t s,
                     StreamOccupancy* occ) {
    if ((long long)(p.n[1] + 4) * p.n[2] >= (1LL << 31))
        return cudaErrorInvalidValue;
    return with_stencil(order, [&](auto o) {
        return with_model(p.model, [&](auto mdl) {
            return with_axes(p.axes, [&](auto ax) {
                return launch_spmd<decltype(o)::value, decltype(mdl), RING,
                                   decltype(ax)>(u, mext, aux_in, out,
                                                 aux_out, sl, ts, p, device,
                                                 s, occ);
            });
        });
    });
}

}  // namespace

extern "C" {

// Launches the interior (ring = 0) or the ring (ring = 1) tiles of one
// shard's fused 3D step on `stream` of device `device`. `mext` is the
// shard's halo-extended stack (nm, nxl+2r, nyl+2r, nz); the slabs are read
// by the ring launch only (null for the interior one). `split` holds ntx,
// nty, ix0, ix1, iy0, iy1 (ops/fused_spmd.py::split_3d). Both launches
// write `out` (and `aux_out`), each its own tiles. Returns the CUDA error
// code of the launch (0 on success).
int gcm_fused_spmd(const float* u, const float* mext, const float* aux_in,
                   float* out, float* aux_out, const float* xlo,
                   const float* xhi, const float* ylo, const float* yhi,
                   const int* split, int ring, const GcmFusedParams* params,
                   int order, int device, void* stream) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    const Slabs sl{xlo, xhi, ylo, yhi};
    const TileSplit ts{split[0], split[1], split[2], split[3], split[4],
                       split[5]};
    cudaStream_t s = (cudaStream_t)stream;
    if (ring)
        return (int)dispatch<true>(order, u, mext, aux_in, out, aux_out, sl,
                                   ts, *params, device, s, nullptr);
    return (int)dispatch<false>(order, u, mext, aux_in, out, aux_out, sl, ts,
                                *params, device, s, nullptr);
}

// The occupancy the interior (ring = 0) or ring (ring = 1) launch with
// these parameters gets: out[0] resident blocks an SM, out[1] its dynamic
// shared memory in bytes.
int gcm_fused_spmd_occupancy(const GcmFusedParams* params, int order,
                             int ring, int device, int* out) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    const Slabs sl{nullptr, nullptr, nullptr, nullptr};
    const TileSplit ts{0, 0, 0, 0, 0, 0};
    StreamOccupancy occ{0, 0};
    err = ring ? dispatch<true>(order, nullptr, nullptr, nullptr, nullptr,
                                nullptr, sl, ts, *params, device, nullptr,
                                &occ)
               : dispatch<false>(order, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, sl, ts, *params, device, nullptr,
                                 &occ);
    out[0] = occ.blocks_per_sm;
    out[1] = occ.smem_bytes;
    return (int)err;
}

// The output tile's extent along x (axis 0: one plane) or y (axis 1).
int gcm_fused_spmd_tile(int axis) { return axis == 0 ? 1 : STREAM_TY; }

}  // extern "C"
