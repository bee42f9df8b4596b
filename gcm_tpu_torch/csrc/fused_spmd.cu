// The fused 3D step on one shard of a domain-decomposed grid (CUDA C++,
// sm_90a), as two launches: the interior tiles and the ring tiles.
//
// Replaces the Pallas TPU kernels gcm_tpu/parallel/fused_spmd.py::
// _make_interior_call and _make_ring_call (both built by _pallas_build). Their
// plain PyTorch versions are gcm_tpu_torch/ops/fused_spmd.py::
// fused_spmd_interior_reference and fused_spmd_ring_reference, which they
// must match. The step itself (three sweeps, border algebra, folded
// correctors) is the single-card kernel's (gcm_common.cuh::step_tile); only
// the sources of the window and the materials differ.
//
// What bounds it on an H100: memory, as fused_step. Per point of the shard
// and step it reads the 9 state components and 4 compact material fields and
// writes 9 components, about 88 bytes against 3.35 TB/s (96 with a damage
// corrector); the ring launch adds the halo slabs it reads, 2r rows of the
// shard's x and y faces (C * r * 2 (nyl + nxl + 2r) * nz floats), and the
// halo extension of the material stack. An orthotropic extended stack has
// 13 fields instead of 4 (124 bytes a point), read through the same
// per-pair and per-zero stack rows of the parameters.
//
// What the design does about it:
// - The shard's block is cut into TX x TY x TZ output tiles (the last ones
//   along each axis ragged). The interior tiles are those whose r-haloed
//   window lies inside the block; the binding passes their rectangle
//   [ix0, ix1) x [iy0, iy1) (ops/fused_spmd.py::tile_split). The interior
//   launch reads only the local block and the materials, so it can run while
//   the slabs travel; its x/y reads never reach the clamp.
// - The ring launch runs one block per ring tile (and z chunk); the block
//   finds its tile from its index in closed form (ring_tile, the rectangle
//   form of gcm_tpu's _ring_maps). Its first sweep reads through SlabSrc:
//   the local block inside, the received slabs outside; y slabs span the
//   x-extended range, so corner cells come from them. It writes into the
//   interior launch's output buffer: the tiles are disjoint.
// - Materials come from the shard's halo-extended stack (nm, nxl+2r,
//   nyl+2r, nz), built once at setup (ExtMat): no material exchange per step.
// - Border conditions: z borders apply on both launches; x/y borders only on
//   a ring tile row at the shard's first or last row, and only where the
//   shard sits on that domain face. The binding folds the face flags into
//   the border kinds of each shard's launch (a side with a neighbour gets
//   kind -1), so one kernel serves every shard.
// Speed work left for later: cp.async/TMA staging, tile tuning, one launch
// for all co-resident shards.

#include "gcm_common.cuh"

namespace {

constexpr int TX = 8, TY = 8, TZ = 16;
constexpr int NTHREADS = 256;

// The shard's tile grid (ntx x nty tiles) and its interior rectangle.
struct TileSplit {
    int ntx, nty, ix0, ix1, iy0, iy1;
};

struct Slabs {
    const float* xlo;
    const float* xhi;
    const float* ylo;
    const float* yhi;
};

// The k-th tile outside the interior rectangle, row by row: the rows before
// ix0 whole, then each interior row's tiles left and right of the
// rectangle, then the rows from ix1 on whole. An empty rectangle (all 0)
// makes every tile a ring tile.
__device__ inline void ring_tile(const TileSplit& t, int k, int* ix,
                                 int* iy) {
    const int top = t.ix0 * t.nty;
    if (k < top) {
        *ix = k / t.nty;
        *iy = k % t.nty;
        return;
    }
    k -= top;
    const int side = t.iy0 + (t.nty - t.iy1);
    const int mid = (t.ix1 - t.ix0) * side;
    if (k < mid) {
        *ix = t.ix0 + k / side;
        const int q = k % side;
        *iy = q < t.iy0 ? q : t.iy1 + (q - t.iy0);
        return;
    }
    k -= mid;
    *ix = t.ix1 + k / t.nty;
    *iy = k % t.nty;
}

template <int ORDER, bool RING>
__global__ void __launch_bounds__(NTHREADS)
fused_spmd_kernel(const float* __restrict__ u, const float* __restrict__ mext,
                  const float* __restrict__ aux_in, float* __restrict__ out,
                  float* __restrict__ aux_out, Slabs sl, TileSplit ts,
                  GcmFusedParams p) {
    extern __shared__ float smem[];
    constexpr int R = Stencil<ORDER>::R;
    int ix, iy;
    if constexpr (RING) {
        ring_tile(ts, blockIdx.y, &ix, &iy);
    } else {
        ix = ts.ix0 + blockIdx.z;
        iy = ts.iy0 + blockIdx.y;
    }
    const int T[3] = {TX, TY, TZ};
    const int t0[3] = {ix * TX, iy * TY, (int)blockIdx.x * TZ};
    const int n0 = p.n[0], n1 = p.n[1], n2 = p.n[2];
    const long long N = (long long)n0 * n1 * n2;
    const ExtMat<float> mat{mext, n0, n1, n2, R, R,
                            (long long)(n0 + 2 * R) * (n1 + 2 * R) * n2};
    if constexpr (RING) {
        const SlabSrc src{u, sl.xlo, sl.xhi, sl.ylo, sl.yhi,
                          n0, n1, n2, R, N};
        step_tile<ORDER>(p, 3, t0, T, src, mat, smem, out, aux_in, aux_out);
    } else {
        const GlobalSrc src{u, n0, n1, n2, N};
        step_tile<ORDER>(p, 3, t0, T, src, mat, smem, out, aux_in, aux_out);
    }
}

template <int ORDER, bool RING>
cudaError_t launch_spmd(const float* u, const float* mext,
                        const float* aux_in, float* out, float* aux_out,
                        const Slabs& sl, const TileSplit& ts,
                        const GcmFusedParams& p, cudaStream_t stream) {
    const int T[3] = {TX, TY, TZ};
    const size_t smem = step_smem_bytes(p, T, Stencil<ORDER>::R, 3);
    cudaError_t err = cudaFuncSetAttribute(
        fused_spmd_kernel<ORDER, RING>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int nz = (p.n[2] + TZ - 1) / TZ;
    const int interior = (ts.ix1 - ts.ix0) * (ts.iy1 - ts.iy0);
    dim3 grid;
    if (RING) grid = dim3(nz, ts.ntx * ts.nty - interior, 1);
    else grid = dim3(nz, ts.iy1 - ts.iy0, ts.ix1 - ts.ix0);
    if (grid.y == 0 || grid.z == 0) return cudaSuccess;
    fused_spmd_kernel<ORDER, RING><<<grid, NTHREADS, smem, stream>>>(
        u, mext, aux_in, out, aux_out, sl, ts, p);
    return cudaGetLastError();
}

template <bool RING>
int dispatch(int order, const float* u, const float* mext,
             const float* aux_in, float* out, float* aux_out,
             const Slabs& sl, const TileSplit& ts, const GcmFusedParams& p,
             cudaStream_t s) {
    switch (order) {
        case 1: return (int)launch_spmd<1, RING>(u, mext, aux_in, out,
                                                 aux_out, sl, ts, p, s);
        case 2: return (int)launch_spmd<2, RING>(u, mext, aux_in, out,
                                                 aux_out, sl, ts, p, s);
        case 3: return (int)launch_spmd<3, RING>(u, mext, aux_in, out,
                                                 aux_out, sl, ts, p, s);
        case 4: return (int)launch_spmd<4, RING>(u, mext, aux_in, out,
                                                 aux_out, sl, ts, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Launches the interior (ring = 0) or the ring (ring = 1) tiles of one
// shard's fused 3D step on `stream` of device `device`. `mext` is the
// shard's halo-extended stack (nm, nxl+2r, nyl+2r, nz); the slabs are read
// by the ring launch only (null for the interior one). `split` holds ntx,
// nty, ix0, ix1, iy0, iy1. Both launches write `out` (and `aux_out`), each
// its own tiles. Returns the CUDA error code of the launch (0 on success).
int gcm_fused_spmd(const float* u, const float* mext, const float* aux_in,
                   float* out, float* aux_out, const float* xlo,
                   const float* xhi, const float* ylo, const float* yhi,
                   const int* split, int ring, const GcmFusedParams* params,
                   int order, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Slabs sl{xlo, xhi, ylo, yhi};
    const TileSplit ts{split[0], split[1], split[2], split[3], split[4],
                       split[5]};
    cudaStream_t s = (cudaStream_t)stream;
    if (ring)
        return dispatch<true>(order, u, mext, aux_in, out, aux_out, sl, ts,
                              *params, s);
    return dispatch<false>(order, u, mext, aux_in, out, aux_out, sl, ts,
                           *params, s);
}

// The output tile's extent along x (axis 0) or y (axis 1).
int gcm_fused_spmd_tile(int axis) { return axis == 0 ? TX : TY; }

}  // extern "C"
