// The fused 2D step on one shard of a grid split along x (CUDA C++,
// sm_90a), as two launches: the interior x-tiles and the ring x-tiles, on a
// float or bf16 material stack.
//
// Replaces the Pallas TPU kernel gcm_tpu/parallel/fused_spmd.py::
// _make_2d_spmd_call (which="interior" and "ring", built by _pallas_build).
// Its plain PyTorch version is gcm_tpu_torch/ops/fused_spmd.py::
// fused_spmd_2d_reference, which it must match. The step is the
// single-card 2D kernel's (gcm_common.cuh::step_tile_n, two sweeps), with
// the window and materials from the shard's own sources.
//
// What bounds it on an H100: memory, as fused_step_2d. Per point of the
// shard elastic2d reads 5 state components and 4 material fields and writes
// 5 components, about 56 bytes against 3.35 TB/s; the ring launch adds its
// two r-row x slabs (C * 2r * ny floats) and the halo rows of the material
// stack. An orthotropic stack has 6 fields instead of 4 (64 bytes a point).
//
// What the design does about it:
// - The shard's block (nxl, ny) is cut into TX2 x TY2 tiles; y, the
//   contiguous axis, is never split and clamps at the domain faces, where
//   its borders always apply. The interior x-tiles [ix0, ix1) are those
//   whose r-haloed window lies inside the block; they read only the local
//   block and the materials. The ring launch covers the other x-tiles (the
//   first, and the last one or two), reading the received slabs xlo/xhi
//   (C, r, ny) beyond the block through SlabSrc, and writes into the
//   interior launch's output buffer.
// - Materials come from the shard's x-extended stack (nm, nxl+2r, ny),
//   stored as float or bf16 and upcast at the load (ExtMat<T>); a bf16
//   stack cuts a point's bytes from 56 to 48.
//   The TPU's 8-row slab depth (H2) and its nxl % 8 rule are gone: r rows,
//   any extents.
// - x borders apply only on the ring's first or last row, where the shard
//   sits on that domain face; the binding folds the face flags into each
//   launch's border kinds. The 2D step folds no correctors, as in JAX.

#include "gcm_common.cuh"

namespace {

constexpr int TX2 = 32, TY2 = 64;
constexpr int NTHREADS2 = 256;

template <int ORDER, bool RING, class MatT>
__global__ void __launch_bounds__(NTHREADS2)
fused_spmd_2d_kernel(const float* __restrict__ u,
                     const MatT* __restrict__ mext, float* __restrict__ out,
                     const float* __restrict__ xlo,
                     const float* __restrict__ xhi, int ix0, int ix1,
                     GcmFusedParams p) {
    extern __shared__ float smem[];
    constexpr int R = Stencil<ORDER>::R;
    const int k = blockIdx.y;
    const int ix = RING ? (k < ix0 ? k : ix1 + (k - ix0)) : ix0 + k;
    const int T[3] = {TX2, TY2, 1};
    const int t0[3] = {ix * TX2, (int)blockIdx.x * TY2, 0};
    const int n0 = p.n[0], n1 = p.n[1];
    const long long N = (long long)n0 * n1;
    const ExtMat<MatT> mat{mext, n0, n1, 1, R, 0,
                           (long long)(n0 + 2 * R) * n1};
    if constexpr (RING) {
        const SlabSrc src{u, xlo, xhi, nullptr, nullptr, n0, n1, 1, R, N};
        step_tile_n<ORDER, 1, 2>(p, t0, T, src, mat, smem, out, nullptr,
                                 nullptr);
    } else {
        const GlobalSrc src{u, n0, n1, 1, N};
        step_tile_n<ORDER, 1, 2>(p, t0, T, src, mat, smem, out, nullptr,
                                 nullptr);
    }
}

template <int ORDER, bool RING, class MatT>
cudaError_t launch_spmd_2d(const float* u, const void* mext, float* out,
                           const float* xlo, const float* xhi, int ix0,
                           int ix1, const GcmFusedParams& p,
                           cudaStream_t stream) {
    const int T[3] = {TX2, TY2, 1};
    const size_t smem = step_smem_bytes(p, T, Stencil<ORDER>::R, 2);
    cudaError_t err = cudaFuncSetAttribute(
        fused_spmd_2d_kernel<ORDER, RING, MatT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int ntx = (p.n[0] + TX2 - 1) / TX2;
    const int ntiles = RING ? ntx - (ix1 - ix0) : ix1 - ix0;
    if (ntiles <= 0) return cudaSuccess;
    const dim3 grid((p.n[1] + TY2 - 1) / TY2, ntiles);
    fused_spmd_2d_kernel<ORDER, RING, MatT>
        <<<grid, NTHREADS2, smem, stream>>>(u, (const MatT*)mext, out, xlo,
                                            xhi, ix0, ix1, p);
    return cudaGetLastError();
}

template <bool RING, class MatT>
int dispatch_2d(int order, const float* u, const void* mext, float* out,
                const float* xlo, const float* xhi, int ix0, int ix1,
                const GcmFusedParams& p, cudaStream_t s) {
    switch (order) {
        case 1: return (int)launch_spmd_2d<1, RING, MatT>(
                    u, mext, out, xlo, xhi, ix0, ix1, p, s);
        case 2: return (int)launch_spmd_2d<2, RING, MatT>(
                    u, mext, out, xlo, xhi, ix0, ix1, p, s);
        case 3: return (int)launch_spmd_2d<3, RING, MatT>(
                    u, mext, out, xlo, xhi, ix0, ix1, p, s);
        case 4: return (int)launch_spmd_2d<4, RING, MatT>(
                    u, mext, out, xlo, xhi, ix0, ix1, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Launches the interior (ring = 0) or the ring (ring = 1) x-tiles of one
// shard's fused 2D step, params->n = {nxl, ny, 1}. `mext` is the shard's
// x-extended stack (nm, nxl+2r, ny); the slabs xlo/xhi (C, r, ny) are read
// by the ring launch only. The interior tiles are [ix0, ix1). The stack is
// bf16 when `mat_bf16` is set, float otherwise. Returns the CUDA error code
// of the launch (0 on success).
int gcm_fused_spmd_2d(const float* u, const void* mext, float* out,
                      const float* xlo, const float* xhi, int ix0, int ix1,
                      int ring, const GcmFusedParams* params, int order,
                      int mat_bf16, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const GcmFusedParams& p = *params;
    if (ring && mat_bf16)
        return dispatch_2d<true, __nv_bfloat16>(order, u, mext, out, xlo,
                                                xhi, ix0, ix1, p, s);
    if (ring)
        return dispatch_2d<true, float>(order, u, mext, out, xlo, xhi, ix0,
                                        ix1, p, s);
    if (mat_bf16)
        return dispatch_2d<false, __nv_bfloat16>(order, u, mext, out, xlo,
                                                 xhi, ix0, ix1, p, s);
    return dispatch_2d<false, float>(order, u, mext, out, xlo, xhi, ix0, ix1,
                                     p, s);
}

// The output x-tile's extent.
int gcm_fused_spmd_2d_tile(void) { return TX2; }

}  // extern "C"
