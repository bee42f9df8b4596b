// One whole 2D grid-characteristic time step in one kernel (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel gcm_tpu/ops/pallas_fused.py::fused_step_2d
// (body _make_2d_kernel, folded correctors _corrector_epilogue). Its plain
// PyTorch version is gcm_tpu_torch/ops/fused.py::fused_step_2d_reference
// (= solver.gcm.step on materials derived from the compact stack, then the
// plain corrector epilogue), which it must match. The sweep, the border
// algebra and the epilogue are the 3D kernel's (gcm_common.cuh), run on a
// grid of extent 1 along z.
//
// What bounds it on an H100: memory. Per grid point and step elastic2d
// reads 5 state components and 4 compact material fields (cp, cs, rho,
// kappa) and writes 5 components: 36 bytes in, 20 bytes out, 56 bytes
// against 3.35 TB/s, ~60 Gpoints/s at the roofline (a damage corrector
// adds 4 bytes in and 4 out). Two sweeps of interpolation and pair algebra
// are far below the f32 rate.
//
// What the design does about it:
// - One block owns a TX x TY output tile, y (the contiguous axis) along the
//   threads. The first sweep reads the state from global memory at clamped
//   indices (edge replication, as in 3D) over the tile plus an r-cell halo
//   along the other axis, and writes shared memory; the second sweep reads
//   that, applies the folded correctors and writes the output tile. The
//   intermediate state never goes to device memory.
// - The TPU kernel's rule nx % 8 == 0 (8-row aligned halo DMAs for its
//   sublane tiling) is gone: any extents, ragged tiles masked at the store.
// - Shared memory: C * (TX + 2r) * TY floats at most, 46 KB for elastic2d
//   at orders 3-4, so several blocks fit on an SM.

#include "gcm_common.cuh"

namespace {

constexpr int TX2 = 32, TY2 = 64;
constexpr int NTHREADS2 = 256;

template <int ORDER>
__global__ void __launch_bounds__(NTHREADS2)
fused_step_2d_kernel(const float* __restrict__ u, const float* __restrict__ m,
                     const float* __restrict__ aux_in, float* __restrict__ out,
                     float* __restrict__ aux_out, GcmFusedParams p) {
    extern __shared__ float smem[];
    const int T[3] = {TX2, TY2, 1};
    const int t0[3] = {(int)blockIdx.y * TX2, (int)blockIdx.x * TY2, 0};
    const long long N = (long long)p.n[0] * p.n[1];
    const GlobalSrc src{u, p.n[0], p.n[1], 1, N};
    const GlobalMat mat{m, p.n[0], p.n[1], 1, N};
    step_tile<ORDER>(p, 2, t0, T, src, mat, smem, out, aux_in, aux_out);
}

template <int ORDER>
cudaError_t launch_2d(const float* u, const float* m, const float* aux_in,
                      float* out, float* aux_out, const GcmFusedParams& p,
                      cudaStream_t stream) {
    const int T[3] = {TX2, TY2, 1};
    const size_t smem = step_smem_bytes(p, T, Stencil<ORDER>::R, 2);
    cudaError_t err = cudaFuncSetAttribute(
        fused_step_2d_kernel<ORDER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.n[1] + TY2 - 1) / TY2, (p.n[0] + TX2 - 1) / TX2);
    fused_step_2d_kernel<ORDER><<<grid, NTHREADS2, smem, stream>>>(
        u, m, aux_in, out, aux_out, p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one fused 2D step; the same contract as gcm_fused_step, with
// params->n = {nx, ny, 1}.
int gcm_fused_step_2d(const float* u, const float* mstack,
                      const float* aux_in, float* out, float* aux_out,
                      const GcmFusedParams* params, int order, int device,
                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const GcmFusedParams& p = *params;
    switch (order) {
        case 1: return (int)launch_2d<1>(u, mstack, aux_in, out, aux_out, p, s);
        case 2: return (int)launch_2d<2>(u, mstack, aux_in, out, aux_out, p, s);
        case 3: return (int)launch_2d<3>(u, mstack, aux_in, out, aux_out, p, s);
        case 4: return (int)launch_2d<4>(u, mstack, aux_in, out, aux_out, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
