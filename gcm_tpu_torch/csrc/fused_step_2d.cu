// One whole 2D grid-characteristic time step in one kernel (CUDA C++, sm_90a),
// or two steps per pass (temporal blocking), on a float or bf16 material
// stack.
//
// Replaces the Pallas TPU kernel gcm_tpu/ops/pallas_fused.py::fused_step_2d
// (body _make_2d_kernel, folded correctors _corrector_epilogue, axes_seq
// temporal blocking, bf16 stacks upcast after the DMA). Its plain PyTorch
// version is gcm_tpu_torch/ops/fused.py::fused_step_2d_reference
// (= solver.gcm.step on materials derived from the compact stack, once per
// step of the sequence, then the plain corrector epilogue), which it must
// match. The sweep, the border algebra and the epilogue are the 3D
// kernel's (gcm_common.cuh), run on a grid of extent 1 along z.
//
// What bounds it on an H100: memory. Per grid point and step elastic2d
// reads 5 state components and 4 compact material fields (cp, cs, rho,
// kappa) and writes 5 components: 36 bytes in, 20 bytes out, 56 bytes
// against 3.35 TB/s, ~60 Gpoints/s at the roofline (a damage corrector
// adds 4 bytes in and 4 out); a bf16 stack makes it 20 + 8 + 20 = 48 bytes.
// The orthotropic stack (v11, v66, v22, rho, k01, k10) has 6 fields: 64
// bytes a point (52 with bf16), read through the same per-pair and per-zero
// stack rows of the parameters.
// Two steps per pass move the same bytes for two steps. Two sweeps of
// interpolation and pair algebra are far below the f32 rate.
//
// What the design does about it:
// - One block owns a TX x TY output tile, y (the contiguous axis) along the
//   threads. The first sweep reads the state from global memory at clamped
//   indices (edge replication, as in 3D) over the tile plus a K*r-cell halo
//   (r along the first sweep's own axis), and writes shared memory; each
//   later sweep reads the buffer the one before it wrote; the last applies
//   the folded correctors (K = 1) and writes the output tile. The
//   intermediate states never go to device memory.
// - With K = 2 the second step reads the first one's result at indices
//   clamped to the domain (ClampedSharedSrc), so the out-of-domain halo
//   cells of the first step, which are don't-cares, are never read: that
//   is the TPU kernel's re-patch of the shrinking halo between steps.
// - bf16 stacks are read as bf16 and upcast at the load (GlobalMat<T>).
// - The TPU kernel's rule nx % 8 == 0 (8-row aligned halo DMAs for its
//   sublane tiling) and its K*r <= 8 limit are gone: any extents, ragged
//   tiles masked at the store.
// - Shared memory: at most C * ((TX + 2H - r) * (TY + 2H) + (TX + 2H - r)
//   * (TY + 2H - 2r)) floats, about 100 KB for elastic2d at order 4, K = 2.

#include "gcm_common.cuh"

namespace {

constexpr int TX2 = 32, TY2 = 64;
constexpr int NTHREADS2 = 256;

template <int ORDER, class MatT, int K>
__global__ void __launch_bounds__(NTHREADS2)
fused_step_2d_kernel(const float* __restrict__ u, const MatT* __restrict__ m,
                     const float* __restrict__ aux_in, float* __restrict__ out,
                     float* __restrict__ aux_out, GcmFusedParams p) {
    extern __shared__ float smem[];
    const int T[3] = {TX2, TY2, 1};
    const int t0[3] = {(int)blockIdx.y * TX2, (int)blockIdx.x * TY2, 0};
    const long long N = (long long)p.n[0] * p.n[1];
    const GlobalSrc src{u, p.n[0], p.n[1], 1, N};
    const GlobalMat<MatT> mat{m, p.n[0], p.n[1], 1, N};
    step_tile_n<ORDER, K, 2>(p, t0, T, src, mat, smem, out, aux_in, aux_out);
}

template <int ORDER, class MatT, int K>
cudaError_t launch_2d(const float* u, const void* m, const float* aux_in,
                      float* out, float* aux_out, const GcmFusedParams& p,
                      cudaStream_t stream) {
    const int T[3] = {TX2, TY2, 1};
    const size_t smem = step_smem_bytes(p, T, Stencil<ORDER>::R, 2, K);
    cudaError_t err = cudaFuncSetAttribute(
        fused_step_2d_kernel<ORDER, MatT, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.n[1] + TY2 - 1) / TY2, (p.n[0] + TX2 - 1) / TX2);
    fused_step_2d_kernel<ORDER, MatT, K><<<grid, NTHREADS2, smem, stream>>>(
        u, (const MatT*)m, aux_in, out, aux_out, p);
    return cudaGetLastError();
}

template <class MatT, int K>
cudaError_t dispatch_2d(int order, const float* u, const void* m,
                        const float* aux_in, float* out, float* aux_out,
                        const GcmFusedParams& p, cudaStream_t s) {
    switch (order) {
        case 1: return launch_2d<1, MatT, K>(u, m, aux_in, out, aux_out, p, s);
        case 2: return launch_2d<2, MatT, K>(u, m, aux_in, out, aux_out, p, s);
        case 3: return launch_2d<3, MatT, K>(u, m, aux_in, out, aux_out, p, s);
        case 4: return launch_2d<4, MatT, K>(u, m, aux_in, out, aux_out, p, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Launches one fused 2D pass of `ksteps` (1 or 2) steps; the same contract
// as gcm_fused_step_slab, with params->n = {nx, ny, 1}: the second step's
// sweep order in params->axes_next, the stack stored as bf16 when
// `mat_bf16` is set (float otherwise), correctors folded only with
// ksteps = 1.
int gcm_fused_step_2d(const float* u, const void* mstack,
                      const float* aux_in, float* out, float* aux_out,
                      const GcmFusedParams* params, int order, int mat_bf16,
                      int ksteps, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const GcmFusedParams& p = *params;
    if (ksteps == 2 && p.nspec > 0) return (int)cudaErrorInvalidValue;
    if (ksteps == 1 && !mat_bf16)
        return (int)dispatch_2d<float, 1>(order, u, mstack, aux_in, out,
                                          aux_out, p, s);
    if (ksteps == 1)
        return (int)dispatch_2d<__nv_bfloat16, 1>(order, u, mstack, aux_in,
                                                  out, aux_out, p, s);
    if (ksteps == 2 && !mat_bf16)
        return (int)dispatch_2d<float, 2>(order, u, mstack, aux_in, out,
                                          aux_out, p, s);
    if (ksteps == 2)
        return (int)dispatch_2d<__nv_bfloat16, 2>(order, u, mstack, aux_in,
                                                  out, aux_out, p, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
