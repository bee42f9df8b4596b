// The full 3D grid-characteristic step on a float or bf16 material stack,
// one or two steps per pass over memory (CUDA C++, sm_90a).
//
// Replaces two Pallas TPU kernels of gcm_tpu/ops/pallas_fused.py:
// - fused_step (body _make_fused_kernel, sweep math _sweep_window, border
//   algebra _bc_incoming, folded correctors _corrector_epilogue): one step
//   on a float stack, which is this kernel's <ORDER, float, 1>
//   instantiation;
// - fused_step_slab (body _make_slab_kernel, call :894): the same contract
//   plus bf16 material stacks (upcast right after the load, all arithmetic
//   float) and K = len(axes_seq) steps per pass with a K*r halo and the
//   edge re-patch between steps (temporal blocking, K = 1 or 2), with the
//   folded corrector epilogue at K = 1.
// Its plain PyTorch versions are gcm_tpu_torch/ops/fused.py::
// fused_step_reference (solver.gcm.step on materials derived from the
// compact stack, then the plain corrector epilogue) and
// fused_step_slab_reference (the stack upcast from bf16, fused_step_reference
// once per step of the sequence, the epilogue at K = 1), which it must
// match. The sweep, the border algebra and the epilogue are shared with the
// 2D and SPMD kernels (gcm_common.cuh::step_tile).
//
// What bounds it on an H100: memory. Per grid point a pass reads the 9
// state components and the 4 compact material fields (cp, cs, rho, kappa)
// and writes 9 components: 36 + 16 + 36 = 88 bytes with a float stack,
// 36 + 8 + 36 = 80 with a bf16 one, ~38-42 Gpoints/s a pass at 3.35 TB/s (a
// damage corrector adds 4 bytes in and 4 out). An orthotropic stack
// (ops/fused.py::stack_mats_ortho: six per-stiffness speeds v<lbl>, rho and
// six coupling ratios k<a><b>) has 13 fields, 52 bytes a point: 124 bytes a
// pass (98 with bf16). Both layouts run the same code: the parameters name
// the stack row of each pair's speed and of each zero's ratio. A K = 2 pass
// moves the same bytes for two steps, so its bound a step is half of that.
// The arithmetic (three sweeps a step of Lagrange interpolation and pair
// algebra, a few hundred flops per point, each sweep over a haloed box)
// stays far below the 67 TFLOP/s f32 rate. On top come the re-reads of the
// halo that each tile recomputes.
//
// What the design does about it:
// - Not the TPU's slab tiling: its full (y, z) plane per x-tile is
//   256 * 128 * 9 * 4 B = 1.2 MB at the contact shape, far over the 227 KB
//   of shared memory a block has; it exists for long contiguous TPU DMA
//   bursts. One block owns a TX x TY x TZ output tile and runs the K * 3
//   sweeps back to back, so no intermediate state or step goes to device
//   memory: the state is read once (plus halo) and written once a pass.
// - The first sweep reads the state straight from global memory (the
//   window, with a K*r halo on every axis, is served by L1/L2); the sweeps
//   then write two shared buffers in turn, and the last one writes the
//   output tile. An axis swept s times keeps a halo of K*r - s*r; each
//   sweep computes over the still-haloed extent of the other axes,
//   recomputing the corners, as the TPU kernel does.
// - Edge replication is index clamping: window cell g of state and
//   materials is read from clamp(g, 0, n-1), so a recomputed halo row
//   outside the domain equals the swept edge row (the edge_pad of the
//   plain step). The first step's out-of-domain halo cells are don't-cares
//   (the TPU kernel re-patches them); the second step reads the first
//   one's result through ClampedSharedSrc, at indices clamped to the
//   domain. Borders stay keyed on the global row index (0 or n-1), ragged
//   tiles are masked at the store, and any extent works, thinner than the
//   halo included.
// - The tile is chosen per (ORDER, K) so the two live buffers fit: 8x8x16
//   (K = 1: ~93-138 KB for elastic3d; K = 2 at r = 1: ~158-171 KB) and
//   8x8x8 at K = 2, r = 2 (8x8x16 would need 166 + 124 KB; 8x8x8 needs
//   110 + 83 KB).
// - Materials are read from global memory at each cell (GlobalMat<T>,
//   float or __nv_bfloat16, L2-resident reuse across the sweeps) and
//   upcast in registers; z = rho*c and 0.5/z are derived from the upcast
//   values, as the plain version derives them from the rounded stack.
// - Folded correctors run on each output cell in registers just before its
//   store, so a viscoelastic or damage step stays one pass over memory.
// Speed work left for later: the large K = 2 buffers leave one block an SM;
// register-resident columns along z, cp.async/TMA staging of the window.

#include "gcm_common.cuh"

namespace {

constexpr int NTHREADS = 256;

template <int ORDER, int K>
struct SlabTile {
    static constexpr int TX = 8, TY = 8;
    static constexpr int TZ = (K == 2 && ORDER >= 3) ? 8 : 16;
};

template <int ORDER, class MatT, int K>
__global__ void __launch_bounds__(NTHREADS)
fused_step_slab_kernel(const float* __restrict__ u,
                       const MatT* __restrict__ m,
                       const float* __restrict__ aux_in,
                       float* __restrict__ out, float* __restrict__ aux_out,
                       GcmFusedParams p) {
    using TL = SlabTile<ORDER, K>;
    extern __shared__ float smem[];
    const int T[3] = {TL::TX, TL::TY, TL::TZ};
    const int t0[3] = {(int)blockIdx.z * TL::TX, (int)blockIdx.y * TL::TY,
                       (int)blockIdx.x * TL::TZ};
    const long long N = (long long)p.n[0] * p.n[1] * p.n[2];
    const GlobalSrc src{u, p.n[0], p.n[1], p.n[2], N};
    const GlobalMat<MatT> mat{m, p.n[0], p.n[1], p.n[2], N};
    step_tile<ORDER, K>(p, 3, t0, T, src, mat, smem, out, aux_in, aux_out);
}

template <int ORDER, class MatT, int K>
cudaError_t launch_slab(const float* u, const void* m, const float* aux_in,
                        float* out, float* aux_out, const GcmFusedParams& p,
                        cudaStream_t stream) {
    using TL = SlabTile<ORDER, K>;
    const int T[3] = {TL::TX, TL::TY, TL::TZ};
    const size_t smem = step_smem_bytes(p, T, Stencil<ORDER>::R, 3, K);
    cudaError_t err = cudaFuncSetAttribute(
        fused_step_slab_kernel<ORDER, MatT, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.n[2] + TL::TZ - 1) / TL::TZ,
                    (p.n[1] + TL::TY - 1) / TL::TY,
                    (p.n[0] + TL::TX - 1) / TL::TX);
    fused_step_slab_kernel<ORDER, MatT, K><<<grid, NTHREADS, smem, stream>>>(
        u, (const MatT*)m, aux_in, out, aux_out, p);
    return cudaGetLastError();
}

template <class MatT, int K>
cudaError_t dispatch_slab(int order, const float* u, const void* m,
                          const float* aux_in, float* out, float* aux_out,
                          const GcmFusedParams& p, cudaStream_t s) {
    switch (order) {
        case 1: return launch_slab<1, MatT, K>(u, m, aux_in, out, aux_out, p, s);
        case 2: return launch_slab<2, MatT, K>(u, m, aux_in, out, aux_out, p, s);
        case 3: return launch_slab<3, MatT, K>(u, m, aux_in, out, aux_out, p, s);
        case 4: return launch_slab<4, MatT, K>(u, m, aux_in, out, aux_out, p, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Launches one pass of `ksteps` (1 or 2) full 3D steps on `stream` (a
// cudaStream_t) of device `device`: the sweeps along params->axes, then
// (ksteps = 2) along params->axes_next; the stack (nm, nx, ny, nz) is bf16
// when `mat_bf16` is set, float otherwise. The folded correctors (aux_in/
// aux_out, one field per damage corrector, null without) run only with
// ksteps = 1. Returns the CUDA error code of the launch (0 on success); the
// caller allocates the outputs and checks shapes, types and contiguity.
int gcm_fused_step_slab(const float* u, const void* mstack,
                        const float* aux_in, float* out, float* aux_out,
                        const GcmFusedParams* params, int order, int mat_bf16,
                        int ksteps, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const GcmFusedParams& p = *params;
    if (ksteps == 2 && p.nspec > 0) return (int)cudaErrorInvalidValue;
    if (ksteps == 1 && !mat_bf16)
        return (int)dispatch_slab<float, 1>(order, u, mstack, aux_in, out,
                                            aux_out, p, s);
    if (ksteps == 1)
        return (int)dispatch_slab<__nv_bfloat16, 1>(order, u, mstack, aux_in,
                                                    out, aux_out, p, s);
    if (ksteps == 2 && !mat_bf16)
        return (int)dispatch_slab<float, 2>(order, u, mstack, aux_in, out,
                                            aux_out, p, s);
    if (ksteps == 2)
        return (int)dispatch_slab<__nv_bfloat16, 2>(order, u, mstack, aux_in,
                                                    out, aux_out, p, s);
    return (int)cudaErrorInvalidValue;
}

const char* gcm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// sizeof(GcmFusedParams), so the binding can check its mirror of the layout
int gcm_params_size(void) { return (int)sizeof(GcmFusedParams); }

}  // extern "C"
