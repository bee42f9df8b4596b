// One whole 3D grid-characteristic time step in one kernel (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel gcm_tpu/ops/pallas_fused.py::fused_step
// (body _make_fused_kernel, sweep math _sweep_window, border algebra
// _bc_incoming, folded correctors _corrector_epilogue). Its plain PyTorch
// version is gcm_tpu_torch/ops/fused.py::fused_step_reference
// (= solver.gcm.step on materials derived from the compact stack, then the
// plain corrector epilogue), which it must match. The sweep, the border
// algebra and the epilogue are shared with the 2D kernel (gcm_common.cuh).
//
// What bounds it on an H100: memory. Per grid point and step it must read
// the 9 state components and the 4 compact material fields (cp, cs, rho,
// kappa) and write 9 components: (9+4)*4 = 52 bytes in, 36 bytes out, about
// 88 bytes against 3.35 TB/s, or ~38 Gpoints/s at the roofline (a damage
// corrector adds 4 bytes in and 4 out). The arithmetic (three sweeps of
// Lagrange interpolation and pair algebra, a few hundred flops per point)
// is far below the 67 TFLOP/s f32 rate. On top come the re-reads of the
// halo that each tile recomputes.
//
// What the design does about it:
// - One block owns a TX x TY x TZ output tile. The three sweeps of the step
//   run back to back inside the block, so the intermediate states of the
//   step never go to device memory: the state is read once (plus halo) and
//   written once, instead of 3 reads + 3 writes for three sweep launches.
// - The first sweep reads the state straight from global memory (the tile's
//   window, with an r-cell halo on every axis, is served by L1/L2) and
//   writes its result to shared memory; the second sweep reads that and
//   writes a second shared buffer; the third writes the output tile. Each
//   sweep trims the halo of its own axis and computes over the still-haloed
//   extent of the others, recomputing the corners, as the TPU kernel does.
//   TPU tiles (32 x 64 x nz, sized for 128 MiB of VMEM) would not fit in
//   the 227 KB of shared memory a block has; this tile needs about 100 KB
//   at order 2.
// - Edge replication is index clamping: window cell g of state and
//   materials is read from clamp(g, 0, n-1). A recomputed halo row outside
//   the domain then equals the swept edge row, which is the edge_pad
//   semantics of the reference; extents need not be tile multiples (ragged
//   tiles are masked at the store).
// - Border conditions apply only on rows whose global index along the
//   sweep axis is 0 or n-1.
// - Materials are read from global memory at each cell (L2-resident reuse
//   across the three sweeps); impedances z = rho*c and 0.5/z are derived in
//   registers, as the compact TPU layout derives them in VMEM.
// - Folded correctors run on each output cell in registers just before its
//   store, so a viscoelastic or damage step stays one pass over memory.
// Speed work left for later: cp.async/TMA staging of the first sweep's
// window, tile shape tuning, register-resident per-cell arrays.

#include "gcm_common.cuh"

namespace {

constexpr int TX = 8, TY = 8, TZ = 16;
constexpr int NTHREADS = 256;

template <int ORDER>
__global__ void __launch_bounds__(NTHREADS)
fused_step_kernel(const float* __restrict__ u, const float* __restrict__ m,
                  const float* __restrict__ aux_in, float* __restrict__ out,
                  float* __restrict__ aux_out, GcmFusedParams p) {
    extern __shared__ float smem[];
    const int T[3] = {TX, TY, TZ};
    const int t0[3] = {(int)blockIdx.z * TX, (int)blockIdx.y * TY,
                       (int)blockIdx.x * TZ};
    const long long N = (long long)p.n[0] * p.n[1] * p.n[2];
    const GlobalSrc src{u, p.n[0], p.n[1], p.n[2], N};
    const GlobalMat mat{m, p.n[0], p.n[1], p.n[2], N};
    step_tile<ORDER>(p, 3, t0, T, src, mat, smem, out, aux_in, aux_out);
}

template <int ORDER>
cudaError_t launch(const float* u, const float* m, const float* aux_in,
                   float* out, float* aux_out, const GcmFusedParams& p,
                   cudaStream_t stream) {
    const int T[3] = {TX, TY, TZ};
    const size_t smem = step_smem_bytes(p, T, Stencil<ORDER>::R, 3);
    cudaError_t err = cudaFuncSetAttribute(
        fused_step_kernel<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.n[2] + TZ - 1) / TZ, (p.n[1] + TY - 1) / TY,
                    (p.n[0] + TX - 1) / TX);
    fused_step_kernel<ORDER><<<grid, NTHREADS, smem, stream>>>(
        u, m, aux_in, out, aux_out, p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one fused step on `stream` (a cudaStream_t) of device `device`.
// `aux_in`/`aux_out` hold one field per damage corrector of the epilogue
// (null without). Returns the CUDA error code of the launch (0 on success);
// the caller allocates the outputs and checks shapes, types and contiguity.
int gcm_fused_step(const float* u, const float* mstack, const float* aux_in,
                   float* out, float* aux_out, const GcmFusedParams* params,
                   int order, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const GcmFusedParams& p = *params;
    switch (order) {
        case 1: return (int)launch<1>(u, mstack, aux_in, out, aux_out, p, s);
        case 2: return (int)launch<2>(u, mstack, aux_in, out, aux_out, p, s);
        case 3: return (int)launch<3>(u, mstack, aux_in, out, aux_out, p, s);
        case 4: return (int)launch<4>(u, mstack, aux_in, out, aux_out, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* gcm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// sizeof(GcmFusedParams), so the binding can check its mirror of the layout
int gcm_params_size(void) { return (int)sizeof(GcmFusedParams); }

}  // extern "C"
