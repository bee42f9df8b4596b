// The full 3D grid-characteristic step on a float or bf16 material stack,
// one or two steps per pass over memory (CUDA C++, sm_90a).
//
// Replaces two Pallas TPU kernels of gcm_tpu/ops/pallas_fused.py:
// - fused_step (body _make_fused_kernel, sweep math _sweep_window, border
//   algebra _bc_incoming, folded correctors _corrector_epilogue): one step
//   on a float stack, which is this kernel's float, one-step form;
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
// match. The sweep algebra, border algebra and epilogue are shared with the
// 2D and SPMD kernels (gcm_common.cuh).
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
// algebra, a few hundred flops per point) stays far below the 67 TFLOP/s
// f32 rate. What a design adds on top: the re-reads and recomputation of
// each tile's halo, and whatever keeps the loads from overlapping the
// arithmetic (few resident warps, long dependent chains, local memory).
//
// One step a pass (K = 1: fused_step, the slab step on the contact path)
// walks x the same way in both of its bodies (gcm_common.cuh), which the
// form picks at compile time (stream_body, gcm_stream_body):
// - Not the TPU's slab tiling: its full (y, z) plane per x-tile is
//   256 * 128 * 9 * 4 B = 1.2 MB at the contact shape, far over the 227 KB
//   of shared memory a block has. A block owns an 8 x 32 tile of the (y, z)
//   plane (z contiguous: 128-byte rows) and walks a chunk of x, the
//   outermost axis, one plane at a time. Its 352 threads (11 warps) cover
//   any sweep of a plane window, up to 10 x 34 cells, in one pass, so no
//   warp idles at the barrier while others take a second pass. The chunks
//   are cut by occupancy (stream_chunk): as few waves of blocks as the
//   card holds, the fewest planes each.
// - Each incoming plane window (the tile with an r halo in y and z) is
//   staged into shared memory with cp.async ahead of the plane computing,
//   as the TPU kernel double-buffers its windows with DMA semaphores. The
//   in-plane sweeps that precede x run on it; the x sweep of the plane r
//   behind reads the 2r + 1 planes they leave; the in-plane sweeps after x
//   run on its result, and the last one stores the tile after the folded
//   correctors. Only the (y, z) halo is recomputed (and 2r planes of
//   in-plane sweeps a chunk), and the state is read once and written once
//   a pass.
// - What bounded the first body (stream_step, the ring body) on the card
//   (PERF.md, 512x512x256, order 2): 4.5-5.1 ms a step against a bound of
//   1.76. Variants that compute wrong numbers split it: with the cell's
//   materials made constant a step took 2.5-3.3 ms; with the x sweep's
//   ring reads made register reads, 2-4% less; without the barriers
//   between a plane's sweeps, 4-6% less. The cell's material path set the
//   pace: seven loads a cell and sweep through L1, the first of a plane a
//   miss to memory on the critical path, and three IEEE divisions.
// - The owned body (stream_step_owned: elastic3d at orders 1-2 on a
//   compact stack, the main path) gives each thread one cell of the
//   window in every sweep of every plane. The cell's four material values
//   are loaded a plane ahead into registers and its impedances and
//   half-reciprocals derived once a plane for all of its sweeps there; the
//   thread stages its own cell with cp.async; the x sweep's three planes
//   are its own slots of shared memory, which no other thread touches, so
//   the x sweep waits at no barrier and the ring's barriers go: two a
//   plane. 3.1-3.3 ms a step at 512x512x256 in every sweep order, 75-80
//   registers a thread and two blocks an SM, no spills. The three planes
//   held in registers instead spilled 4-12 bytes at the 80 registers that
//   two 11-warp blocks leave, and ran no faster.
// - The ring body (stream_step: orders 3-4, where the x sweep's five
//   planes would not fit a thread, acoustic3d, and orthotropic stacks,
//   whose speeds and ratios differ by axis) keeps the x sweep's planes in
//   a ring of shared memory that the block shares, and reads each cell's
//   materials from global memory at each sweep (GlobalMat<T>, float or
//   __nv_bfloat16, upcast in registers). 57-73 KB of shared memory at r =
//   1, three blocks an SM at 56 registers; 91-123 KB at r = 2.
// - The component map of the model (elastic3d, acoustic3d) and the tile
//   extents are compile-time: a cell's components stay in registers and
//   the cell loops divide by constants; each sweep order is its own
//   instantiation. The stack rows stay runtime, so the compact and
//   orthotropic layouts share the ring body's code.
// - Edge replication is index clamping: window cell g of state and
//   materials is read from clamp(g, 0, n-1) (a plane outside the domain is
//   the edge plane), so a recomputed halo row outside the domain equals the
//   swept edge row (the edge_pad of the plain step). Borders stay keyed on
//   the global row index (0 or n-1), ragged tiles are masked at the store,
//   and any extent works, thinner than the halo included.
// - z = rho*c and 0.5/z are derived from the upcast material values, as
//   the plain version derives them from the rounded stack (the owned body
//   as 0.5 * rcp_rn(z), the same float).
// Two steps a pass (K = 2, temporal blocking, opt-in) run the two-step
// form of that body (gcm_common.cuh::stream_pair), compiled one stencil
// order a source (fused_pair_stream.cuh) and launched from here.

#include "fused_pair_stream.cuh"

GCM_PAIR_STREAM_ENTRY(1);
GCM_PAIR_STREAM_ENTRY(2);
GCM_PAIR_STREAM_ENTRY(3);
GCM_PAIR_STREAM_ENTRY(4);

namespace {

// One step: output planes [ch * blockIdx.z, +ch) of the (y, z) tile
// (blockIdx.y, blockIdx.x), on the owned body (OWNED) or the ring body.
template <int ORDER, class M, class MatT, class AX, bool OWNED>
__global__ void __launch_bounds__(STREAM_NT,
                                  StreamBody<ORDER, M, AX, OWNED>::MINB)
fused_step_stream_kernel(const float* __restrict__ u,
                         const MatT* __restrict__ m,
                         const float* __restrict__ aux_in,
                         float* __restrict__ out, float* __restrict__ aux_out,
                         int ch, GcmFusedParams p) {
    extern __shared__ float smem[];
    const int n0 = p.n[0], n1 = p.n[1], n2 = p.n[2];
    const long long N = (long long)n0 * n1 * n2;
    const int xa = (int)blockIdx.z * ch;
    const int xb = min(xa + ch, n0);
    const GlobalSrc src{u, n0, n1, n2, N};
    const GlobalMat<MatT> mat{m, n0, n1, n2, N};
    const int y0 = (int)blockIdx.y * STREAM_TY;
    const int z0 = (int)blockIdx.x * STREAM_TZ;
    const StepOut so{out, aux_in, aux_out, N};
    if constexpr (OWNED)
        stream_step_owned<ORDER, M, AX>(p, src, mat, xa, xb, y0, z0, smem,
                                        so);
    else
        stream_step<ORDER, M, AX>(p, src, mat, xa, xb, y0, z0, smem, so);
}

// Launches one step on the body OWNED (occ == nullptr), or reports the
// occupancy such a launch gets.
template <int ORDER, class M, class MatT, class AX, bool OWNED>
cudaError_t launch_body(const float* u, const void* m, const float* aux_in,
                        float* out, float* aux_out, const GcmFusedParams& p,
                        int device, cudaStream_t stream,
                        StreamOccupancy* occ) {
    using L = StreamBody<ORDER, M, AX, OWNED>;
    const auto kernel = fused_step_stream_kernel<ORDER, M, MatT, AX, OWNED>;
    int bps = 0;
    cudaError_t err = stream_blocks_per_sm(kernel, L::BYTES, &bps);
    if (err != cudaSuccess) return err;
    if (occ != nullptr) {
        *occ = StreamOccupancy{bps, L::BYTES};
        return cudaSuccess;
    }
    const int nzt = (p.n[2] + STREAM_TZ - 1) / STREAM_TZ;
    const int nyt = (p.n[1] + STREAM_TY - 1) / STREAM_TY;
    const int ch = stream_chunk(p.n[0], (long long)nzt * nyt,
                                 Stencil<ORDER>::R, bps, device);
    const dim3 grid(nzt, nyt, (p.n[0] + ch - 1) / ch);
    kernel<<<grid, STREAM_NT, L::BYTES, stream>>>(
        u, (const MatT*)m, aux_in, out, aux_out, ch, p);
    return cudaGetLastError();
}

// One step on the body its form compiles to (stream_body).
template <int ORDER, class M, class MatT, class AX>
cudaError_t launch_stream(const float* u, const void* m, const float* aux_in,
                          float* out, float* aux_out, const GcmFusedParams& p,
                          int device, cudaStream_t stream,
                          StreamOccupancy* occ) {
    if constexpr (owned_form<ORDER, M>()) {
        if (compact_rows(p))
            return launch_body<ORDER, M, MatT, AX, true>(
                u, m, aux_in, out, aux_out, p, device, stream, occ);
    }
    return launch_body<ORDER, M, MatT, AX, false>(u, m, aux_in, out, aux_out,
                                                  p, device, stream, occ);
}

template <class MatT>
cudaError_t dispatch_stream(int order, const float* u, const void* m,
                            const float* aux_in, float* out, float* aux_out,
                            const GcmFusedParams& p, int device,
                            cudaStream_t s, StreamOccupancy* occ) {
    return with_stencil(order, [&](auto o) {
        return with_model(p.model, [&](auto mdl) {
            return with_axes(p.axes, [&](auto ax) {
                return launch_stream<decltype(o)::value, decltype(mdl), MatT,
                                     decltype(ax)>(u, m, aux_in, out, aux_out,
                                                   p, device, s, occ);
            });
        });
    });
}

cudaError_t slab(const float* u, const void* mstack, const float* aux_in,
                 float* out, float* aux_out, const GcmFusedParams& p,
                 int order, int mat_bf16, int ksteps, int device,
                 cudaStream_t s, StreamOccupancy* occ) {
    // the streamed body addresses a plane with 32-bit offsets
    if ((long long)p.n[1] * p.n[2] >= (1LL << 31))
        return cudaErrorInvalidValue;
    if (ksteps == 1 && !mat_bf16)
        return dispatch_stream<float>(order, u, mstack, aux_in, out, aux_out,
                                      p, device, s, occ);
    if (ksteps == 1)
        return dispatch_stream<__nv_bfloat16>(order, u, mstack, aux_in, out,
                                              aux_out, p, device, s, occ);
    if (ksteps != 2 || p.nspec > 0) return cudaErrorInvalidValue;
    const auto pair = order == 1   ? gcm_fused_pair_stream_o1
                      : order == 2 ? gcm_fused_pair_stream_o2
                      : order == 3 ? gcm_fused_pair_stream_o3
                      : order == 4 ? gcm_fused_pair_stream_o4
                                   : nullptr;
    if (pair == nullptr) return cudaErrorInvalidValue;
    int o[2] = {0, 0};
    const cudaError_t err = (cudaError_t)pair(
        u, mstack, out, &p, mat_bf16, device, s,
        occ != nullptr ? o : nullptr);
    if (occ != nullptr) *occ = StreamOccupancy{o[0], o[1]};
    return err;
}

}  // namespace

extern "C" {

// Launches one pass of `ksteps` (1 or 2) full 3D steps on `stream` (a
// cudaStream_t) of device `device`: the sweeps along params->axes, then
// (ksteps = 2) along params->axes_next; the stack (nm, nx, ny, nz) is bf16
// when `mat_bf16` is set, float otherwise. Both run the streamed body
// compiled for params->model. The folded correctors (aux_in/aux_out, one
// field per damage corrector, null without) run only with ksteps = 1.
// Returns the CUDA error code of the launch (0 on success); the caller
// allocates the outputs and checks shapes, types and contiguity.
int gcm_fused_step_slab(const float* u, const void* mstack,
                        const float* aux_in, float* out, float* aux_out,
                        const GcmFusedParams* params, int order, int mat_bf16,
                        int ksteps, int device, void* stream) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    return (int)slab(u, mstack, aux_in, out, aux_out, *params, order,
                     mat_bf16, ksteps, device, (cudaStream_t)stream, nullptr);
}

// The occupancy a launch of `ksteps` (1 or 2) steps with these arguments
// gets: out[0] resident blocks an SM, out[1] its dynamic shared memory in
// bytes.
int gcm_fused_step_slab_occupancy(const GcmFusedParams* params, int order,
                                  int mat_bf16, int ksteps, int device,
                                  int* out) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    StreamOccupancy occ{0, 0};
    err = slab(nullptr, nullptr, nullptr, nullptr, nullptr, *params, order,
               mat_bf16, ksteps, device, nullptr, &occ);
    out[0] = occ.blocks_per_sm;
    out[1] = occ.smem_bytes;
    return (int)err;
}

// The body a one-step launch (ksteps = 1) of `order` with these parameters
// runs, from the form alone (no device is asked): 1 the owned body
// (gcm_common.cuh::stream_step_owned: elastic3d at orders 1-2 on a compact
// stack), 0 the ring body (stream_step). The SPMD launches (fused_spmd.cu)
// make the same choice.
int gcm_stream_body(const GcmFusedParams* params, int order) {
    return stream_body(order, *params);
}

// Fills the component map compiled for `model` (STREAM_MODEL_*,
// SWEEP_MODEL_*2D: the one map of each model that the streamed bodies, the
// per-sweep kernel and the simplex sweep are all compiled for, from
// gcm_common.cuh) into ncomp, sign, npairs, pair_sigma, pair_vel, nzeros,
// zero_comp, zero_src, ndiag, diag, nshear and shear of *out. Returns 0, or
// 1 for an unknown id.
int gcm_model_map(int model, GcmFusedParams* out) {
    return (int)with_sweep_model(model, [&](auto mdl) {
        model_map<decltype(mdl)>(out);
        return cudaSuccess;
    });
}

const char* gcm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// sizeof(GcmFusedParams), so the binding can check its mirror of the layout
int gcm_params_size(void) { return (int)sizeof(GcmFusedParams); }

}  // extern "C"
