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
// match. The sweep math, the border algebra and the epilogue are the 3D
// kernels' (gcm_common.cuh).
//
// What bounds it on an H100: memory. Per grid point and step elastic2d
// reads 5 state components and 4 compact material fields (cp, cs, rho,
// kappa) and writes 5 components: 36 bytes in, 20 bytes out, 56 bytes
// against 3.35 TB/s, ~60 Gpoints/s at the roofline (a damage corrector
// adds 4 bytes in and 4 out); a bf16 stack makes it 20 + 8 + 20 = 48 bytes.
// The orthotropic stack (v11, v66, v22, rho, k01, k10) has 6 fields: 64
// bytes a point (52 with bf16), read through the same per-pair and per-zero
// stack rows of the parameters. Two steps per pass move the same bytes for
// two steps. Two sweeps of interpolation and pair algebra are far below
// the f32 rate. What a design adds on top: the halo each block re-reads
// and recomputes, and whatever keeps the loads from overlapping the
// arithmetic.
//
// One step a pass (K = 1, the 2D path) is gcm_common.cuh::stream_rows:
// - A row is a plane whose only in-plane axis is the contiguous one, but
//   stream_step's templates are not reused: their (8 x 32) plane tile would
//   leave 7 of 8 rows of threads idle on a row, and their x ring lives in
//   shared memory because the in-plane sweeps after x need the neighbours'
//   results. In 2D the x sweep needs only its own column, so a thread
//   keeps its column's ring of 2r + 1 rows in registers.
// - A block of 128 threads (4 warps) owns a window of 128 columns of y
//   (the contiguous axis: 512-byte rows), one a thread, of which the middle
//   128 - 2r are its output strip, and walks a chunk of x rows. Each
//   incoming row window is staged into shared memory with cp.async three
//   rows ahead of the one computing (16-byte copies where the rows are
//   aligned, 4-byte copies of clamped cells at the domain's edges and for
//   ragged extents). y first: the y sweep runs on the staged row for the
//   strip and its result enters the ring. x first: the raw column enters
//   the ring, the x sweep computes the whole window row into shared
//   memory, and the y sweep of the strip reads its neighbours there. One
//   formulation for both sweep orders. The state is read once and written
//   once; the recomputed halo is 2r columns a window and 2r rows a chunk.
// - Chunks are cut by occupancy (stream_chunk): at 2048^2, 17 strips by a
//   chunk of ~40 rows fill the card in one wave.
// - The component map (elastic2d, acoustic2d) is compile-time, so a
//   cell's 5 or 3 components stay in registers; the stack rows stay
//   runtime (the compact and orthotropic layouts share the code) and the
//   stack's stored type is a runtime flag (DynMat): 4 orders x 2 models x
//   2 sweep orders = 16 instantiations.
// - Edge replication is index clamping, as in 3D: borders stay keyed on the
//   global row or column (0 or n - 1), ragged strips are masked at the
//   store, any extent works, thinner than the halo included.
// Two steps a pass (K = 2, temporal blocking, opt-in) run the two-step form
// of that body, gcm_common.cuh::stream_rows_pair. It replaces the two-step
// form of the Pallas kernel: len(axes_seq) == 2, the sweeps of
// _make_2d_kernel (:1013-1022) once a step with the edge re-patch between
// the steps (:1020-1022), folded correctors refused (:1086-1088). A pass
// moves one step's bytes for two steps; four sweeps stay far below the
// f32 rate but are what one-step launches issue twice (the one-step body
// is issue-bound at half its bound, PERF.md), so the aim is to beat two
// one-step launches:
// - The one-step row pipeline twice, chained in registers. A block of 128
//   threads owns a window of 128 columns of y and walks a chunk of x rows;
//   the first step (A) runs on the whole window, and the second (B) reads
//   A's output rows. A's output strip of 128 - 2r columns feeds B's strip
//   of 128 - 4r (r = 1: 124 columns, 17 strips at 2048^2).
// - Rows are staged with cp.async three rows ahead (16-byte copies where
//   the rows are aligned), as for one step. Each sweep along x reads a
//   register ring of 2r + 1 rows of the thread's own column: A's ring of
//   A's input, B's ring of A's output after B's first sweep. Only the y
//   sweeps read neighbours, from a shared row.
// - The edge re-patch: A's output row goes through a shared row that B
//   reads at columns clamped to the domain (the y edge), and B's ring is
//   filled at clamped row indices (the x edge: the domain's first row
//   enters r + 1 times, its last repeats until the chunk is done). So the
//   state and materials are read once and the state written once a pass.
// - Compile time: the model's component map and both sweep orders (A and
//   B each x first or y first), 4 orders x 2 models x 4 pairs = 32
//   instantiations, in this source beside the one-step body's 16. The
//   stack's stored type is a runtime flag (DynMat) and the stack rows stay
//   runtime, so the compact and orthotropic layouts, float and bf16, share
//   a path.
// - x chunks are cut by occupancy as for one step, counting the 4r rows a
//   chunk stages beyond its own.

#include "gcm_common.cuh"

namespace {

// One step: output rows [ch * blockIdx.y, +ch) of strip blockIdx.x.
template <int ORDER, class M, bool XFIRST>
__global__ void __launch_bounds__(ROWS_NT, RowTile<ORDER>::MINB)
fused_step_rows_kernel(const float* __restrict__ u, const void* m, int bf16,
                       const float* __restrict__ aux_in,
                       float* __restrict__ out, float* __restrict__ aux_out,
                       int ch, int vec, GcmFusedParams p) {
    extern __shared__ __align__(16) float smem[];
    const int n0 = p.n[0], n1 = p.n[1];
    const long long N = (long long)n0 * n1;
    const int xa = (int)blockIdx.y * ch;
    const int xb = min(xa + ch, n0);
    const GlobalSrc src{u, n0, n1, 1, N};
    const DynMat mat{m, n0, n1, 1, N, bf16};
    stream_rows<ORDER, M, XFIRST>(p, src, mat, xa, xb,
                                  (int)blockIdx.x * RowTile<ORDER>::TY, smem,
                                  StepOut{out, aux_in, aux_out, N}, vec != 0);
}

// Launches one step (occ == nullptr), or reports the occupancy such a
// launch gets.
template <int ORDER, class M, bool XFIRST>
cudaError_t launch_rows(const float* u, const void* m, int bf16,
                        const float* aux_in, float* out, float* aux_out,
                        const GcmFusedParams& p, int device,
                        cudaStream_t stream, StreamOccupancy* occ) {
    using L = RowLayout<ORDER, M::C, XFIRST>;
    const auto kernel = fused_step_rows_kernel<ORDER, M, XFIRST>;
    int bps = 0;
    cudaError_t err = stream_blocks_per_sm(kernel, L::BYTES, &bps, ROWS_NT);
    if (err != cudaSuccess) return err;
    if (occ != nullptr) {
        *occ = StreamOccupancy{bps, L::BYTES};
        return cudaSuccess;
    }
    const int nst = (p.n[1] + RowTile<ORDER>::TY - 1) / RowTile<ORDER>::TY;
    const int ch = stream_chunk(p.n[0], nst, Stencil<ORDER>::R, bps, device);
    const int vec = p.n[1] % 4 == 0 && aligned16(u);
    const dim3 grid(nst, (p.n[0] + ch - 1) / ch);
    kernel<<<grid, ROWS_NT, L::BYTES, stream>>>(u, m, bf16, aux_in, out,
                                                aux_out, ch, vec, p);
    return cudaGetLastError();
}

// Two steps: output rows [ch * blockIdx.y, +ch) of strip blockIdx.x.
template <int ORDER, class M, bool XA, bool XB>
__global__ void __launch_bounds__(PAIR_ROWS_NT, PairRowTile<ORDER>::MINB)
fused_pair_rows_kernel(const float* __restrict__ u, const void* m, int bf16,
                       float* __restrict__ out, int ch, int vec,
                       GcmFusedParams p) {
    extern __shared__ __align__(16) float smem[];
    const int n0 = p.n[0], n1 = p.n[1];
    const long long N = (long long)n0 * n1;
    const int xa = (int)blockIdx.y * ch;
    const int xb = min(xa + ch, n0);
    const GlobalSrc src{u, n0, n1, 1, N};
    const DynMat mat{m, n0, n1, 1, N, bf16};
    stream_rows_pair<ORDER, M, XA, XB>(
        p, src, mat, xa, xb, (int)blockIdx.x * PairRowTile<ORDER>::TY, smem,
        StepOut{out, nullptr, nullptr, N}, vec != 0);
}

// Launches one pass of two steps (occ == nullptr), or reports the
// occupancy such a launch gets.
template <int ORDER, class M, bool XA, bool XB>
cudaError_t launch_pair_rows(const float* u, const void* m, int bf16,
                             float* out, const GcmFusedParams& p, int device,
                             cudaStream_t stream, StreamOccupancy* occ) {
    using L = PairRowLayout<ORDER, M::C, XA, XB>;
    using T = PairRowTile<ORDER>;
    const auto kernel = fused_pair_rows_kernel<ORDER, M, XA, XB>;
    int bps = 0;
    cudaError_t err = stream_blocks_per_sm(kernel, L::BYTES, &bps, T::NT);
    if (err != cudaSuccess) return err;
    if (occ != nullptr) {
        *occ = StreamOccupancy{bps, L::BYTES};
        return cudaSuccess;
    }
    const int nst = (p.n[1] + T::TY - 1) / T::TY;
    const int ch = stream_chunk(p.n[0], nst, 2 * T::R, bps, device);
    const int vec = p.n[1] % 4 == 0 && aligned16(u);
    const dim3 grid(nst, (p.n[0] + ch - 1) / ch);
    kernel<<<grid, T::NT, L::BYTES, stream>>>(u, m, bf16, out, ch, vec, p);
    return cudaGetLastError();
}

cudaError_t step_2d(const float* u, const void* mstack, const float* aux_in,
                    float* out, float* aux_out, const GcmFusedParams& p,
                    int order, int mat_bf16, int ksteps, int device,
                    cudaStream_t s, StreamOccupancy* occ) {
    if (ksteps == 1)
        return with_rows(order, p, [&](auto o, auto mdl, auto xfirst) {
            return launch_rows<decltype(o)::value, decltype(mdl),
                               decltype(xfirst)::value>(
                u, mstack, mat_bf16, aux_in, out, aux_out, p, device, s,
                occ);
        });
    if (ksteps != 2 || p.nspec > 0) return cudaErrorInvalidValue;
    return with_stencil(order, [&](auto o) {
        return with_rows_pair(p, [&](auto mdl, auto xa, auto xb) {
            return launch_pair_rows<decltype(o)::value, decltype(mdl),
                                    decltype(xa)::value, decltype(xb)::value>(
                u, mstack, mat_bf16, out, p, device, s, occ);
        });
    });
}

}  // namespace

extern "C" {

// Launches one fused 2D pass of `ksteps` (1 or 2) steps; the same contract
// as gcm_fused_step_slab, with params->n = {nx, ny, 1}: one step runs the
// row-streamed body compiled for params->model (SWEEP_MODEL_ELASTIC2D or
// SWEEP_MODEL_ACOUSTIC2D), two its two-step form with the second step's
// sweep order in params->axes_next; the stack stored as bf16 when
// `mat_bf16` is set (float otherwise), correctors folded only with
// ksteps = 1.
int gcm_fused_step_2d(const float* u, const void* mstack,
                      const float* aux_in, float* out, float* aux_out,
                      const GcmFusedParams* params, int order, int mat_bf16,
                      int ksteps, int device, void* stream) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    return (int)step_2d(u, mstack, aux_in, out, aux_out, *params, order,
                        mat_bf16, ksteps, device, (cudaStream_t)stream,
                        nullptr);
}

// The occupancy a launch of `ksteps` (1 or 2) steps with these parameters
// gets: out[0] resident blocks an SM, out[1] its dynamic shared memory in
// bytes.
int gcm_fused_step_2d_occupancy(const GcmFusedParams* params, int order,
                                int mat_bf16, int ksteps, int device,
                                int* out) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    StreamOccupancy occ{0, 0};
    err = step_2d(nullptr, nullptr, nullptr, nullptr, nullptr, *params,
                  order, mat_bf16, ksteps, device, nullptr, &occ);
    out[0] = occ.blocks_per_sm;
    out[1] = occ.smem_bytes;
    return (int)err;
}

}  // extern "C"
