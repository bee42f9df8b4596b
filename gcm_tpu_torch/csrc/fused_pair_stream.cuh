// Two full 3D grid-characteristic steps in one pass over memory (temporal
// blocking) on a float or bf16 material stack (CUDA C++, sm_90a): the
// two-step form of fused_step_slab.cu's kernel, which launches it through
// gcm_fused_pair_stream_o<order>. Each stencil order is compiled in a
// source of its own (fused_pair_stream_o1.cu .. _o4.cu, 72 instantiations
// each), so that the build runs them in parallel beside the one-step ones.
//
// Replaces the two-step form of the Pallas TPU kernel gcm_tpu/ops/
// pallas_fused.py::fused_step_slab (:807, call :894): len(axes_seq) == 2,
// a K*r halo and the edge re-patch between the steps (:838), folded
// correctors refused (:862). Its plain PyTorch version is gcm_tpu_torch/
// ops/fused.py::fused_step_slab_reference (fused_step_reference once per
// step on the stack upcast from bf16), which it must match.
//
// What bounds it on an H100: memory, and a pass moves one step's bytes for
// two steps: 88 bytes a point with a float stack (36 state in, 16 compact
// materials, 36 state out), 80 with bf16, 124 / 98 with the orthotropic
// stack (fused_step_slab.cu). The six sweeps' arithmetic stays far below
// the 67 TFLOP/s f32 rate. What a design adds on top: the first step's
// halo, recomputed by every tile, and the few warps a block of this size
// leaves an SM.
//
// What the design does about it (gcm_common.cuh::stream_pair):
// - The one-step body's pipeline twice, chained in shared memory. A block
//   owns a (y, z) tile and walks a chunk of x. The first step (A) runs on
//   the tile with a 2r halo in y and z; each of its output planes, inside
//   the domain only, goes through A's in-plane sweeps after x, the edge
//   re-patch and the second step's (B's) in-plane sweeps before x into a
//   ring of 2r + 1 planes, which B's x sweep reads r planes behind A; B's
//   last sweep stores the tile. So the state and the materials are read
//   once and the state written once a pass; only A's (y, z) halo and 2r
//   planes of A a chunk are recomputed.
// - The edge re-patch: the plain version runs two steps, so B reads A's
//   output edge-replicated. A recomputed on clamped inputs gives the edge
//   value outside the domain only along axes A has not swept yet, so A's
//   output cells outside the domain in y or z are overwritten with their
//   clamped cell before B reads them (patch_edges, only in tiles that reach
//   past an edge), and B's x ring is read at clamped plane indices (A's
//   edge plane stands for the planes outside).
// - Shared memory: ring A, ring B, two plane temporaries and, when an
//   in-plane sweep comes before A's x, two raw planes. At r = 1 an 8 x 16
//   tile takes 65-76 KB for elastic3d, so three blocks of 256 threads (8
//   warps, the 12 x 20 raw window in one pass; 80 registers, no spills)
//   share an SM and one block's barriers overlap the others' sweeps: 8%
//   faster than the one-step body's 8 x 32 tile at one block of 14 warps
//   an SM, and than 16 x 16 (PERF.md §6). At r = 2 a 4 x 32 tile (480
//   threads, one block) keeps every order pair within the 227 KB a block
//   has (132-195 KB).
// - Compile time: the model's component map and both sweep orders (every
//   pair of the six orders, as fused.py::norm_axes_seq lets through), so a
//   cell's components stay in registers; 4 orders x 2 models x 36 pairs =
//   288 instantiations, in four sources. The stack's stored type is a
//   runtime flag (DynMat, a uniform branch at each material load), which
//   halves them; the stack rows stay runtime, so the compact and
//   orthotropic layouts share a path.
// - x chunks are cut by occupancy as for one step, counting the 4r planes
//   of A each chunk stages beyond its own.

#pragma once

#include "gcm_common.cuh"

namespace {

template <int ORDER, class M, class AXA, class AXB>
__global__ void __launch_bounds__(PairTile<ORDER>::NT,
                                  PairLayout<ORDER, M, AXA, AXB>::MINB)
fused_pair_stream_kernel(const float* __restrict__ u, const void* m,
                         int bf16, float* __restrict__ out, int ch,
                         GcmFusedParams p) {
    using T = PairTile<ORDER>;
    extern __shared__ float smem[];
    const int n0 = p.n[0], n1 = p.n[1], n2 = p.n[2];
    const long long N = (long long)n0 * n1 * n2;
    const int xa = (int)blockIdx.z * ch;
    const int xb = min(xa + ch, n0);
    const GlobalSrc src{u, n0, n1, n2, N};
    const DynMat mat{m, n0, n1, n2, N, bf16};
    stream_pair<ORDER, M, AXA, AXB>(p, src, mat, xa, xb,
                                    (int)blockIdx.y * T::TY,
                                    (int)blockIdx.x * T::TZ, smem,
                                    StepOut{out, nullptr, nullptr, N});
}

// Launches one pass (occ == nullptr), or reports the occupancy such a
// launch gets in occ[0] (blocks an SM) and occ[1] (shared memory bytes).
template <int ORDER, class M, class AXA, class AXB>
cudaError_t launch_stream_pair(const float* u, const void* m, int bf16,
                               float* out, const GcmFusedParams& p,
                               int device, cudaStream_t stream, int* occ) {
    using L = PairLayout<ORDER, M, AXA, AXB>;
    using T = PairTile<ORDER>;
    const auto kernel = fused_pair_stream_kernel<ORDER, M, AXA, AXB>;
    int bps = 0;
    cudaError_t err = stream_blocks_per_sm(kernel, L::BYTES, &bps, T::NT);
    if (err != cudaSuccess) return err;
    if (occ != nullptr) {
        occ[0] = bps;
        occ[1] = L::BYTES;
        return cudaSuccess;
    }
    const int nzt = (p.n[2] + T::TZ - 1) / T::TZ;
    const int nyt = (p.n[1] + T::TY - 1) / T::TY;
    const int ch = stream_chunk(p.n[0], (long long)nzt * nyt, 2 * T::R, bps,
                                device);
    const dim3 grid(nzt, nyt, (p.n[0] + ch - 1) / ch);
    kernel<<<grid, T::NT, L::BYTES, stream>>>(u, m, bf16, out, ch, p);
    return cudaGetLastError();
}

// One pass of two full 3D steps (p.axes, then p.axes_next) at stencil
// order ORDER on `stream` of device `device`, compiled for p.model; the
// stack is bf16 when `bf16` is set. With `occ` non-null nothing launches:
// occ[0] gets the resident blocks an SM, occ[1] the shared memory in bytes.
template <int ORDER>
cudaError_t pair_stream(const float* u, const void* mstack, float* out,
                        const GcmFusedParams& p, int bf16, int device,
                        cudaStream_t stream, int* occ) {
    return with_model(p.model, [&](auto mdl) {
        return with_axes(p.axes, [&](auto axa) {
            return with_axes(p.axes_next, [&](auto axb) {
                return launch_stream_pair<ORDER, decltype(mdl), decltype(axa),
                                          decltype(axb)>(
                    u, mstack, bf16, out, p, device, stream, occ);
            });
        });
    });
}

}  // namespace

// The entry points of the four sources, called by fused_step_slab.cu,
// which checks the extents and refuses folded correctors; each returns
// the CUDA error code (0 on success).
#define GCM_PAIR_STREAM_ENTRY(ORDER)                                         \
    extern "C" int gcm_fused_pair_stream_o##ORDER(                           \
        const float* u, const void* mstack, float* out,                      \
        const GcmFusedParams* params, int mat_bf16, int device,              \
        void* stream, int* occ)
