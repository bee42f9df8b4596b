// The fused 2D step on one shard of a grid split along x (CUDA C++,
// sm_90a), as two launches: the interior rows and the ring rows, on a
// float or bf16 material stack.
//
// Replaces the Pallas TPU kernel gcm_tpu/parallel/fused_spmd.py::
// _make_2d_spmd_call (which="interior" and "ring", built by _pallas_build).
// Its plain PyTorch version is gcm_tpu_torch/ops/fused_spmd.py::
// fused_spmd_2d_reference, which it must match. The step is the
// single-card 2D kernel's (gcm_common.cuh::stream_rows: x walked row by row
// through a ring of rows in registers, rows staged with cp.async, the
// component map compiled), with the rows and materials from the shard's
// own sources.
//
// What bounds it on an H100: memory, as fused_step_2d. Per point of the
// shard elastic2d reads 5 state components and 4 material fields and writes
// 5 components, about 56 bytes against 3.35 TB/s; the ring launch adds its
// two r-row x slabs (C * 2r * ny floats) and the halo rows of the material
// stack. An orthotropic stack has 6 fields instead of 4 (64 bytes a point).
//
// What the design does about it:
// - A tile is one x row (TILE_2D = 1 of ops/fused_spmd.py;
//   gcm_fused_spmd_2d_tile), so the interior is every row r or more from
//   the shard's x faces, [r, nxl - r), and the ring the r rows at each x
//   face: under 1% of a 512-row shard (the earlier 32-row box tiles made it
//   ~19%). y, the contiguous axis, is never split: it is walked in strips
//   of 128 - 2r columns and clamps at the domain faces, where its borders
//   always apply.
// - The interior launch walks chunks of its rows (cut by occupancy,
//   stream_chunk); it reads only the local block and the materials, so it
//   runs while the slabs travel. The ring launch has two blocks a strip,
//   one for each face's r rows (one for the whole block when the shard is
//   too thin for an interior, nxl <= 2r); its rows come through SlabSrc,
//   staged with cp.async from the local block inside and the received
//   slabs xlo/xhi (C, r, ny) beyond it, and it writes into the interior
//   launch's output buffer: the rows are disjoint.
// - Materials come from the shard's x-extended stack (nm, nxl+2r, ny),
//   stored as float or bf16 (a runtime flag, DynMat with e0 = r) and upcast
//   at the load; a bf16 stack cuts a point's bytes from 56 to 48. The
//   TPU's 8-row slab depth (H2) and its nxl % 8 rule are gone: r rows, any
//   extents.
// - x borders apply only on the ring's first or last row, where the shard
//   sits on that domain face; the binding folds the face flags into each
//   launch's border kinds. The 2D step folds no correctors, as in JAX.
// - 4 orders x 2 models x 2 sweep orders x interior/ring = 32
//   instantiations.

#include "gcm_common.cuh"

namespace {

// Rows [xa, xb) of block k of a launch: the interior's chunk k of ch rows,
// or the ring's face band k (0: rows [0, ix0); 1: rows [ix1, n0), which is
// the whole block when the interior is empty, ix0 = ix1 = 0).
template <bool RING>
__device__ inline void rows_of(int k, int ix0, int ix1, int n0, int ch,
                               int* xa, int* xb) {
    if (RING) {
        *xa = k == 0 ? 0 : ix1;
        *xb = k == 0 ? ix0 : n0;
    } else {
        *xa = ix0 + k * ch;
        *xb = min(*xa + ch, ix1);
    }
}

template <int ORDER, class M, bool XFIRST, bool RING>
__global__ void __launch_bounds__(ROWS_NT, RowTile<ORDER>::MINB)
fused_spmd_rows_kernel(const float* __restrict__ u, const void* mext,
                       int bf16, float* __restrict__ out,
                       const float* __restrict__ xlo,
                       const float* __restrict__ xhi, int ix0, int ix1,
                       int ch, int vec, GcmFusedParams p) {
    extern __shared__ __align__(16) float smem[];
    constexpr int R = Stencil<ORDER>::R;
    const int n0 = p.n[0], n1 = p.n[1];
    int xa, xb;
    rows_of<RING>((int)blockIdx.y, ix0, ix1, n0, ch, &xa, &xb);
    if (xa >= xb) return;
    const long long N = (long long)n0 * n1;
    const DynMat mat{mext, n0, n1, 1, (long long)(n0 + 2 * R) * n1, bf16, R};
    const StepOut so{out, nullptr, nullptr, N};
    const int y0 = (int)blockIdx.x * RowTile<ORDER>::TY;
    if constexpr (RING) {
        const SlabSrc src{u, xlo, xhi, nullptr, nullptr, n0, n1, 1, R, N};
        stream_rows<ORDER, M, XFIRST>(p, src, mat, xa, xb, y0, smem, so,
                                      vec != 0);
    } else {
        const GlobalSrc src{u, n0, n1, 1, N};
        stream_rows<ORDER, M, XFIRST>(p, src, mat, xa, xb, y0, smem, so,
                                      vec != 0);
    }
}

// Launches the interior or the ring rows (occ == nullptr), or reports the
// occupancy such a launch gets.
template <int ORDER, class M, bool XFIRST, bool RING>
cudaError_t launch_spmd_rows(const float* u, const void* mext, int bf16,
                             float* out, const float* xlo, const float* xhi,
                             int ix0, int ix1, const GcmFusedParams& p,
                             int device, cudaStream_t stream,
                             StreamOccupancy* occ) {
    using L = RowLayout<ORDER, M::C, XFIRST>;
    const auto kernel = fused_spmd_rows_kernel<ORDER, M, XFIRST, RING>;
    int bps = 0;
    cudaError_t err = stream_blocks_per_sm(kernel, L::BYTES, &bps, ROWS_NT);
    if (err != cudaSuccess) return err;
    if (occ != nullptr) {
        *occ = StreamOccupancy{bps, L::BYTES};
        return cudaSuccess;
    }
    const int nst = (p.n[1] + RowTile<ORDER>::TY - 1) / RowTile<ORDER>::TY;
    int ch = 0, nblk = 2;
    if (!RING) {
        const int len = ix1 - ix0;
        if (len <= 0) return cudaSuccess;
        ch = stream_chunk(len, nst, Stencil<ORDER>::R, bps, device);
        nblk = (len + ch - 1) / ch;
    }
    const int vec = p.n[1] % 4 == 0 && aligned16(u) &&
                    (!RING || (aligned16(xlo) && aligned16(xhi)));
    const dim3 grid(nst, nblk);
    kernel<<<grid, ROWS_NT, L::BYTES, stream>>>(u, mext, bf16, out, xlo, xhi,
                                                ix0, ix1, ch, vec, p);
    return cudaGetLastError();
}

// The interior (RING false) or ring launch, or its occupancy (occ).
template <bool RING>
cudaError_t dispatch_spmd_rows(int order, const float* u, const void* mext,
                               int bf16, float* out, const float* xlo,
                               const float* xhi, int ix0, int ix1,
                               const GcmFusedParams& p, int device,
                               cudaStream_t s, StreamOccupancy* occ) {
    return with_rows(order, p, [&](auto o, auto mdl, auto xfirst) {
        return launch_spmd_rows<decltype(o)::value, decltype(mdl),
                                decltype(xfirst)::value, RING>(
            u, mext, bf16, out, xlo, xhi, ix0, ix1, p, device, s, occ);
    });
}

}  // namespace

extern "C" {

// Launches the interior (ring = 0) or the ring (ring = 1) rows of one
// shard's fused 2D step, params->n = {nxl, ny, 1}, compiled for
// params->model. `mext` is the shard's x-extended stack (nm, nxl+2r, ny);
// the slabs xlo/xhi (C, r, ny) are read by the ring launch only. The
// interior rows are [ix0, ix1) (ops/fused_spmd.py::tile_split with
// TILE_2D = 1; both 0 when empty). The stack is bf16 when `mat_bf16` is
// set, float otherwise. Returns the CUDA error code of the launch (0 on
// success).
int gcm_fused_spmd_2d(const float* u, const void* mext, float* out,
                      const float* xlo, const float* xhi, int ix0, int ix1,
                      int ring, const GcmFusedParams* params, int order,
                      int mat_bf16, int device, void* stream) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    if (ring)
        return (int)dispatch_spmd_rows<true>(order, u, mext, mat_bf16, out,
                                             xlo, xhi, ix0, ix1, *params,
                                             device, s, nullptr);
    return (int)dispatch_spmd_rows<false>(order, u, mext, mat_bf16, out, xlo,
                                          xhi, ix0, ix1, *params, device, s,
                                          nullptr);
}

// The occupancy the interior (ring = 0) or ring (ring = 1) launch with
// these parameters gets: out[0] resident blocks an SM, out[1] its dynamic
// shared memory in bytes.
int gcm_fused_spmd_2d_occupancy(const GcmFusedParams* params, int order,
                                int ring, int device, int* out) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    StreamOccupancy occ{0, 0};
    err = ring ? dispatch_spmd_rows<true>(order, nullptr, nullptr, 0,
                                          nullptr, nullptr, nullptr, 0, 0,
                                          *params, device, nullptr, &occ)
               : dispatch_spmd_rows<false>(order, nullptr, nullptr, 0,
                                           nullptr, nullptr, nullptr, 0, 0,
                                           *params, device, nullptr, &occ);
    out[0] = occ.blocks_per_sm;
    out[1] = occ.smem_bytes;
    return (int)err;
}

// The output tile's extent along x: one row.
int gcm_fused_spmd_2d_tile(void) { return 1; }

}  // extern "C"
