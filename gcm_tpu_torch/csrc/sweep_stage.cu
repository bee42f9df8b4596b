// One characteristic sweep along one axis of a 2D or 3D state (CUDA C++,
// sm_90a).
//
// Replaces the Pallas TPU kernel gcm_tpu/ops/pallas_stage.py::pallas_stage
// (body _make_sweep_kernel, border rows _apply_bc_row, edge patch
// _patch_halo). Its plain PyTorch version is solver/gcm.py::stage, which
// ops/sweep.py::sweep_stage runs for CPU tensors and which it must match.
// Stencil weights and the border algebra are the fused kernels'
// (gcm_common.cuh).
//
// What bounds it on an H100: memory. Per point an elastic3d sweep reads the
// 9 state components, each pair's speed and impedance fields (2 distinct
// fields of each for the P and S families) and kappa, and writes all 9
// components: 14*4 = 56 bytes in and 36 out, about 92 bytes per point and
// sweep, 276 per step of three sweeps against the fused step's 88. With
// orthotropic media the views share fewer fields: every pair has its own
// speed and impedance and every zero its own ratio, 3 + 3 + 2 = 8 fields,
// 104 bytes a point and sweep. The
// shifted stencil taps re-read neighbouring cells, which L1/L2 serve.
//
// What the design does about it:
// - One thread per cell, consecutive threads on consecutive cells of the
//   contiguous (last) axis, so every tap of a warp is one coalesced row
//   segment; taps along the sweep axis are index-clamped reads (the
//   reference's edge_pad), so no halo is staged and any extent works.
// - c, z and kappa are read from the per-axis material fields
//   (MaterialFields or OrthotropicMaterialFields .axis_view, computed once
//   at an engine's setup) as pallas_stage reads them, not derived from a
//   stack; B is reconstructed as sign*(wl-wr)/(2*max(z,1e-30)) where
//   z > 0, as pallas_stage does.
// - The kernel writes the whole new state: components the sweep does not
//   touch are copied, so a step is a chain of launches on fresh buffers.

#include "gcm_common.cuh"

// Mirrors ctypes structure _SweepParams in gcm_tpu_torch/ops/sweep.py
// (pointers first, then 4-byte fields; the binding checks the size).
struct GcmSweepParams {
    const float* pair_c[MAXP];   // per pair: wave speed field
    const float* pair_z[MAXP];   // per pair: impedance field
    const float* zero_kappa[MAXZ];
    int n[3];                    // nx, ny, nz (nz = 1 for a 2D grid)
    int ncomp;
    int sign;                    // +1 elastic, -1 acoustic
    int axis;                    // sweep axis
    int npairs;
    int pair_sigma[MAXP];
    int pair_vel[MAXP];
    int nzeros;
    int zero_comp[MAXZ];
    int zero_src[MAXZ];
    int bc_kind[2];              // -1 none, else as GcmFusedParams
    float bc_val[2][MAXP];
    float dtoh;                  // dt / h along the axis
};

namespace {

constexpr int NTHREADS_SWEEP = 256;

template <int ORDER>
__global__ void __launch_bounds__(NTHREADS_SWEEP)
sweep_stage_kernel(const float* __restrict__ u, float* __restrict__ out,
                   GcmSweepParams p) {
    using S = Stencil<ORDER>;
    const long long N = (long long)p.n[0] * p.n[1] * p.n[2];
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N) return;
    const int a = p.axis;
    const long long stride =
        a == 0 ? (long long)p.n[1] * p.n[2] : (a == 1 ? p.n[2] : 1);
    const int na = p.n[a];
    const int ga = (int)((idx / stride) % na);

    float old[MAXC], nw[MAXC];
    for (int c = 0; c < p.ncomp; ++c) {
        old[c] = __ldg(u + c * N + idx);
        nw[c] = old[c];
    }
    for (int q = 0; q < p.npairs; ++q) {
        const int sg = p.pair_sigma[q];
        const int vl = p.pair_vel[q];
        const float c = __ldg(p.pair_c[q] + idx);
        const float z = __ldg(p.pair_z[q] + idx);
        float w[S::NP];
        S::weights(c * p.dtoh, w);
        float Ap = 0.f, Bp = 0.f, Am = 0.f, Bm = 0.f;
#pragma unroll
        for (int t = 0; t < S::NP; ++t) {
            const int o = t + S::LO;
            const long long ip =
                idx + (long long)(min(max(ga + o, 0), na - 1) - ga) * stride;
            const long long im =
                idx + (long long)(min(max(ga - o, 0), na - 1) - ga) * stride;
            Ap += w[t] * __ldg(u + sg * N + ip);
            Bp += w[t] * __ldg(u + vl * N + ip);
            Am += w[t] * __ldg(u + sg * N + im);
            Bm += w[t] * __ldg(u + vl * N + im);
        }
        const float szb = (float)p.sign * z;
        float wl = Ap + szb * Bp;
        float wr = Am - szb * Bm;
        if (ga == 0 && p.bc_kind[0] >= 0)
            wr = bc_incoming(p.bc_kind[0], p.bc_val[0][q], wl, p.sign, z, 0);
        if (ga == na - 1 && p.bc_kind[1] >= 0)
            wl = bc_incoming(p.bc_kind[1], p.bc_val[1][q], wr, p.sign, z, 1);
        nw[sg] = 0.5f * (wl + wr);
        nw[vl] = z > 0.0f
            ? (float)p.sign * (wl - wr) / (2.0f * fmaxf(z, 1e-30f))
            : old[vl];
    }
    for (int j = 0; j < p.nzeros; ++j) {
        const int zc = p.zero_comp[j], zs = p.zero_src[j];
        nw[zc] = old[zc] + __ldg(p.zero_kappa[j] + idx) * (nw[zs] - old[zs]);
    }
    for (int c = 0; c < p.ncomp; ++c) out[c * N + idx] = nw[c];
}

template <int ORDER>
cudaError_t launch_sweep(const float* u, float* out, const GcmSweepParams& p,
                         cudaStream_t stream) {
    const long long N = (long long)p.n[0] * p.n[1] * p.n[2];
    const long long blocks = (N + NTHREADS_SWEEP - 1) / NTHREADS_SWEEP;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    sweep_stage_kernel<ORDER><<<(unsigned)blocks, NTHREADS_SWEEP, 0, stream>>>(
        u, out, p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one sweep on `stream` of device `device`; returns the CUDA error
// code of the launch (0 on success). The caller allocates `out` and checks
// shapes, types, contiguity and the material field pointers.
int gcm_sweep_stage(const float* u, float* out, const GcmSweepParams* params,
                    int order, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    switch (order) {
        case 1: return (int)launch_sweep<1>(u, out, *params, s);
        case 2: return (int)launch_sweep<2>(u, out, *params, s);
        case 3: return (int)launch_sweep<3>(u, out, *params, s);
        case 4: return (int)launch_sweep<4>(u, out, *params, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// sizeof(GcmSweepParams), so the binding can check its mirror of the layout
int gcm_sweep_params_size(void) { return (int)sizeof(GcmSweepParams); }

}  // extern "C"
