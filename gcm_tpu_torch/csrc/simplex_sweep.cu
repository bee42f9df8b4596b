// One characteristic sweep along one axis of a simplex (tri/tet) mesh
// (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel
// gcm_tpu/ops/pallas_simplex.py::fused_simplex_sweep (body
// _make_sweep_kernel, plan build_fused_simplex_plan). It computes what that
// kernel computes, on the foot tables as they are: for each pair (sigma, v)
// of the sweep, both fields interpolated at the pair's two feet,
// sum_k w[t,n,k] * u[c, ids[t,n,k]] in float32 in k order; the invariants
// w_l = A + s*z*B, w_r = A - s*z*B; where a foot left the hull, the incoming
// invariant rebuilt by the border algebra (one kind for the whole hull, or
// the node's own code and value for the pair's traction axis); then
// A = (w_l + w_r)/2, B = s*(w_l - w_r)/(2*max(z, 1e-30)) where z > 0, the
// zero-speed stresses via kappa, and every other component copied. Its
// plain PyTorch version is ops/simplex.py::simplex_sweep_reference.
//
// What bounds it on an H100: memory, and the gathers' locality. Per node a
// 3D elastic order-1 sweep reads 4 tables of K=4 (ids and weights: 128
// bytes) and their 4 outside flags, its own 9 components, 3 material rows,
// and writes 9 components: about 200 bytes of streams per node, plus 48
// gathered values whose rows neighbouring nodes share, which L1/L2 serve
// (the whole 274,625-node state is 10 MB).
//
// What the design does about it:
// - One thread per node, consecutive threads on consecutive nodes, so the
//   state, material and flag streams are coalesced; a box mesh's lexical
//   node order keeps a warp's gathers within a few rows of the state.
// - No padding, row blocks or lane rolls: those are TPU layout. The tables
//   are read uncompressed, so a mesh of any numbering takes this path.
// - K is a template parameter for the table widths the meshes have (3 and 4
//   at order 1, 10 and 16 at order 2) and a runtime value otherwise.
// - The border algebra is the cubic kernels' bc_incoming (gcm_common.cuh):
//   a foot leaving through +direction is the cubic grid's high face (side
//   1, w_l rebuilt from w_r), through -direction its low face (side 0).
// - The output is a separate buffer: the gathers read the input state.

#include "gcm_common.cuh"

// Mirrors ctypes structure _SimplexParams in gcm_tpu_torch/ops/simplex.py
// (pointers first, then 4-byte fields; the binding checks the size).
struct GcmSimplexParams {
    const int* ids;              // [T, N, K] this sweep's tables
    const float* weights;        // [T, N, K]
    const unsigned char* outside;  // [T, N] 1 where the foot left the hull
    const float* mats;           // [3, N]: zp, zs, kappa
    const int* code;             // [N] per-node border kinds (bc_kind < 0)
    const float* val;            // [dim, N] per-node values of this axis,
                                 // by traction axis (bc_kind < 0)
    int N;
    int K;
    int ncomp;
    int sign;                    // +1 elastic, -1 acoustic
    int npairs;                  // pairs with tables (a fluid has no S)
    int pair_sigma[MAXP];
    int pair_vel[MAXP];
    int pair_tp[MAXP];           // table of the +1 foot
    int pair_tm[MAXP];           // table of the -1 foot
    int pair_zrow[MAXP];         // mats row of the impedance
    int pair_traction[MAXP];
    int nzeros;
    int zero_comp[MAXZ];
    int zero_src[MAXZ];
    int kappa_row;
    int bc_kind;                 // -1 per node, else 0 absorbing, 1 free,
                                 // 2 fixed_force, 3 fixed_velocity
    float bc_val[MAXP];          // uniform kind: each pair's value
};

namespace {

constexpr int NTHREADS_SIMPLEX = 256;

// sum_k w[k] * u[c, ids[k]] for components ca and cb over table t's row n
template <int KT>
__device__ __forceinline__ void interp_pair(
        const GcmSimplexParams& p, const float* __restrict__ u, long long N,
        int t, long long n, int ca, int cb, float& a, float& b) {
    const int K = KT > 0 ? KT : p.K;
    const long long row = ((long long)t * N + n) * K;
    const int* __restrict__ ids = p.ids + row;
    const float* __restrict__ w = p.weights + row;
    const float* ua = u + (long long)ca * N;
    const float* ub = u + (long long)cb * N;
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int j = __ldg(ids + k);
        const float wk = __ldg(w + k);
        sa += wk * __ldg(ua + j);
        sb += wk * __ldg(ub + j);
    }
    a = sa;
    b = sb;
}

template <int KT>
__global__ void __launch_bounds__(NTHREADS_SIMPLEX)
simplex_sweep_kernel(const float* __restrict__ u, float* __restrict__ out,
                     GcmSimplexParams p) {
    const long long N = p.N;
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;

    float old[MAXC], nw[MAXC];
    for (int c = 0; c < p.ncomp; ++c) {
        old[c] = __ldg(u + c * N + n);
        nw[c] = old[c];
    }
    for (int q = 0; q < p.npairs; ++q) {
        const int sg = p.pair_sigma[q];
        const int vl = p.pair_vel[q];
        const int tp = p.pair_tp[q], tm = p.pair_tm[q];
        float sp, vp, sm, vm;
        interp_pair<KT>(p, u, N, tp, n, sg, vl, sp, vp);
        interp_pair<KT>(p, u, N, tm, n, sg, vl, sm, vm);
        const float z = __ldg(p.mats + p.pair_zrow[q] * N + n);
        const float szb = (float)p.sign * z;
        float wl = sp + szb * vp;
        float wr = sm - szb * vm;
        const bool out_p = __ldg(p.outside + tp * N + n) != 0;
        const bool out_m = __ldg(p.outside + tm * N + n) != 0;
        if (out_p || out_m) {
            int kind;
            float v;
            if (p.bc_kind >= 0) {
                kind = p.bc_kind;
                v = p.bc_val[q];
            } else {
                kind = __ldg(p.code + n);
                v = __ldg(p.val + p.pair_traction[q] * N + n);
            }
            const float wl0 = wl, wr0 = wr;
            if (out_p) wl = bc_incoming(kind, v, wr0, p.sign, z, 1);
            if (out_m) wr = bc_incoming(kind, v, wl0, p.sign, z, 0);
        }
        nw[sg] = 0.5f * (wl + wr);
        nw[vl] = z > 0.0f
            ? (float)p.sign * (wl - wr) / (2.0f * fmaxf(z, 1e-30f))
            : old[vl];
    }
    if (p.nzeros > 0) {
        const float kap = __ldg(p.mats + p.kappa_row * N + n);
        for (int j = 0; j < p.nzeros; ++j) {
            const int zc = p.zero_comp[j], zs = p.zero_src[j];
            nw[zc] = old[zc] + kap * (nw[zs] - old[zs]);
        }
    }
    for (int c = 0; c < p.ncomp; ++c) out[c * N + n] = nw[c];
}

template <int KT>
cudaError_t launch_simplex(const float* u, float* out,
                           const GcmSimplexParams& p, cudaStream_t stream) {
    const long long blocks =
        ((long long)p.N + NTHREADS_SIMPLEX - 1) / NTHREADS_SIMPLEX;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    simplex_sweep_kernel<KT><<<(unsigned)blocks, NTHREADS_SIMPLEX, 0,
                               stream>>>(u, out, p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one sweep on `stream` of device `device`; returns the CUDA error
// code of the launch (0 on success). The caller allocates `out` and checks
// shapes, types, contiguity and every pointer of the parameters.
int gcm_simplex_sweep(const float* u, float* out,
                      const GcmSimplexParams* params, int device,
                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (params->N <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (params->K) {
        case 3: return (int)launch_simplex<3>(u, out, *params, s);
        case 4: return (int)launch_simplex<4>(u, out, *params, s);
        case 10: return (int)launch_simplex<10>(u, out, *params, s);
        case 16: return (int)launch_simplex<16>(u, out, *params, s);
        default: return (int)launch_simplex<0>(u, out, *params, s);
    }
}

// sizeof(GcmSimplexParams), so the binding can check its mirror of the layout
int gcm_simplex_params_size(void) { return (int)sizeof(GcmSimplexParams); }

}  // extern "C"
