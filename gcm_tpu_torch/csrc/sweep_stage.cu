// One characteristic sweep along one axis of a 2D or 3D state (CUDA C++,
// sm_90a).
//
// Replaces the Pallas TPU kernel gcm_tpu/ops/pallas_stage.py::pallas_stage
// (:366, call :478; body _make_sweep_kernel, border rows _apply_bc_row,
// edge patch _patch_halo). Its plain PyTorch version is solver/gcm.py::
// stage, which ops/sweep.py::sweep_stage runs for CPU tensors and which it
// must match. Stencil weights, the border algebra and the component maps
// are the fused kernels' (gcm_common.cuh).
//
// What bounds it on an H100: memory. Per point an elastic3d sweep reads the
// 9 state components, each pair's speed and impedance fields (2 distinct
// fields of each for the P and S families) and kappa, and writes all 9
// components: 14*4 = 56 bytes in and 36 out, about 92 bytes per point and
// sweep, 276 per step of three sweeps against the fused step's 88. With
// orthotropic media the views share fewer fields: every pair has its own
// speed and impedance and every zero its own ratio, 3 + 3 + 2 = 8 fields,
// 104 bytes a point and sweep.
//
// What the design does about it:
// - The model's component map (elastic3d, acoustic3d, elastic2d,
//   acoustic2d) and the sweep axis are compile time, so a cell's values
//   stay in registers; the binding holds the runtime model to the compiled
//   map (gcm_model_map) and refuses any other model.
// - The state is read as (C, outer, na, inner): na cells along the sweep
//   axis, inner contiguous cells between two of them. A block stages the
//   2 * NPAIRS components the sweep interpolates, for its tile and an r
//   halo along the axis at clamped indices (the plain version's edge_pad),
//   into shared memory with cp.async, and every tap comes from there, so
//   each byte of them leaves device memory once (the halo rows of
//   neighbouring tiles are L2 hits):
//   - along a strided axis (x, and y of a 3D state): 16 rows of the axis
//     by 64 contiguous cells, 16-byte copies where aligned; a thread takes
//     a vector of 4 contiguous cells in 2 rows and reads each tap row as
//     one vector;
//   - along the contiguous axis (z of a 3D state, y of a 2D one): 16 rows
//     by a 64-cell segment of the axis with its r halo at both ends, 4-byte
//     copies; a thread reads the 4 + 2r cells around its vector of a
//     component once.
// - The components the sweep does not interpolate (the zero-speed
//   invariants and the untouched ones) and the material views go from
//   device memory through registers, as 16-byte vectors when the extents
//   allow (N and the contiguous run multiples of 4, every pointer 16-byte
//   aligned), else one float a thread (ragged extents); each result is
//   stored as soon as it is computed.
// - c, z and kappa are read from the per-axis material views (MaterialFields
//   or OrthotropicMaterialFields .axis_view, computed once at an engine's
//   setup) as pallas_stage reads them, not derived from a stack; B is
//   reconstructed as sign*(wl-wr)/(2*max(z,1e-30)) where z > 0, as
//   pallas_stage does.
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
    int axis;                    // sweep axis
    int model;                   // compiled component map (*_MODEL_*)
    int bc_kind[2];              // -1 none, else as GcmFusedParams
    float bc_val[2][MAXP];
    float dtoh;                  // dt / h along the axis
};

namespace {

constexpr int SWEEP_NT = 128;
// strided axis: rows along the axis x contiguous cells a block computes
constexpr int SWEEP_TA = 16, SWEEP_TI = 64;
// contiguous axis: rows x cells along the axis a block computes
constexpr int SWEEP_TR = 16, SWEEP_TC = 64;

// The state as (C, outer, na, inner) and the block grid over it.
struct SweepGeom {
    long long N;
    int outer, na, inner;
    int ntc;                     // tiles across (contiguous cells or rows)
    int nta;                     // tiles along the axis
};

template <int V>
struct Vec {
    float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> ldv(const float* p) {
    Vec<V> r;
    if constexpr (V == 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p));
        r.v[0] = f.x;
        r.v[1] = f.y;
        r.v[2] = f.z;
        r.v[3] = f.w;
    } else {
        r.v[0] = __ldg(p);
    }
    return r;
}

template <int V>
__device__ __forceinline__ void stv(float* p, const float (&a)[V]) {
    if constexpr (V == 4)
        *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
    else
        *p = a[0];
}

// The component staged in shared-memory slot s of a sweep along A: pair
// s / 2's stress for even s, its velocity for odd s.
template <class M, int A>
__host__ __device__ constexpr int slot_comp(int s) {
    return s % 2 == 0 ? M::sigma(A, s / 2) : M::vel(A, s / 2);
}

// Whether a sweep along A leaves component c as it is.
template <class M, int A>
__host__ __device__ constexpr bool untouched(int c) {
    for (int s = 0; s < 2 * M::NPAIRS; ++s)
        if (slot_comp<M, A>(s) == c) return false;
    for (int j = 0; j < M::NZEROS; ++j)
        if (M::zcomp(A, j) == c) return false;
    return true;
}

template <int ORDER, class M, int A, int V>
__global__ void __launch_bounds__(SWEEP_NT)
sweep_stage_kernel(const float* __restrict__ u, float* __restrict__ out,
                   GcmSweepParams p, SweepGeom g) {
    using S = Stencil<ORDER>;
    constexpr int R = S::R, NS = 2 * M::NPAIRS, SIGN = M::SIGN;
    constexpr bool CONTIG = A == M::DIM - 1;
    // a staged slot: E0 rows of E1 cells
    constexpr int E0 = CONTIG ? SWEEP_TR : SWEEP_TA + 2 * R;
    constexpr int E1 = CONTIG ? SWEEP_TC + 2 * R : SWEEP_TI;
    constexpr int LANES = (CONTIG ? SWEEP_TC : SWEEP_TI) / V;
    constexpr int GROUPS = SWEEP_NT / LANES;
    __shared__ __align__(16) float sm[NS * E0 * E1];
    const long long N = g.N;
    const int na = g.na;

    // the tile: rows [r0, r0 + TR) x axis cells [a0, a0 + TC) (contiguous),
    // or axis rows [a0, a0 + TA) x cells [i0, i0 + TI) of outer slab o
    int b = (int)blockIdx.x, a0, r0 = 0, i0 = 0;
    long long base = 0;
    if constexpr (CONTIG) {
        a0 = (b % g.nta) * SWEEP_TC;
        r0 = (b / g.nta) * SWEEP_TR;
        for (int e = threadIdx.x; e < E0 * E1; e += SWEEP_NT) {
            const int r = e / E1, k = e - r * E1;
            if (r0 + r >= g.outer) continue;
            const int a = min(max(a0 - R + k, 0), na - 1);
            const float* src = u + (long long)(r0 + r) * na + a;
#pragma unroll
            for (int s = 0; s < NS; ++s)
                cp_async4(sm + s * E0 * E1 + e,
                          src + slot_comp<M, A>(s) * N);
        }
    } else {
        i0 = (b % g.ntc) * SWEEP_TI;
        b /= g.ntc;
        a0 = (b % g.nta) * SWEEP_TA;
        base = (long long)(b / g.nta) * na * g.inner;
        for (int e = threadIdx.x; e < E0 * LANES; e += SWEEP_NT) {
            const int r = e / LANES, l = e - r * LANES;
            const int i = i0 + l * V;
            if (i >= g.inner) continue;
            const int a = min(max(a0 - R + r, 0), na - 1);
            const float* src = u + base + (long long)a * g.inner + i;
            float* dst = sm + r * E1 + l * V;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                if constexpr (V == 4)
                    cp_async16(dst + s * E0 * E1,
                               src + slot_comp<M, A>(s) * N);
                else
                    cp_async4(dst + s * E0 * E1,
                              src + slot_comp<M, A>(s) * N);
            }
        }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    const int l = threadIdx.x % LANES;
    for (int r = threadIdx.x / LANES; r < (CONTIG ? SWEEP_TR : SWEEP_TA);
         r += GROUPS) {
        // the vector's first cell: its offset, and its row along the axis
        long long off;
        int ga;
        if constexpr (CONTIG) {
            ga = a0 + l * V;
            if (r0 + r >= g.outer || ga >= na) continue;
            off = (long long)(r0 + r) * na + ga;
        } else {
            ga = a0 + r;
            const int i = i0 + l * V;
            if (ga >= na || i >= g.inner) continue;
            off = base + (long long)ga * g.inner + i;
        }
        // tap[t][e]: cell e of the vector at offset t - R along the axis
        const auto taps = [&](int s, float (&tap)[2 * R + 1][V]) {
            const float* sl = sm + s * E0 * E1;
            if constexpr (CONTIG) {
                float w[V + 2 * R];
#pragma unroll
                for (int j = 0; j < V + 2 * R; ++j)
                    w[j] = sl[r * E1 + l * V + j];
#pragma unroll
                for (int t = 0; t <= 2 * R; ++t)
#pragma unroll
                    for (int e = 0; e < V; ++e) tap[t][e] = w[t + e];
            } else {
#pragma unroll
                for (int t = 0; t <= 2 * R; ++t) {
                    const float* row = sl + (r + t) * E1 + l * V;
                    if constexpr (V == 4) {
                        const float4 f = *reinterpret_cast<const float4*>(row);
                        tap[t][0] = f.x;
                        tap[t][1] = f.y;
                        tap[t][2] = f.z;
                        tap[t][3] = f.w;
                    } else {
                        tap[t][0] = row[0];
                    }
                }
            }
        };
        float dsrc[V];           // the zero-speed invariants' source change
#pragma unroll
        for (int q = 0; q < M::NPAIRS; ++q) {
            float ts[2 * R + 1][V], tv[2 * R + 1][V];
            taps(2 * q, ts);
            taps(2 * q + 1, tv);
            const Vec<V> c = ldv<V>(p.pair_c[q] + off);
            const Vec<V> z = ldv<V>(p.pair_z[q] + off);
            float ns[V], nv[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
                float w[S::NP];
                S::weights(c.v[e] * p.dtoh, w);
                float Ap = 0.f, Bp = 0.f, Am = 0.f, Bm = 0.f;
#pragma unroll
                for (int t = 0; t < S::NP; ++t) {
                    const int o = t + S::LO;
                    Ap += w[t] * ts[R + o][e];
                    Bp += w[t] * tv[R + o][e];
                    Am += w[t] * ts[R - o][e];
                    Bm += w[t] * tv[R - o][e];
                }
                const float zz = z.v[e];
                const float szb = (float)SIGN * zz;
                float wl = Ap + szb * Bp;
                float wr = Am - szb * Bm;
                const int gae = CONTIG ? ga + e : ga;
                if (gae == 0 && p.bc_kind[0] >= 0)
                    wr = bc_incoming(p.bc_kind[0], p.bc_val[0][q], wl, SIGN,
                                     zz, 0);
                if (gae == na - 1 && p.bc_kind[1] >= 0)
                    wl = bc_incoming(p.bc_kind[1], p.bc_val[1][q], wr, SIGN,
                                     zz, 1);
                ns[e] = 0.5f * (wl + wr);
                nv[e] = zz > 0.0f
                    ? (float)SIGN * (wl - wr) / (2.0f * fmaxf(zz, 1e-30f))
                    : tv[R][e];
                if (M::sigma(A, q) == M::zsrc(A)) dsrc[e] = ns[e] - ts[R][e];
            }
            stv<V>(out + M::sigma(A, q) * N + off, ns);
            stv<V>(out + M::vel(A, q) * N + off, nv);
        }
#pragma unroll
        for (int j = 0; j < M::NZEROS; ++j) {
            const Vec<V> old = ldv<V>(u + M::zcomp(A, j) * N + off);
            const Vec<V> k = ldv<V>(p.zero_kappa[j] + off);
            float nw[V];
#pragma unroll
            for (int e = 0; e < V; ++e) nw[e] = old.v[e] + k.v[e] * dsrc[e];
            stv<V>(out + M::zcomp(A, j) * N + off, nw);
        }
#pragma unroll
        for (int cc = 0; cc < M::C; ++cc) {
            if (!untouched<M, A>(cc)) continue;
            stv<V>(out + cc * N + off, ldv<V>(u + cc * N + off).v);
        }
    }
}

template <int ORDER, class M, int A, int V>
cudaError_t launch_sweep(const float* u, float* out, const GcmSweepParams& p,
                         const SweepGeom& g, cudaStream_t stream) {
    constexpr bool CONTIG = A == M::DIM - 1;
    const long long blocks =
        CONTIG ? (long long)g.ntc * g.nta : (long long)g.ntc * g.nta * g.outer;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (blocks == 0) return cudaSuccess;
    sweep_stage_kernel<ORDER, M, A, V><<<(unsigned)blocks, SWEEP_NT, 0,
                                         stream>>>(u, out, p, g);
    return cudaGetLastError();
}

template <int ORDER, class M, int A>
cudaError_t dispatch_vector(const float* u, float* out,
                            const GcmSweepParams& p, cudaStream_t s) {
    constexpr bool CONTIG = A == M::DIM - 1;
    long long outer = 1, inner = 1;
    for (int d = 0; d < A; ++d) outer *= p.n[d];
    for (int d = A + 1; d < M::DIM; ++d) inner *= p.n[d];
    if (outer * p.n[A] >= (1LL << 31) || inner >= (1LL << 31))
        return cudaErrorInvalidValue;
    SweepGeom g;
    g.N = outer * p.n[A] * inner;
    g.outer = (int)outer;
    g.na = p.n[A];
    g.inner = (int)inner;
    g.ntc = CONTIG ? (int)((outer + SWEEP_TR - 1) / SWEEP_TR)
                   : (int)((inner + SWEEP_TI - 1) / SWEEP_TI);
    g.nta = CONTIG ? (g.na + SWEEP_TC - 1) / SWEEP_TC
                   : (g.na + SWEEP_TA - 1) / SWEEP_TA;
    // 16-byte vectors: every component's and field's rows start aligned
    bool vec = g.N % 4 == 0 && (CONTIG ? g.na : g.inner) % 4 == 0 &&
               aligned16(u) && aligned16(out);
    for (int q = 0; q < M::NPAIRS; ++q)
        vec = vec && aligned16(p.pair_c[q]) && aligned16(p.pair_z[q]);
    for (int j = 0; j < M::NZEROS; ++j)
        vec = vec && aligned16(p.zero_kappa[j]);
    if (vec) return launch_sweep<ORDER, M, A, 4>(u, out, p, g, s);
    return launch_sweep<ORDER, M, A, 1>(u, out, p, g, s);
}

cudaError_t sweep(const float* u, float* out, const GcmSweepParams& p,
                  int order, cudaStream_t s) {
    return with_stencil(order, [&](auto o) {
        return with_sweep_model(p.model, [&](auto mdl) {
            using M = decltype(mdl);
            constexpr int OR = decltype(o)::value;
            switch (p.axis) {
                case 0: return dispatch_vector<OR, M, 0>(u, out, p, s);
                case 1: return dispatch_vector<OR, M, 1>(u, out, p, s);
                case 2:
                    if constexpr (M::DIM == 3)
                        return dispatch_vector<OR, M, 2>(u, out, p, s);
                    return cudaErrorInvalidValue;
                default: return cudaErrorInvalidValue;
            }
        });
    });
}

}  // namespace

extern "C" {

// Launches one sweep on `stream` of device `device` with the component map
// params->model; returns the CUDA error code of the launch (0 on success).
// The caller allocates `out` and checks shapes, types, contiguity, the
// material field pointers and the model against gcm_model_map.
int gcm_sweep_stage(const float* u, float* out, const GcmSweepParams* params,
                    int order, int device, void* stream) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    return (int)sweep(u, out, *params, order, (cudaStream_t)stream);
}

// sizeof(GcmSweepParams), so the binding can check its mirror of the layout
int gcm_sweep_params_size(void) { return (int)sizeof(GcmSweepParams); }

}  // extern "C"
