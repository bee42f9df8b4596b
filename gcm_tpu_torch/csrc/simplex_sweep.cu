// One characteristic sweep along one axis of a simplex (tri/tet) mesh
// (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel
// gcm_tpu/ops/pallas_simplex.py::fused_simplex_sweep (:411, call :480; body
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
// What bounds it on an H100: memory. Per node a 3D elastic order-1 sweep
// reads 4 tables of K = 4 (ids and weights: 128 bytes) and their 4 outside
// flags, its own 9 components and 3 material rows, and writes 9
// components: 216 bytes of streams a node. On top come 48 gathered values
// a node (4 components at each of 4 feet of the S tables, 2 at each of the
// P tables' 4), whose rows neighbouring nodes share, which L1 and L2 serve
// (the whole 274,625-node state is 10 MB of the 50 MB L2).
//
// What the design does about it:
// - The component map of the model along the sweep axis is compiled in
//   (gcm_common.cuh: Elastic3D, Acoustic3D, Elastic2D, Acoustic2D), so a
//   node's components live in registers: no stack frame. Which pairs have
//   tables stays a runtime flag (a fluid has no S tables), as do the table
//   rows, the material rows and the border.
// - Each table row is walked once for every component its pairs need: the
//   two S pairs of a 3D sweep share one pair of tables (one table a wave
//   and direction), so one read of ids and weights serves four gathers.
//   Where K is a multiple of 4 (K = 4, 16) and the rows are 16-byte
//   aligned, ids and weights are read as 16-byte loads.
// - The streamed tables are read with the evict-first hint, so that the
//   state, which the gathers read, stays in L2.
// - Grid: each thread takes SIMPLEX_NPT nodes SIMPLEX_NT apart and issues
//   their loads together. The card holds 132 SMs x 2048 threads = 270,336,
//   fewer than the 274,625 nodes of the 65^3 mesh, so one node a thread
//   cannot fill it in one wave. The launch asks the occupancy of the
//   kernel, launches as many blocks as the card holds at once and gives
//   each a contiguous range of ceil(N / blocks) nodes (the same to one
//   node), which its threads walk.
// - No padding, row blocks or lane rolls: those are TPU layout. The tables
//   are read uncompressed, so a mesh of any numbering takes this path.
// - The border algebra is the cubic kernels' bc_incoming (gcm_common.cuh):
//   a foot leaving through +direction is the cubic grid's high face (side
//   1, w_l rebuilt from w_r), through -direction its low face (side 0).
// - The output is a separate buffer: the gathers read the input state.

#include "gcm_common.cuh"

// Mirrors ctypes structure _SimplexParams in gcm_tpu_torch/ops/simplex.py
// (pointers first, then 4-byte fields; the binding checks the size). Pair q
// is the model's pair q along the sweep axis (M::sigma(axis, q), M::vel).
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
    int model;                   // compiled component map (SWEEP_MODEL_*,
                                 // STREAM_MODEL_*)
    int axis;                    // sweep axis
    int pair_tp[MAXP];           // table of pair q's +1 foot; -1: no tables
    int pair_tm[MAXP];           // table of its -1 foot
    int pair_zrow[MAXP];         // mats row of its impedance
    int pair_traction[MAXP];     // val row of its per-node border values
    int kappa_row;               // mats row of kappa
    int bc_kind;                 // -1 per node, else 0 absorbing, 1 free,
                                 // 2 fixed_force, 3 fixed_velocity
    float bc_val[MAXP];          // uniform kind: each pair's value
};

namespace {

constexpr int SIMPLEX_NT = 128;
constexpr int SIMPLEX_NPT = 2;
// blocks an SM for __launch_bounds__: a budget of 85 registers a thread,
// so that the two nodes' components and gathers stay in registers
constexpr int SIMPLEX_MINB = 6;

// acc[g] = sum_k w[k] * u[comp[g], ids[k]] over table t's row of node n,
// for NG components at once (one read of the row). A row of K <= 4 is
// unrolled whole, so that its loads issue together with the other node's;
// a longer row (order 2 and up) is walked a vector or two entries at a
// time, within the register budget (unrolled whole, its ids and weights
// would spill).
template <int KT, int NG>
__device__ __forceinline__ void walk(const GcmSimplexParams& p,
                                     const float* __restrict__ u, int t,
                                     int n, const int (&comp)[NG],
                                     float (&acc)[NG], bool vec) {
    const int N = p.N;
    const int K = KT > 0 ? KT : p.K;
    const long long row = ((long long)t * N + n) * K;
    const int* __restrict__ ids = p.ids + row;
    const float* __restrict__ w = p.weights + row;
    const auto gather = [&](int j, float wk) {
#pragma unroll
        for (int g = 0; g < NG; ++g)
            acc[g] += wk * __ldg(u + (long long)comp[g] * N + j);
    };
    const auto vec4 = [&](int k4) {
        const int4 j = __ldcs((const int4*)ids + k4);
        const float4 wk = __ldcs((const float4*)w + k4);
        gather(j.x, wk.x);
        gather(j.y, wk.y);
        gather(j.z, wk.z);
        gather(j.w, wk.w);
    };
    const auto one = [&](int k) { gather(__ldcs(ids + k), __ldcs(w + k)); };
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[g] = 0.0f;
    if constexpr (KT > 0 && KT % 4 == 0) {
        if (vec) {
            if constexpr (KT == 4) {
                vec4(0);
            } else {
#pragma unroll 1
                for (int k4 = 0; k4 < KT / 4; ++k4) vec4(k4);
            }
            return;
        }
    }
    if constexpr (KT > 0 && KT <= 4) {
#pragma unroll
        for (int k = 0; k < KT; ++k) one(k);
    } else {
#pragma unroll 2
        for (int k = 0; k < K; ++k) one(k);
    }
}

// The sweep along axis A of model M with tables of K = KT (0: p.K) on the
// nodes [blockIdx.x * nb, +nb), NPT nodes a thread at a time.
template <int KT, class M, int A>
__global__ void __launch_bounds__(SIMPLEX_NT, SIMPLEX_MINB)
simplex_sweep_kernel(const float* __restrict__ u, float* __restrict__ out,
                     GcmSimplexParams p, int nb, int vec) {
    constexpr int C = M::C, NP = M::NPAIRS, NPT = SIMPLEX_NPT;
    const int N = p.N;
    const int start = (int)blockIdx.x * nb;
    const int end = min(start + nb, N);
    // the two S pairs of a 3D sweep on one pair of tables: one walk
    const bool shared_s = NP == 3 && p.pair_tp[1] >= 0 &&
                          p.pair_tp[1] == p.pair_tp[2] &&
                          p.pair_tm[1] == p.pair_tm[2];
    for (int base = start + (int)threadIdx.x; base < end;
         base += SIMPLEX_NT * NPT) {
        int n[NPT];
        bool live[NPT];
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
            const int m = base + i * SIMPLEX_NT;
            live[i] = m < end;
            n[i] = live[i] ? m : base;
        }
        float old[NPT][C], nw[NPT][C];
#pragma unroll
        for (int i = 0; i < NPT; ++i)
#pragma unroll
            for (int c = 0; c < C; ++c) {
                old[i][c] = __ldg(u + (long long)c * N + n[i]);
                nw[i][c] = old[i][c];
            }
        // pair q's update of nodes n[] from sigma and v interpolated at its
        // +1 feet (ip) and -1 feet (im)
        const auto update = [&](auto qc, const float (&ip)[NPT][2],
                                const float (&im)[NPT][2]) {
            constexpr int q = decltype(qc)::value;
            constexpr int sg = M::sigma(A, q), vl = M::vel(A, q);
            const int tp = p.pair_tp[q], tm = p.pair_tm[q];
#pragma unroll
            for (int i = 0; i < NPT; ++i) {
                const float z = __ldg(p.mats + (long long)p.pair_zrow[q] * N +
                                      n[i]);
                const float szb = (float)M::SIGN * z;
                float wl = ip[i][0] + szb * ip[i][1];
                float wr = im[i][0] - szb * im[i][1];
                const bool out_p =
                    __ldg(p.outside + (long long)tp * N + n[i]) != 0;
                const bool out_m =
                    __ldg(p.outside + (long long)tm * N + n[i]) != 0;
                if (out_p || out_m) {
                    int kind;
                    float v;
                    if (p.bc_kind >= 0) {
                        kind = p.bc_kind;
                        v = p.bc_val[q];
                    } else {
                        kind = __ldg(p.code + n[i]);
                        v = __ldg(p.val + (long long)p.pair_traction[q] * N +
                                  n[i]);
                    }
                    const float wl0 = wl, wr0 = wr;
                    if (out_p) wl = bc_incoming(kind, v, wr0, M::SIGN, z, 1);
                    if (out_m) wr = bc_incoming(kind, v, wl0, M::SIGN, z, 0);
                }
                nw[i][sg] = 0.5f * (wl + wr);
                nw[i][vl] = z > 0.0f ? (float)M::SIGN * (wl - wr) /
                                           (2.0f * fmaxf(z, 1e-30f))
                                     : old[i][vl];
            }
        };
        // pair q alone: one walk of each of its two table rows
        const auto single = [&](auto qc) {
            constexpr int q = decltype(qc)::value;
            if (p.pair_tp[q] < 0) return;
            const int comp[2] = {M::sigma(A, q), M::vel(A, q)};
            float ip[NPT][2], im[NPT][2];
#pragma unroll
            for (int i = 0; i < NPT; ++i) {
                walk<KT>(p, u, p.pair_tp[q], n[i], comp, ip[i], vec);
                walk<KT>(p, u, p.pair_tm[q], n[i], comp, im[i], vec);
            }
            update(qc, ip, im);
        };
        single(Int<0>{});
        if constexpr (NP == 2) single(Int<1>{});
        if constexpr (NP == 3) {
            if (shared_s) {
                // both S pairs from one walk of each shared row
                const int comp[4] = {M::sigma(A, 1), M::vel(A, 1),
                                     M::sigma(A, 2), M::vel(A, 2)};
                float ip[2][NPT][2], im[2][NPT][2];
#pragma unroll
                for (int i = 0; i < NPT; ++i) {
                    float a[4], b[4];
                    walk<KT>(p, u, p.pair_tp[1], n[i], comp, a, vec);
                    walk<KT>(p, u, p.pair_tm[1], n[i], comp, b, vec);
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        ip[j][i][0] = a[2 * j];
                        ip[j][i][1] = a[2 * j + 1];
                        im[j][i][0] = b[2 * j];
                        im[j][i][1] = b[2 * j + 1];
                    }
                }
                update(Int<1>{}, ip[0], im[0]);
                update(Int<2>{}, ip[1], im[1]);
            } else {
                single(Int<1>{});
                single(Int<2>{});
            }
        }
        // the zero-speed stresses move with the P pair's sigma
        if (M::NZEROS > 0 && p.pair_tp[0] >= 0) {
#pragma unroll
            for (int i = 0; i < NPT; ++i) {
                const float kap =
                    __ldg(p.mats + (long long)p.kappa_row * N + n[i]);
#pragma unroll
                for (int j = 0; j < M::NZEROS; ++j) {
                    const int zc = M::zcomp(A, j), zs = M::zsrc(A);
                    nw[i][zc] = old[i][zc] + kap * (nw[i][zs] - old[i][zs]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
            if (!live[i]) continue;
#pragma unroll
            for (int c = 0; c < C; ++c)
                out[(long long)c * N + n[i]] = nw[i][c];
        }
    }
}

// Launches one sweep (occ == nullptr), or reports in occ[0] the resident
// blocks an SM and in occ[1] the nodes a block takes.
template <class M, int A, int KT>
cudaError_t launch_simplex(const float* u, float* out,
                           const GcmSimplexParams& p, int device,
                           cudaStream_t stream, int* occ) {
    const auto kernel = simplex_sweep_kernel<KT, M, A>;
    int bps = 0;
    cudaError_t err = stream_blocks_per_sm(kernel, 0, &bps, SIMPLEX_NT);
    if (err != cudaSuccess) return err;
    // as many blocks as the card holds at once, at least a node a thread
    const long long slots = (long long)(bps > 0 ? bps : 1) * sm_count(device);
    long long nb = ((long long)p.N + slots - 1) / slots;
    if (nb < SIMPLEX_NT) nb = SIMPLEX_NT;
    const long long blocks = ((long long)p.N + nb - 1) / nb;
    if (occ != nullptr) {
        occ[0] = bps;
        occ[1] = (int)nb;
        return cudaSuccess;
    }
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int vec = p.K % 4 == 0 && aligned16(p.ids) && aligned16(p.weights);
    kernel<<<(unsigned)blocks, SIMPLEX_NT, 0, stream>>>(u, out, p, (int)nb,
                                                        vec);
    return cudaGetLastError();
}

// Calls f(Int<KT>{}) for the table widths the meshes of a DIM-dimensional
// model have: order 1 (DIM + 1) and 2 (10 in 2D, 16 in 3D), and the
// 16-wide 2D order-3 tables; any other width runs the generic KT = 0.
template <int DIM, class F>
cudaError_t with_width(int K, F&& f) {
    if constexpr (DIM == 2) {
        switch (K) {
            case 3: return f(Int<3>{});
            case 10: return f(Int<10>{});
            case 16: return f(Int<16>{});
            default: return f(Int<0>{});
        }
    } else {
        switch (K) {
            case 4: return f(Int<4>{});
            case 16: return f(Int<16>{});
            default: return f(Int<0>{});
        }
    }
}

cudaError_t simplex(const float* u, float* out, const GcmSimplexParams& p,
                    int device, cudaStream_t s, int* occ) {
    return with_sweep_model(p.model, [&](auto mdl) {
        using M = decltype(mdl);
        const auto axis = [&](auto a) {
            return with_width<M::DIM>(p.K, [&](auto k) {
                return launch_simplex<M, decltype(a)::value,
                                      decltype(k)::value>(u, out, p, device,
                                                          s, occ);
            });
        };
        switch (p.axis) {
            case 0: return axis(Int<0>{});
            case 1: return axis(Int<1>{});
            case 2:
                if constexpr (M::DIM == 3) return axis(Int<2>{});
                return cudaErrorInvalidValue;
            default: return cudaErrorInvalidValue;
        }
    });
}

}  // namespace

extern "C" {

// Launches one sweep on `stream` of device `device`, compiled for
// params->model along params->axis; returns the CUDA error code of the
// launch (0 on success). The caller allocates `out` and checks shapes,
// types, contiguity and every pointer of the parameters.
int gcm_simplex_sweep(const float* u, float* out,
                      const GcmSimplexParams* params, int device,
                      void* stream) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    if (params->N <= 0) return 0;
    return (int)simplex(u, out, *params, device, (cudaStream_t)stream,
                        nullptr);
}

// What a launch with these parameters gets: out[0] resident blocks an SM,
// out[1] the nodes each block takes.
int gcm_simplex_occupancy(const GcmSimplexParams* params, int device,
                          int* out) {
    const DeviceScope scope(device);
    cudaError_t err = scope.error();
    if (err != cudaSuccess) return (int)err;
    int occ[2] = {0, 0};
    err = simplex(nullptr, nullptr, *params, device, nullptr, occ);
    out[0] = occ[0];
    out[1] = occ[1];
    return (int)err;
}

// sizeof(GcmSimplexParams), so the binding can check its mirror of the layout
int gcm_simplex_params_size(void) { return (int)sizeof(GcmSimplexParams); }

}  // extern "C"
