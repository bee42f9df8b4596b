// Device code shared by the port's CUDA kernels (sm_90a): the parameter
// block of the fused steps, Lagrange stencil weights, the border algebra,
// material stacks stored as float or bf16 (upcast at the load), the
// component maps fixed at compile time (the streamed bodies, the per-sweep
// kernel and the simplex sweep), the two one-step 3D bodies of the 3D
// fused, slab and SPMD kernels, which walk x plane by plane (stream_step,
// the ring body: the x sweep's planes in a ring of shared memory;
// stream_step_owned, the owned body: each thread owns a cell in every
// sweep), the ring body's two-step form (stream_pair: the slab kernel's
// two steps a pass), the one-step 2D body that walks x row by row
// through a ring of rows in registers (stream_rows: the 2D fused and SPMD
// kernels), and its two-step form (stream_rows_pair: the 2D kernel's two
// steps a pass).
//
// The device functions sit in an anonymous namespace: each kernel source
// compiles its own copy, and the sources link into one library without
// clashing symbols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

constexpr int MAXP = 3;      // pairs per sweep
constexpr int MAXZ = 2;      // zero-speed invariants per sweep
constexpr int MAXSPEC = 4;   // folded correctors per step

// Mirrors ctypes structure _Params in gcm_tpu_torch/ops/fused.py (all
// fields 4 bytes wide, so there is no padding to agree on). A 2D grid is
// n = {nx, ny, 1} with the first two entries of `axes` used.
struct GcmFusedParams {
    int n[3];                    // nx, ny, nz
    int ncomp;
    int nm;                      // material stack height
    int sign;                    // +1 elastic, -1 acoustic
    int axes[3];                 // sweep order
    int rho_idx;                 // stack row of rho
    int zero_kappa[3][MAXZ];     // stack row of each zero's coupling ratio
                                 // (the compact stack's one kappa, or the
                                 // orthotropic k<a><b>); -1 past nzeros
    int npairs[3];               // per physical axis
    int pair_sigma[3][MAXP];
    int pair_vel[3][MAXP];
    int pair_c[3][MAXP];         // stack row of the pair's wave speed
    int nzeros[3];
    int zero_comp[3][MAXZ];
    int zero_src[3][MAXZ];
    int bc_kind[3][2];           // -1 none, 0 absorbing, 1 free,
                                 // 2 fixed_force, 3 fixed_velocity
    float bc_val[3][2][MAXP];    // BorderSpec.pair_value per pair
    float dtoh[3];               // dt / h per axis
    // folded ODE correctors (ops/fused.py::fold_corrector_specs), applied
    // to each output cell before its store; nspec = 0 turns them off
    int nspec;
    int spec_kind[MAXSPEC];      // 0 Maxwell, 1 damage
    float spec_a[MAXSPEC];       // Maxwell: exp(-dt/tau); damage: threshold
    float spec_b[MAXSPEC];       // damage: rate
    float dt;
    int ndiag;                   // normal-stress components
    int diag[3];
    int nshear;                  // shear-stress components
    int shear[3];
    int axes_next[3];            // sweep order of the second in-window
                                 // step (temporal blocking, K = 2)
    int model;                   // compiled component map of the streamed
                                 // bodies (STREAM_MODEL_*, SWEEP_MODEL_*2D);
                                 // -1 for none
};

// The component maps the streamed bodies and the per-sweep kernel are
// compiled for (the ids of GcmFusedParams::model, GcmSweepParams::model and
// GcmSimplexParams::model; gcm_model_map exports all four).
constexpr int STREAM_MODEL_ELASTIC3D = 0;
constexpr int STREAM_MODEL_ACOUSTIC3D = 1;
constexpr int SWEEP_MODEL_ELASTIC2D = 2;
constexpr int SWEEP_MODEL_ACOUSTIC2D = 3;

namespace {

template <int ORDER>
struct Stencil {
    // offsets relative to the direction sign: order 1 {0,1}, 2 {-1,0,1},
    // 3 {-1,0,1,2}, 4 {-2,..,2}
    static constexpr int NP = ORDER + 1;
    static constexpr int LO = ORDER == 1 ? 0 : (ORDER == 4 ? -2 : -1);
    static constexpr int R = ORDER >= 3 ? 2 : 1;

    // ops/interp.py::stencil_weights, term for term
    __device__ static void weights(float t, float* w) {
        if constexpr (ORDER == 1) {
            w[0] = 1.0f - t;
            w[1] = t;
        } else if constexpr (ORDER == 2) {
            w[0] = 0.5f * t * (t - 1.0f);
            w[1] = 1.0f - t * t;
            w[2] = 0.5f * t * (t + 1.0f);
        } else if constexpr (ORDER == 3) {
            w[0] = -t * (t - 1.0f) * (t - 2.0f) / 6.0f;
            w[1] = (t + 1.0f) * (t - 1.0f) * (t - 2.0f) / 2.0f;
            w[2] = -(t + 1.0f) * t * (t - 2.0f) / 2.0f;
            w[3] = (t + 1.0f) * t * (t - 1.0f) / 6.0f;
        } else {
            w[0] = (t + 1.0f) * t * (t - 1.0f) * (t - 2.0f) / 24.0f;
            w[1] = -(t + 2.0f) * t * (t - 1.0f) * (t - 2.0f) / 6.0f;
            w[2] = (t + 2.0f) * (t + 1.0f) * (t - 1.0f) * (t - 2.0f) / 4.0f;
            w[3] = -(t + 2.0f) * (t + 1.0f) * t * (t - 2.0f) / 6.0f;
            w[4] = (t + 2.0f) * (t + 1.0f) * t * (t - 1.0f) / 24.0f;
        }
    }
};

// The one-step 3D body: a block of STREAM_NT threads owns a STREAM_TY x
// STREAM_TZ tile of the (y, z) plane (z contiguous, 128-byte rows) and
// walks a chunk of x planes. 11 warps: every sweep of a plane window, up
// to (8 + 2) x (32 + 2) = 340 cells at r = 1, is one pass of the block.
constexpr int STREAM_NT = 352;
constexpr int STREAM_TY = 8;
constexpr int STREAM_TZ = 32;

// 4-byte asynchronous copy from global to shared memory (cp.async, sm_80+):
// issued copies complete in commit groups; cp_async_wait<N> returns once at
// most the N most recent groups are still in flight, and a barrier after it
// makes every thread's copies visible to the block.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
#else
    *dst = *src;
#endif
}

// The same for 16 bytes (four floats, both addresses 16-byte aligned),
// cached in L2 only: the per-sweep kernel's and the 2D body's aligned rows.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
#else
    for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// Reads the state from global memory at clamped coordinates.
struct GlobalSrc {
    const float* __restrict__ u;
    int n0, n1, n2;
    long long N;
    // the first cell of row x (clamped) of component c of a 2D state (n2 =
    // 1): the row's cells follow contiguously
    __device__ const float* row(int c, int x) const {
        return u + c * N + (long long)min(max(x, 0), n0 - 1) * n1;
    }
    // component 0 of cell (x, y, z) at clamped coordinates; *cs is the
    // distance from one component to the next
    __device__ const float* cell(int x, int y, int z, long long* cs) const {
        *cs = N;
        return u + ((long long)min(max(x, 0), n0 - 1) * n1 +
                    min(max(y, 0), n1 - 1)) * n2 + min(max(z, 0), n2 - 1);
    }
    // Starts the copy of the C components of plane x, cells [ylo, ylo+EY)
    // x [zlo, zlo+EZ) at clamped coordinates, into dst (C, EY, EZ), by a
    // block of NT threads: neighbouring threads copy neighbouring z, so
    // rows coalesce.
    template <int C, int EY, int EZ, int NT = STREAM_NT>
    __device__ __forceinline__ void stage(float* dst, int x, int ylo,
                                          int zlo) const {
        x = min(max(x, 0), n0 - 1);
        const float* pl = u + (long long)x * n1 * n2;
        for (int e = threadIdx.x; e < EY * EZ; e += NT) {
            const int j = e / EZ, k = e - j * EZ;
            const int y = min(max(ylo + j, 0), n1 - 1);
            const int z = min(max(zlo + k, 0), n2 - 1);
            const float* s = pl + y * n2 + z;
#pragma unroll
            for (int c = 0; c < C; ++c)
                cp_async4(dst + c * EY * EZ + e, s + c * N);
        }
    }
};

// Reads one shard's state: its local block (C, n0, n1, n2) inside, and the
// halo slabs received from its neighbours (parallel/fused_spmd.py::
// exchange_slabs) up to R cells outside it along x and y. xlo/xhi are
// (C, R, n1, n2); ylo/yhi are (C, n0 + 2R, R, n2) and span the x-extended
// range, so they hold the corners and win there. Without y slabs (a 2D
// shard (C, n0, n1, 1), split along x only) y clamps; z always clamps.
struct SlabSrc {
    const float* __restrict__ u;
    const float* __restrict__ xlo;
    const float* __restrict__ xhi;
    const float* __restrict__ ylo;
    const float* __restrict__ yhi;
    int n0, n1, n2, R;
    long long N;
    // component 0 of cell (x, y, z) in the block or the slab that holds
    // it; *cs is the distance from one component to the next there
    __device__ const float* cell(int x, int y, int z, long long* cs) const {
        z = min(max(z, 0), n2 - 1);
        x = min(max(x, -R), n0 - 1 + R);
        if (ylo == nullptr) y = min(max(y, 0), n1 - 1);
        else y = min(max(y, -R), n1 - 1 + R);
        if (y < 0 || y >= n1) {
            *cs = (long long)(n0 + 2 * R) * R * n2;
            return (y < 0 ? ylo : yhi) +
                   ((long long)(x + R) * R + (y < 0 ? y + R : y - n1)) * n2 +
                   z;
        }
        if (x < 0 || x >= n0) {
            *cs = (long long)R * n1 * n2;
            return (x < 0 ? xlo : xhi) +
                   ((long long)(x < 0 ? x + R : x - n0) * n1 + y) * n2 + z;
        }
        *cs = N;
        return u + ((long long)x * n1 + y) * n2 + z;
    }
    // the address that holds component c of cell (x, y, z)
    __device__ const float* at(int c, int x, int y, int z) const {
        long long cs;
        const float* const a = cell(x, y, z, &cs);
        return a + c * cs;
    }
    // GlobalSrc::row of a 2D shard, x reaching R rows into the slabs
    __device__ const float* row(int c, int x) const { return at(c, x, 0, 0); }
    // GlobalSrc::stage with each cell's address picked from the block or a
    // slab.
    template <int C, int EY, int EZ>
    __device__ __forceinline__ void stage(float* dst, int x, int ylo,
                                          int zlo) const {
        for (int e = threadIdx.x; e < EY * EZ; e += STREAM_NT) {
            const int j = e / EZ, k = e - j * EZ;
            long long cs;
            const float* const s = cell(x, ylo + j, zlo + k, &cs);
#pragma unroll
            for (int c = 0; c < C; ++c)
                cp_async4(dst + c * EY * EZ + e, s + c * cs);
        }
    }
};

// One material value, upcast to float right after the load: the stacks are
// stored as float or as bf16 (half the material stream); all arithmetic
// stays float.
__device__ __forceinline__ float mat_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float mat_load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
}

// Material stack of the state's own extents (nm, n0, n1, n2) of stored type
// T, read at clamped coordinates (edge replication).
template <class T>
struct GlobalMat {
    const T* __restrict__ m;
    int n0, n1, n2;
    long long N;
    // plane x of row 0, and a cell's 32-bit offset within a plane
    __device__ const T* plane(int x) const {
        return m + (long long)min(max(x, 0), n0 - 1) * n1 * n2;
    }
    __device__ int cell(int y, int z) const {
        return min(max(y, 0), n1 - 1) * n2 + min(max(z, 0), n2 - 1);
    }
    __device__ float ld(const T* pl, int row, int cell) const {
        return mat_load(pl + row * N + cell);
    }
};

// GlobalMat's streamed addressing with the stored type (float or bf16) a
// runtime flag: one instantiation of the two-step body (and of the 2D one)
// reads both, which halves its instantiations (a uniform branch at each
// material load). With e0 > 0 the stack is a 2D shard's x-extended one
// (nm, n0 + 2 e0, n1, n2), local row x at x + e0, as ExtMat<T> with e1 = 0.
struct DynMat {
    const void* __restrict__ m;
    int n0, n1, n2;
    long long N;                 // (n0 + 2 e0) * n1 * n2
    int bf16;
    int e0 = 0;
    __device__ const char* plane(int x) const {
        const long long pl =
            (long long)(min(max(x, -e0), n0 - 1 + e0) + e0) * n1 * n2;
        return (const char*)m + (bf16 ? 2 : 4) * pl;
    }
    __device__ int cell(int y, int z) const {
        return min(max(y, 0), n1 - 1) * n2 + min(max(z, 0), n2 - 1);
    }
    __device__ float ld(const char* pl, int row, int cell) const {
        const long long i = row * N + cell;
        return bf16 ? mat_load((const __nv_bfloat16*)pl + i)
                    : mat_load((const float*)pl + i);
    }
};

// A shard's halo-extended material stack (parallel/fused_spmd.py::
// extended_mstack): (nm, n0 + 2 e0, n1 + 2 e1, n2), local cell x at x + e0.
// Coordinates clamp to the extended range, z to the block.
template <class T>
struct ExtMat {
    const T* __restrict__ m;
    int n0, n1, n2, e0, e1;
    long long N;                 // (n0 + 2 e0) * (n1 + 2 e1) * n2
    __device__ const T* plane(int x) const {
        return m + (long long)(min(max(x, -e0), n0 - 1 + e0) + e0) *
                       (n1 + 2 * e1) * n2;
    }
    __device__ int cell(int y, int z) const {
        return (min(max(y, -e1), n1 - 1 + e1) + e1) * n2 +
               min(max(z, 0), n2 - 1);
    }
    __device__ float ld(const T* pl, int row, int cell) const {
        return mat_load(pl + row * N + cell);
    }
};

__device__ __forceinline__ float bc_incoming(int kind, float value, float out,
                                             int sign, float z, int side) {
    // ops/pallas_fused.py::_bc_incoming
    if (kind == 0) return 0.0f;
    if (kind == 1) return -out;
    if (kind == 2) return 2.0f * value - out;
    float s = side == 0 ? -1.0f : 1.0f;
    return out + s * 2.0f * (float)sign * z * value;
}

// ------------------------------------------- the one-step 3D body, streamed

// Component maps of the models (gcm_tpu_torch/models/spec.py), fixed at
// compile time so that a cell's components live in registers: along sweep
// axis a, pair q couples stress sigma(a, q) with velocity vel(a, q), and
// zero-speed invariant j moves zcomp(a, j) with the change of zsrc(a);
// diag/shear name the stresses the folded correctors act on. The material
// rows or fields of each pair's speed and each zero's ratio stay runtime
// parameters (addresses), so one instantiation reads either layout.
struct Elastic3D {
    // [vx, vy, vz, sxx, sxy, sxz, syy, syz, szz]
    static constexpr int ID = STREAM_MODEL_ELASTIC3D;
    static constexpr int DIM = 3, C = 9, SIGN = 1, NPAIRS = 3, NZEROS = 2;
    static constexpr int NDIAG = 3, NSHEAR = 3;
    __host__ __device__ static constexpr int sigma(int a, int q) {
        return a == 0 ? 3 + q
                      : (a == 1 ? (q == 0 ? 6 : (q == 1 ? 4 : 7))
                                : (q == 0 ? 8 : (q == 1 ? 5 : 7)));
    }
    __host__ __device__ static constexpr int vel(int a, int q) {
        return a == 0 ? q
                      : (a == 1 ? (q == 0 ? 1 : (q == 1 ? 0 : 2))
                                : (q == 0 ? 2 : (q == 1 ? 0 : 1)));
    }
    __host__ __device__ static constexpr int zcomp(int a, int j) {
        return a == 0 ? (j == 0 ? 6 : 8)
                      : (a == 1 ? (j == 0 ? 3 : 8) : (j == 0 ? 3 : 6));
    }
    __host__ __device__ static constexpr int zsrc(int a) {
        return sigma(a, 0);
    }
    __host__ __device__ static constexpr int diag(int i) {
        return i == 0 ? 3 : (i == 1 ? 6 : 8);
    }
    __host__ __device__ static constexpr int shear(int i) {
        return i == 0 ? 4 : (i == 1 ? 5 : 7);
    }
};

struct Acoustic3D {
    // [vx, vy, vz, p]
    static constexpr int ID = STREAM_MODEL_ACOUSTIC3D;
    static constexpr int DIM = 3, C = 4, SIGN = -1, NPAIRS = 1, NZEROS = 0;
    static constexpr int NDIAG = 0, NSHEAR = 0;
    __host__ __device__ static constexpr int sigma(int, int) { return 3; }
    __host__ __device__ static constexpr int vel(int a, int) { return a; }
    __host__ __device__ static constexpr int zcomp(int, int) { return 0; }
    __host__ __device__ static constexpr int zsrc(int) { return 0; }
    __host__ __device__ static constexpr int diag(int) { return 0; }
    __host__ __device__ static constexpr int shear(int) { return 0; }
};

struct Elastic2D {
    // [vx, vy, sxx, sxy, syy]
    static constexpr int ID = SWEEP_MODEL_ELASTIC2D;
    static constexpr int DIM = 2, C = 5, SIGN = 1, NPAIRS = 2, NZEROS = 1;
    static constexpr int NDIAG = 2, NSHEAR = 1;
    __host__ __device__ static constexpr int sigma(int a, int q) {
        return q == 1 ? 3 : (a == 0 ? 2 : 4);
    }
    __host__ __device__ static constexpr int vel(int a, int q) {
        return q == 0 ? a : 1 - a;
    }
    __host__ __device__ static constexpr int zcomp(int a, int) {
        return a == 0 ? 4 : 2;
    }
    __host__ __device__ static constexpr int zsrc(int a) {
        return sigma(a, 0);
    }
    __host__ __device__ static constexpr int diag(int i) {
        return i == 0 ? 2 : 4;
    }
    __host__ __device__ static constexpr int shear(int) { return 3; }
};

struct Acoustic2D {
    // [vx, vy, p]
    static constexpr int ID = SWEEP_MODEL_ACOUSTIC2D;
    static constexpr int DIM = 2, C = 3, SIGN = -1, NPAIRS = 1, NZEROS = 0;
    static constexpr int NDIAG = 0, NSHEAR = 0;
    __host__ __device__ static constexpr int sigma(int, int) { return 2; }
    __host__ __device__ static constexpr int vel(int a, int) { return a; }
    __host__ __device__ static constexpr int zcomp(int, int) { return 0; }
    __host__ __device__ static constexpr int zsrc(int) { return 0; }
    __host__ __device__ static constexpr int diag(int) { return 0; }
    __host__ __device__ static constexpr int shear(int) { return 0; }
};

// The compiled map of model M in the fields of GcmFusedParams, for the
// binding to hold the runtime model to.
template <class M>
__host__ inline void model_map(GcmFusedParams* p) {
    p->ncomp = M::C;
    p->sign = M::SIGN;
    for (int a = 0; a < M::DIM; ++a) {
        p->npairs[a] = M::NPAIRS;
        p->nzeros[a] = M::NZEROS;
        for (int q = 0; q < M::NPAIRS; ++q) {
            p->pair_sigma[a][q] = M::sigma(a, q);
            p->pair_vel[a][q] = M::vel(a, q);
        }
        for (int j = 0; j < M::NZEROS; ++j) {
            p->zero_comp[a][j] = M::zcomp(a, j);
            p->zero_src[a][j] = M::zsrc(a);
        }
    }
    p->ndiag = M::NDIAG;
    p->nshear = M::NSHEAR;
    for (int i = 0; i < M::NDIAG; ++i) p->diag[i] = M::diag(i);
    for (int i = 0; i < M::NSHEAR; ++i) p->shear[i] = M::shear(i);
}

// A sweep order (a permutation of the three axes) as types.
template <int A0_, int A1_, int A2_>
struct Axes {
    static constexpr int A0 = A0_, A1 = A1_, A2 = A2_;
    // position of x in the order
    static constexpr int P = A0 == 0 ? 0 : (A1 == 0 ? 1 : 2);
    // the axis swept i-th
    __host__ __device__ static constexpr int at(int i) {
        return i == 0 ? A0 : (i == 1 ? A1 : A2);
    }
    // whether y / z is among the first s sweeps
    __host__ __device__ static constexpr bool ys(int s) {
        return (s > 0 && A0 == 1) || (s > 1 && A1 == 1) || (s > 2 && A2 == 1);
    }
    __host__ __device__ static constexpr bool zs(int s) {
        return (s > 0 && A0 == 2) || (s > 1 && A1 == 2) || (s > 2 && A2 == 2);
    }
};

// The (y, z) window of a TY x TZ tile with a halo of HY rows and HZ
// columns on each side.
template <int TY_, int TZ_, int HY_, int HZ_>
struct Box {
    static constexpr int TY = TY_, TZ = TZ_, HY = HY_, HZ = HZ_;
    static constexpr int EY = TY + 2 * HY, EZ = TZ + 2 * HZ;
    static constexpr int VOL = EY * EZ;
};

// The window of a one-step tile at one stage of the step: the tile with a
// halo of R cells along each in-plane axis not swept yet (YS, ZS: swept).
template <int R, bool YS, bool ZS>
using Win = Box<STREAM_TY, STREAM_TZ, YS ? 0 : R, ZS ? 0 : R>;

// Window W after a sweep along in-plane axis A, which drops R cells of
// its halo along A.
template <class W, int A, int R>
using Drop = Box<W::TY, W::TZ, W::HY - (A == 1 ? R : 0),
                 W::HZ - (A == 2 ? R : 0)>;

// Shared memory of stream_step for one (order, model, sweep order), in
// floats from the start of the block's buffer:
// - RAW: two incoming raw planes (double buffer), only when some in-plane
//   sweep precedes x (P > 0); at P = 0 the raw planes go straight into the
//   ring;
// - RING: the planes the x sweep reads, after the sweeps before x: 2R + 1
//   of them, and one more at P = 0 for the plane in flight;
// - TMP: the x sweep's output plane (P = 0, 1) or the first of two
//   in-plane sweeps before x (P = 2); TMP2: the first sweep after x when
//   two follow it (P = 0).
template <int ORDER, class M, class AX>
struct StreamLayout {
    static constexpr int R = Stencil<ORDER>::R, C = M::C, P = AX::P;
    using Raw = Win<R, false, false>;
    using Mid = Win<R, AX::ys(1), AX::zs(1)>;
    using Post = Win<R, AX::ys(2), AX::zs(2)>;
    using Ring = Win<R, AX::ys(P), AX::zs(P)>;
    using Out = Win<R, true, true>;
    static constexpr int NRAW = P == 0 ? 0 : 2;
    static constexpr int NSLOT = P == 0 ? 2 * R + 2 : 2 * R + 1;
    static constexpr int RAW = 0;
    static constexpr int RING = RAW + NRAW * C * Raw::VOL;
    static constexpr int TMP = RING + NSLOT * C * Ring::VOL;
    static constexpr int TMP2 = TMP + C * (P == 2 ? Mid::VOL : Ring::VOL);
    static constexpr int FLOATS = TMP2 + (P == 0 ? C * Post::VOL : 0);
    static constexpr int BYTES = (int)sizeof(float) * FLOATS;
    // blocks an SM can hold by shared memory (228 KB, 1 KB reserved a
    // block), at most 3: the register budget of __launch_bounds__ (56 a
    // thread at 3 blocks of 11 warps; ptxas then spills a few bytes in the
    // order 1-2 elastic3d forms, which still run faster than 2 blocks
    // without spills, PERF.md)
    static constexpr int MINB = 233472 / (BYTES + 1024) >= 3
                                    ? 3
                                    : (233472 / (BYTES + 1024) >= 2 ? 2 : 1);
};

// Where the last sweep stores: the state (C, n0, n1, n2) and, for the
// damage correctors, the aux streams (naux, n0, n1, n2).
struct StepOut {
    float* __restrict__ u;
    const float* __restrict__ aux_in;
    float* __restrict__ aux_out;
    long long N;
};

// The folded correctors on one cell in registers (corrector_epilogue with
// the model's stresses fixed at compile time).
template <class M>
__device__ __forceinline__ void epilogue_n(const GcmFusedParams& p,
                                           float (&c)[M::C],
                                           const StepOut& so, long long off) {
    if constexpr (M::NDIAG > 0) {
        int q = 0;
#pragma unroll
        for (int s = 0; s < MAXSPEC; ++s) {
            if (s >= p.nspec) break;
            if (p.spec_kind[s] == 0) {
                const float decay = p.spec_a[s];
                float sum = 0.0f;
#pragma unroll
                for (int i = 0; i < M::NDIAG; ++i) sum += c[M::diag(i)];
                const float mean = sum / (float)M::NDIAG;
#pragma unroll
                for (int i = 0; i < M::NDIAG; ++i)
                    c[M::diag(i)] = mean + (c[M::diag(i)] - mean) * decay;
#pragma unroll
                for (int i = 0; i < M::NSHEAR; ++i) c[M::shear(i)] *= decay;
            } else {
                const float thr = p.spec_a[s], rate = p.spec_b[s];
                const float d = so.aux_in[q * so.N + off];
                float smax = c[M::diag(0)];
#pragma unroll
                for (int i = 1; i < M::NDIAG; ++i)
                    smax = fmaxf(smax, c[M::diag(i)]);
                const float over = fmaxf(smax - thr, 0.0f) / thr;
                const float d_new =
                    fminf(fmaxf(d + rate * over * p.dt, 0.0f), 1.0f);
                const float f =
                    fminf((1.0f - d_new) / fmaxf(1.0f - d, 1e-12f), 1.0f);
#pragma unroll
                for (int i = 0; i < M::NDIAG; ++i) c[M::diag(i)] *= f;
#pragma unroll
                for (int i = 0; i < M::NSHEAR; ++i) c[M::shear(i)] *= f;
                so.aux_out[q * so.N + off] = d_new;
                ++q;
            }
        }
    }
}

// The folded correctors and the store of one output cell at flat offset
// `off` of the state.
template <class M>
__device__ __forceinline__ void store_cell(const GcmFusedParams& p,
                                           float (&nw)[M::C],
                                           const StepOut& so, long long off) {
    if (p.nspec > 0) epilogue_n<M>(p, nw, so, off);
#pragma unroll
    for (int c = 0; c < M::C; ++c) so.u[c * so.N + off] = nw[c];
}

// 1 / x rounded to nearest (0.5f * rcp_rn(z) is 0.5f / z bit for bit
// wherever the quotient is a normal float: scaling by 0.5 is exact).
__device__ __forceinline__ float rcp_rn(float x) {
#if defined(__CUDA_ARCH__)
    return __frcp_rn(x);
#else
    return 1.0f / x;
#endif
}

// One cell of a sweep along axis A (sweep's term for term, with the
// component map of M): ld(c, o) reads component c at offset o along A,
// co(q, c, z, rz) gives pair q's wave speed, impedance rho*c and 0.5/z (0
// where z is 0), ka(j) zero j's coupling ratio; ga is the cell's row along
// A.
template <int ORDER, class M, int A, class Ld, class Co, class Ka>
__device__ __forceinline__ void cell_core(const GcmFusedParams& p,
                                          const Ld& ld, const Co& co,
                                          const Ka& ka, int ga,
                                          float (&nw)[M::C]) {
    using S = Stencil<ORDER>;
    float old[M::C];
#pragma unroll
    for (int c = 0; c < M::C; ++c) {
        old[c] = ld(c, 0);
        nw[c] = old[c];
    }
#pragma unroll
    for (int q = 0; q < M::NPAIRS; ++q) {
        const int sg = M::sigma(A, q), vl = M::vel(A, q);
        float c, z, rz;
        co(q, c, z, rz);
        float w[S::NP];
        S::weights(c * p.dtoh[A], w);
        float Ap = 0.f, Bp = 0.f, Am = 0.f, Bm = 0.f;
#pragma unroll
        for (int t = 0; t < S::NP; ++t) {
            const int o = t + S::LO;
            Ap += w[t] * ld(sg, o);
            Bp += w[t] * ld(vl, o);
            Am += w[t] * ld(sg, -o);
            Bm += w[t] * ld(vl, -o);
        }
        const float szb = (float)M::SIGN * z;
        float wl = Ap + szb * Bp;
        float wr = Am - szb * Bm;
        if (ga == 0 && p.bc_kind[A][0] >= 0)
            wr = bc_incoming(p.bc_kind[A][0], p.bc_val[A][0][q], wl, M::SIGN,
                             z, 0);
        if (ga == p.n[A] - 1 && p.bc_kind[A][1] >= 0)
            wl = bc_incoming(p.bc_kind[A][1], p.bc_val[A][1][q], wr, M::SIGN,
                             z, 1);
        nw[sg] = 0.5f * (wl + wr);
        nw[vl] = z > 0.0f ? (float)M::SIGN * (wl - wr) * rz : old[vl];
    }
#pragma unroll
    for (int j = 0; j < M::NZEROS; ++j) {
        const int zc = M::zcomp(A, j), zsr = M::zsrc(A);
        nw[zc] = old[zc] + ka(j) * (nw[zsr] - old[zsr]);
    }
}

// cell_core with the cell's materials read at each sweep: mp and moff
// address them in the stack.
template <int ORDER, class M, int A, class Ld, class Mat, class MP>
__device__ __forceinline__ void cell_sweep(const GcmFusedParams& p,
                                           const Ld& ld, const Mat& mat,
                                           MP mp, int moff, int ga,
                                           float (&nw)[M::C]) {
    const float rho = mat.ld(mp, p.rho_idx, moff);
    const auto co = [&](int q, float& c, float& z, float& rz) {
        c = mat.ld(mp, p.pair_c[A][q], moff);
        z = rho * c;
        rz = z > 0.0f ? 0.5f / fmaxf(z, 1e-30f) : 0.0f;
    };
    const auto ka = [&](int j) {
        return mat.ld(mp, p.zero_kappa[A][j], moff);
    };
    cell_core<ORDER, M, A>(p, ld, co, ka, ga, nw);
}

// One sweep along the in-plane axis A (1 = y, 2 = z) of plane x, by a
// block of NT threads: reads the window In from the shared buffer `in` and
// writes window Out (In less its halo along A) to the shared buffer `dst`,
// or, TO_GLOBAL, the tile's cells inside the domain to the output after
// the folded correctors.
template <int ORDER, class M, int A, class In, class Out, bool TO_GLOBAL,
          int NT, class Mat>
__device__ __forceinline__ void plane_sweep(const GcmFusedParams& p,
                                            const float* in, float* dst,
                                            const Mat& mat, int x, int y0,
                                            int z0, const StepOut& so) {
    static_assert(A == 1 || A == 2, "an in-plane axis");
    constexpr int DY = In::HY - Out::HY, DZ = In::HZ - Out::HZ;
    static_assert((A == 1 ? DZ : DY) == 0 && (A == 1 ? DY : DZ) ==
                      Stencil<ORDER>::R, "the sweep drops A's halo only");
    constexpr int ST = A == 1 ? In::EZ : 1;
    const auto mp = mat.plane(x);
    const long long plane = (long long)x * p.n[1] * p.n[2];
    for (int idx = threadIdx.x; idx < Out::VOL; idx += NT) {
        const int j = idx / Out::EZ, k = idx - j * Out::EZ;
        const int gy = y0 - Out::HY + j, gz = z0 - Out::HZ + k;
        if (TO_GLOBAL && (gy >= p.n[1] || gz >= p.n[2])) continue;
        const float* b = in + (j + DY) * In::EZ + k + DZ;
        const auto ld = [&](int c, int o) { return b[c * In::VOL + o * ST]; };
        float nw[M::C];
        cell_sweep<ORDER, M, A>(p, ld, mat, mp, mat.cell(gy, gz),
                                A == 1 ? gy : gz, nw);
        if constexpr (TO_GLOBAL) {
            store_cell<M>(p, nw, so, plane + gy * p.n[2] + gz);
        } else {
#pragma unroll
            for (int c = 0; c < M::C; ++c) dst[c * Out::VOL + idx] = nw[c];
        }
    }
}

// The x sweep of plane x over window W, by a block of NT threads: rp[t]
// holds plane x - R + t (the ring's slots, after the in-plane sweeps that
// precede x), each W-shaped.
template <int ORDER, class M, class W, bool TO_GLOBAL, int NT, class Mat>
__device__ __forceinline__ void x_sweep(
        const GcmFusedParams& p,
        const float* const (&rp)[2 * Stencil<ORDER>::R + 1], float* dst,
        const Mat& mat, int x, int y0, int z0, const StepOut& so) {
    constexpr int R = Stencil<ORDER>::R;
    const auto mp = mat.plane(x);
    const long long plane = (long long)x * p.n[1] * p.n[2];
    for (int idx = threadIdx.x; idx < W::VOL; idx += NT) {
        const int j = idx / W::EZ, k = idx - j * W::EZ;
        const int gy = y0 - W::HY + j, gz = z0 - W::HZ + k;
        if (TO_GLOBAL && (gy >= p.n[1] || gz >= p.n[2])) continue;
        const auto ld = [&](int c, int o) {
            return rp[o + R][c * W::VOL + idx];
        };
        float nw[M::C];
        cell_sweep<ORDER, M, 0>(p, ld, mat, mp, mat.cell(gy, gz), x, nw);
        if constexpr (TO_GLOBAL) {
            store_cell<M>(p, nw, so, plane + gy * p.n[2] + gz);
        } else {
#pragma unroll
            for (int c = 0; c < M::C; ++c) dst[c * W::VOL + idx] = nw[c];
        }
    }
}

// One full 3D step (sweeps along AX::A0, A1, A2) of output planes [xa, xb)
// of the (y, z) tile at (y0, z0), walking x: each incoming plane xi (from
// xa - R to xb + R - 1, clamped by the source, which replicates the edge)
// is staged into shared memory while the previous one computes; the
// in-plane sweeps that precede x run on it and put it into the ring; then
// the x sweep of plane xi - R reads the 2R + 1 ring planes around it, the
// in-plane sweeps that follow x run on its result, and the last sweep
// stores the tile's cells, after the folded correctors. Called by every
// thread of a STREAM_NT-thread block. Any cell of a sweep goes to any
// thread, so the ring is shared by the block (a barrier on each side of
// each sweep) and each cell reads its materials from global memory at
// each sweep: on the card the material path set its pace (2.5-3.3 ms of
// its 4.5-5.1 at 512x512x256, PERF.md). The ring body remains for the
// forms the owned body (stream_step_owned) is not compiled for: orders
// 3-4 (r = 2, five planes a cell), acoustic3d, and orthotropic stacks,
// whose speed and ratio rows differ by axis.
template <int ORDER, class M, class AX, class Src, class Mat>
__device__ __forceinline__ void stream_step(const GcmFusedParams& p,
                                            const Src& src, const Mat& mat,
                                            int xa, int xb, int y0, int z0,
                                            float* smem, const StepOut& so) {
    using L = StreamLayout<ORDER, M, AX>;
    using Raw = typename L::Raw;
    using Ring = typename L::Ring;
    constexpr int R = L::R, C = M::C, P = L::P;
    constexpr int SLOT = C * Ring::VOL;
    float* const ring = smem + L::RING;
    float* const tmp = smem + L::TMP;
    float* const tmp2 = smem + L::TMP2;
    // the buffer of incoming plane number `it` (counted from xa - R)
    const auto inbox = [&](int it) {
        return P == 0 ? ring + (it % L::NSLOT) * SLOT
                      : smem + L::RAW + (it & 1) * (C * Raw::VOL);
    };
    const int nin = xb - xa + 2 * R;
    src.template stage<C, Raw::EY, Raw::EZ>(inbox(0), xa - R, y0 - R, z0 - R);
    cp_async_commit();
    for (int it = 0; it < nin; ++it) {
        const int xi = xa - R + it;
        if (it + 1 < nin)
            src.template stage<C, Raw::EY, Raw::EZ>(inbox(it + 1), xi + 1,
                                                    y0 - R, z0 - R);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if constexpr (P > 0) {
            float* const slot = ring + (it % L::NSLOT) * SLOT;
            const float* const in = inbox(it);
            if constexpr (P == 1) {
                plane_sweep<ORDER, M, AX::A0, Raw, Ring, false, STREAM_NT>(
                    p, in, slot, mat, xi, y0, z0, so);
            } else {
                using Mid = typename L::Mid;
                plane_sweep<ORDER, M, AX::A0, Raw, Mid, false, STREAM_NT>(
                    p, in, tmp, mat, xi, y0, z0, so);
                __syncthreads();
                plane_sweep<ORDER, M, AX::A1, Mid, Ring, false, STREAM_NT>(
                    p, tmp, slot, mat, xi, y0, z0, so);
            }
            __syncthreads();
        }
        if (it < 2 * R) continue;
        const int xo = xi - R;
        const float* rp[2 * R + 1];
#pragma unroll
        for (int t = 0; t <= 2 * R; ++t)
            rp[t] = ring + ((it - 2 * R + t) % L::NSLOT) * SLOT;
        if constexpr (P == 2) {
            x_sweep<ORDER, M, Ring, true, STREAM_NT>(p, rp, nullptr, mat, xo,
                                                     y0, z0, so);
        } else {
            x_sweep<ORDER, M, Ring, false, STREAM_NT>(p, rp, tmp, mat, xo,
                                                      y0, z0, so);
            __syncthreads();
            if constexpr (P == 1) {
                plane_sweep<ORDER, M, AX::A2, Ring, typename L::Out, true,
                            STREAM_NT>(p, tmp, nullptr, mat, xo, y0, z0, so);
            } else {
                using Post = typename L::Post;
                plane_sweep<ORDER, M, AX::A1, Ring, Post, false, STREAM_NT>(
                    p, tmp, tmp2, mat, xo, y0, z0, so);
                __syncthreads();
                plane_sweep<ORDER, M, AX::A2, Post, typename L::Out, true,
                            STREAM_NT>(p, tmp2, nullptr, mat, xo, y0, z0, so);
            }
        }
    }
}

// ------------------------------- the one-step 3D body, cells owned by threads

// Whether the one-step form of (ORDER, M) has the owned body compiled
// (stream_step_owned): elastic3d at r = 1, orders 1 and 2. Orders 3-4 (a
// 45-float queue a thread) and acoustic3d keep the ring body, as does an
// orthotropic stack (compact_rows).
template <int ORDER, class M>
constexpr bool owned_form() {
    return Stencil<ORDER>::R == 1 && M::ID == STREAM_MODEL_ELASTIC3D;
}

// Whether the stack rows of p are the compact layout's: pair 0 reads one
// speed row and pairs 1-2 another, every zero one coupling row, the same
// along every axis (an orthotropic stack has a speed row per axis and
// pair, and a ratio row per axis and zero).
__host__ inline bool compact_rows(const GcmFusedParams& p) {
    for (int a = 0; a < 3; ++a) {
        if (p.npairs[a] != 3 || p.nzeros[a] != 2) return false;
        if (p.pair_c[a][0] != p.pair_c[0][0] ||
            p.pair_c[a][1] != p.pair_c[0][1] ||
            p.pair_c[a][2] != p.pair_c[0][1])
            return false;
        if (p.zero_kappa[a][0] != p.zero_kappa[0][0] ||
            p.zero_kappa[a][1] != p.zero_kappa[0][0])
            return false;
    }
    return true;
}

// The body a one-step 3D launch of stencil order `order` with parameters p
// runs: 1 the owned body (stream_step_owned), 0 the ring body
// (stream_step).
__host__ inline int stream_body(int order, const GcmFusedParams& p) {
    return (order == 1 || order == 2) &&
           p.model == STREAM_MODEL_ELASTIC3D && compact_rows(p);
}

// Shared memory of stream_step_owned for one (order, model, sweep order),
// in floats from the start of the block's buffer. Planes the owners alone
// read are stored in the owners' layout (C, 10 x 34 window cells: thread
// t's cell, component c, at c * 340 + t):
// - RAW: the incoming raw planes, each thread copying its own cell. When
//   x is swept first (P = 0) the x sweep reads its three planes here: five
//   planes, two of them staged ahead. Else two, one staged ahead, which the
//   first in-plane sweep reads at its neighbours;
// - Q (P > 0): the x sweep's three planes, each the last in-plane sweep
//   before x of a plane, a slot a plane;
// - T1: the x sweep's output (P = 0, 1) or the first in-plane sweep's (P
//   = 2), in its window's layout, read by the next sweep at neighbours;
// - T2: the first sweep after x when two follow it (P = 0).
template <int ORDER, class M, class AX>
struct OwnedLayout {
    static_assert(owned_form<ORDER, M>(), "the owned body's forms");
    static constexpr int R = 1, C = M::C, P = AX::P;
    using Raw = Win<R, false, false>;
    using Mid = Win<R, AX::ys(1), AX::zs(1)>;
    using Post = Win<R, AX::ys(2), AX::zs(2)>;
    using Out = Win<R, true, true>;
    // planes staged ahead of the one computing, and raw planes held
    static constexpr int AHEAD = P == 0 ? 2 : 1;
    static constexpr int NRAW = P == 0 ? 2 * R + 1 + AHEAD : AHEAD + 1;
    static constexpr int PL = C * Raw::VOL;
    static constexpr int RAW = 0;
    static constexpr int Q = RAW + NRAW * PL;
    static constexpr int T1 = Q + (P == 0 ? 0 : (2 * R + 1) * PL);
    static constexpr int T2 = T1 + C * (P == 0 ? Raw::VOL : Mid::VOL);
    static constexpr int FLOATS = T2 + (P == 0 ? C * Post::VOL : 0);
    static constexpr int BYTES = (int)sizeof(float) * FLOATS;
    // blocks an SM for __launch_bounds__: two, at up to 80 registers a
    // thread (the cell's materials of two planes, in registers); ptxas
    // reports no spills (PERF.md)
    static constexpr int MINB = 2;
};

// The layout of a one-step launch's body (OWNED: stream_step_owned).
template <int ORDER, class M, class AX, bool OWNED>
using StreamBody = std::conditional_t<OWNED, OwnedLayout<ORDER, M, AX>,
                                      StreamLayout<ORDER, M, AX>>;

// A cell's materials for every sweep of one plane, from a compact stack:
// the two wave speeds (pair 0's, pairs 1-2's), their impedances rho*c and
// half-reciprocals 0.5/z (0 where z is 0), and the coupling ratio.
struct CellMat {
    float c[2], z[2], rz[2], kap;
};

// Loads rho, the two speeds and the ratio of the cell at moff of plane mp.
template <class Mat, class MP>
__device__ __forceinline__ void mat_fetch(const GcmFusedParams& p,
                                          const Mat& mat, MP mp, int moff,
                                          float (&f)[4]) {
    f[0] = mat.ld(mp, p.rho_idx, moff);
    f[1] = mat.ld(mp, p.pair_c[0][0], moff);
    f[2] = mat.ld(mp, p.pair_c[0][1], moff);
    f[3] = mat.ld(mp, p.zero_kappa[0][0], moff);
}

__device__ __forceinline__ CellMat cell_mat(const float (&f)[4]) {
    CellMat m;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        m.c[s] = f[1 + s];
        m.z[s] = f[0] * m.c[s];
        m.rz[s] =
            m.z[s] > 0.0f ? 0.5f * rcp_rn(fmaxf(m.z[s], 1e-30f)) : 0.0f;
    }
    m.kap = f[3];
    return m;
}

// cell_core on materials computed once a plane.
template <int ORDER, class M, int A, class Ld>
__device__ __forceinline__ void cell_owned(const GcmFusedParams& p,
                                           const Ld& ld, const CellMat& m,
                                           int ga, float (&nw)[M::C]) {
    const auto co = [&](int q, float& c, float& z, float& rz) {
        const int s = q == 0 ? 0 : 1;
        c = m.c[s];
        z = m.z[s];
        rz = m.rz[s];
    };
    const auto ka = [&](int) { return m.kap; };
    cell_core<ORDER, M, A>(p, ld, co, ka, ga, nw);
}

// Cell (j, k) of the raw window (halo r = 1) in window W: whether it lies
// there, and its index there.
template <class W>
__device__ __forceinline__ bool in_win(int j, int k) {
    const int a = j - (1 - W::HY), b = k - (1 - W::HZ);
    return a >= 0 && a < W::EY && b >= 0 && b < W::EZ;
}
template <class W>
__device__ __forceinline__ int win_idx(int j, int k) {
    return (j - (1 - W::HY)) * W::EZ + k - (1 - W::HZ);
}

// The in-plane sweep along A (1 = y, 2 = z) of the owned cell (j, k) of
// the raw window, at global (gy, gz), when it lies in window Out: in(c, a,
// b) reads component c of cell (a, b) of window In, the sweep's input;
// put(nw) takes the new values.
template <int ORDER, class M, int A, class In, class Out, class InF,
          class Put>
__device__ __forceinline__ void owned_sweep(const GcmFusedParams& p,
                                            const InF& in, const CellMat& m,
                                            int j, int k, int gy, int gz,
                                            const Put& put) {
    static_assert(A == 1 || A == 2, "an in-plane axis");
    if (!in_win<Out>(j, k)) return;
    const int a = j - (1 - In::HY), b = k - (1 - In::HZ);
    const auto ld = [&](int c, int o) {
        return in(c, a + (A == 1 ? o : 0), b + (A == 2 ? o : 0));
    };
    float nw[M::C];
    cell_owned<ORDER, M, A>(p, ld, m, A == 1 ? gy : gz, nw);
    put(nw);
}

// One full 3D step (sweeps along AX::A0, A1, A2) of output planes [xa, xb)
// of the (y, z) tile at (y0, z0), walking x, by every thread of a
// STREAM_NT-thread block, each thread owning one cell of the tile's
// window with its r = 1 halo (10 x 34 cells, threads 0-339) in every sweep
// of every plane:
// - each incoming plane xi (from xa - 1 to xb, clamped by the source,
//   which replicates the edge) is staged into shared memory ahead of the
//   one computing, each thread copying its own cell (OwnedLayout::AHEAD);
// - the in-plane sweeps that precede x run on it, each cell reading its
//   neighbours from shared memory, and the cell's last value before x (at
//   P = 0 the raw cell) is its slot of the x sweep's three planes;
// - the x sweep of plane xo = xi - 1 reads the thread's own three slots,
//   which no other thread reads or writes: no barrier; the in-plane
//   sweeps that follow x run on its result through shared memory, and the
//   last sweep stores the tile's cells after the folded correctors;
// - the cell's materials are loaded a plane ahead into registers, and its
//   speeds, impedances and half-reciprocals computed once a plane for all
//   of its sweeps there (at P > 0 those of xi and of xo are both held).
// Two barriers a plane. The state is read once and written once; the (y,
// z) halo and 2 planes of in-plane sweeps a chunk are recomputed, as in
// stream_step.
template <int ORDER, class M, class AX, class Src, class Mat>
__device__ __forceinline__ void stream_step_owned(
        const GcmFusedParams& p, const Src& src, const Mat& mat, int xa,
        int xb, int y0, int z0, float* smem, const StepOut& so) {
    using L = OwnedLayout<ORDER, M, AX>;
    using Raw = typename L::Raw;
    using Mid = typename L::Mid;
    using Post = typename L::Post;
    using Out = typename L::Out;
    constexpr int R = 1, C = M::C, P = L::P, V = Raw::VOL;
    const int n1 = p.n[1], n2 = p.n[2];
    const int t = threadIdx.x;
    const bool own = t < V;
    const int j = t / Raw::EZ, k = t - j * Raw::EZ;
    const int gy = y0 - R + j, gz = z0 - R + k;
    const int moff = mat.cell(gy, gz);
    float* const t1 = smem + L::T1;
    float* const t2 = smem + L::T2;
    // incoming plane number `it` (x = xa - R + it), and slot `it` of the
    // x sweep's planes (P > 0)
    const auto raw = [&](int it) {
        return smem + L::RAW + (it % L::NRAW) * L::PL;
    };
    const auto slot = [&](int it) {
        return smem + L::Q + (it % (2 * R + 1)) * L::PL;
    };
    const auto stage = [&](int it) {
        if (!own) return;
        long long cs;
        const float* const s = src.cell(xa - R + it, gy, gz, &cs);
        float* const d = raw(it) + t;
#pragma unroll
        for (int c = 0; c < C; ++c) cp_async4(d + c * V, s + c * cs);
    };
    // window W's cells (a, e) in buffer b, in the owners' layout or in W's
    const auto owners = [](const float* b) {
        return [b](int c, int a, int e) { return b[c * V + a * Raw::EZ + e]; };
    };
    const auto view = [](const float* b, auto w) {
        using W = decltype(w);
        return [b](int c, int a, int e) {
            return b[c * W::VOL + a * W::EZ + e];
        };
    };
    const auto to_t = [&](float* b, auto w) {
        using W = decltype(w);
        return [b, j, k](float (&nw)[M::C]) {
            const int i = win_idx<W>(j, k);
#pragma unroll
            for (int c = 0; c < C; ++c) b[c * W::VOL + i] = nw[c];
        };
    };
    const auto to_global = [&](int x) {
        const long long off = ((long long)x * n1 + gy) * n2 + gz;
        const bool in = gy < n1 && gz < n2;
        return [&p, &so, off, in](float (&nw)[M::C]) {
            if (in) store_cell<M>(p, nw, so, off);
        };
    };
    // the x sweep of the thread's cell on its three planes, b(it) holding
    // the one of incoming plane it
    const auto x_cell = [&](auto b, int it, const CellMat& m, int xo,
                            float (&nw)[M::C]) {
        const float* const q0 = b(it - 2) + t;
        const float* const q1 = b(it - 1) + t;
        const float* const q2 = b(it) + t;
        const auto ld = [&](int c, int o) {
            return (o < 0 ? q0 : (o == 0 ? q1 : q2))[c * V];
        };
        cell_owned<ORDER, M, 0>(p, ld, m, xo, nw);
    };
    const int nin = xb - xa + 2 * R;
    // the materials of the next plane that needs them: at P = 0 the next
    // output plane, else the next incoming one
    float f[4];
    mat_fetch(p, mat, mat.plane(P == 0 ? xa : xa - R), moff, f);
    CellMat cur{}, prv{};
#pragma unroll
    for (int it = 0; it < L::AHEAD; ++it) {
        if (it < nin) stage(it);
        cp_async_commit();
    }
    for (int it = 0; it < nin; ++it) {
        const int xi = xa - R + it;
        const int xo = xi - R;
        // plane it has landed (each thread's own copies); at P > 0 every
        // thread is then done with plane it - 1, whose buffer takes plane
        // it + 1; at P = 0 the buffer that takes plane it + 2 was last
        // read by its owner before the previous plane's barriers
        cp_async_wait<L::AHEAD - 1>();
        if constexpr (P > 0) __syncthreads();
        if (it + L::AHEAD < nin) stage(it + L::AHEAD);
        cp_async_commit();
        if constexpr (P == 0) {
            if (it < 2 * R) continue;
            cur = cell_mat(f);
            if (xo + 1 < xb) mat_fetch(p, mat, mat.plane(xo + 1), moff, f);
            if (own) {
                float nw[C];
                x_cell(raw, it, cur, xo, nw);
                to_t(t1, Raw{})(nw);
            }
            __syncthreads();
            owned_sweep<ORDER, M, AX::A1, Raw, Post>(
                p, view(t1, Raw{}), cur, j, k, gy, gz, to_t(t2, Post{}));
            __syncthreads();
            owned_sweep<ORDER, M, AX::A2, Post, Out>(
                p, view(t2, Post{}), cur, j, k, gy, gz, to_global(xo));
        } else {
            prv = cur;
            cur = cell_mat(f);
            if (it + 1 < nin) mat_fetch(p, mat, mat.plane(xi + 1), moff, f);
            float* const q = slot(it) + t;
            const auto to_q = [q](float (&nw)[M::C]) {
#pragma unroll
                for (int c = 0; c < C; ++c) q[c * V] = nw[c];
            };
            if constexpr (P == 1) {
                owned_sweep<ORDER, M, AX::A0, Raw, Mid>(
                    p, owners(raw(it)), cur, j, k, gy, gz, to_q);
                if (it < 2 * R) continue;
                if (own && in_win<Mid>(j, k)) {
                    float nw[C];
                    x_cell(slot, it, prv, xo, nw);
                    to_t(t1, Mid{})(nw);
                }
                __syncthreads();
                owned_sweep<ORDER, M, AX::A2, Mid, Out>(
                    p, view(t1, Mid{}), prv, j, k, gy, gz, to_global(xo));
            } else {
                owned_sweep<ORDER, M, AX::A0, Raw, Mid>(
                    p, owners(raw(it)), cur, j, k, gy, gz, to_t(t1, Mid{}));
                __syncthreads();
                owned_sweep<ORDER, M, AX::A1, Mid, Out>(
                    p, view(t1, Mid{}), cur, j, k, gy, gz, to_q);
                if (it < 2 * R) continue;
                if (own && in_win<Out>(j, k)) {
                    float nw[C];
                    x_cell(slot, it, prv, xo, nw);
                    to_global(xo)(nw);
                }
            }
        }
    }
}

// ------------------------------------------ two steps a pass, streamed

// The output tile of the two-step body and its block: 8 x 16 at r = 1
// (65-76 KB of shared memory, three blocks an SM) and 4 x 32 at r = 2 (one
// block, 132-195 KB: every sweep-order pair fits the 227 KB a block has),
// and threads enough (rounded up to whole warps) for the first
// step's widest window, (TY + 4r) x (TZ + 4r) cells, in one pass.
template <int ORDER>
struct PairTile {
    static constexpr int R = Stencil<ORDER>::R;
    static constexpr int TY = R == 1 ? 8 : 4, TZ = R == 1 ? 16 : 32;
    static constexpr int NT = ((TY + 4 * R) * (TZ + 4 * R) + 31) / 32 * 32;
};

// The in-plane sweeps between the first step's x sweep and the second
// step's: the first step's after its x (KA of them), then the second
// step's before its x; K1 in all.
template <class AXA, class AXB>
struct PairChain {
    static constexpr int KA = 2 - AXA::P;
    static constexpr int K1 = KA + AXB::P;
    __host__ __device__ static constexpr int axis(int i) {
        return i < KA ? AXA::at(AXA::P + 1 + i) : AXB::at(i - KA);
    }
};

// Shared memory of stream_pair for one (order, model, sweep-order pair),
// in floats from the start of the block's buffer. The first step (A)
// starts from the tile with a 2R halo in y and z, the second (B) from A's
// output with an R halo; a window drops R along each axis it is swept.
// - RAW: two incoming raw planes (double buffer) when some in-plane sweep
//   precedes A's x sweep (PA > 0); at PA = 0 they go straight into RINGA;
// - RINGA: the planes A's x sweep reads, 2R + 1 (2R + 2 at PA = 0);
// - T0, T1: one plane each, for the in-plane sweeps around the x sweeps,
//   written in turn;
// - RINGB: the 2R + 1 planes B's x sweep reads, A's output planes after
//   the edge re-patch and B's in-plane sweeps before its x.
template <int ORDER, class M, class AXA_, class AXB_>
struct PairLayout {
    using AXA = AXA_;
    using AXB = AXB_;
    using T = PairTile<ORDER>;
    static constexpr int R = T::R, C = M::C, NT = T::NT;
    static constexpr int PA = AXA::P, PB = AXB::P;
    using Raw = Box<T::TY, T::TZ, 2 * R, 2 * R>;
    using MidA = Box<T::TY, T::TZ, 2 * R - R * AXA::ys(1),
                     2 * R - R * AXA::zs(1)>;
    using RingA = Box<T::TY, T::TZ, 2 * R - R * AXA::ys(PA),
                      2 * R - R * AXA::zs(PA)>;
    using OutA = Box<T::TY, T::TZ, R, R>;
    using RingB = Box<T::TY, T::TZ, R - R * AXB::ys(PB), R - R * AXB::zs(PB)>;
    using Out = Box<T::TY, T::TZ, 0, 0>;
    static constexpr int NRAW = PA == 0 ? 0 : 2;
    static constexpr int NSA = PA == 0 ? 2 * R + 2 : 2 * R + 1;
    static constexpr int NSB = 2 * R + 1;
    // the windows only shrink, so RINGA's (and at PA = 2 the one between
    // A's two in-plane sweeps) is the largest a temporary holds
    static constexpr int TVOL =
        PA == 2 && MidA::VOL > RingA::VOL ? MidA::VOL : RingA::VOL;
    static constexpr int RAW = 0;
    static constexpr int RINGA = RAW + NRAW * C * Raw::VOL;
    static constexpr int T0 = RINGA + NSA * C * RingA::VOL;
    static constexpr int T1 = T0 + C * TVOL;
    static constexpr int RINGB = T1 + C * TVOL;
    static constexpr int FLOATS = RINGB + NSB * C * RingB::VOL;
    static constexpr int BYTES = (int)sizeof(float) * FLOATS;
    static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
    // blocks an SM can hold by shared memory, at most 3: the register
    // budget of __launch_bounds__
    static constexpr int MINB = 233472 / (BYTES + 1024) >= 3
                                    ? 3
                                    : (233472 / (BYTES + 1024) >= 2 ? 2 : 1);
};

// A's output plane in window W (halo R, buffer b): each cell outside the
// domain in y or z takes the value of the cell at its coordinates clamped
// to the domain, the edge replication the plain version gives B's input.
// The clamped cell lies in the window (the tile's origin lies in the
// domain); only cells outside are written and only cells inside are read.
template <class W, int C, int NT>
__device__ __forceinline__ void patch_edges(float* b, int n1, int n2, int y0,
                                            int z0) {
    for (int idx = threadIdx.x; idx < W::VOL; idx += NT) {
        const int j = idx / W::EZ, k = idx - j * W::EZ;
        const int gy = y0 - W::HY + j, gz = z0 - W::HZ + k;
        const int cy = min(max(gy, 0), n1 - 1), cz = min(max(gz, 0), n2 - 1);
        if (cy == gy && cz == gz) continue;
        const int from = (cy - y0 + W::HY) * W::EZ + (cz - z0 + W::HZ);
#pragma unroll
        for (int c = 0; c < C; ++c) b[c * W::VOL + idx] = b[c * W::VOL + from];
    }
}

// The in-plane sweeps of PairChain from sweep I on, on plane x, the input
// (window In) in T0 for even I and T1 for odd I; each writes the other
// temporary and the last the ring slot `slot` of B. Before sweep KA (A's
// output complete), A's output is re-patched at the domain's y and z edges
// where the tile's window reaches past them (`edge`).
template <int ORDER, class M, class L, int I, class In, class Mat>
__device__ __forceinline__ void pair_chain(const GcmFusedParams& p,
                                           float* smem, float* slot,
                                           const Mat& mat, int x, int y0,
                                           int z0, bool edge,
                                           const StepOut& so) {
    using CH = PairChain<typename L::AXA, typename L::AXB>;
    float* const t0 = smem + L::T0;
    float* const t1 = smem + L::T1;
    if constexpr (I == CH::KA) {
        static_assert(In::HY == L::R && In::HZ == L::R, "A's output window");
        if (edge) {
            float* const a_out = I == CH::K1 ? slot : (I % 2 ? t1 : t0);
            patch_edges<In, M::C, L::NT>(a_out, p.n[1], p.n[2], y0, z0);
            __syncthreads();
        }
    }
    if constexpr (I < CH::K1) {
        constexpr int A = CH::axis(I);
        using Out = Drop<In, A, L::R>;
        plane_sweep<ORDER, M, A, In, Out, false, L::NT>(
            p, I % 2 ? t1 : t0, I == CH::K1 - 1 ? slot : (I % 2 ? t0 : t1),
            mat, x, y0, z0, so);
        __syncthreads();
        pair_chain<ORDER, M, L, I + 1, Out>(p, smem, slot, mat, x, y0, z0,
                                            edge, so);
    }
}

// Two full 3D steps (A along AXA, then B along AXB) of output planes
// [xa, xb) of the (y, z) tile at (y0, z0), walking x, by every thread of
// an L::NT-thread block. A runs stream_step's pipeline on the tile with a
// 2R halo in y and z: each incoming plane (from the clamping source, which
// replicates the edge) is staged while the previous one computes, A's
// in-plane sweeps before x put it into ring A, and A's x sweep of the
// plane R behind reads that ring. A computes its output planes inside the
// domain only, [xa - R, xb + R) cut to [0, n0); its in-plane sweeps after
// x, the edge re-patch and B's in-plane sweeps before x turn each into a
// plane of ring B, which B's x sweep reads at clamped plane indices (the
// edge replication along x). B runs R planes behind A (at the domain's
// last plane it flushes the rest of the chunk), and its last sweep stores
// the tile. State and materials are read once and the state written once
// a pass; A's (y, z) halo and 2R planes of A a chunk are recomputed.
template <int ORDER, class M, class AXA, class AXB, class Src, class Mat>
__device__ __forceinline__ void stream_pair(const GcmFusedParams& p,
                                            const Src& src, const Mat& mat,
                                            int xa, int xb, int y0, int z0,
                                            float* smem, const StepOut& so) {
    using L = PairLayout<ORDER, M, AXA, AXB>;
    using CH = PairChain<AXA, AXB>;
    using Raw = typename L::Raw;
    using RingA = typename L::RingA;
    using RingB = typename L::RingB;
    constexpr int R = L::R, C = M::C, PA = L::PA, PB = L::PB, NT = L::NT;
    constexpr int SA = C * RingA::VOL, SB = C * RingB::VOL;
    float* const ringa = smem + L::RINGA;
    float* const ringb = smem + L::RINGB;
    float* const t0 = smem + L::T0;
    float* const t1 = smem + L::T1;
    const int n0 = p.n[0];
    const int ya = max(xa - R, 0), yb = min(xb + R, n0);
    const bool edge = y0 - R < 0 || y0 + L::T::TY + R > p.n[1] ||
                      z0 - R < 0 || z0 + L::T::TZ + R > p.n[2];
    // the buffer of incoming plane number `it` (counted from ya - R)
    const auto inbox = [&](int it) {
        return PA == 0 ? ringa + (it % L::NSA) * SA
                       : smem + L::RAW + (it & 1) * (C * Raw::VOL);
    };
    const int nin = yb - ya + 2 * R;
    src.template stage<C, Raw::EY, Raw::EZ, NT>(inbox(0), ya - R, y0 - 2 * R,
                                                z0 - 2 * R);
    cp_async_commit();
    for (int it = 0; it < nin; ++it) {
        const int xi = ya - R + it;
        if (it + 1 < nin)
            src.template stage<C, Raw::EY, Raw::EZ, NT>(
                inbox(it + 1), xi + 1, y0 - 2 * R, z0 - 2 * R);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if constexpr (PA > 0) {
            float* const slot = ringa + (it % L::NSA) * SA;
            const float* const in = inbox(it);
            if constexpr (PA == 1) {
                plane_sweep<ORDER, M, AXA::A0, Raw, RingA, false, NT>(
                    p, in, slot, mat, xi, y0, z0, so);
            } else {
                using Mid = typename L::MidA;
                plane_sweep<ORDER, M, AXA::A0, Raw, Mid, false, NT>(
                    p, in, t0, mat, xi, y0, z0, so);
                __syncthreads();
                plane_sweep<ORDER, M, AXA::A1, Mid, RingA, false, NT>(
                    p, t0, slot, mat, xi, y0, z0, so);
            }
            __syncthreads();
        }
        if (it < 2 * R) continue;
        // A's output plane xo, into ring B
        const int xo = xi - R;
        float* const bslot = ringb + (xo % L::NSB) * SB;
        const float* rp[2 * R + 1];
#pragma unroll
        for (int t = 0; t <= 2 * R; ++t)
            rp[t] = ringa + ((it - 2 * R + t) % L::NSA) * SA;
        x_sweep<ORDER, M, RingA, false, NT>(p, rp, CH::K1 == 0 ? bslot : t0,
                                            mat, xo, y0, z0, so);
        __syncthreads();
        pair_chain<ORDER, M, L, 0, RingA>(p, smem, bslot, mat, xo, y0, z0,
                                          edge, so);
        // B on every output plane whose planes of ring B are all there
        const int last = xo == n0 - 1 ? xb : min(xb, xo - R + 1);
        for (int xq = max(xa, xo - R); xq < last; ++xq) {
            const float* rq[2 * R + 1];
#pragma unroll
            for (int t = 0; t <= 2 * R; ++t)
                rq[t] = ringb +
                        (min(max(xq - R + t, 0), n0 - 1) % L::NSB) * SB;
            if constexpr (PB == 2) {
                x_sweep<ORDER, M, RingB, true, NT>(p, rq, nullptr, mat, xq,
                                                   y0, z0, so);
            } else {
                x_sweep<ORDER, M, RingB, false, NT>(p, rq, t0, mat, xq, y0,
                                                    z0, so);
                __syncthreads();
                if constexpr (PB == 1) {
                    plane_sweep<ORDER, M, AXB::A2, RingB, typename L::Out,
                                true, NT>(p, t0, nullptr, mat, xq, y0, z0,
                                          so);
                } else {
                    using Post = Drop<RingB, AXB::A1, R>;
                    plane_sweep<ORDER, M, AXB::A1, RingB, Post, false, NT>(
                        p, t0, t1, mat, xq, y0, z0, so);
                    __syncthreads();
                    plane_sweep<ORDER, M, AXB::A2, Post, typename L::Out,
                                true, NT>(p, t1, nullptr, mat, xq, y0, z0,
                                          so);
                }
            }
            __syncthreads();
        }
    }
}

// ------------------------------------------- the one-step 2D body, streamed

// The one-step 2D body: a block of ROWS_NT threads (4 warps) owns a window
// of ROWS_NT columns of y (the contiguous axis), one a thread, whose middle
// ROWS_NT - 2R columns are its output strip, and walks a chunk of x rows.
// Incoming rows are staged ROWS_DEPTH - 1 rows ahead.
constexpr int ROWS_NT = 128;
constexpr int ROWS_DEPTH = 4;

template <int ORDER>
struct RowTile {
    static constexpr int R = Stencil<ORDER>::R;
    // output columns a block (the window less its R halo on each side)
    static constexpr int TY = ROWS_NT - 2 * R;
    // floats a staged component row: the window from the multiple of 4
    // at or below its first column, whole 16-byte vectors
    static constexpr int EW = ROWS_NT + 4;
    // blocks an SM for __launch_bounds__: a budget of 85 registers a
    // thread, which ptxas does not reach (48-79, no stack frame), so the
    // order 1-2 forms hold 8 blocks (32 warps) an SM
    static constexpr int MINB = 6;
};

// Shared memory of stream_rows for C components, in floats: ROWS_DEPTH
// staged rows of C x EW and, when x is swept first, the x sweep's output
// row (C x ROWS_NT) that the y sweep reads.
template <int ORDER, int C, bool XFIRST>
struct RowLayout {
    static constexpr int FLOATS =
        ROWS_DEPTH * C * RowTile<ORDER>::EW + (XFIRST ? C * ROWS_NT : 0);
    static constexpr int BYTES = (int)sizeof(float) * FLOATS;
};

// Starts the copy of C component rows, cells [ys, ys + EW) at clamped
// columns, into dst (C, EW), by a block of NT threads; row(c) is the
// first cell of component c's row (ny cells). With `vec` (ys a multiple of
// 4, every component row 16-byte aligned) each 4-cell vector inside the
// row is one 16-byte copy; vectors that reach past either end, and every
// vector without `vec`, are four 4-byte copies of clamped cells (the edge
// replication of the plain step).
template <int C, int EW, int NT, class Row>
__device__ __forceinline__ void stage_row(float* dst, const Row& row, int ys,
                                          int ny, bool vec) {
    constexpr int NV = EW / 4;
    for (int e = threadIdx.x; e < C * NV; e += NT) {
        const int c = e / NV, v = e - c * NV;
        const int y = ys + 4 * v;
        const float* rp = row(c);
        float* d = dst + c * EW + 4 * v;
        if (vec && y >= 0 && y + 4 <= ny) {
            cp_async16(d, rp + y);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                cp_async4(d + k, rp + min(max(y + k, 0), ny - 1));
        }
    }
}

// One full 2D step (sweeps along x then y when XFIRST, else y then x) of
// output rows [xa, xb) of the strip of columns [y0, y0 + TY), walking x,
// by every thread of a ROWS_NT-thread block; thread w owns window column
// gy = y0 - R + w. Each incoming row xi (from xa - R to xb + R - 1, clamped
// by the source, which replicates the edge) is staged into shared memory
// ROWS_DEPTH - 1 rows ahead of the one computing. Without XFIRST the y
// sweep runs on it for the strip's columns, reading the staged row at the
// column's neighbours; with XFIRST the raw column is taken as it is. That
// result enters the thread's ring of the last 2R + 1 rows, in registers:
// the x sweep needs only its own column. Then the x sweep of row xi - R
// reads the ring and either stores the strip (y swept already) or writes
// the whole window row to shared memory, whose R halo columns the y sweep
// of the strip then reads. One formulation for both sweep orders; the
// state is read once and written once, and 2R rows of y sweeps a chunk
// (XFIRST: 2R of the window's columns a row) are recomputed.
template <int ORDER, class M, bool XFIRST, class Src, class Mat>
__device__ __forceinline__ void stream_rows(const GcmFusedParams& p,
                                            const Src& src, const Mat& mat,
                                            int xa, int xb, int y0,
                                            float* smem, const StepOut& so,
                                            bool vec) {
    using T = RowTile<ORDER>;
    constexpr int R = T::R, C = M::C, EW = T::EW, D = ROWS_DEPTH;
    const int ny = p.n[1];
    const int w = threadIdx.x;
    const int gy = y0 - R + w;
    // the first staged column (a multiple of 4 at or below the window's
    // first) and this thread's column in a staged row
    const int ys = (y0 - R) & ~3;
    const int col = y0 - R - ys + w;
    const bool strip = w >= R && w < R + T::TY && gy < ny;
    float* const xrow = smem + D * C * EW;
    const auto raw = [&](int it) { return smem + (it % D) * (C * EW); };
    const auto stage = [&](int it) {
        const int x = xa - R + it;
        stage_row<C, EW, ROWS_NT>(raw(it),
                                  [&](int c) { return src.row(c, x); }, ys,
                                  ny, vec);
    };
    const int nin = xb - xa + 2 * R;
#pragma unroll
    for (int it = 0; it < D - 1; ++it) {
        if (it < nin) stage(it);
        cp_async_commit();
    }
    float ring[2 * R + 1][C];
#pragma unroll
    for (int t = 0; t <= 2 * R; ++t)
#pragma unroll
        for (int c = 0; c < C; ++c) ring[t][c] = 0.0f;
    for (int it = 0; it < nin; ++it) {
        const int xi = xa - R + it;
        // row it has landed; every thread is done with row it - 1, whose
        // buffer takes row it + D - 1
        cp_async_wait<D - 2>();
        __syncthreads();
        if (it + D - 1 < nin) stage(it + D - 1);
        cp_async_commit();
#pragma unroll
        for (int t = 0; t < 2 * R; ++t)
#pragma unroll
            for (int c = 0; c < C; ++c) ring[t][c] = ring[t + 1][c];
        const float* const in = raw(it) + col;
        if constexpr (XFIRST) {
#pragma unroll
            for (int c = 0; c < C; ++c) ring[2 * R][c] = in[c * EW];
        } else if (strip) {
            const auto ld = [&](int c, int o) { return in[c * EW + o]; };
            cell_sweep<ORDER, M, 1>(p, ld, mat, mat.plane(xi),
                                    mat.cell(gy, 0), gy, ring[2 * R]);
        }
        if (it < 2 * R) continue;
        const int xo = xi - R;
        const auto mp = mat.plane(xo);
        const int mc = mat.cell(gy, 0);
        const long long off = (long long)xo * ny + gy;
        const auto ldx = [&](int c, int o) { return ring[o + R][c]; };
        float nw[C];
        if constexpr (XFIRST) {
            cell_sweep<ORDER, M, 0>(p, ldx, mat, mp, mc, xo, nw);
#pragma unroll
            for (int c = 0; c < C; ++c) xrow[c * ROWS_NT + w] = nw[c];
            __syncthreads();
            if (strip) {
                const float* const b = xrow + w;
                const auto ldy = [&](int c, int o) {
                    return b[c * ROWS_NT + o];
                };
                cell_sweep<ORDER, M, 1>(p, ldy, mat, mp, mc, gy, nw);
                store_cell<M>(p, nw, so, off);
            }
        } else if (strip) {
            cell_sweep<ORDER, M, 0>(p, ldx, mat, mp, mc, xo, nw);
            store_cell<M>(p, nw, so, off);
        }
    }
}

// ------------------------------------------ two 2D steps a pass, streamed

// The two-step 2D body: a block of PAIR_ROWS_NT threads (4 warps) owns a
// window of PAIR_ROWS_NT columns of y, one a thread, and walks a chunk of x
// rows. Its output strip is the middle PAIR_ROWS_NT - 4R columns: the first
// step's y sweep drops R columns on each side, the second's another R.
constexpr int PAIR_ROWS_NT = 128;

template <int ORDER>
struct PairRowTile {
    static constexpr int R = Stencil<ORDER>::R;
    static constexpr int NT = PAIR_ROWS_NT;
    // output columns a block
    static constexpr int TY = NT - 4 * R;
    // floats a staged component row (stream_rows' EW)
    static constexpr int EW = NT + 4;
    // blocks an SM for __launch_bounds__: 102 registers a thread at r = 1,
    // 128 at r = 2, where each of the two register rings holds 5 rows
    static constexpr int MINB = R == 1 ? 5 : 4;
};

// Shared memory of stream_rows_pair for C components, in floats:
// ROWS_DEPTH staged rows of C x EW; A's x sweep output row when A sweeps
// x first (XROW); A's output row (AROW), which B reads at columns clamped
// to the domain; and, when B sweeps x first, two rows of B's x sweep
// output (BROW), written in turn by consecutive output rows.
template <int ORDER, int C, bool XA, bool XB>
struct PairRowLayout {
    using T = PairRowTile<ORDER>;
    static constexpr int ROW = C * T::NT;
    static constexpr int XROW = ROWS_DEPTH * C * T::EW;
    static constexpr int AROW = XROW + (XA ? ROW : 0);
    static constexpr int BROW = AROW + ROW;
    static constexpr int FLOATS = BROW + (XB ? 2 * ROW : 0);
    static constexpr int BYTES = (int)sizeof(float) * FLOATS;
};

// Two full 2D steps (A along x then y when XA, else y then x; B the same
// with XB) of output rows [xa, xb) of the strip of columns [y0, y0 + TY),
// walking x, by every thread of a PAIR_ROWS_NT-thread block; thread w owns
// window column gy = y0 - 2R + w.
// - A runs stream_rows' pipeline on the whole window: each incoming row
//   (clamped by the source, which replicates the edge) is staged
//   ROWS_DEPTH - 1 rows ahead; A's first sweep puts it into A's register
//   ring of 2R + 1 rows, whose x sweep gives A's output row R behind. A
//   computes its output rows inside the domain only, [xa - R, xb + R) cut
//   to [0, n0), and its columns [R, NT - R) of the window, the ones B's y
//   sweep reads.
// - The y edge: A's output row goes through a shared row, which B reads at
//   columns clamped to the domain, the edge replication the plain version
//   gives B's input (a thread outside reads another thread's value, hence
//   the barrier).
// - The x edge: B keeps its own register ring of 2R + 1 rows of A's output
//   after B's first sweep, filled at clamped row indices: at row 0 the
//   first row enters R + 1 times (more in a chunk that starts near it),
//   and after row n0 - 1 the last row enters again until the chunk's
//   output rows are done. This is the TPU kernel's re-patch of the halo
//   between the steps.
// - B runs R rows behind A, and its last sweep stores the strip.
// The state and the materials are read once a pass and the state written
// once; 2R columns of A a window and 2R rows of A a chunk are recomputed.
template <int ORDER, class M, bool XA, bool XB, class Src, class Mat>
__device__ __forceinline__ void stream_rows_pair(const GcmFusedParams& p,
                                                 const Src& src,
                                                 const Mat& mat, int xa,
                                                 int xb, int y0, float* smem,
                                                 const StepOut& so,
                                                 bool vec) {
    using T = PairRowTile<ORDER>;
    using L = PairRowLayout<ORDER, M::C, XA, XB>;
    constexpr int R = T::R, C = M::C, NT = T::NT, EW = T::EW;
    constexpr int D = ROWS_DEPTH;
    const int n0 = p.n[0], ny = p.n[1];
    const int w = threadIdx.x;
    const int y0w = y0 - 2 * R;          // the window's first column
    const int gy = y0w + w;
    const bool inside = gy >= 0 && gy < ny;
    // A's output columns, and the strip's columns inside the domain
    const bool acol = w >= R && w < NT - R;
    const bool strip = w >= 2 * R && w < NT - 2 * R && gy < ny;
    // the first staged column (a multiple of 4 at or below the window's
    // first) and this thread's column in a staged row
    const int ys = y0w & ~3;
    const int col = y0w - ys + w;
    float* const xrow = smem + L::XROW;
    float* const arow = smem + L::AROW;
    // the window position of column g clamped to the domain
    const auto at = [&](int g) { return min(max(g, 0), ny - 1) - y0w; };
    const auto raw = [&](int it) { return smem + (it % D) * (C * EW); };
    // A's output rows, and the incoming rows from ya - R on
    const int ya = max(xa - R, 0), yb = min(xb + R, n0);
    const auto stage = [&](int it) {
        const int x = ya - R + it;
        stage_row<C, EW, NT>(raw(it), [&](int c) { return src.row(c, x); },
                             ys, ny, vec);
    };
    const int nin = yb - ya + 2 * R;
#pragma unroll
    for (int it = 0; it < D - 1; ++it) {
        if (it < nin) stage(it);
        cp_async_commit();
    }
    float ra[2 * R + 1][C], rb[2 * R + 1][C];
#pragma unroll
    for (int t = 0; t <= 2 * R; ++t)
#pragma unroll
        for (int c = 0; c < C; ++c) ra[t][c] = rb[t][c] = 0.0f;
    const int mc = mat.cell(gy, 0);
    for (int it = 0; it < nin; ++it) {
        const int xi = ya - R + it;
        // row it has landed; every thread is done with row it - 1, whose
        // buffer takes row it + D - 1, and with the shared rows
        cp_async_wait<D - 2>();
        __syncthreads();
        if (it + D - 1 < nin) stage(it + D - 1);
        cp_async_commit();
#pragma unroll
        for (int t = 0; t < 2 * R; ++t)
#pragma unroll
            for (int c = 0; c < C; ++c) ra[t][c] = ra[t + 1][c];
        const float* const in = raw(it) + col;
        if constexpr (XA) {
#pragma unroll
            for (int c = 0; c < C; ++c) ra[2 * R][c] = in[c * EW];
        } else if (acol && inside) {
            const auto ld = [&](int c, int o) { return in[c * EW + o]; };
            cell_sweep<ORDER, M, 1>(p, ld, mat, mat.plane(xi), mc, gy,
                                    ra[2 * R]);
        }
        if (it < 2 * R) continue;
        // A's output row xo into the shared row
        const int xo = xi - R;
        const auto mp = mat.plane(xo);
        const auto ldx = [&](int c, int o) { return ra[o + R][c]; };
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = 0.0f;
        if constexpr (XA) {
            cell_sweep<ORDER, M, 0>(p, ldx, mat, mp, mc, xo, v);
#pragma unroll
            for (int c = 0; c < C; ++c) xrow[c * NT + w] = v[c];
            __syncthreads();
            if (acol && inside) {
                const float* const b = xrow + w;
                const auto ldy = [&](int c, int o) { return b[c * NT + o]; };
                cell_sweep<ORDER, M, 1>(p, ldy, mat, mp, mc, gy, v);
            }
        } else if (acol && inside) {
            cell_sweep<ORDER, M, 0>(p, ldx, mat, mp, mc, xo, v);
        }
        if (acol && inside) {
#pragma unroll
            for (int c = 0; c < C; ++c) arow[c * NT + w] = v[c];
        }
        __syncthreads();
        // B's first sweep on A's row xo, read at clamped columns
        if constexpr (XB) {
            if (acol) {
                const int k = at(gy);
#pragma unroll
                for (int c = 0; c < C; ++c) v[c] = arow[c * NT + k];
            }
        } else if (strip) {
            const auto ldy = [&](int c, int o) {
                return arow[c * NT + at(gy + o)];
            };
            cell_sweep<ORDER, M, 1>(p, ldy, mat, mp, mc, gy, v);
        }
        // the rows of B's ring that row xo stands for: itself, and at the
        // domain's first and last rows the rows outside up to the chunk's
        // reach [xa - R, xb + R)
        const int vlo = xo == ya ? xa - R : xo;
        const int vhi = xo == yb - 1 ? xb + R - 1 : xo;
        for (int vr = vlo; vr <= vhi; ++vr) {
#pragma unroll
            for (int t = 0; t < 2 * R; ++t)
#pragma unroll
                for (int c = 0; c < C; ++c) rb[t][c] = rb[t + 1][c];
#pragma unroll
            for (int c = 0; c < C; ++c) rb[2 * R][c] = v[c];
            // B's output row xq, whose ring rows are all there
            const int xq = vr - R;
            if (xq < xa || xq >= xb) continue;
            const auto mq = mat.plane(xq);
            const auto ldb = [&](int c, int o) { return rb[o + R][c]; };
            const long long off = (long long)xq * ny + gy;
            float nw[C];
            if constexpr (XB) {
                // B's x sweep over A's columns, which B's y sweep reads
                float* const bb = smem + L::BROW + (xq & 1) * L::ROW;
                if (acol) {
                    cell_sweep<ORDER, M, 0>(p, ldb, mat, mq, mc, xq, nw);
#pragma unroll
                    for (int c = 0; c < C; ++c) bb[c * NT + w] = nw[c];
                }
                __syncthreads();
                if (strip) {
                    const float* const b = bb + w;
                    const auto ldy = [&](int c, int o) {
                        return b[c * NT + o];
                    };
                    cell_sweep<ORDER, M, 1>(p, ldy, mat, mq, mc, gy, nw);
                    store_cell<M>(p, nw, so, off);
                }
            } else if (strip) {
                cell_sweep<ORDER, M, 0>(p, ldb, mat, mq, mc, xq, nw);
                store_cell<M>(p, nw, so, off);
            }
        }
    }
}

// -------------------------------------------- host side of the streamed body

template <int N>
struct Int {
    static constexpr int value = N;
};

// Calls f(Int<order>{}) for a stencil order 1-4.
template <class F>
__host__ inline cudaError_t with_stencil(int order, F&& f) {
    switch (order) {
        case 1: return f(Int<1>{});
        case 2: return f(Int<2>{});
        case 3: return f(Int<3>{});
        case 4: return f(Int<4>{});
        default: return cudaErrorInvalidValue;
    }
}

// Calls f(M{}) for the compiled component map p.model.
template <class F>
__host__ inline cudaError_t with_model(int model, F&& f) {
    switch (model) {
        case STREAM_MODEL_ELASTIC3D: return f(Elastic3D{});
        case STREAM_MODEL_ACOUSTIC3D: return f(Acoustic3D{});
        default: return cudaErrorInvalidValue;
    }
}

// Calls f(M{}) for a 2D component map p.model (SWEEP_MODEL_ELASTIC2D,
// SWEEP_MODEL_ACOUSTIC2D).
template <class F>
__host__ inline cudaError_t with_model_2d(int model, F&& f) {
    switch (model) {
        case SWEEP_MODEL_ELASTIC2D: return f(Elastic2D{});
        case SWEEP_MODEL_ACOUSTIC2D: return f(Acoustic2D{});
        default: return cudaErrorInvalidValue;
    }
}

// Calls f(Int<order>{}, M{}, std::bool_constant<XFIRST>{}) for a launch
// of the one-step 2D body (stream_rows): a stencil order 1-4, the compiled
// 2D map p.model, and the sweep order p.axes, (0, 1) x first or (1, 0) y
// first.
template <class F>
__host__ inline cudaError_t with_rows(int order, const GcmFusedParams& p,
                                      F&& f) {
    if ((p.axes[0] != 0 && p.axes[0] != 1) || p.axes[1] != 1 - p.axes[0])
        return cudaErrorInvalidValue;
    return with_stencil(order, [&](auto o) {
        return with_model_2d(p.model, [&](auto mdl) {
            return p.axes[0] == 0 ? f(o, mdl, std::true_type{})
                                  : f(o, mdl, std::false_type{});
        });
    });
}

// Calls f(M{}, std::bool_constant<XA>{}, std::bool_constant<XB>{}) for a
// launch of the two-step 2D body (stream_rows_pair): the compiled 2D map
// p.model and the sweep orders p.axes (A) and p.axes_next (B), each (0, 1)
// x first or (1, 0) y first.
template <class F>
__host__ inline cudaError_t with_rows_pair(const GcmFusedParams& p, F&& f) {
    const auto order_2d = [](const int* ax) {
        return (ax[0] == 0 || ax[0] == 1) && ax[1] == 1 - ax[0];
    };
    if (!order_2d(p.axes) || !order_2d(p.axes_next))
        return cudaErrorInvalidValue;
    return with_model_2d(p.model, [&](auto mdl) {
        if (p.axes[0] == 0)
            return p.axes_next[0] == 0
                       ? f(mdl, std::true_type{}, std::true_type{})
                       : f(mdl, std::true_type{}, std::false_type{});
        return p.axes_next[0] == 0
                   ? f(mdl, std::false_type{}, std::true_type{})
                   : f(mdl, std::false_type{}, std::false_type{});
    });
}

// Calls f(M{}) for any of the four compiled component maps (the per-sweep
// kernel's, and the streamed bodies' 3D and 2D ones).
template <class F>
__host__ inline cudaError_t with_sweep_model(int model, F&& f) {
    switch (model) {
        case SWEEP_MODEL_ELASTIC2D: return f(Elastic2D{});
        case SWEEP_MODEL_ACOUSTIC2D: return f(Acoustic2D{});
        default: return with_model(model, f);
    }
}

// Calls f(Axes<...>{}) for a sweep order, any permutation of (0, 1, 2).
template <class F>
__host__ inline cudaError_t with_axes(const int* ax, F&& f) {
    switch (ax[0] * 9 + ax[1] * 3 + ax[2]) {
        case 5: return f(Axes<0, 1, 2>{});
        case 7: return f(Axes<0, 2, 1>{});
        case 11: return f(Axes<1, 0, 2>{});
        case 15: return f(Axes<1, 2, 0>{});
        case 19: return f(Axes<2, 0, 1>{});
        case 21: return f(Axes<2, 1, 0>{});
        default: return cudaErrorInvalidValue;
    }
}

// Whether a pointer is 16-byte aligned (for 16-byte vector copies).
__host__ inline bool aligned16(const void* q) {
    return ((uintptr_t)q & 15) == 0;
}

// Makes `device` the calling thread's current device for the life of the
// object and then restores the device that was current before. Every entry
// point opens with one: an entry that left the device of its launch current
// would send the caller's later work that names no device (PyTorch's
// torch.cuda.synchronize(), torch.empty(..., device="cuda")) to the card of
// the last shard launched.
class DeviceScope {
  public:
    explicit DeviceScope(int device) {
        err_ = cudaGetDevice(&prev_);
        if (err_ == cudaSuccess && prev_ != device) {
            err_ = cudaSetDevice(device);
            restore_ = err_ == cudaSuccess;
        }
    }
    ~DeviceScope() {
        if (restore_) cudaSetDevice(prev_);
    }
    DeviceScope(const DeviceScope&) = delete;
    DeviceScope& operator=(const DeviceScope&) = delete;
    cudaError_t error() const { return err_; }

  private:
    int prev_ = 0;
    bool restore_ = false;
    cudaError_t err_ = cudaSuccess;
};

// What a launch of the streamed body would get: resident blocks an SM at
// its shared memory, and that shared memory.
struct StreamOccupancy {
    int blocks_per_sm;
    int smem_bytes;
};

// Allows `smem` bytes of dynamic shared memory to `kernel` and returns its
// resident blocks an SM at `nt` threads a block, on the current device.
// Each kernel, device and size is asked of the runtime once and kept (as
// stream_chunk keeps a device's SM count and a shape's chunk): asked at
// every launch it would cost the host microseconds, and the SPMD paths are
// host-paced. A mutex guards the caches, since launches can come from
// several host threads. A kernel's allowance only grows: the two-step 2D
// kernel takes shared memory by its components and sweep orders, and an
// allowance cut to a smaller launch's would refuse a larger one.
template <class K>
__host__ inline cudaError_t stream_blocks_per_sm(K kernel, int smem, int* bps,
                                                 int nt = STREAM_NT) {
    static std::mutex mu;
    static std::map<std::tuple<const void*, int>, int> allowed;
    static std::map<std::tuple<const void*, int, int, int>, int> blocks;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const void* const k = (const void*)kernel;
    std::lock_guard<std::mutex> lock(mu);
    int& most = allowed[{k, device}];
    if (smem > most) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        most = smem;
    }
    const auto key = std::make_tuple(k, device, smem, nt);
    const auto it = blocks.find(key);
    if (it != blocks.end()) {
        *bps = it->second;
        return cudaSuccess;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(bps, kernel, nt, smem);
    if (err == cudaSuccess) blocks.emplace(key, *bps);
    return err;
}

// The SM count of a device, asked of the runtime once and kept (1 if the
// query fails).
__host__ inline int sm_count(int device) {
    static std::mutex mu;
    static std::map<int, int> sms;
    std::lock_guard<std::mutex> lock(mu);
    auto sm = sms.find(device);
    if (sm == sms.end()) {
        int n = 0;
        if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                   device) == cudaSuccess && n > 0)
            sm = sms.emplace(device, n).first;
    }
    return sm == sms.end() ? 1 : sm->second;
}

// Planes a block walks when `columns` (y, z) tiles each walk `len` planes
// beside `fixed` other blocks of the launch, and `bps` blocks an SM are
// resident: the chunk that minimizes the waves of blocks times the planes
// each block stages (its chunk and the 2R planes of in-plane sweeps it
// recomputes around it). On an H100 at 2 blocks an SM, 128 columns of 256
// planes take 2 chunks: one wave of 256 blocks.
__host__ inline int stream_chunk(int len, long long columns, int R, int bps,
                                 int device, long long fixed = 0) {
    static std::mutex mu;
    static std::map<std::tuple<int, long long, int, int, int, long long>,
                    int> chunks;
    const int nsm = sm_count(device);
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(len, columns, R, bps, device, fixed);
    const auto it = chunks.find(key);
    if (it != chunks.end()) return it->second;
    const long long slots = (long long)(bps > 0 ? bps : 1) * nsm;
    int best = len;
    long long best_cost = -1;
    for (int nch = 1; nch <= len; ++nch) {
        const int ch = (len + nch - 1) / nch;
        if ((len + ch - 1) / ch != nch) continue;
        const long long waves = (columns * nch + fixed + slots - 1) / slots;
        const long long cost = waves * (ch + 2 * R);
        if (best_cost < 0 || cost < best_cost) {
            best_cost = cost;
            best = ch;
        }
    }
    chunks.emplace(key, best);
    return best;
}

}  // namespace
