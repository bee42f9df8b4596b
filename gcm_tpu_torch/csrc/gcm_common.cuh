// Device code shared by the port's CUDA kernels (sm_90a): the parameter
// block of the fused steps, Lagrange stencil weights, the border algebra,
// material stacks stored as float or bf16 (upcast at the load), one
// characteristic sweep over a box of cells, the folded ODE corrector
// epilogue, and a whole step (or K steps, temporal blocking) on one tile.
//
// The device functions sit in an anonymous namespace: each kernel source
// compiles its own copy, and the sources link into one library without
// clashing symbols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAXC = 9;      // components of the largest model (elastic3d)
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
};

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

// A box of cells in global coordinates (may reach outside the domain).
struct Region {
    int o[3];
    int e[3];
    int vol;
};

// Reads the state from global memory at clamped coordinates.
struct GlobalSrc {
    const float* __restrict__ u;
    int n0, n1, n2;
    long long N;
    __device__ float ld(int c, int x, int y, int z) const {
        x = min(max(x, 0), n0 - 1);
        y = min(max(y, 0), n1 - 1);
        z = min(max(z, 0), n2 - 1);
        return __ldg(u + c * N + ((long long)x * n1 + y) * n2 + z);
    }
};

// Reads one shard's state: its local block (C, n0, n1, n2) inside, and the
// halo slabs received from its neighbours (parallel/fused_spmd.py::
// exchange_slabs) up to R cells outside it along x and y. xlo/xhi are
// (C, R, n1, n2); ylo/yhi are (C, n0 + 2R, R, n2) and span the x-extended
// range, so they hold the corners and win there. Without y slabs (a 2D
// shard, split along x only) y clamps; z always clamps.
struct SlabSrc {
    const float* __restrict__ u;
    const float* __restrict__ xlo;
    const float* __restrict__ xhi;
    const float* __restrict__ ylo;
    const float* __restrict__ yhi;
    int n0, n1, n2, R;
    long long N;
    __device__ float ld(int c, int x, int y, int z) const {
        z = min(max(z, 0), n2 - 1);
        x = min(max(x, -R), n0 - 1 + R);
        if (ylo == nullptr) y = min(max(y, 0), n1 - 1);
        else y = min(max(y, -R), n1 - 1 + R);
        if (y < 0)
            return __ldg(ylo + (((long long)c * (n0 + 2 * R) + x + R) * R
                                + y + R) * n2 + z);
        if (y >= n1)
            return __ldg(yhi + (((long long)c * (n0 + 2 * R) + x + R) * R
                                + y - n1) * n2 + z);
        if (x < 0)
            return __ldg(xlo + (((long long)c * R + x + R) * n1 + y) * n2 + z);
        if (x >= n0)
            return __ldg(xhi + (((long long)c * R + x - n0) * n1 + y) * n2
                         + z);
        return __ldg(u + c * N + ((long long)x * n1 + y) * n2 + z);
    }
};

// Reads a previous sweep's result from shared memory; every cell a sweep
// touches lies inside the source region by construction.
struct SharedSrc {
    const float* s;
    Region r;
    __device__ float ld(int c, int x, int y, int z) const {
        return s[c * r.vol + ((x - r.o[0]) * r.e[1] + (y - r.o[1])) * r.e[2]
                 + (z - r.o[2])];
    }
};

// Reads the previous in-window step's result from shared memory at
// coordinates clamped to the domain [0, n-1]: the out-of-domain halo cells
// of that step hold don't-care values, and the next step must see its edge
// replication (the edge_pad of the plain step). A clamped cell lies inside
// the source region, since the tile's origin lies inside the domain.
struct ClampedSharedSrc {
    const float* s;
    Region r;
    int n0, n1, n2;
    __device__ float ld(int c, int x, int y, int z) const {
        x = min(max(x, 0), n0 - 1);
        y = min(max(y, 0), n1 - 1);
        z = min(max(z, 0), n2 - 1);
        return s[c * r.vol + ((x - r.o[0]) * r.e[1] + (y - r.o[1])) * r.e[2]
                 + (z - r.o[2])];
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
    __device__ long long off(int x, int y, int z) const {
        x = min(max(x, 0), n0 - 1);
        y = min(max(y, 0), n1 - 1);
        z = min(max(z, 0), n2 - 1);
        return ((long long)x * n1 + y) * n2 + z;
    }
    __device__ float ld(int row, long long off) const {
        return mat_load(m + row * N + off);
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
    __device__ long long off(int x, int y, int z) const {
        x = min(max(x, -e0), n0 - 1 + e0) + e0;
        y = min(max(y, -e1), n1 - 1 + e1) + e1;
        z = min(max(z, 0), n2 - 1);
        return ((long long)x * (n1 + 2 * e1) + y) * n2 + z;
    }
    __device__ float ld(int row, long long off) const {
        return mat_load(m + row * N + off);
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

// The folded correctors on one output cell's components `c`, in corrector
// order (ops/pallas_fused.py::_corrector_epilogue, term for term); the q-th
// damage corrector reads and writes aux field q at flat offset `off`.
__device__ __forceinline__ void corrector_epilogue(
        const GcmFusedParams& p, float* c, const float* __restrict__ aux_in,
        float* __restrict__ aux_out, long long N, long long off) {
    int q = 0;
    for (int s = 0; s < p.nspec; ++s) {
        if (p.spec_kind[s] == 0) {
            if (p.ndiag == 0) continue;
            const float decay = p.spec_a[s];
            float sum = 0.0f;
            for (int i = 0; i < p.ndiag; ++i) sum += c[p.diag[i]];
            const float mean = sum / (float)p.ndiag;
            for (int i = 0; i < p.ndiag; ++i)
                c[p.diag[i]] = mean + (c[p.diag[i]] - mean) * decay;
            for (int i = 0; i < p.nshear; ++i) c[p.shear[i]] *= decay;
        } else {
            const float thr = p.spec_a[s], rate = p.spec_b[s];
            const float d = aux_in[q * N + off];
            float smax = c[p.diag[0]];
            for (int i = 1; i < p.ndiag; ++i) smax = fmaxf(smax, c[p.diag[i]]);
            const float over = fmaxf(smax - thr, 0.0f) / thr;
            const float d_new =
                fminf(fmaxf(d + rate * over * p.dt, 0.0f), 1.0f);
            // incremental degradation (solver/correctors.py::DamageCorrector)
            const float f =
                fminf((1.0f - d_new) / fmaxf(1.0f - d, 1e-12f), 1.0f);
            for (int i = 0; i < p.ndiag; ++i) c[p.diag[i]] *= f;
            for (int i = 0; i < p.nshear; ++i) c[p.shear[i]] *= f;
            aux_out[q * N + off] = d_new;
            ++q;
        }
    }
}

// One characteristic sweep along physical axis a over region `reg`, reading
// the state from `src` and the materials from `mat` (any stack layout: p
// names each pair's speed row and each zero's ratio row), and writing either
// a shared buffer (all cells) or the output of extents p.n (in-block cells
// only, after the folded correctors). Borders apply on the rows at 0 and
// p.n[a] - 1 along the sweep axis, for the kinds p.bc_kind gives.
template <int ORDER, class Src, class Mat, bool TO_GLOBAL>
__device__ void sweep(const GcmFusedParams& p, int a, const Src& src,
                      const Mat& mat, const Region& reg,
                      float* __restrict__ dst,
                      const float* __restrict__ aux_in,
                      float* __restrict__ aux_out) {
    using S = Stencil<ORDER>;
    const int C = p.ncomp;
    const long long N = (long long)p.n[0] * p.n[1] * p.n[2];
    for (int idx = threadIdx.x; idx < reg.vol; idx += blockDim.x) {
        const int k = idx % reg.e[2];
        const int j = (idx / reg.e[2]) % reg.e[1];
        const int i = idx / (reg.e[2] * reg.e[1]);
        const int gx = reg.o[0] + i, gy = reg.o[1] + j, gz = reg.o[2] + k;
        if (TO_GLOBAL && (gx >= p.n[0] || gy >= p.n[1] || gz >= p.n[2]))
            continue;
        // position along the sweep axis, and the unit step along it
        const int ga = a == 0 ? gx : (a == 1 ? gy : gz);
        const int na = p.n[a];
        const int sx = a == 0, sy = a == 1, sz = a == 2;
        const long long moff = mat.off(gx, gy, gz);

        float old[MAXC], nw[MAXC];
        for (int c = 0; c < C; ++c) {
            old[c] = src.ld(c, gx, gy, gz);
            nw[c] = old[c];
        }
        const float rho = mat.ld(p.rho_idx, moff);
        for (int q = 0; q < p.npairs[a]; ++q) {
            const int sg = p.pair_sigma[a][q];
            const int vl = p.pair_vel[a][q];
            const float c = mat.ld(p.pair_c[a][q], moff);
            const float z = rho * c;
            const float rz = z > 0.0f ? 0.5f / fmaxf(z, 1e-30f) : 0.0f;
            float w[S::NP];
            S::weights(c * p.dtoh[a], w);
            float Ap = 0.f, Bp = 0.f, Am = 0.f, Bm = 0.f;
#pragma unroll
            for (int t = 0; t < S::NP; ++t) {
                const int o = t + S::LO;
                const int px = gx + o * sx, py = gy + o * sy, pz = gz + o * sz;
                const int mx = gx - o * sx, my = gy - o * sy, mz = gz - o * sz;
                Ap += w[t] * src.ld(sg, px, py, pz);
                Bp += w[t] * src.ld(vl, px, py, pz);
                Am += w[t] * src.ld(sg, mx, my, mz);
                Bm += w[t] * src.ld(vl, mx, my, mz);
            }
            const float szb = (float)p.sign * z;
            float wl = Ap + szb * Bp;
            float wr = Am - szb * Bm;
            if (ga == 0 && p.bc_kind[a][0] >= 0)
                wr = bc_incoming(p.bc_kind[a][0], p.bc_val[a][0][q], wl,
                                 p.sign, z, 0);
            if (ga == na - 1 && p.bc_kind[a][1] >= 0)
                wl = bc_incoming(p.bc_kind[a][1], p.bc_val[a][1][q], wr,
                                 p.sign, z, 1);
            nw[sg] = 0.5f * (wl + wr);
            nw[vl] = z > 0.0f ? (float)p.sign * (wl - wr) * rz : old[vl];
        }
        for (int q = 0; q < p.nzeros[a]; ++q) {
            const int zc = p.zero_comp[a][q], zs = p.zero_src[a][q];
            nw[zc] = old[zc] + mat.ld(p.zero_kappa[a][q], moff) *
                               (nw[zs] - old[zs]);
        }
        if (TO_GLOBAL) {
            const long long off = ((long long)gx * p.n[1] + gy) * p.n[2] + gz;
            if (p.nspec > 0) corrector_epilogue(p, nw, aux_in, aux_out, N, off);
            for (int c = 0; c < C; ++c) dst[c * N + off] = nw[c];
        } else {
            for (int c = 0; c < C; ++c) dst[c * reg.vol + idx] = nw[c];
        }
    }
}

// The flattened sweep sequence of K in-window steps: p.axes, then (K = 2)
// p.axes_next, dim entries each.
__host__ __device__ inline void flat_axes(const GcmFusedParams& p, int dim,
                                          int K, int* ax) {
    for (int j = 0; j < dim; ++j) {
        ax[j] = p.axes[j];
        if (K == 2) ax[dim + j] = p.axes_next[j];
    }
}

// Box of the output of the first `nswept` sweeps of the sequence `ax` on
// the tile at t0 with extents T, in a window with a halo of H = K*R cells
// on every axis: an axis swept s times keeps a halo of H - s*R. Axes at or
// past `dim` have extent 1 and no halo.
__host__ __device__ inline Region tile_region(const int* ax, int nswept,
                                              const int* t0, const int* T,
                                              int R, int H, int dim) {
    Region r;
    r.vol = 1;
    for (int d = 0; d < 3; ++d) {
        int s = 0;
        for (int q = 0; q < nswept; ++q) s += ax[q] == d;
        const int halo = d >= dim ? 0 : H - s * R;
        r.o[d] = t0[d] - halo;
        r.e[d] = (d >= dim ? 1 : T[d]) + 2 * halo;
        r.vol *= r.e[d];
    }
    return r;
}

// Shared memory of K steps on one tile of extents T: two buffers that the
// sweeps of the sequence write in turn, the first as large as the first
// sweep's output, the second as the second's (the regions only shrink).
__host__ inline size_t step_smem_bytes(const GcmFusedParams& p, const int* T,
                                       int R, int dim, int K = 1) {
    const int t0[3] = {0, 0, 0};
    int ax[6];
    flat_axes(p, dim, K, ax);
    size_t vol = tile_region(ax, 1, t0, T, R, K * R, dim).vol;
    if (K * dim > 2) vol += tile_region(ax, 2, t0, T, R, K * R, dim).vol;
    return sizeof(float) * (size_t)p.ncomp * vol;
}

// K whole steps (K = 1 or 2, DIM sweeps each, along p.axes then
// p.axes_next) on the output tile at t0 with extents T: the first sweep
// reads `src`, each later one the shared buffer the one before it wrote (the
// first sweep of the second step through ClampedSharedSrc), and the last
// writes `out` and, after the folded correctors, the aux stream. The sweep
// loop unrolls at compile time, so the axes, regions and buffers stay in
// registers. Called by every thread of the block.
template <int ORDER, int K, int DIM, class Src, class Mat>
__device__ __forceinline__ void step_tile_n(
        const GcmFusedParams& p, const int* t0, const int* T, const Src& src,
        const Mat& mat, float* smem, float* __restrict__ out,
        const float* __restrict__ aux_in, float* __restrict__ aux_out) {
    static_assert(K == 1 || K == 2, "one or two steps per window");
    constexpr int R = Stencil<ORDER>::R;
    constexpr int H = K * R;
    constexpr int S = K * DIM;
    int ax[S];
    flat_axes(p, DIM, K, ax);
    Region prev = tile_region(ax, 1, t0, T, R, H, DIM);
    float* const b0 = smem;
    float* const b1 = smem + p.ncomp * prev.vol;
    sweep<ORDER, Src, Mat, false>(p, ax[0], src, mat, prev, b0, nullptr,
                                  nullptr);
#pragma unroll
    for (int i = 1; i < S; ++i) {
        __syncthreads();
        const Region reg = tile_region(ax, i + 1, t0, T, R, H, DIM);
        const float* in = ((i - 1) & 1) ? b1 : b0;
        float* dst = (i & 1) ? b1 : b0;
        if (K > 1 && i % DIM == 0) {
            const ClampedSharedSrc s{in, prev, p.n[0], p.n[1], p.n[2]};
            sweep<ORDER, ClampedSharedSrc, Mat, false>(
                p, ax[i], s, mat, reg, dst, nullptr, nullptr);
        } else if (i == S - 1) {
            sweep<ORDER, SharedSrc, Mat, true>(p, ax[i], SharedSrc{in, prev},
                                               mat, reg, out, aux_in, aux_out);
        } else {
            sweep<ORDER, SharedSrc, Mat, false>(p, ax[i], SharedSrc{in, prev},
                                                mat, reg, dst, nullptr,
                                                nullptr);
        }
        prev = reg;
    }
}

// step_tile_n for a grid of `dim` (2 or 3) axes.
template <int ORDER, int K = 1, class Src, class Mat>
__device__ __forceinline__ void step_tile(
        const GcmFusedParams& p, int dim, const int* t0, const int* T,
        const Src& src, const Mat& mat, float* smem, float* __restrict__ out,
        const float* __restrict__ aux_in, float* __restrict__ aux_out) {
    if (dim == 2)
        step_tile_n<ORDER, K, 2>(p, t0, T, src, mat, smem, out, aux_in,
                                 aux_out);
    else
        step_tile_n<ORDER, K, 3>(p, t0, T, src, mat, smem, out, aux_in,
                                 aux_out);
}

}  // namespace
