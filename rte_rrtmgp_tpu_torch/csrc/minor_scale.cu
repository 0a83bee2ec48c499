// The minor-gas scaling rows of one gas-optics call, both atmospheres in
// one launch, and their adjoint: the rows the minor-gas gathers and the
// fused kernels multiply each window's absorption by (reference
// gas_optical_depths_minor, rrtmgp/kernels/mo_gas_optics_rrtmgp_kernels.
// F90:461-480).
//
// No TPU kernel corresponds: the JAX package forms these rows in plain
// JAX (rte_rrtmgp_tpu/ops/gas_optics.py:297-309), one window at a time.
// Plain twins: rte_rrtmgp_tpu_torch/ops/gas_optics.py::scaling_rows (the
// forward, the loop of minor_scaling over both atmospheres) and
// rte_rrtmgp_tpu_torch/ops/kernels/minor_scale.py::minor_scale_bwd_plain
// (the adjoint's closed form).
//
// minor_scale: out[w, cell] for every window w of the table (lower
// windows first, then upper; columns lower, idx_minor,
// scales_with_density, idx_minor_scaling, scale_by_complement) and every
// cell of the 2-D cell grid (n0, n1): col_gas[idx_minor], times
// 0.01 play / tlay where the window scales with density, times the
// scaling gas's dry fraction (or its complement) where it has one, times
// 1 in the window's atmosphere and 0 in the other. One thread per cell:
// it reads its col_gas[0], col_gas[idx_h2o], play, tlay and tropo once,
// forms 1 / col_dry, the dry factor and 0.01 play / tlay once, then walks
// the table in order, reading the gas rows each window names (many
// windows share them: L1 hits) and storing the window's row. Every
// operation is the twin's, in the twin's order, rounded as the twin
// rounds it (__fmul_rn and friends: nvcc contracts nothing), so the rows
// equal the twin's on the same tensors bit for bit.
//
// minor_scale_bwd: from the rows' cotangent g (nwin, n0, n1), those of
// col_gas (every row; zero where no window reads it), play and tlay. One
// thread per cell walks the windows of its cell's atmosphere in the same
// order, accumulating the gas cotangents in its own column of shared
// memory (one slot per col_gas row) and those of the dry factor and
// 0.01 play / tlay in registers; it writes each cotangent once at the
// end. No atomics: two runs give identical bits.
//
// Layout: a block is a tile of 32 cells along the grid's fast axis (n1,
// the output's contiguous one) by 8 along the other, so every store of
// the rows is coalesced. The inputs are read through element strides,
// so the fused gas optics' transposed views (play.T, col_gas.transpose(
// 1, 2)) need no copy: there a warp's reads of one row land in 32
// sectors, which the tile's other 7 warps read too (L1 hits).
//
// What bounds them on this card: the rows written (4 or 8 B per window
// and cell) and col_gas read once; the adjoint the same in reverse.
//
// Contract (checked by the Python wrapper): float32 or float64 data (the
// same for all), the tropopause flags as bytes (torch.bool), int32 table
// (nwin, 5) contiguous, the rows and their cotangent contiguous, every
// other tensor's offsets within 32-bit strides.

#include "common.cuh"

namespace {

constexpr int kTileX = 32;        // cells of a tile along n1
constexpr int kTileY = 8;         // along n0
constexpr int kThreads = kTileX * kTileY;
constexpr int kFields = 5;        // the table's columns

__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
    return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
    return __ddiv_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}

// A 2-D field read or written through element strides.
template <typename T>
struct Field2 {
    T* p;
    int s0, s1;
    __device__ T& at(int i, int j) const {
        return p[(long long)i * s0 + (long long)j * s1];
    }
};

// The terms every window of a cell shares, as the twin forms them:
// 1 / col_dry and the dry factor are reciprocals times 1 (torch's
// ``1.0 / x``), 0.01 play / tlay is (0.01 play) / tlay.
template <typename T>
struct CellTerms {
    T inv, dry, r;
};

template <typename T>
__device__ __forceinline__ CellTerms<T> cell_terms(
        const T* cc, int cg, int idx_h2o, T p, T t) {
    CellTerms<T> c;
    c.inv = div_rn(T(1), __ldg(cc));
    c.dry = div_rn(T(1), add_rn(mul_rn(__ldg(cc + (long long)idx_h2o * cg),
                                       c.inv), T(1)));
    c.r = div_rn(mul_rn(T(0.01), p), t);
    return c;
}

// The tile's cell (i, j), and the table staged in shared memory.
__device__ __forceinline__ void tile_cell(int n0, int n1, int* i, int* j) {
    const int tiles1 = (n1 + kTileX - 1) / kTileX;
    *i = (int)(blockIdx.x / tiles1) * kTileY + threadIdx.y;
    *j = (int)(blockIdx.x % tiles1) * kTileX + threadIdx.x;
}

__device__ __forceinline__ void stage_table(int* win, const int* table,
                                            int nwin) {
    for (int k = threadIdx.y * kTileX + threadIdx.x; k < nwin * kFields;
         k += kThreads)
        win[k] = table[k];
    __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) minor_scale_kernel(
        Field2<const unsigned char> tropo, Field2<const T> play,
        Field2<const T> tlay, const T* __restrict__ col, int cg, int c0,
        int c1, const int* __restrict__ table, int nwin, int idx_h2o,
        int n0, int n1, T* __restrict__ out) {
    extern __shared__ int win[];                 // (nwin, kFields)
    stage_table(win, table, nwin);
    int i, j;
    tile_cell(n0, n1, &i, &j);
    if (i >= n0 || j >= n1) return;
    const T* cc = col + (long long)i * c0 + (long long)j * c1;
    const bool lower = tropo.at(i, j) != 0;
    const CellTerms<T> c = cell_terms(cc, cg, idx_h2o, play.at(i, j),
                                      tlay.at(i, j));
    const T mask_lo = lower ? T(1) : T(0);
    const T mask_up = lower ? T(0) : T(1);
    const long long ncell = (long long)n0 * n1;
    T* o = out + (long long)i * n1 + j;
    for (int w = 0; w < nwin; ++w) {
        const int* f = win + w * kFields;
        T s = __ldg(cc + (long long)f[1] * cg);
        if (f[2]) {
            s = mul_rn(s, c.r);
            if (f[3] > 0) {
                const T frac = mul_rn(
                    mul_rn(__ldg(cc + (long long)f[3] * cg), c.inv), c.dry);
                s = mul_rn(s, f[4] ? sub_rn(T(1), frac) : frac);
            }
        }
        o[w * ncell] = mul_rn(s, f[0] ? mask_lo : mask_up);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) minor_scale_bwd_kernel(
        Field2<const unsigned char> tropo, Field2<const T> play,
        Field2<const T> tlay, const T* __restrict__ col, int cg, int c0,
        int c1, const int* __restrict__ table, int nwin, int idx_h2o,
        int ngas1, int n0, int n1, const T* __restrict__ g,
        T* __restrict__ dcol, int dg, int d0, int d1, Field2<T> dplay,
        Field2<T> dtlay) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* win = (int*)smem;                       // (nwin, kFields)
    const size_t off = ((size_t)nwin * kFields * sizeof(int) + 15) / 16 * 16;
    T* acc = (T*)(smem + off) + threadIdx.y * kTileX + threadIdx.x;
    for (int k = 0; k < ngas1; ++k) acc[k * kThreads] = T(0);
    stage_table(win, table, nwin);
    int i, j;
    tile_cell(n0, n1, &i, &j);
    if (i >= n0 || j >= n1) return;
    const T* cc = col + (long long)i * c0 + (long long)j * c1;
    const T p = play.at(i, j), t = tlay.at(i, j);
    const bool lower = tropo.at(i, j) != 0;
    const CellTerms<T> c = cell_terms(cc, cg, idx_h2o, p, t);
    const long long ncell = (long long)n0 * n1;
    const T* gc = g + (long long)i * n1 + j;
    T ddry = T(0), dr = T(0);
    for (int w = 0; w < nwin; ++w) {
        const int* f = win + w * kFields;
        if ((f[0] != 0) != lower) continue;     // the other atmosphere's
        const T gm = gc[w * ncell];
        const int idx = f[1];
        if (!f[2]) {
            acc[idx * kThreads] += gm;
            continue;
        }
        const T ci = __ldg(cc + (long long)idx * cg);
        if (f[3] <= 0) {
            acc[idx * kThreads] += gm * c.r;
            dr += gm * ci;
            continue;
        }
        const int isc = f[3];
        const T cs = __ldg(cc + (long long)isc * cg);
        const T frac = cs * c.inv * c.dry;
        const T ds1 = gm * (f[4] ? T(1) - frac : frac);
        const T dfrac = f[4] ? -(gm * (ci * c.r)) : gm * (ci * c.r);
        acc[idx * kThreads] += ds1 * c.r;
        dr += ds1 * ci;
        acc[isc * kThreads] += (dfrac * c.dry) * c.inv;
        ddry += dfrac * (cs * c.inv);
    }
    // dry = 1 / (1 + col_h2o / col_dry), then 1 / col_dry. The cotangent
    // of 1 / col_dry is formed times 1 / col_dry: alone it passes
    // float32's range (a gas column times a column cotangent)
    const T dd = -(ddry * c.dry) * c.dry;
    const T ch = __ldg(cc + (long long)idx_h2o * cg);
    acc[idx_h2o * kThreads] += dd * c.inv;
    acc[0] -= (ddry * c.dry + dd * (ch * c.inv)) * c.inv;
    T* dc = dcol + (long long)i * d0 + (long long)j * d1;
    for (int k = 0; k < ngas1; ++k) dc[(long long)k * dg] = acc[k * kThreads];
    dplay.at(i, j) = T(0.01) * (dr / t);
    dtlay.at(i, j) = -(dr * c.r) / t;
}

size_t table_bytes(int nwin) {
    return ((size_t)nwin * kFields * sizeof(int) + 15) / 16 * 16;
}

int tiles(int n0, int n1) {
    return ((n1 + kTileX - 1) / kTileX) * ((n0 + kTileY - 1) / kTileY);
}

template <typename T>
Field2<const T> field(const void* p, int s0, int s1) {
    return Field2<const T>{(const T*)p, s0, s1};
}

}  // namespace

// Rows (nwin, n0, n1), contiguous, of the table's windows; f64 selects
// double data. Nothing is launched for an empty grid or table.
extern "C" int launch_minor_scale(
        const void* tropo, int tr0, int tr1, const void* play, int p0,
        int p1, const void* tlay, int t0, int t1, const void* col, int cg,
        int c0, int c1, const void* table, int nwin, int idx_h2o, int n0,
        int n1, int f64, void* out, void* stream) {
    if (nwin == 0 || n0 == 0 || n1 == 0) return 0;
    const size_t smem = table_bytes(nwin);
    auto go = [&](auto kernel, auto zero) {
        using T = decltype(zero);
        cudaError_t err = rte::allow_smem(kernel, smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<tiles(n0, n1), dim3(kTileX, kTileY), smem,
                 (cudaStream_t)stream>>>(
            field<unsigned char>(tropo, tr0, tr1), field<T>(play, p0, p1),
            field<T>(tlay, t0, t1), (const T*)col, cg, c0, c1,
            (const int*)table, nwin, idx_h2o, n0, n1, (T*)out);
        return (int)cudaGetLastError();
    };
    return f64 ? go(minor_scale_kernel<double>, 0.0)
               : go(minor_scale_kernel<float>, 0.0f);
}

// The cotangents of col_gas (ngas1 rows, written through its strides),
// play and tlay from that of the rows, g (nwin, n0, n1) contiguous.
extern "C" int launch_minor_scale_bwd(
        const void* tropo, int tr0, int tr1, const void* play, int p0,
        int p1, const void* tlay, int t0, int t1, const void* col, int cg,
        int c0, int c1, const void* table, int nwin, int idx_h2o, int ngas1,
        int n0, int n1, int f64, const void* g, void* dcol, int dg, int d0,
        int d1, void* dplay, int dp0, int dp1, void* dtlay, int dt0,
        int dt1, void* stream) {
    if (n0 == 0 || n1 == 0) return 0;
    auto go = [&](auto kernel, auto zero) {
        using T = decltype(zero);
        const size_t smem = table_bytes(nwin)
            + (size_t)ngas1 * kThreads * sizeof(T);
        cudaError_t err = rte::allow_smem(kernel, smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<tiles(n0, n1), dim3(kTileX, kTileY), smem,
                 (cudaStream_t)stream>>>(
            field<unsigned char>(tropo, tr0, tr1), field<T>(play, p0, p1),
            field<T>(tlay, t0, t1), (const T*)col, cg, c0, c1,
            (const int*)table, nwin, idx_h2o, ngas1, n0, n1, (const T*)g,
            (T*)dcol, dg, d0, d1, Field2<T>{(T*)dplay, dp0, dp1},
            Field2<T>{(T*)dtlay, dt0, dt1});
        return (int)cudaGetLastError();
    };
    return f64 ? go(minor_scale_bwd_kernel<double>, 0.0)
               : go(minor_scale_bwd_kernel<float>, 0.0f);
}
