// Helpers shared by the fused LW and SW kernels.
#pragma once

#include <cuda_runtime.h>

namespace rte {

constexpr int kMetaFields = 5;   // minor_meta row: lower, flavor, g0, width, start

// Sum over the 32 lanes of a warp (xor butterfly: every lane gets the
// same, order-fixed result).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Deterministic block reduction, step 1: the warp's sum of v goes to
// partial[warp * nlev + lev]. Every thread of the block must call it.
__device__ __forceinline__ void reduce_level(float v, float* partial,
                                             int nlev, int lev) {
    float s = warp_sum(v);
    if ((threadIdx.x & 31) == 0) partial[(threadIdx.x >> 5) * nlev + lev] = s;
}

// Step 2 (after __syncthreads): the warp partials of each level summed in
// warp order.
__device__ __forceinline__ float level_total(const float* partial,
                                             int nwarps, int nlev, int lev) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += partial[w * nlev + lev];
    return s;
}

// Major-gas tau (and, with pfrac_tab, the Planck fraction) of g-point g
// at one cell: the 8-corner lerp over (temperature, eta, pressure) of the
// plain (ntemp, neta, npres+1, ngpt) tables, the upper atmosphere reading
// the pressure row above its index (reference interpolate3D_byflav).
struct CellDesc {
    int jt, jp;        // lower temperature index, pressure base row
    float ft, fp;      // temperature and pressure fractions
    bool lower;        // cell below the tropopause
};

__device__ __forceinline__ CellDesc load_cell(const int* jtemp,
                                              const float* ftemp,
                                              const int* jpress,
                                              const float* fpress,
                                              const int* tropo, int cell) {
    CellDesc d;
    d.lower = tropo[cell] != 0;
    d.jt = jtemp[cell];
    d.ft = ftemp[cell];
    d.jp = jpress[cell] + (d.lower ? 0 : 1);
    d.fp = fpress[cell];
    return d;
}

__device__ __forceinline__ void major_tau(
        const CellDesc& d, int flav, int nflav, int ncell, int cell,
        const int* __restrict__ jeta, const float* __restrict__ feta,
        const float* __restrict__ col_mix,
        const float* __restrict__ kmajor, const float* __restrict__ pfrac_tab,
        int neta, int npres1, int ngpt, int g, float* tau, float* pf) {
    float t = 0.0f, p = 0.0f;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * nflav + flav) * ncell + cell;
        int je = jeta[fi];
        float fe = feta[fi];
        float cm = col_mix[fi];
        float ftv = it == 0 ? 1.0f - d.ft : d.ft;
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
            float fpv = dp == 0 ? 1.0f - d.fp : d.fp;
#pragma unroll
            for (int de = 0; de < 2; ++de) {
                float fev = de == 0 ? 1.0f - fe : fe;
                float wgt = (fev * ftv) * fpv;
                long long k = ((long long)(((d.jt + it) * neta + je + de)
                                           * npres1 + d.jp + dp)) * ngpt + g;
                t += (wgt * cm) * __ldg(kmajor + k);
                if (pfrac_tab) p += wgt * __ldg(pfrac_tab + k);
            }
        }
    }
    *tau = t;
    *pf = p;
}

// Minor-gas contributions of the minors whose g-point window holds g
// (reference gas_optical_depths_minor): per minor, the 2-D (temperature x
// eta) lerp of its kminor column times its scaling row; meta in shared
// memory, lower-atmosphere minors first.
__device__ __forceinline__ float minor_tau(
        float tau, const CellDesc& d, const int* meta, int nminor,
        int nflav, int ncell, int cell, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ msc,
        const float* __restrict__ klo, const float* __restrict__ kup,
        int ncl, int ncu, int neta, int g) {
    for (int m = 0; m < nminor; ++m) {
        const int* mm = meta + m * kMetaFields;
        int g0 = mm[2];
        if (g < g0 || g >= g0 + mm[3]) continue;
        int f = mm[1];
        const float* tab = mm[0] ? klo : kup;
        int ncont = mm[0] ? ncl : ncu;
        int k = mm[4] + (g - g0);
        float kk = 0.0f;
#pragma unroll
        for (int it = 0; it < 2; ++it) {
            int fi = (it * nflav + f) * ncell + cell;
            int row = (d.jt + it) * neta + jeta[fi];
            float fe = feta[fi];
            float ftv = it == 0 ? 1.0f - d.ft : d.ft;
            kk += ((1.0f - fe) * ftv) * __ldg(tab + row * ncont + k)
                + (fe * ftv) * __ldg(tab + (row + 1) * ncont + k);
        }
        tau += msc[(long long)m * ncell + cell] * kk;
    }
    return tau;
}

// Dynamic shared memory beyond 48 KB must be opted into per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

}  // namespace rte

extern "C" const char* rte_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
