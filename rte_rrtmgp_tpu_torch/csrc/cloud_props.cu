// Cloud particle-size LUT interpolation, by band, both phases summed.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/minor_gather.py::
// cloud_props_lane (_cloud_kernel). Plain twin:
// rte_rrtmgp_tpu_torch/ops/kernels/cloud_props.py::cloud_props_plain.
//
// out[p, b, cell] for p in (tau, tau*ssa, tau*ssa*g):
//   v_q    = tab_q[idx, b] + fint * (tab_q[idx+1, b] - tab_q[idx, b])
//   t      = wp * v_ext;  ts = t * v_ssa;  tsg = ts * v_asy
// summed over the liquid and ice phases.
//
// What bounds it on this card: memory traffic. Per (cell, band) it reads
// 6 floats of per-cell input (shared by the band's threads through L1)
// and 12 table entries from two tables of a few KB that stay in L1/L2,
// and writes 3 floats. The design: one thread per (band, cell) with the
// cell index fastest, so the output writes and the per-cell input reads
// are coalesced; the tables are read through the read-only cache.
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous; idx in [0, nsize-2] (the prep clamps it).

#include "common.cuh"

namespace {

__device__ __forceinline__ float lerp_tab(const float* __restrict__ tab,
                                          int idx, int nbnd, int b,
                                          float f) {
    float lo = __ldg(tab + idx * nbnd + b);
    float hi = __ldg(tab + (idx + 1) * nbnd + b);
    return lo + f * (hi - lo);
}

__global__ void cloud_props_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ fint,
                                   const float* __restrict__ wp,
                                   const float* __restrict__ liq,
                                   const float* __restrict__ ice,
                                   float* __restrict__ out,
                                   int ncell, int nbnd, int nsl, int nsi) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)ncell * nbnd) return;
    int b = (int)(i / ncell);
    int cell = (int)(i - (long long)b * ncell);
    float t = 0.0f, ts = 0.0f, tsg = 0.0f;
    for (int p = 0; p < 2; ++p) {
        const float* tab = p == 0 ? liq : ice;
        int ns = p == 0 ? nsl : nsi;
        int k = idx[p * ncell + cell];
        float f = fint[p * ncell + cell];
        float w = wp[p * ncell + cell];
        float pt = w * lerp_tab(tab, k, nbnd, b, f);
        float pts = pt * lerp_tab(tab + ns * nbnd, k, nbnd, b, f);
        float ptsg = pts * lerp_tab(tab + 2 * ns * nbnd, k, nbnd, b, f);
        t += pt;
        ts += pts;
        tsg += ptsg;
    }
    long long plane = (long long)nbnd * ncell;
    long long o = (long long)b * ncell + cell;
    out[o] = t;
    out[plane + o] = ts;
    out[2 * plane + o] = tsg;
}

}  // namespace

extern "C" {

int launch_cloud_props(const void* idx, const void* fint, const void* wp,
                       const void* liq, const void* ice, void* out,
                       int ncell, int nbnd, int nsl, int nsi,
                       void* stream) {
    long long n = (long long)ncell * nbnd;
    if (n == 0) return 0;
    const int threads = 256;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cloud_props_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)idx, (const float*)fint, (const float*)wp,
        (const float*)liq, (const float*)ice, (float*)out,
        ncell, nbnd, nsl, nsi);
    return (int)cudaGetLastError();
}

}  // extern "C"
