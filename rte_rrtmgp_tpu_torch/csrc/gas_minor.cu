// Minor-gas optical depths of one atmosphere, added into tau in place, and
// the Rayleigh optical depth with the absorption/Rayleigh combine: the
// staged gas-optics gathers of the public gas_optics_lw/sw.
//
// Replaces the TPU kernels rte_rrtmgp_tpu/ops/pallas/minor_gather.py::
// minor_contributions_lane (via ops/gas_optics_pallas.py::
// tau_minor_pallas) and ::rayleigh_k_lane (via tau_rayleigh_pallas, with
// the combine of models/rrtmgp/gas_optics.py:344-358). Plain twins:
// rte_rrtmgp_tpu_torch/ops/kernels/gas_minor.py::gas_minor_plain and
// gas_rayleigh_plain.
//
// Layout: one block per cell, one thread per g-point; tau and ssa are
// (cell, g-point) with g fastest. gas_minor: each thread walks the minor
// gases of the atmosphere (metadata in shared memory) and adds, for those
// whose g-point window holds its g-point, the 2-D (temperature x eta) lerp
// of kminor times the gas's scaling row (common.cuh::minor_tau, the code
// the fused kernels run), in the twin's order; no atomics, so two runs
// give identical bits. gas_rayleigh: the krayl lerp in the cell's
// atmosphere (common.cuh::rayleigh_k) times col_h2o + col_dry, added to
// tau, and ssa = tau_rayleigh / tau where tau > 2 tiny.
//
// What bounds them on this card: reading and writing tau (and writing
// ssa), 4 B per (cell, g-point) each; the table gathers hit kminor and
// krayl, which stay resident in L2.
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; cells flattened in the caller's order.

#include <cfloat>

#include "common.cuh"

namespace {

__global__ void gas_minor_kernel(
        float* __restrict__ tau, const int* __restrict__ jtemp,
        const float* __restrict__ ftemp, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ msc,
        const int* __restrict__ minor_meta, const float* __restrict__ kminor,
        int ncell, int ngpt, int neta, int nflav, int nminor, int ncont) {
    extern __shared__ int meta[];
    for (int i = threadIdx.x; i < nminor * rte::kMetaFields; i += blockDim.x)
        meta[i] = minor_meta[i];
    __syncthreads();
    const int cell = blockIdx.x;
    const int g = threadIdx.x;
    if (g >= ngpt) return;
    rte::CellDesc d;
    d.jt = jtemp[cell];
    d.ft = ftemp[cell];
    long long o = (long long)cell * ngpt + g;
    tau[o] = rte::minor_tau(tau[o], d, meta, nminor, nflav, ncell, cell,
                            jeta, feta, msc, kminor, kminor, ncont, ncont,
                            neta, g);
}

__global__ void gas_rayleigh_kernel(
        float* __restrict__ tau, float* __restrict__ ssa,
        const int* __restrict__ jtemp, const float* __restrict__ ftemp,
        const int* __restrict__ tropo, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ krayl,
        const int* __restrict__ gflav, const float* __restrict__ rayscale,
        int ncell, int ngpt, int neta, int nflav) {
    const int cell = blockIdx.x;
    const int g = threadIdx.x;
    if (g >= ngpt) return;
    rte::CellDesc d;
    d.lower = tropo[cell] != 0;
    d.jt = jtemp[cell];
    d.ft = ftemp[cell];
    int flav = gflav[(d.lower ? 0 : 1) * ngpt + g];
    float ray = rte::rayleigh_k(d, flav, nflav, ncell, cell, jeta, feta,
                                krayl, neta, ngpt, g) * rayscale[cell];
    long long o = (long long)cell * ngpt + g;
    float t = tau[o] + ray;
    tau[o] = t;
    if (ssa) ssa[o] = t > 2.0f * FLT_MIN ? ray / t : 0.0f;
}

}  // namespace

extern "C" int launch_gas_minor(
        void* tau, const void* jtemp, const void* ftemp, const void* jeta,
        const void* feta, const void* msc, const void* minor_meta,
        const void* kminor, int ncell, int ngpt, int neta, int nflav,
        int nminor, int ncont, void* stream) {
    if (ncell == 0 || nminor == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    size_t smem = (size_t)nminor * rte::kMetaFields * sizeof(int);
    cudaError_t err = rte::allow_smem(gas_minor_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    gas_minor_kernel<<<ncell, threads, smem, (cudaStream_t)stream>>>(
        (float*)tau, (const int*)jtemp, (const float*)ftemp,
        (const int*)jeta, (const float*)feta, (const float*)msc,
        (const int*)minor_meta, (const float*)kminor, ncell, ngpt, neta,
        nflav, nminor, ncont);
    return (int)cudaGetLastError();
}

extern "C" int launch_gas_rayleigh(
        void* tau, void* ssa, const void* jtemp, const void* ftemp,
        const void* tropo, const void* jeta, const void* feta,
        const void* krayl, const void* gflav, const void* rayscale,
        int ncell, int ngpt, int neta, int nflav, void* stream) {
    if (ncell == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    gas_rayleigh_kernel<<<ncell, threads, 0, (cudaStream_t)stream>>>(
        (float*)tau, (float*)ssa, (const int*)jtemp, (const float*)ftemp,
        (const int*)tropo, (const int*)jeta, (const float*)feta,
        (const float*)krayl, (const int*)gflav, (const float*)rayscale,
        ncell, ngpt, neta, nflav);
    return (int)cudaGetLastError();
}
