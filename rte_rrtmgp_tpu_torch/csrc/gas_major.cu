// Major-gas optical depth and (LW) Planck fraction of every cell and
// g-point: the staged gas-optics gather of the public gas_optics_lw/sw.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/major_gather.py::
// major_interp_lane (via ops/gas_optics_pallas.py::tau_major_pallas).
// Plain twin: rte_rrtmgp_tpu_torch/ops/kernels/gas_major.py::
// gas_major_plain.
//
// Layout: one block per cell, one thread per g-point. Each thread does the
// 8-corner (temperature, eta, pressure) lerp of the plain kmajor table
// (ntemp, neta, npres+1, ngpt) times col_mix, and of planck_frac from the
// same corners (common.cuh::major_tau, the code the fused kernels run);
// the upper atmosphere reads the pressure row above its index. The
// cell's descriptors are read once per block (a broadcast load); the
// table gathers and the (cell, g-point) stores are coalesced along g.
//
// What bounds it on this card: writing tau (and pfrac), 4 B per
// (cell, g-point) each; the 8-16 gathers per thread hit tables of 8 MB
// that stay resident in the 50 MB L2.
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; cells flattened in the caller's order.

#include "common.cuh"

namespace {

__global__ void gas_major_kernel(
        const int* __restrict__ jtemp, const float* __restrict__ ftemp,
        const int* __restrict__ jpress, const float* __restrict__ fpress,
        const int* __restrict__ tropo, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ col_mix,
        const float* __restrict__ kmajor, const float* __restrict__ pfrac_tab,
        const int* __restrict__ gflav, float* __restrict__ tau,
        float* __restrict__ pfrac, int ncell, int ngpt, int neta, int npres1,
        int nflav) {
    const int cell = blockIdx.x;
    const int g = threadIdx.x;
    if (g >= ngpt) return;
    rte::CellDesc d = rte::load_cell(jtemp, ftemp, jpress, fpress, tropo,
                                     cell);
    int flav = gflav[(d.lower ? 0 : 1) * ngpt + g];
    float t, p;
    rte::major_tau(d, flav, nflav, ncell, cell, jeta, feta, col_mix, kmajor,
                   pfrac_tab, neta, npres1, ngpt, g, &t, &p);
    long long o = (long long)cell * ngpt + g;
    tau[o] = t;
    if (pfrac) pfrac[o] = p;
}

}  // namespace

extern "C" int launch_gas_major(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* kmajor,
        const void* pfrac_tab, const void* gflav, void* tau, void* pfrac,
        int ncell, int ngpt, int neta, int npres1, int nflav, void* stream) {
    if (ncell == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    gas_major_kernel<<<ncell, threads, 0, (cudaStream_t)stream>>>(
        (const int*)jtemp, (const float*)ftemp, (const int*)jpress,
        (const float*)fpress, (const int*)tropo, (const int*)jeta,
        (const float*)feta, (const float*)col_mix, (const float*)kmajor,
        (const float*)pfrac_tab, (const int*)gflav, (float*)tau,
        (float*)pfrac, ncell, ngpt, neta, npres1, nflav);
    return (int)cudaGetLastError();
}
