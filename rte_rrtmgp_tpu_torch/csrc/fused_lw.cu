// The fused LW step: RRTMGP gas optics + Planck sources + one-angle
// no-scattering transport + broadband sum, one column per block.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/fused_lw.py::
// lw_fused_gas_optics_solve (_fused_lw_kernel, with fused_minors.minor_pass
// and planck_band_pair). Plain twin:
// rte_rrtmgp_tpu_torch/ops/kernels/fused_lw.py::lw_fused_plain.
//
// Layout: one block per column, one thread per g-point, so the g-axis of
// kmajor/planck_frac (ntemp, neta, npres+1, ngpt) is the coalesced axis.
// Per layer each thread computes the 8-corner major tau and Planck
// fraction, adds the minor gases whose g-window holds its g-point and the
// cloud absorption of its band (pass 1). Pass 2 forms the Planck
// lay/lev sources from the totplnk lerp, the transmittance and the
// linear-in-tau sources, and runs the down sweep; pass 3 runs the up
// sweep from the surface. The per-thread tau/source columns live in
// wrapper-allocated scratch laid out (column, layer, g-point).
//
// What bounds it on this card: the table gathers (16 per cell and
// g-point from 8 MB tables that stay resident in the 50 MB L2) and the
// scratch traffic (two float columns written, read and rewritten per
// g-point: about 6 x 4 B per (column, layer, g-point) of device memory).
// The design keeps the gathers coalesced along g, reads the tables
// through the read-only cache, and fuses the source computation into the
// down sweep so only two scratch fields exist.
//
// Broadband sums are deterministic: at each level a warp-shuffle sum per
// warp into shared memory, then a fixed-order sum of the warp partials,
// times pi * weight. No atomics. With band_up/band_dn the kernel gives
// per-band sums (band, level, column) instead (common.cuh::BandSums,
// gpt2band). The down sweep starts from the incident flux inc
// (g-point, column).
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; descriptors layer-major (nlay, ncol).

#include <cfloat>
#include <cmath>

#include "common.cuh"
#include "transport.cuh"

namespace {

using rte::CellDesc;

__device__ __forceinline__ float planck_band(float t, const float* tot,
                                             int ntot, int nbnd, int b,
                                             float tp_min, float tp_delta) {
    // reference interpolate1D: fraction from the unclipped position
    float val0 = (t - tp_min) / tp_delta;
    float frac = val0 - truncf(val0);
    int idx = min(max((int)val0, 0), ntot - 2);
    float lo = __ldg(tot + idx * nbnd + b);
    float hi = __ldg(tot + (idx + 1) * nbnd + b);
    return lo + frac * (hi - lo);
}

__device__ __forceinline__ float geo_mean(float a, float b) {
    float p = a * b;
    return p > 0.0f ? sqrtf(p) : 0.0f;
}

__global__ void fused_lw_kernel(
        const int* __restrict__ jtemp, const float* __restrict__ ftemp,
        const int* __restrict__ jpress, const float* __restrict__ fpress,
        const int* __restrict__ tropo, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ col_mix,
        const float* __restrict__ msc, const int* __restrict__ minor_meta,
        const float* __restrict__ kmajor, const float* __restrict__ pfrac_tab,
        const float* __restrict__ klo, const float* __restrict__ kup,
        const int* __restrict__ gflav, const int* __restrict__ gpt2band,
        const float* __restrict__ totplnk, const float* __restrict__ tlay,
        const float* __restrict__ tlev, const float* __restrict__ tsfc,
        const float* __restrict__ emis, const float* __restrict__ inc,
        const float* __restrict__ cloud, float* __restrict__ scratch,
        float* __restrict__ up, float* __restrict__ dn,
        float* __restrict__ band_up, float* __restrict__ band_dn,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int ntot, int nbnd,
        float tp_min, float tp_delta, float ds, float piw) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    float* p_up = smem;                       // (nwarps, nlev)
    float* p_dn = p_up + nwarps * nlev;       // (nwarps, nlev)
    int* meta = (int*)(p_dn + nwarps * nlev);
    for (int i = threadIdx.x; i < nminor * rte::kMetaFields; i += blockDim.x)
        meta[i] = minor_meta[i];
    __syncthreads();
    const bool byband = band_up != nullptr;
    rte::BandSums bands = {};
    if (byband)
        bands.init((float*)(meta + nminor * rte::kMetaFields), gpt2band, ngpt,
                   nbnd);

    const int c = blockIdx.x;
    const int g = threadIdx.x;
    const bool active = g < ngpt;
    const int ncell = nlay * ncol;
    const long long plane = (long long)ncol * nlay * ngpt;
    float* tau_s = scratch + (long long)c * nlay * ngpt + g;  // tau, then trans
    float* src_s = tau_s + plane;             // Planck fraction, then source_up
    const int band = active ? gpt2band[g] : 0;
    // by band: output (band, level, column)
    const long long bs = (long long)nlev * ncol;
    const rte::LevelSink up_s{p_up, nlev, byband ? band_up + c : nullptr,
                              ncol, bs, piw};
    const rte::LevelSink dn_s{p_dn, nlev, byband ? band_dn + c : nullptr,
                              ncol, bs, piw};

    // ---- pass 1: gas optics per layer ----
    if (active) {
        for (int l = 0; l < nlay; ++l) {
            int cell = l * ncol + c;
            CellDesc d = rte::load_cell(jtemp, ftemp, jpress, fpress, tropo,
                                        cell);
            int flav = gflav[(d.lower ? 0 : 1) * ngpt + g];
            float tau, pf;
            rte::major_tau(d, flav, nflav, ncell, cell, jeta, feta, col_mix,
                           kmajor, pfrac_tab, neta, npres1, ngpt, g, &tau,
                           &pf);
            tau = rte::minor_tau(tau, d, meta, nminor, nflav, ncell, cell,
                                 jeta, feta, msc, klo, kup, ncl, ncu, neta, g);
            if (cloud) tau += cloud[(long long)band * ncell + cell];
            tau_s[(long long)l * ngpt] = tau;
            src_s[(long long)l * ngpt] = pf;
        }
    }

    // ---- pass 2: sources + down sweep (reference :51-240, :620-745) ----
    float rdn = active ? inc[(long long)g * ncol + c] / piw : 0.0f;
    float pf_cur = 0.0f, lev_top = 0.0f;
    if (active) {
        pf_cur = src_s[0];
        lev_top = pf_cur * planck_band(tlev[c], totplnk, ntot, nbnd, band,
                                       tp_min, tp_delta);
    }
    dn_s.put(bands, rdn, 0);
    float pf_sfc = 0.0f;
    for (int l = 0; l < nlay; ++l) {
        if (active) {
            float pf_next = l + 1 < nlay ? src_s[(long long)(l + 1) * ngpt]
                                         : 0.0f;
            float pf_bot = l + 1 < nlay ? geo_mean(pf_cur, pf_next) : pf_cur;
            float lev_bot = pf_bot * planck_band(
                tlev[(l + 1) * ncol + c], totplnk, ntot, nbnd, band, tp_min,
                tp_delta);
            float lay = pf_cur * planck_band(tlay[l * ncol + c], totplnk,
                                             ntot, nbnd, band, tp_min,
                                             tp_delta);
            float tl = tau_s[(long long)l * ngpt] * ds;
            float trans, sdn, sup;
            rte::lw_source(tl, lay, lev_top, lev_bot, &trans, &sdn, &sup);
            rdn = trans * rdn + sdn;
            tau_s[(long long)l * ngpt] = trans;
            src_s[(long long)l * ngpt] = sup;
            lev_top = lev_bot;
            if (l + 1 == nlay) pf_sfc = pf_cur;
            pf_cur = pf_next;
        }
        dn_s.put(bands, rdn, l + 1);
    }

    // ---- surface emission + reflection, then the up sweep ----
    float rup = 0.0f;
    if (active) {
        float e = emis[(long long)g * ncol + c];
        float sfc = pf_sfc * planck_band(tsfc[c], totplnk, ntot, nbnd, band,
                                         tp_min, tp_delta);
        rup = rdn * (1.0f - e) + e * sfc;
    }
    up_s.put(bands, rup, nlay);
    for (int l = nlay - 1; l >= 0; --l) {
        if (active)
            rup = tau_s[(long long)l * ngpt] * rup
                + src_s[(long long)l * ngpt];
        up_s.put(bands, rup, l);
    }
    if (byband) return;

    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
        up[lev * ncol + c] = piw * rte::level_total(p_up, nwarps, nlev, lev);
        dn[lev * ncol + c] = piw * rte::level_total(p_dn, nwarps, nlev, lev);
    }
}

}  // namespace

extern "C" int launch_fused_lw(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* msc,
        const void* minor_meta, const void* kmajor, const void* pfrac_tab,
        const void* klo, const void* kup, const void* gflav,
        const void* gpt2band, const void* totplnk, const void* tlay,
        const void* tlev, const void* tsfc, const void* emis,
        const void* inc, const void* cloud, void* scratch, void* up,
        void* dn, void* band_up, void* band_dn,
        int ncol, int nlay, int ngpt, int neta, int npres1,
        int nflav, int nminor, int ncl, int ncu, int ntot, int nbnd,
        float tp_min, float tp_delta, float ds, float piw,
        void* stream) {
    if (ncol == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    size_t smem = (size_t)2 * (threads / 32) * (nlay + 1) * sizeof(float)
        + (size_t)nminor * rte::kMetaFields * sizeof(int)
        + (band_up ? rte::BandSums::bytes(threads, nbnd) : 0);
    cudaError_t err = rte::allow_smem(fused_lw_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fused_lw_kernel<<<ncol, threads, smem, (cudaStream_t)stream>>>(
        (const int*)jtemp, (const float*)ftemp, (const int*)jpress,
        (const float*)fpress, (const int*)tropo, (const int*)jeta,
        (const float*)feta, (const float*)col_mix, (const float*)msc,
        (const int*)minor_meta, (const float*)kmajor,
        (const float*)pfrac_tab, (const float*)klo, (const float*)kup,
        (const int*)gflav, (const int*)gpt2band, (const float*)totplnk,
        (const float*)tlay, (const float*)tlev, (const float*)tsfc,
        (const float*)emis, (const float*)inc, (const float*)cloud,
        (float*)scratch, (float*)up, (float*)dn, (float*)band_up,
        (float*)band_dn, ncol, nlay, ngpt, neta, npres1, nflav, nminor, ncl,
        ncu, ntot, nbnd, tp_min, tp_delta, ds, piw);
    return (int)cudaGetLastError();
}
