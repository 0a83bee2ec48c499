// Adjoint of the fused LW step (fused_lw.cu): gas optics + Planck
// sources + one-angle no-scattering transport + broadband sum, backward,
// one column per block.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/fused_lw_bwd.py::
// _lw_fused_bwd (pallas_call :506; derivation :7-36). Plain twin:
// torch.autograd.grad of rte_rrtmgp_tpu_torch/ops/kernels/fused_lw.py::
// lw_fused_plain (fused_lw.py::lw_fused_bwd_plain).
//
// Layout: one block per column, one thread per g-point, as the forward.
//   Phase 0: the forward's pass 1, per layer the major tau and Planck
//     fraction, the minors and the band's cloud absorption, into scratch.
//   Phase A: the transport adjoint (transport_bwd.cuh::lw_adjoint) with
//     the sources formed from the Planck fractions and the totplnk lerp,
//     as the forward forms them, from the incident flux inc; its
//     cotangent goes to inc_b. On the way up each layer's cotangents
//     become those of the total tau, of the Planck fraction (the layer
//     source, the geometric-mean level sources of the two adjacent
//     levels and, for the last layer, the surface source) and of the
//     temperatures through dB/dT = (hi - lo) / tp_delta, summed over the
//     g-points per layer, level and column (warp shuffles, then a
//     fixed-order sum of the warp partials).
//   Phase B: per layer, the adjoints of the cloud increment, the major
//     lookup and the minors, and their per-cell sums over g-points
//     (gas_optics_bwd.cuh::gas_bars_reduce, fixed order, no atomics).
// Scratch: four float fields of (column, layer, g-point): tau and the
// Planck fraction (phase 0), the downward radiance and the up-sweep
// cotangent kept by the adjoint's down pass, which become the cotangents
// of tau and of the Planck fraction on its up pass.
//
// What bounds it on this card: the table gathers (16 per (cell, g-point)
// in phase 0 and again in phase B, tables resident in L2), the scratch
// traffic (about 40 B per (column, layer, g-point)), and the per-cell
// sums, which run on one thread per output while the rest of the block
// waits.
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; descriptors layer-major (nlay, ncol).

#include <cfloat>
#include <cmath>

#include "common.cuh"
#include "gas_optics_bwd.cuh"
#include "transport_bwd.cuh"

namespace {

using rte::CellDesc;

struct Planck {
    const float* tot;
    int ntot, nbnd, band;
    float tp_min, tp_delta;
    // the band's totplnk lerp at t (fused_lw.cu::planck_band) and its
    // derivative in t
    __device__ void at(float t, float* b, float* db) const {
        float val0 = (t - tp_min) / tp_delta;
        float frac = val0 - truncf(val0);
        int idx = min(max((int)val0, 0), ntot - 2);
        float lo = __ldg(tot + idx * nbnd + band);
        float hi = __ldg(tot + (idx + 1) * nbnd + band);
        *b = lo + frac * (hi - lo);
        *db = (hi - lo) / tp_delta;
    }
    __device__ float operator()(float t) const {
        float b, db;
        at(t, &b, &db);
        return b;
    }
};

__device__ __forceinline__ float geo_mean(float a, float b) {
    float p = a * b;
    return p > 0.0f ? sqrtf(p) : 0.0f;
}

// Layer l's optical depth along the ray and its sources, from the
// phase-0 scratch (the forward's pass 2 arithmetic).
struct Col {
    const float* TAU;
    const float* PF;
    long long ls;
    const float* tlay;
    const float* tlev;
    int nlay, ncol, c;
    float ds;
    Planck pb;
    __device__ void layer(int l, float* tl, float* lay, float* top,
                          float* bot) const {
        float pf = PF[l * ls];
        float pf_top = l == 0 ? pf : geo_mean(PF[(l - 1) * ls], pf);
        float pf_bot = l + 1 < nlay ? geo_mean(pf, PF[(l + 1) * ls]) : pf;
        *tl = TAU[l * ls] * ds;
        *lay = pf * pb(__ldg(tlay + l * ncol + c));
        *top = pf_top * pb(__ldg(tlev + l * ncol + c));
        *bot = pf_bot * pb(__ldg(tlev + (l + 1) * ncol + c));
    }
};

// Takes the transport's cotangents: the tau cotangent into TB, the
// Planck-fraction cotangent into PB (one layer behind, when the level
// below is complete), the temperatures' into the warp partials.
struct Sink {
    bool active;
    float* TB;
    float* PB;
    const float* PF;
    long long ls;
    const float* tlay;
    const float* tlev;
    const float* tsfc;
    int nlay, ncol, c;
    float ds;
    Planck pb;
    float* emis_b;
    float* inc_b;
    float* p_tlay;          // (nwarps, nlay)
    float* p_tlev;          // (nwarps, nlay+1)
    float* p_tsfc;          // (nwarps, 1)
    float pfb_next = 0.0f;  // Planck-fraction cotangent of the layer below
    float levt_next = 0.0f; // top-level source cotangent of the layer below
    float pfb_sfc = 0.0f;   // the surface source's share of the last layer's

    __device__ void surface(float e_b, float s_b) {
        float part = 0.0f;
        if (active) {
            *emis_b = e_b;
            float b, db;
            pb.at(__ldg(tsfc + c), &b, &db);
            pfb_sfc = s_b * b;
            part = s_b * PF[(nlay - 1) * ls] * db;
        }
        rte::reduce_level(part, p_tsfc, 1, 0);
    }

    __device__ void layer(int l, const rte::LwBars& bars) {
        float part_lay = 0.0f, part_lev = 0.0f;
        if (active) {
            TB[l * ls] = bars.tl * ds;
            float pf = PF[l * ls];
            float b, db;
            pb.at(__ldg(tlay + l * ncol + c), &b, &db);
            float pfb = bars.lay * b;
            part_lay = bars.lay * pf * db;
            // level l+1 is complete: the bottom source of layer l and the
            // top source of layer l+1
            float lb = bars.bot + levt_next;
            pb.at(__ldg(tlev + (l + 1) * ncol + c), &b, &db);
            float pfl;
            if (l + 1 == nlay) {
                pfl = pf;
                pfb += lb * b + pfb_sfc;
            } else {
                float pf_dn = PF[(l + 1) * ls];
                float p = pf * pf_dn;
                pfl = p > 0.0f ? sqrtf(p) : 0.0f;
                if (p > 0.0f) {
                    float pfl_b = lb * b;
                    pfb += pfl_b * 0.5f * pf_dn / pfl;
                    pfb_next += pfl_b * 0.5f * pf / pfl;
                }
                PB[(l + 1) * ls] = pfb_next;
            }
            part_lev = lb * pfl * db;
            pfb_next = pfb;
            levt_next = bars.top;
        }
        rte::reduce_level(part_lay, p_tlay, nlay, l);
        rte::reduce_level(part_lev, p_tlev, nlay + 1, l + 1);
    }

    __device__ void top(float ib) {
        float part = 0.0f;
        if (active) {
            *inc_b = ib;
            float b, db;
            pb.at(__ldg(tlev + c), &b, &db);
            pfb_next += levt_next * b;
            PB[0] = pfb_next;
            part = levt_next * PF[0] * db;
        }
        rte::reduce_level(part, p_tlev, nlay + 1, 0);
    }
};

__global__ void fused_lw_bwd_kernel(
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
        const float* __restrict__ cloud, const float* __restrict__ gup,
        const float* __restrict__ gdn, float* scratch, rte::GasBarsOut out,
        float* tlay_b, float* tlev_b, float* tsfc_b, float* emis_b,
        float* inc_b,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int ntot, int nbnd,
        float tp_min, float tp_delta, float ds, float piw) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    float* p_tlay = smem;                          // (nwarps, nlay)
    float* p_tlev = p_tlay + nwarps * nlay;        // (nwarps, nlev)
    float* p_tsfc = p_tlev + nwarps * nlev;        // (nwarps, 1)
    float* gsm = p_tsfc + nwarps;
    rte::GasBarsSmem sm = rte::GasBarsSmem::carve(gsm, blockDim.x, nminor,
                                                  nflav);
    sm.meta = (int*)(gsm + rte::GasBarsSmem::floats(blockDim.x, nminor,
                                                    nflav));
    for (int i = threadIdx.x; i < nminor * rte::kMetaFields; i += blockDim.x)
        sm.meta[i] = minor_meta[i];
    __syncthreads();

    const int c = blockIdx.x;
    const bool active = threadIdx.x < ngpt;
    const int g = active ? threadIdx.x : 0;
    const int ncell = nlay * ncol;
    const long long plane = (long long)ncol * nlay * ngpt;
    const long long ls = ngpt;
    float* TAU = scratch + (long long)c * nlay * ngpt + g;
    float* PF = TAU + plane;
    float* TB = PF + plane;        // the adjoint's kept radiances, then tau's cotangent
    float* PB = TB + plane;        // its kept up-sweep cotangents, then pf's
    const int band = gpt2band[g];
    const Planck pb{totplnk, ntot, nbnd, band, tp_min, tp_delta};

    // ---- phase 0: gas optics per layer (fused_lw.cu pass 1) ----
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
            tau = rte::minor_tau(tau, d, sm.meta, nminor, nflav, ncell, cell,
                                 jeta, feta, msc, klo, kup, ncl, ncu, neta, g);
            if (cloud) tau += cloud[(long long)band * ncell + cell];
            TAU[l * ls] = tau;
            PF[l * ls] = pf;
        }
    }

    // ---- phase A: the transport adjoint and the Planck sources' ----
    Col col{TAU, PF, ls, tlay, tlev, nlay, ncol, c, ds, pb};
    const long long gc = (long long)g * ncol + c;
    Sink sink{active, TB, PB, PF, ls, tlay, tlev, tsfc, nlay, ncol, c, ds,
              pb, emis_b + gc, inc_b + gc, p_tlay, p_tlev, p_tsfc};
    float e = active ? __ldg(emis + gc) : 0.0f;
    float ssrc = 0.0f;
    if (active) ssrc = PF[(nlay - 1) * ls] * pb(__ldg(tsfc + c));
    rte::lw_adjoint(active, col, nlay, piw, active ? __ldg(inc + gc) : 0.0f,
                    e, ssrc, gup + c, gdn + c, ncol, TB, PB, ls, sink);
    __syncthreads();
    for (int i = threadIdx.x; i < nlev; i += blockDim.x) {
        if (i < nlay)
            tlay_b[i * ncol + c] = rte::level_total(p_tlay, nwarps, nlay, i);
        tlev_b[i * ncol + c] = rte::level_total(p_tlev, nwarps, nlev, i);
    }
    if (threadIdx.x == 0) tsfc_b[c] = rte::level_total(p_tsfc, nwarps, 1, 0);

    // ---- phase B: cloud, major and minor adjoints, summed per cell ----
    for (int l = 0; l < nlay; ++l) {
        int cell = l * ncol + c;
        CellDesc d = rte::load_cell(jtemp, ftemp, jpress, fpress, tropo,
                                    cell);
        if (active) {
            float tb = TB[l * ls];
            int flav = gflav[(d.lower ? 0 : 1) * ngpt + g];
            rte::MajorBars mb = rte::major_adjoint(
                d, flav, nflav, ncell, cell, jeta, feta, col_mix, kmajor,
                pfrac_tab, neta, npres1, ngpt, g, tb, PB[l * ls]);
            sm.tb[g] = tb;
            sm.band[0][g] = tb;
            sm.fe[0][g] = mb.fe[0];
            sm.fe[1][g] = mb.fe[1];
            sm.cm[0][g] = mb.cm[0];
            sm.cm[1][g] = mb.cm[1];
            sm.ft[g] = mb.ft;
            sm.fp[g] = mb.fp;
        }
        rte::gas_bars_reduce(sm, out, d, cell, ncell, ngpt, nflav, nminor,
                             gflav, gpt2band, jeta, feta, msc, klo, kup, ncl,
                             ncu, neta);
    }
}

}  // namespace

extern "C" int launch_fused_lw_bwd(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* msc,
        const void* minor_meta, const void* kmajor, const void* pfrac_tab,
        const void* klo, const void* kup, const void* gflav,
        const void* gpt2band, const void* totplnk, const void* tlay,
        const void* tlev, const void* tsfc, const void* emis,
        const void* inc, const void* cloud, const void* gup,
        const void* gdn, void* scratch, void* ftemp_b, void* fpress_b,
        void* feta_b, void* col_mix_b, void* msc_b, void* cloud_b,
        void* tlay_b, void* tlev_b, void* tsfc_b, void* emis_b, void* inc_b,
        int ncol, int nlay, int ngpt, int neta, int npres1,
        int nflav, int nminor, int ncl, int ncu, int ntot, int nbnd,
        float tp_min, float tp_delta, float ds, float piw,
        void* stream) {
    if (ncol == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    int nwarps = threads / 32;
    size_t smem = (size_t)(nwarps * (2 * nlay + 2)
                           + rte::GasBarsSmem::floats(threads, nminor, nflav))
                      * sizeof(float)
                  + (size_t)nminor * rte::kMetaFields * sizeof(int);
    cudaError_t err = rte::allow_smem(fused_lw_bwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rte::GasBarsOut out{(float*)ftemp_b, (float*)fpress_b, (float*)feta_b,
                        (float*)col_mix_b, (float*)msc_b, nullptr,
                        (float*)cloud_b, cloud ? 1 : 0, cloud ? nbnd : 0};
    fused_lw_bwd_kernel<<<ncol, threads, smem, (cudaStream_t)stream>>>(
        (const int*)jtemp, (const float*)ftemp, (const int*)jpress,
        (const float*)fpress, (const int*)tropo, (const int*)jeta,
        (const float*)feta, (const float*)col_mix, (const float*)msc,
        (const int*)minor_meta, (const float*)kmajor,
        (const float*)pfrac_tab, (const float*)klo, (const float*)kup,
        (const int*)gflav, (const int*)gpt2band, (const float*)totplnk,
        (const float*)tlay, (const float*)tlev, (const float*)tsfc,
        (const float*)emis, (const float*)inc, (const float*)cloud,
        (const float*)gup, (const float*)gdn, (float*)scratch, out,
        (float*)tlay_b, (float*)tlev_b, (float*)tsfc_b, (float*)emis_b,
        (float*)inc_b,
        ncol, nlay, ngpt, neta, npres1, nflav, nminor, ncl, ncu, ntot, nbnd,
        tp_min, tp_delta, ds, piw);
    return (int)cudaGetLastError();
}
