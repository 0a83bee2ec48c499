// The fused SW step: RRTMGP gas optics + Rayleigh + by-band cloud
// increment + Meador-Weaver two-stream + Shonk-Hogan adding + broadband
// sums, one column per block.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/fused_sw.py::
// sw_fused_gas_optics_solve (_fused_sw_kernel, _combine_gas_cloud,
// fused_minors.minor_pass and solver_lanes._sw_body_lm). Plain twin:
// rte_rrtmgp_tpu_torch/ops/kernels/fused_sw.py::sw_fused_plain.
//
// Layout: one block per column, one thread per g-point (the coalesced
// axis of kmajor and krayl). Pass 1, top down: per layer the major and
// minor absorption, Rayleigh, the absorption/Rayleigh combine and the
// cloud 2-stream increment, the two-stream coefficients with the
// reference's clamps, min_mu0 and night masking, and the direct beam.
// Passes 2 and 3: the adding albedo/source build bottom up, then the
// diffuse fluxes top down from the diffuse incident flux incdif (g-point,
// column; zero when null) (transport.cuh::adding). Per-thread layer
// columns live in wrapper-allocated scratch laid out (field, column,
// level, g-point).
//
// What bounds it on this card: the table gathers (8 kmajor and 4 krayl
// reads per cell and g-point, tables resident in L2) and the scratch
// traffic (six float fields, about 14 x 4 B per (column, level, g-point)
// of device memory). The design keeps every access coalesced along g and
// reads the tables through the read-only cache.
//
// Broadband sums are deterministic: warp-shuffle sums per level into
// shared memory, then fixed-order sums of the warp partials. No atomics.
// With band_out the kernel gives per-band sums (3, band, level, column)
// instead (common.cuh::BandSums, gpt2band).
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; descriptors layer-major (nlay, ncol).

#include <cfloat>
#include <cmath>

#include "common.cuh"
#include "transport.cuh"

namespace {

using rte::CellDesc;

__global__ void fused_sw_kernel(
        const int* __restrict__ jtemp, const float* __restrict__ ftemp,
        const int* __restrict__ jpress, const float* __restrict__ fpress,
        const int* __restrict__ tropo, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ col_mix,
        const float* __restrict__ msc, const int* __restrict__ minor_meta,
        const float* __restrict__ kmajor, const float* __restrict__ klo,
        const float* __restrict__ kup, const float* __restrict__ krayl,
        const int* __restrict__ gflav, const int* __restrict__ gpt2band,
        const float* __restrict__ rayscale, const float* __restrict__ cloud,
        const float* __restrict__ mu0, const float* __restrict__ alb_dir,
        const float* __restrict__ alb_dif, const float* __restrict__ inc,
        const float* __restrict__ incdif, float* __restrict__ scratch,
        float* __restrict__ out, float* __restrict__ band_out,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int nbnd, int nband) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    float* p_up = smem;                       // (nwarps, nlev) each
    float* p_dn = p_up + nwarps * nlev;
    float* p_dir = p_dn + nwarps * nlev;
    int* meta = (int*)(p_dir + nwarps * nlev);
    for (int i = threadIdx.x; i < nminor * rte::kMetaFields; i += blockDim.x)
        meta[i] = minor_meta[i];
    __syncthreads();
    const bool byband = band_out != nullptr;
    rte::BandSums bands = {};
    if (byband)
        bands.init((float*)(meta + nminor * rte::kMetaFields), gpt2band, ngpt,
                   nband);

    const int c = blockIdx.x;
    const int g = threadIdx.x;
    const bool active = g < ngpt;
    const int ncell = nlay * ncol;
    const long long field = (long long)ncol * nlev * ngpt;
    float* R = scratch + (long long)c * nlev * ngpt + g;   // rdif
    float* T = R + field;                                  // tdif
    float* SDN = T + field;                                // source_dn
    float* SUP = SDN + field;                              // source_up, then 1/(1-r*alb)
    float* ALB = SUP + field;                              // albedo at levels
    float* SRC = ALB + field;                              // source at levels
    const int band = active ? gpt2band[g] : 0;

    const float tiny = FLT_MIN;
    // by band: planes up, dn total, dir of (band, level, column)
    const long long bs = (long long)nlev * ncol;
    const long long bplane = (long long)nband * bs;
    float* bup = byband ? band_out + c : nullptr;
    float* bdn = byband ? bup + bplane : nullptr;
    float* bdir = byband ? bup + 2 * bplane : nullptr;
    const rte::LevelSink dir_s{p_dir, nlev, bdir, ncol, bs, 1.0f, nullptr};
    const rte::LevelSink up_s{p_up, nlev, bup, ncol, bs, 1.0f, nullptr};
    const rte::LevelSink dn_s{p_dn, nlev, bdn, ncol, bs, 1.0f, bdir};

    // ---- pass 1: optics, two-stream coefficients, direct beam ----
    float dir = active ? inc[(long long)g * ncol + c] * mu0[c] : 0.0f;
    dir_s.put(bands, dir, 0);
    for (int l = 0; l < nlay; ++l) {
        if (active) {
            int cell = l * ncol + c;
            CellDesc d = rte::load_cell(jtemp, ftemp, jpress, fpress, tropo,
                                        cell);
            int flav = gflav[(d.lower ? 0 : 1) * ngpt + g];
            float tau, unused;
            rte::major_tau(d, flav, nflav, ncell, cell, jeta, feta, col_mix,
                           kmajor, nullptr, neta, npres1, ngpt, g, &tau,
                           &unused);
            tau = rte::minor_tau(tau, d, meta, nminor, nflav, ncell, cell,
                                 jeta, feta, msc, klo, kup, ncl, ncu, neta, g);
            float ray = rte::rayleigh_k(d, flav, nflav, ncell, cell, jeta,
                                        feta, krayl, neta, ngpt, g)
                * rayscale[cell];
            // combine_abs_and_rayleigh + cloud increment (fused_sw.py:40-64)
            float t = tau + ray;
            float w0 = t > 2.0f * tiny ? ray / t : 0.0f;
            float asym = 0.0f;
            if (cloud) {
                long long bc = (long long)band * ncell + cell;
                long long cplane = (long long)nbnd * ncell;
                float ct = cloud[bc];
                float cs = cloud[cplane + bc];
                float cg = cloud[2 * cplane + bc];
                float t12 = t + ct;
                float tauscat = t * w0 + ct * cs;
                float g12 = (ct * cs * cg) / fmaxf(tauscat, tiny);
                asym = tauscat > 2.0f * tiny ? g12 : 0.0f;
                w0 = t12 > 2.0f * tiny ? tauscat / fmaxf(t12, tiny) : w0;
                t = t12;
            }
            // Meador-Weaver / PIFM coefficients (reference :985-1127)
            float mu = mu0[cell];
            rte::SwLayer s = rte::sw_layer(t, w0, asym, mu);
            bool day = mu > 0.0f;
            long long o = (long long)l * ngpt;
            R[o] = s.rdif;
            T[o] = s.tdif;
            SUP[o] = day ? s.rdir * dir : 0.0f;
            SDN[o] = day ? s.tdir * dir : 0.0f;
            dir = dir * s.tns;
        }
        dir_s.put(bands, dir, l + 1);
    }

    // ---- passes 2 and 3: adding (Eqs 9-13) from the diffuse TOA flux ----
    float alb_sfc = 0.0f, src_sfc = 0.0f, top = 0.0f;
    if (active) {
        alb_sfc = alb_dif[(long long)g * ncol + c];
        src_sfc = mu0[(nlay - 1) * ncol + c] > 0.0f
            ? dir * alb_dir[(long long)g * ncol + c] : 0.0f;
        top = incdif ? incdif[(long long)g * ncol + c] : 0.0f;
    }
    rte::adding(active, R, T, SDN, SUP, ALB, SRC, nlay, ngpt, alb_sfc,
                src_sfc, top, up_s, dn_s, bands);
    if (byband) return;

    __syncthreads();
    const long long oplane = (long long)nlev * ncol;
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
        float fd = rte::level_total(p_dir, nwarps, nlev, lev);
        out[lev * ncol + c] = rte::level_total(p_up, nwarps, nlev, lev);
        out[oplane + lev * ncol + c] =
            rte::level_total(p_dn, nwarps, nlev, lev) + fd;
        out[2 * oplane + lev * ncol + c] = fd;
    }
}

}  // namespace

extern "C" int launch_fused_sw(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* msc,
        const void* minor_meta, const void* kmajor, const void* klo,
        const void* kup, const void* krayl, const void* gflav,
        const void* gpt2band, const void* rayscale, const void* cloud,
        const void* mu0, const void* alb_dir, const void* alb_dif,
        const void* inc, const void* incdif, void* scratch, void* out,
        void* band_out, int ncol, int nlay, int ngpt, int neta, int npres1,
        int nflav, int nminor, int ncl, int ncu, int nbnd, int nband,
        void* stream) {
    if (ncol == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    size_t smem = (size_t)3 * (threads / 32) * (nlay + 1) * sizeof(float)
        + (size_t)nminor * rte::kMetaFields * sizeof(int)
        + (band_out ? rte::BandSums::bytes(threads, nband) : 0);
    cudaError_t err = rte::allow_smem(fused_sw_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fused_sw_kernel<<<ncol, threads, smem, (cudaStream_t)stream>>>(
        (const int*)jtemp, (const float*)ftemp, (const int*)jpress,
        (const float*)fpress, (const int*)tropo, (const int*)jeta,
        (const float*)feta, (const float*)col_mix, (const float*)msc,
        (const int*)minor_meta, (const float*)kmajor, (const float*)klo,
        (const float*)kup, (const float*)krayl, (const int*)gflav,
        (const int*)gpt2band, (const float*)rayscale, (const float*)cloud,
        (const float*)mu0, (const float*)alb_dir, (const float*)alb_dif,
        (const float*)inc, (const float*)incdif, (float*)scratch,
        (float*)out, (float*)band_out, ncol, nlay, ngpt, neta, npres1, nflav,
        nminor, ncl, ncu, nbnd, nband);
    return (int)cudaGetLastError();
}
