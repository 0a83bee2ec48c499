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
// Pass 2, bottom up: the adding albedo/source build. Pass 3, top down:
// the diffuse fluxes. Per-thread layer columns live in wrapper-allocated
// scratch laid out (field, column, level, g-point).
//
// What bounds it on this card: the table gathers (8 kmajor and 4 krayl
// reads per cell and g-point, tables resident in L2) and the scratch
// traffic (six float fields, about 14 x 4 B per (column, level, g-point)
// of device memory). The design keeps every access coalesced along g and
// reads the tables through the read-only cache.
//
// Broadband sums are deterministic: warp-shuffle sums per level into
// shared memory, then fixed-order sums of the warp partials. No atomics.
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; descriptors layer-major (nlay, ncol).

#include <cfloat>
#include <cmath>

#include "common.cuh"

namespace {

using rte::CellDesc;

__device__ __forceinline__ float rayleigh_k(
        const CellDesc& d, int flav, int nflav, int ncell, int cell,
        const int* __restrict__ jeta, const float* __restrict__ feta,
        const float* __restrict__ krayl, int neta, int ngpt, int g) {
    // krayl (ntemp, neta, ngpt, 2): 2-D lerp in the cell's atmosphere
    int atm = d.lower ? 0 : 1;
    float k = 0.0f;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * nflav + flav) * ncell + cell;
        int je = jeta[fi];
        float fe = feta[fi];
        float ftv = it == 0 ? 1.0f - d.ft : d.ft;
        long long base = ((long long)((d.jt + it) * neta + je) * ngpt + g);
        float lo = __ldg(krayl + base * 2 + atm);
        float hi = __ldg(krayl + (base + ngpt) * 2 + atm);
        k += ((1.0f - fe) * ftv) * lo + (fe * ftv) * hi;
    }
    return k;
}

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
        float* __restrict__ scratch, float* __restrict__ out,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int nbnd) {
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

    const float eps = FLT_EPSILON;
    const float tiny = FLT_MIN;
    const float min_k = 1.0e4f * FLT_EPSILON;
    const float min_mu0 = sqrtf(FLT_EPSILON);

    // ---- pass 1: optics, two-stream coefficients, direct beam ----
    float dir = active ? inc[(long long)g * ncol + c] * mu0[c] : 0.0f;
    rte::reduce_level(dir, p_dir, nlev, 0);
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
            float ray = rayleigh_k(d, flav, nflav, ncell, cell, jeta, feta,
                                   krayl, neta, ngpt, g) * rayscale[cell];
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
            float mu_s = fmaxf(min_mu0, mu);
            float g1 = (8.0f - w0 * (5.0f + 3.0f * asym)) * 0.25f;
            float g2 = 3.0f * (w0 * (1.0f - asym)) * 0.25f;
            float k = sqrtf(fmaxf((g1 - g2) * (g1 + g2), min_k));
            float e1 = expf(-t * k);
            float e2 = e1 * e1;
            float rt = 1.0f / (k * (1.0f + e2) + g1 * (1.0f - e2));
            float rdif = rt * g2 * (1.0f - e2);
            float tdif = rt * 2.0f * k * e1;
            float k_mu = k * mu_s;
            float den = 1.0f - k_mu * k_mu;
            den = fabsf(den) >= eps ? den : eps;
            float rt2 = w0 * rt / den;
            float g3 = (2.0f - 3.0f * mu_s * asym) * 0.25f;
            float g4 = 1.0f - g3;
            float a1 = g1 * g4 + g2 * g3;
            float a2 = g1 * g3 + g2 * g4;
            float kg3 = k * g3;
            float kg4 = k * g4;
            float tns = expf(-t / mu_s);
            float rdir = rt2 * ((1.0f - k_mu) * (a2 + kg3)
                                - (1.0f + k_mu) * (a2 - kg3) * e2
                                - 2.0f * (kg3 - a2 * k_mu) * e1 * tns);
            float tdir = -rt2 * ((1.0f + k_mu) * (a1 + kg4) * tns
                                 - (1.0f - k_mu) * (a1 - kg4) * e2 * tns
                                 - 2.0f * (kg4 + a1 * k_mu) * e1);
            rdir = fminf(fmaxf(rdir, 0.0f), 1.0f - tns);
            tdir = fminf(fmaxf(tdir, 0.0f), 1.0f - tns - rdir);
            bool day = mu > 0.0f;
            long long o = (long long)l * ngpt;
            R[o] = rdif;
            T[o] = tdif;
            SUP[o] = day ? rdir * dir : 0.0f;
            SDN[o] = day ? tdir * dir : 0.0f;
            dir = dir * tns;
        }
        rte::reduce_level(dir, p_dir, nlev, l + 1);
    }

    // ---- pass 2: adding, bottom-up albedo/source build (Eqs 9-11) ----
    float alb = 0.0f, src = 0.0f;
    if (active) {
        alb = alb_dif[(long long)g * ncol + c];
        src = mu0[(nlay - 1) * ncol + c] > 0.0f
            ? dir * alb_dir[(long long)g * ncol + c] : 0.0f;
        long long o = (long long)nlay * ngpt;
        ALB[o] = alb;
        SRC[o] = src;
        for (int v = nlay - 1; v >= 0; --v) {
            long long ov = (long long)v * ngpt;
            float r = R[ov];
            float td = T[ov];
            float dd = 1.0f / (1.0f - r * alb);
            float src_v = SUP[ov] + td * dd * (src + alb * SDN[ov]);
            alb = r + td * td * alb * dd;
            src = src_v;
            SUP[ov] = dd;
            ALB[ov] = alb;
            SRC[ov] = src;
        }
    }

    // ---- pass 3: top-down diffuse fluxes (Eqs 12-13), no diffuse TOA ----
    float fdn = 0.0f;
    float fup = active ? src : 0.0f;          // 0 * albedo + source at TOA
    rte::reduce_level(fup, p_up, nlev, 0);
    rte::reduce_level(fdn, p_dn, nlev, 0);
    for (int v = 0; v < nlay; ++v) {
        if (active) {
            long long ov = (long long)v * ngpt;
            long long on = ov + ngpt;
            float src_n = SRC[on];
            fdn = (T[ov] * fdn + R[ov] * src_n + SDN[ov]) * SUP[ov];
            fup = fdn * ALB[on] + src_n;
        }
        rte::reduce_level(fup, p_up, nlev, v + 1);
        rte::reduce_level(fdn, p_dn, nlev, v + 1);
    }

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
        const void* inc, void* scratch, void* out,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int nbnd,
        void* stream) {
    if (ncol == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    size_t smem = (size_t)3 * (threads / 32) * (nlay + 1) * sizeof(float)
        + (size_t)nminor * rte::kMetaFields * sizeof(int);
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
        (const float*)inc, (float*)scratch, (float*)out,
        ncol, nlay, ngpt, neta, npres1, nflav, nminor, ncl, ncu, nbnd);
    return (int)cudaGetLastError();
}
