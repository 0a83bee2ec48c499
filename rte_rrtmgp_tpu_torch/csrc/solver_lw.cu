// One-angle LW no-scattering solve with broadband output. One kernel,
// three launchers:
//   launch_solver_lw        the public rte_lw's solver (one launch per
//                           quadrature angle): contiguous (column, layer,
//                           g-point) fields, a scalar secant or one per
//                           (column, g-point), output (column, level);
//   launch_solver_lw_lanes  the staged branch's solver: (g-point, layer,
//                           column) fields through any element strides,
//                           output (level, column);
//   launch_solver_lw_pfrac  the same with the sources formed in the
//                           kernel from the Planck fraction and the band
//                           values of each g-point's band (gpt2band, so
//                           ragged bands work), plus the by-band cloud
//                           absorption.
//
// Replaces the TPU kernels rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py::
// lw_noscat_broadband_lane and ops/pallas/solver_lanes.py::
// lw_noscat_broadband_lanes and ::lw_noscat_broadband_lanes_pfrac
// (reference mo_rte_solver_kernels.F90:51-240, Planck sources
// compute_Planck_source :568-710). Plain twins:
// rte_rrtmgp_tpu_torch/ops/kernels/solver_lw.py::lw_noscat_plain and
// ops/kernels/solver_lanes.py::lw_noscat_lanes_plain,
// ::lw_noscat_lanes_pfrac_plain.
//
// Layout: one block per column, one thread per g-point, sequential over
// layers. Every field is read through its element strides (common.cuh::
// Field3), so the gathers' (column, layer, g-point) output passed as a
// permuted view keeps g fastest and every load coalesced; a band field
// is read at the thread's band, a broadcast (stride 0) field once. Per
// layer a thread forms exp(-tau * ds) and the linear-in-tau sources
// (transport.cuh::lw_source, the code of the fused LW kernel), runs the
// down sweep from the incident flux, the surface emission and
// reflection, and the up sweep. The per-layer terms are recomputed from
// the inputs in each sweep instead of being stored. Templates select
// Tang rescaling (ssa, g; a second down sweep, with the radiances of the
// first sweeps kept in one scratch field), the surface Jacobian, and the
// in-kernel Planck sources (interior levels from the geometric mean of
// the adjacent layers' fractions, 0 where their product is not positive).
//
// What bounds it on this card: reading tau and the sources (or tau and
// the Planck fraction), 8-12 B per (column, layer, g-point), twice
// without rescaling (once per sweep) and three times with it.
//
// Broadband sums are deterministic: warp-shuffle sums per level into
// shared memory, then fixed-order sums of the warp partials, times
// pi * weight. No atomics. launch_solver_lw can give per-band sums
// instead (common.cuh::BandSums: per level, each band's g-points summed
// in g-point order by one thread), as the TPU kernel does for uniform
// bands; here any gpt2band works.
//
// Contract (checked by the Python wrappers): float32, ngpt <= 1024,
// offsets within 32-bit strides, top of the atmosphere at layer 0.

#include "common.cuh"
#include "transport.cuh"

namespace {

using rte::Field2;
using rte::Field3;
using rte::Line;
using rte::f2;
using rte::f3;

struct LwArgs {
    Field3 tau, lay, lev, ssa, asy;      // lay/lev: without PFRAC
    Field3 pfrac, pb_lay, pb_lev, cld;   // PFRAC; cld.p null: no cloud
    Field2 emis, sfc, sfc_jac, inc;      // sfc: without PFRAC
    Field2 ds, pb_sfc;                   // ds.p null: ds_scalar
    const int* gpt2band;                 // PFRAC, or by-band output
    float* scratch;                      // RESCALE: (column, layer, g-point)
    float* up;
    float* dn;
    float* jac;
    float* band_up;                      // by band: (column, level, band);
    float* band_dn;                      // null: broadband up/dn
    int out_sl, out_sc;                  // output strides of (level, column)
    int nlay, ngpt, nband;
    float ds_scalar, piw;
};

__device__ __forceinline__ float geometric_mean(float a, float b) {
    float pp = a * b;
    return pp > 0.0f ? sqrtf(pp) : 0.0f;
}

// One thread's (column, g-point) lines and its layer terms.
template <bool RESCALE, bool PFRAC>
struct LwColumn {
    Line tau, lay, lev, ssa, asy, pf, pbl, pbv, cld;
    int nlay;
    float ds;

    __device__ LwColumn(const LwArgs& a, int g, int c, float ds_)
        : nlay(a.nlay), ds(ds_) {
        tau = a.tau.line(g, c);
        if (PFRAC) {
            int b = a.gpt2band[g];
            pf = a.pfrac.line(g, c);
            pbl = a.pb_lay.line(b, c);
            pbv = a.pb_lev.line(b, c);
            cld = a.cld.line(b, c);
        } else {
            lay = a.lay.line(g, c);
            lev = a.lev.line(g, c);
        }
        if (RESCALE) {
            ssa = a.ssa.line(g, c);
            asy = a.asy.line(g, c);
        }
    }

    __device__ __forceinline__ void layer(int l, float* t, float* sdn,
                                          float* sup, float* an,
                                          float* cn) const {
        float tl = tau[l], ly, top, bot;
        if (PFRAC) {
            if (cld.p) tl += cld[l];
            float p = pf[l];
            ly = p * pbl[l];
            top = (l == 0 ? p : geometric_mean(p, pf[l - 1])) * pbv[l];
            bot = (l == nlay - 1 ? p : geometric_mean(pf[l + 1], p))
                  * pbv[l + 1];
        } else {
            ly = lay[l];
            top = lev[l];
            bot = lev[l + 1];
        }
        tl = tl * ds;
        if (RESCALE) {
            // Tang 2018 rescaling (reference :148-178)
            float w = ssa[l];
            float wb = w * (1.0f - asy[l]) * 0.5f;
            float scale = 1.0f - w + wb;
            *cn = 0.4f * wb / scale;
            tl = tl * scale;
        }
        rte::lw_source(tl, ly, top, bot, t, sdn, sup);
        if (RESCALE) *an = 1.0f - *t * *t;
    }
};

template <bool RESCALE, bool JAC, bool PFRAC>
__global__ void solver_lw_kernel(const LwArgs a) {
    extern __shared__ float smem[];
    const int nlay = a.nlay, ngpt = a.ngpt;
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    float* p_up = smem;                       // (nwarps, nlev) each
    float* p_dn = p_up + nwarps * nlev;
    float* p_jac = p_dn + nwarps * nlev;
    const bool byband = a.band_up != nullptr;
    rte::BandSums bands = {};
    if (byband) bands.init(p_jac + nwarps * nlev, a.gpt2band, ngpt, a.nband);

    const int c = blockIdx.x;
    const bool active = threadIdx.x < ngpt;
    const int g = active ? threadIdx.x : 0;   // idle lanes never read
    // RESCALE: radiance at the layer tops
    float* rad = RESCALE ? a.scratch + (long long)c * nlay * ngpt + g
                         : nullptr;
    float ds = a.ds.p ? a.ds.at(g, c) : a.ds_scalar;
    LwColumn<RESCALE, PFRAC> col(a, g, c, ds);
    float rdn_top = active ? a.inc.at(g, c) / a.piw : 0.0f;
    float t = 0.0f, sdn = 0.0f, sup = 0.0f, an = 0.0f, cn = 0.0f;
    const long long bo = (long long)c * nlev * a.nband;
    const rte::LevelSink up_s{p_up, nlev, byband ? a.band_up + bo : nullptr,
                              a.nband, 1, a.piw};
    const rte::LevelSink dn_s{p_dn, nlev, byband ? a.band_dn + bo : nullptr,
                              a.nband, 1, a.piw};

    // ---- down sweep (reference lw_transport_noscat_dn :681-708) ----
    float rdn = rdn_top;
    if (!RESCALE) dn_s.put(bands, rdn, 0);
    for (int l = 0; l < nlay; ++l) {
        if (active) {
            col.layer(l, &t, &sdn, &sup, &an, &cn);
            if (RESCALE) rad[(long long)l * ngpt] = rdn;
            rdn = t * rdn + sdn;
        }
        if (!RESCALE) dn_s.put(bands, rdn, l + 1);
    }

    // ---- surface emission + reflection (:198-202), then the up sweep ----
    float rup = 0.0f, rjac = 0.0f;
    if (active) {
        float e = a.emis.at(g, c);
        float src = PFRAC ? col.pf[nlay - 1] * a.pb_sfc.at(a.gpt2band[g], c)
                          : a.sfc.at(g, c);
        rup = rdn * (1.0f - e) + e * src;
        if (JAC) rjac = e * a.sfc_jac.at(g, c);
    }
    up_s.put(bands, rup, nlay);
    if (JAC) rte::reduce_level(rjac, p_jac, nlev, nlay);
    for (int l = nlay - 1; l >= 0; --l) {
        if (active) {
            col.layer(l, &t, &sdn, &sup, &an, &cn);
            rup = t * rup + sup;
            if (RESCALE) {
                // adjustment from the downwelling radiance at the layer's
                // top edge (reference lw_transport_1rescl :784-793)
                float* r = rad + (long long)l * ngpt;
                rup = rup + cn * (an * *r - t * sdn - sup);
                *r = rup;
            }
            if (JAC) rjac = t * rjac;
        }
        up_s.put(bands, rup, l);
        if (JAC) rte::reduce_level(rjac, p_jac, nlev, l);
    }

    if (RESCALE) {
        // ---- second down sweep, adjusted from the upwelling field ----
        rdn = rdn_top;
        dn_s.put(bands, rdn, 0);
        for (int l = 0; l < nlay; ++l) {
            if (active) {
                col.layer(l, &t, &sdn, &sup, &an, &cn);
                float adj = cn * (an * rad[(long long)l * ngpt] - t * sup
                                  - sdn);
                rdn = t * rdn + sdn + adj;
            }
            dn_s.put(bands, rdn, l + 1);
        }
    }

    __syncthreads();
    for (int lev_i = threadIdx.x; lev_i < nlev; lev_i += blockDim.x) {
        long long o = (long long)lev_i * a.out_sl + (long long)c * a.out_sc;
        if (!byband) {
            a.up[o] = a.piw * rte::level_total(p_up, nwarps, nlev, lev_i);
            a.dn[o] = a.piw * rte::level_total(p_dn, nwarps, nlev, lev_i);
        }
        if (JAC)
            a.jac[o] = a.piw * rte::level_total(p_jac, nwarps, nlev, lev_i);
    }
}

template <bool RESCALE, bool JAC, bool PFRAC>
cudaError_t run(const LwArgs& a, int ncol, cudaStream_t stream) {
    int threads = (a.ngpt + 31) / 32 * 32;
    size_t smem = (size_t)3 * (threads / 32) * (a.nlay + 1) * sizeof(float)
        + (a.band_up ? rte::BandSums::bytes(threads, a.nband) : 0);
    cudaError_t err = rte::allow_smem(solver_lw_kernel<RESCALE, JAC, PFRAC>,
                                      smem);
    if (err != cudaSuccess) return err;
    solver_lw_kernel<RESCALE, JAC, PFRAC><<<ncol, threads, smem, stream>>>(a);
    return cudaGetLastError();
}

int dispatch(const LwArgs& a, int ncol, void* stream) {
    if (ncol == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    bool rescale = a.ssa.p != nullptr, jacobian = a.jac != nullptr;
    cudaError_t err;
    if (rescale && jacobian) err = run<true, true, false>(a, ncol, s);
    else if (rescale) err = run<true, false, false>(a, ncol, s);
    else if (jacobian) err = run<false, true, false>(a, ncol, s);
    else err = run<false, false, false>(a, ncol, s);
    return (int)err;
}

}  // namespace

// The public layout: (column, layer, g-point) contiguous fields; with
// band_up/band_dn (column, level, band) per-band sums there (gpt2band)
// instead of the broadband up/dn (the Jacobian stays broadband).
extern "C" int launch_solver_lw(
        const void* tau, const void* lay, const void* lev, const void* ssa,
        const void* asy, const void* emis, const void* sfc,
        const void* sfc_jac, const void* inc, const void* ds_field,
        const void* gpt2band, void* scratch, void* up, void* dn, void* jac,
        void* band_up, void* band_dn, int ncol, int nlay, int ngpt,
        int nband, float ds_scalar, float piw, void* stream) {
    LwArgs a = {};
    a.gpt2band = (const int*)gpt2band;
    a.band_up = (float*)band_up;
    a.band_dn = (float*)band_dn;
    a.nband = nband;
    const int sl = ngpt, sc = nlay * ngpt;
    a.tau = f3(tau, 1, sl, sc);
    a.lay = f3(lay, 1, sl, sc);
    a.lev = f3(lev, 1, sl, (nlay + 1) * ngpt);
    a.ssa = f3(ssa, 1, sl, sc);
    a.asy = f3(asy, 1, sl, sc);
    a.emis = f2(emis, 1, ngpt);
    a.sfc = f2(sfc, 1, ngpt);
    a.sfc_jac = f2(sfc_jac, 1, ngpt);
    a.inc = f2(inc, 1, ngpt);
    a.ds = f2(ds_field, 1, ngpt);
    a.scratch = (float*)scratch;
    a.up = (float*)up;
    a.dn = (float*)dn;
    a.jac = (float*)jac;
    a.out_sl = 1;
    a.out_sc = nlay + 1;
    a.nlay = nlay;
    a.ngpt = ngpt;
    a.ds_scalar = ds_scalar;
    a.piw = piw;
    return dispatch(a, ncol, stream);
}

// The lane layout: (g-point, layer, column) fields, (g-point, column)
// boundary fields, each with its element strides; output (level, column).
extern "C" int launch_solver_lw_lanes(
        const void* tau, int tau0, int tau1, int tau2,
        const void* lay, int lay0, int lay1, int lay2,
        const void* lev, int lev0, int lev1, int lev2,
        const void* ssa, int ssa0, int ssa1, int ssa2,
        const void* asy, int asy0, int asy1, int asy2,
        const void* emis, int emis0, int emis1,
        const void* sfc, int sfc0, int sfc1,
        const void* sfc_jac, int jac0, int jac1,
        const void* inc, int inc0, int inc1,
        void* scratch, void* up, void* dn, void* jac,
        int ncol, int nlay, int ngpt, float ds, float piw, void* stream) {
    LwArgs a = {};
    a.tau = f3(tau, tau0, tau1, tau2);
    a.lay = f3(lay, lay0, lay1, lay2);
    a.lev = f3(lev, lev0, lev1, lev2);
    a.ssa = f3(ssa, ssa0, ssa1, ssa2);
    a.asy = f3(asy, asy0, asy1, asy2);
    a.emis = f2(emis, emis0, emis1);
    a.sfc = f2(sfc, sfc0, sfc1);
    a.sfc_jac = f2(sfc_jac, jac0, jac1);
    a.inc = f2(inc, inc0, inc1);
    a.scratch = (float*)scratch;
    a.up = (float*)up;
    a.dn = (float*)dn;
    a.jac = (float*)jac;
    a.out_sl = ncol;
    a.out_sc = 1;
    a.nlay = nlay;
    a.ngpt = ngpt;
    a.ds_scalar = ds;
    a.piw = piw;
    return dispatch(a, ncol, stream);
}

// The lane layout with in-kernel Planck sources: band fields (band,
// layer, column) and (band, column), read at gpt2band[g].
extern "C" int launch_solver_lw_pfrac(
        const void* tau, int tau0, int tau1, int tau2,
        const void* pfrac, int pf0, int pf1, int pf2,
        const void* pb_lay, int pbl0, int pbl1, int pbl2,
        const void* pb_lev, int pbv0, int pbv1, int pbv2,
        const void* pb_sfc, int pbs0, int pbs1,
        const void* cld, int cld0, int cld1, int cld2,
        const void* emis, int emis0, int emis1,
        const void* inc, int inc0, int inc1,
        const void* gpt2band, void* up, void* dn,
        int ncol, int nlay, int ngpt, float ds, float piw, void* stream) {
    if (ncol == 0) return 0;
    LwArgs a = {};
    a.tau = f3(tau, tau0, tau1, tau2);
    a.pfrac = f3(pfrac, pf0, pf1, pf2);
    a.pb_lay = f3(pb_lay, pbl0, pbl1, pbl2);
    a.pb_lev = f3(pb_lev, pbv0, pbv1, pbv2);
    a.pb_sfc = f2(pb_sfc, pbs0, pbs1);
    a.cld = f3(cld, cld0, cld1, cld2);
    a.emis = f2(emis, emis0, emis1);
    a.inc = f2(inc, inc0, inc1);
    a.gpt2band = (const int*)gpt2band;
    a.up = (float*)up;
    a.dn = (float*)dn;
    a.out_sl = ncol;
    a.out_sc = 1;
    a.nlay = nlay;
    a.ngpt = ngpt;
    a.ds_scalar = ds;
    a.piw = piw;
    return (int)run<false, false, true>(a, ncol, (cudaStream_t)stream);
}
