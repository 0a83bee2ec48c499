// SW two-stream solve with broadband output. One kernel, three
// launchers:
//   launch_solver_sw           the public rte_sw's solver: contiguous
//                              (column, layer, g-point) fields, mu0
//                              (column, layer), output (3, column, level);
//   launch_solver_sw_lanes     the staged branch's solver: (g-point,
//                              layer, column) fields through any element
//                              strides, mu0 (layer, column), output
//                              (3, level, column);
//   launch_solver_sw_combined  the same from the absorption and Rayleigh
//                              depths, with the Rayleigh combine and the
//                              by-band delta-scaled cloud increment done in
//                              the kernel (gpt2band, so ragged bands work).
//
// Replaces the TPU kernels rte_rrtmgp_tpu/ops/pallas/solver_sw_kernel.py::
// sw_two_stream_broadband_lane and ops/pallas/solver_lanes.py::
// sw_two_stream_broadband_lanes and ::sw_two_stream_broadband_lanes_combined
// (reference mo_rte_solver_kernels.F90:503-609, 985-1127, 1135-1245;
// combine_abs_and_rayleigh :1954-2036; increment_2stream_by_2stream).
// Plain twins: rte_rrtmgp_tpu_torch/ops/kernels/solver_sw.py::
// sw_2stream_plain and ops/kernels/solver_lanes.py::sw_2stream_lanes_plain,
// ::sw_2stream_lanes_combined_plain.
//
// Layout: one block per column, one thread per g-point; every field read
// through its element strides (common.cuh::Field3), so the gathers'
// (column, layer, g-point) output passed as a permuted view keeps g
// fastest and the loads coalesced. Pass 1, top down: the layer's optics
// (with COMBINED: ssa = tau_ray / tau where tau > 2 tiny, then the
// tau-weighted combine with the cloud of the thread's band, float32 tiny
// guards as in the TPU kernel), the Meador-Weaver coefficients with the
// reference's clamps (transport.cuh::sw_layer, the code of the fused SW
// kernel), night masking by mu0 > 0 per layer, and the direct beam.
// Passes 2 and 3: the adding sweeps (transport.cuh::adding) from the
// diffuse flux at the top, over per-thread layer columns in
// wrapper-allocated scratch laid out (field, column, level, g-point).
// Total down = diffuse + direct.
//
// What bounds it on this card: reading tau, ssa and g (or the two depths
// and the band cloud), 8-12 B per (column, layer, g-point), and the
// scratch traffic (six fields, about 14 x 4 B per (column, level,
// g-point)).
//
// Broadband sums are deterministic: warp-shuffle sums per level into
// shared memory, then fixed-order sums of the warp partials. No atomics.
// launch_solver_sw can give per-band sums instead (common.cuh::BandSums:
// per level, each band's g-points summed in g-point order by one thread),
// as the TPU kernel does for uniform bands; here any gpt2band works.
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

struct SwArgs {
    Field3 tau, ssa, asy;        // COMBINED: tau_abs, tau_ray; asy unused
    Field3 ct, cs, cg;           // COMBINED: cloud by band; ct.p null: none
    Field2 mu0;                  // (layer, column)
    Field2 alb_dir, alb_dif, inc, inc_dif;   // inc_dif.p null: no diffuse
    const int* gpt2band;         // COMBINED, or by-band output
    float* scratch;              // 6 x (column, level, g-point)
    float* out;                  // up, dn total, dir planes
    long long out_plane;
    int out_sl, out_sc;          // output strides of (level, column)
    float* band_out;             // by band: (3, column, level, band); or null
    int ncol, nlay, ngpt, nband;
};

// The layer optics of one thread's (column, g-point).
template <bool COMBINED>
struct SwColumn {
    Line tau, ssa, asy, ct, cs, cg;

    __device__ SwColumn(const SwArgs& a, int g, int c) {
        tau = a.tau.line(g, c);
        ssa = a.ssa.line(g, c);
        if (COMBINED) {
            int b = a.gpt2band[g];
            ct = a.ct.line(b, c);
            cs = a.cs.line(b, c);
            cg = a.cg.line(b, c);
        } else {
            asy = a.asy.line(g, c);
        }
    }

    __device__ __forceinline__ void layer(int l, float* t, float* w0,
                                          float* g) const {
        if (!COMBINED) {
            *t = tau[l];
            *w0 = ssa[l];
            *g = asy[l];
            return;
        }
        // combine_abs_and_rayleigh, then the by-band 2-stream increment
        // (JAX solver_lanes.py:704-721, float32 tiny in every guard)
        const float two_tiny = 2.0f * FLT_MIN;
        float ray = ssa[l];
        float t_gas = tau[l] + ray;
        float ssa_gas = t_gas > two_tiny ? ray / t_gas : 0.0f;
        if (!ct.p) {
            *t = t_gas;
            *w0 = ssa_gas;
            *g = 0.0f;
            return;
        }
        float o_tau = ct[l], o_ssa = cs[l], o_g = cg[l];
        float tt = t_gas + o_tau;
        float tauscat = t_gas * ssa_gas + o_tau * o_ssa;
        float g12 = (o_tau * o_ssa * o_g) / fmaxf(tauscat, FLT_MIN);
        float ssa12 = tauscat / fmaxf(tt, FLT_MIN);
        *t = tt;
        *g = tauscat > two_tiny ? g12 : 0.0f;
        *w0 = tt > two_tiny ? ssa12 : ssa_gas;
    }
};

// BYBAND is a template argument, not a test of a.band_out, so that the
// broadband kernels hold no by-band state in registers (a run-time test
// costs them a third more registers and a block per SM).
template <bool COMBINED, bool BYBAND>
__global__ void solver_sw_kernel(const SwArgs a) {
    extern __shared__ float smem[];
    const int nlay = a.nlay, ngpt = a.ngpt;
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    float* p_up = smem;                       // (nwarps, nlev) each
    float* p_dn = p_up + nwarps * nlev;
    float* p_dir = p_dn + nwarps * nlev;
    rte::BandSums bands = {};
    if (BYBAND) bands.init(p_dir + nwarps * nlev, a.gpt2band, ngpt, a.nband);

    const int c = blockIdx.x;
    const bool active = threadIdx.x < ngpt;
    const int g = active ? threadIdx.x : 0;   // idle lanes never read
    const long long field = (long long)a.ncol * nlev * ngpt;
    float* R = a.scratch + (long long)c * nlev * ngpt + g;   // rdif
    float* T = R + field;                                    // tdif
    float* SDN = T + field;                                  // source_dn
    float* SUP = SDN + field;     // source_up, then 1/(1-r*alb)
    float* ALB = SUP + field;                                // albedo at levels
    float* SRC = ALB + field;                                // source at levels
    SwColumn<COMBINED> col(a, g, c);
    // by band: the (level, band) planes of this column
    const long long bplane = (long long)a.ncol * nlev * a.nband;
    float* bup = BYBAND ? a.band_out + (long long)c * nlev * a.nband
                        : nullptr;
    float* bdn = BYBAND ? bup + bplane : nullptr;
    float* bdir = BYBAND ? bup + 2 * bplane : nullptr;
    const rte::LevelSink dir_s{p_dir, nlev, bdir, a.nband, 1, 1.0f, nullptr};
    const rte::LevelSink up_s{p_up, nlev, bup, a.nband, 1, 1.0f, nullptr};
    const rte::LevelSink dn_s{p_dn, nlev, bdn, a.nband, 1, 1.0f, bdir};

    // ---- pass 1: two-stream coefficients, direct beam ----
    float dir = active ? a.inc.at(g, c) * a.mu0.at(0, c) : 0.0f;
    dir_s.put(bands, dir, 0);
    for (int l = 0; l < nlay; ++l) {
        if (active) {
            float mu = a.mu0.at(l, c);
            float t, w0, asy;
            col.layer(l, &t, &w0, &asy);
            rte::SwLayer s = rte::sw_layer(t, w0, asy, mu);
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
        alb_sfc = a.alb_dif.at(g, c);
        src_sfc = a.mu0.at(nlay - 1, c) > 0.0f ? dir * a.alb_dir.at(g, c)
                                               : 0.0f;
        top = a.inc_dif.p ? a.inc_dif.at(g, c) : 0.0f;
    }
    rte::adding(active, R, T, SDN, SUP, ALB, SRC, nlay, ngpt, alb_sfc,
                src_sfc, top, up_s, dn_s, bands);
    if (BYBAND) return;

    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
        long long o = (long long)lev * a.out_sl + (long long)c * a.out_sc;
        float fd = rte::level_total(p_dir, nwarps, nlev, lev);
        a.out[o] = rte::level_total(p_up, nwarps, nlev, lev);
        a.out[a.out_plane + o] = rte::level_total(p_dn, nwarps, nlev, lev)
                                 + fd;
        a.out[2 * a.out_plane + o] = fd;
    }
}

template <bool COMBINED, bool BYBAND = false>
int run(const SwArgs& a, void* stream) {
    if (a.ncol == 0) return 0;
    int threads = (a.ngpt + 31) / 32 * 32;
    size_t smem = (size_t)3 * (threads / 32) * (a.nlay + 1) * sizeof(float)
        + (BYBAND ? rte::BandSums::bytes(threads, a.nband) : 0);
    cudaError_t err = rte::allow_smem(solver_sw_kernel<COMBINED, BYBAND>,
                                      smem);
    if (err != cudaSuccess) return (int)err;
    solver_sw_kernel<COMBINED, BYBAND><<<a.ncol, threads, smem,
                                         (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

SwArgs base(void* scratch, void* out, int ncol, int nlay, int ngpt,
            bool lanes) {
    SwArgs a = {};
    a.scratch = (float*)scratch;
    a.out = (float*)out;
    a.out_plane = (long long)ncol * (nlay + 1);
    a.out_sl = lanes ? ncol : 1;
    a.out_sc = lanes ? 1 : nlay + 1;
    a.ncol = ncol;
    a.nlay = nlay;
    a.ngpt = ngpt;
    return a;
}

}  // namespace

// The public layout: (column, layer, g-point) contiguous fields; with
// band_out (3, column, level, band) per-band sums there (gpt2band) instead
// of the broadband ``out``.
extern "C" int launch_solver_sw(
        const void* tau, const void* ssa, const void* asy, const void* mu0,
        const void* alb_dir, const void* alb_dif, const void* inc,
        const void* inc_dif, const void* gpt2band, void* scratch, void* out,
        void* band_out, int ncol, int nlay, int ngpt, int nband,
        void* stream) {
    SwArgs a = base(scratch, out, ncol, nlay, ngpt, false);
    a.gpt2band = (const int*)gpt2band;
    a.band_out = (float*)band_out;
    a.nband = nband;
    const int sl = ngpt, sc = nlay * ngpt;
    a.tau = f3(tau, 1, sl, sc);
    a.ssa = f3(ssa, 1, sl, sc);
    a.asy = f3(asy, 1, sl, sc);
    a.mu0 = f2(mu0, 1, nlay);
    a.alb_dir = f2(alb_dir, 1, ngpt);
    a.alb_dif = f2(alb_dif, 1, ngpt);
    a.inc = f2(inc, 1, ngpt);
    a.inc_dif = f2(inc_dif, 1, ngpt);
    return band_out ? run<false, true>(a, stream) : run<false>(a, stream);
}

// The lane layout: (g-point, layer, column) fields, mu0 (layer, column),
// (g-point, column) boundary fields, each with its element strides.
extern "C" int launch_solver_sw_lanes(
        const void* tau, int tau0, int tau1, int tau2,
        const void* ssa, int ssa0, int ssa1, int ssa2,
        const void* asy, int asy0, int asy1, int asy2,
        const void* mu0, int mu_l, int mu_c,
        const void* alb_dir, int ad0, int ad1,
        const void* alb_dif, int af0, int af1,
        const void* inc, int inc0, int inc1,
        const void* inc_dif, int id0, int id1,
        void* scratch, void* out, int ncol, int nlay, int ngpt,
        void* stream) {
    SwArgs a = base(scratch, out, ncol, nlay, ngpt, true);
    a.tau = f3(tau, tau0, tau1, tau2);
    a.ssa = f3(ssa, ssa0, ssa1, ssa2);
    a.asy = f3(asy, asy0, asy1, asy2);
    a.mu0 = f2(mu0, mu_l, mu_c);
    a.alb_dir = f2(alb_dir, ad0, ad1);
    a.alb_dif = f2(alb_dif, af0, af1);
    a.inc = f2(inc, inc0, inc1);
    a.inc_dif = f2(inc_dif, id0, id1);
    return run<false>(a, stream);
}

// The lane layout from the absorption and Rayleigh depths, with the
// by-band cloud (tau, ssa, g) read at gpt2band[g].
extern "C" int launch_solver_sw_combined(
        const void* tau_abs, int ta0, int ta1, int ta2,
        const void* tau_ray, int tr0, int tr1, int tr2,
        const void* ct, int ct0, int ct1, int ct2,
        const void* cs, int cs0, int cs1, int cs2,
        const void* cg, int cg0, int cg1, int cg2,
        const void* mu0, int mu_l, int mu_c,
        const void* alb_dir, int ad0, int ad1,
        const void* alb_dif, int af0, int af1,
        const void* inc, int inc0, int inc1,
        const void* inc_dif, int id0, int id1,
        const void* gpt2band, void* scratch, void* out, int ncol, int nlay,
        int ngpt, void* stream) {
    SwArgs a = base(scratch, out, ncol, nlay, ngpt, true);
    a.tau = f3(tau_abs, ta0, ta1, ta2);
    a.ssa = f3(tau_ray, tr0, tr1, tr2);
    a.ct = f3(ct, ct0, ct1, ct2);
    a.cs = f3(cs, cs0, cs1, cs2);
    a.cg = f3(cg, cg0, cg1, cg2);
    a.mu0 = f2(mu0, mu_l, mu_c);
    a.alb_dir = f2(alb_dir, ad0, ad1);
    a.alb_dif = f2(alb_dif, af0, af1);
    a.inc = f2(inc, inc0, inc1);
    a.inc_dif = f2(inc_dif, id0, id1);
    a.gpt2band = (const int*)gpt2band;
    return run<true>(a, stream);
}
