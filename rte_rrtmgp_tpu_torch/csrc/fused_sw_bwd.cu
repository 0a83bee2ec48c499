// Adjoint of the fused SW step (fused_sw.cu): gas optics + Rayleigh +
// by-band cloud increment + Meador-Weaver two-stream + adding +
// broadband sums, backward, one column per block.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/fused_sw_bwd.py::
// _sw_fused_bwd (pallas_call :694; phases :6-24). Plain twin:
// torch.autograd.grad of rte_rrtmgp_tpu_torch/ops/kernels/fused_sw.py::
// sw_fused_plain (fused_sw.py::sw_fused_bwd_plain).
//
// Layout: one block per column, one thread per g-point, as the forward.
//   Phase 0 (P-R): the forward's gas optics, Rayleigh, absorption/
//     Rayleigh combine and cloud increment per layer; the layer optics
//     (tau, ssa, g) go to scratch.
//   Phase A (P-0, A-F, A-U, A-S, A-C): the two-stream + adding adjoint
//     (transport_bwd.cuh::sw_adjoint) on those optics and mu0, from the
//     diffuse incident flux incdif (zero when null; its cotangent to
//     incdif_b when that is set); the
//     optics' cotangents overwrite them in scratch, and mu0's are summed
//     over the g-points per layer (warp shuffles, then a fixed-order sum
//     of the warp partials).
//   Phase B (A-X, A-G): per layer, the combine and the cloud increment
//     transposed (with the forward's float32 tiny guards), then the
//     major, Rayleigh and minor adjoints, and every per-cell sum over
//     g-points (gas_optics_bwd.cuh::gas_bars_reduce: fixed order, no
//     atomics): ftemp, fpress, feta, col_mix, the minor scalings,
//     rayscale (= col_h2o + col_dry) and the cloud (tau, ssa, g) by band.
// Scratch: 3 float fields of (column, layer, g-point) and the adjoint's
// 13 of (column, level, g-point).
//
// What bounds it on this card: the scratch traffic of the transport
// adjoint (about 110 B per (column, layer, g-point)), the table gathers
// (12 per (cell, g-point), twice), and the per-cell sums, run on one
// thread per output while the rest of the block waits.
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

struct Col {
    const float* T3;       // (t, w0, asym) fields, field stride fs
    long long fs, ls;
    const float* mu0;      // (nlay, ncol)
    int ncol, c;
    __device__ void layer(int l, float* t, float* w0, float* g,
                          float* mu) const {
        *t = T3[l * ls];
        *w0 = T3[fs + l * ls];
        *g = T3[2 * fs + l * ls];
        *mu = __ldg(mu0 + l * ncol + c);
    }
};

struct Sink {
    bool active;
    float* T3;
    long long fs, ls;
    float* p_mu;           // (nwarps, nlay)
    int nlay;
    __device__ void layer(int l, const rte::SwBars& b) {
        if (active) {
            T3[l * ls] = b.t;
            T3[fs + l * ls] = b.w0;
            T3[2 * fs + l * ls] = b.asym;
        }
        rte::reduce_level(b.mu, p_mu, nlay, l);
    }
};

__global__ void fused_sw_bwd_kernel(
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
        const float* __restrict__ incdif, const float* __restrict__ gup,
        const float* __restrict__ gdn, const float* __restrict__ gdir,
        float* scratch, rte::GasBarsOut out, float* mu0_b, float* alb_dir_b,
        float* alb_dif_b, float* inc_b, float* incdif_b,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int nbnd) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    float* p_mu = smem;                            // (nwarps, nlay)
    float* p_seed = p_mu + nwarps * nlay;          // (nwarps, 1)
    float* gsm = p_seed + nwarps;
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
    const long long ls = ngpt;
    const long long fs3 = (long long)ncol * nlay * ngpt;
    const long long fs = (long long)ncol * nlev * ngpt;
    float* T3 = scratch + (long long)c * nlay * ngpt + g;
    float* S = scratch + 3 * fs3 + (long long)c * nlev * ngpt + g;
    const int band = gpt2band[g];
    const long long cplane = (long long)nbnd * ncell;
    const float tiny = FLT_MIN;

    // ---- phase 0: the layer optics (fused_sw.cu pass 1) ----
    if (active) {
        for (int l = 0; l < nlay; ++l) {
            int cell = l * ncol + c;
            CellDesc d = rte::load_cell(jtemp, ftemp, jpress, fpress, tropo,
                                        cell);
            int flav = gflav[(d.lower ? 0 : 1) * ngpt + g];
            float tau, unused;
            rte::major_tau(d, flav, nflav, ncell, cell, jeta, feta, col_mix,
                           kmajor, nullptr, neta, npres1, ngpt, g, &tau,
                           &unused);
            tau = rte::minor_tau(tau, d, sm.meta, nminor, nflav, ncell, cell,
                                 jeta, feta, msc, klo, kup, ncl, ncu, neta, g);
            float ray = rte::rayleigh_k(d, flav, nflav, ncell, cell, jeta,
                                        feta, krayl, neta, ngpt, g)
                * rayscale[cell];
            float t = tau + ray;
            float w0 = t > 2.0f * tiny ? ray / t : 0.0f;
            float asym = 0.0f;
            if (cloud) {
                long long bc = (long long)band * ncell + cell;
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
            T3[l * ls] = t;
            T3[fs3 + l * ls] = w0;
            T3[2 * fs3 + l * ls] = asym;
        }
    }

    // ---- phase A: the two-stream + adding adjoint ----
    Col col{T3, fs3, ls, mu0, ncol, c};
    Sink sink{active, T3, fs3, ls, p_mu, nlay};
    const long long gc = (long long)g * ncol + c;
    rte::SwBoundaryBars bb = rte::sw_adjoint(
        active, col, nlay, active ? __ldg(inc + gc) : 0.0f,
        active ? __ldg(alb_dir + gc) : 0.0f,
        active ? __ldg(alb_dif + gc) : 0.0f,
        active && incdif ? __ldg(incdif + gc) : 0.0f, gup + c, gdn + c,
        gdir + c, ncol, S, fs, ls, sink);
    if (active) {
        alb_dir_b[gc] = bb.alb_dir;
        alb_dif_b[gc] = bb.alb_dif;
        inc_b[gc] = bb.inc;
        if (incdif_b) incdif_b[gc] = bb.inc_dif;
    }
    rte::reduce_level(bb.mu_top, p_seed, 1, 0);
    __syncthreads();
    for (int l = threadIdx.x; l < nlay; l += blockDim.x) {
        float s = rte::level_total(p_mu, nwarps, nlay, l);
        if (l == 0) s += rte::level_total(p_seed, nwarps, 1, 0);
        mu0_b[l * ncol + c] = s;
    }

    // ---- phase B: combine and cloud transposed, then the gas optics ----
    for (int l = 0; l < nlay; ++l) {
        int cell = l * ncol + c;
        CellDesc d = rte::load_cell(jtemp, ftemp, jpress, fpress, tropo,
                                    cell);
        if (active) {
            float t_b = T3[l * ls];
            float w0_b = T3[fs3 + l * ls];
            float asym_b = T3[2 * fs3 + l * ls];
            int flav = gflav[(d.lower ? 0 : 1) * ngpt + g];
            float tau, unused;
            rte::major_tau(d, flav, nflav, ncell, cell, jeta, feta, col_mix,
                           kmajor, nullptr, neta, npres1, ngpt, g, &tau,
                           &unused);
            tau = rte::minor_tau(tau, d, sm.meta, nminor, nflav, ncell, cell,
                                 jeta, feta, msc, klo, kup, ncl, ncu, neta, g);
            float kray = rte::rayleigh_k(d, flav, nflav, ncell, cell, jeta,
                                         feta, krayl, neta, ngpt, g);
            float rs = rayscale[cell];
            float ray = kray * rs;
            float t_gas = tau + ray;
            bool big = t_gas > 2.0f * tiny;
            float ssa_gas = big ? ray / t_gas : 0.0f;
            float t_gas_b, ssa_gas_b, ct_b = 0.0f, cs_b = 0.0f, cg_b = 0.0f;
            if (cloud) {
                // t = t_gas + ct; ts = t_gas ssa_gas + ct cs;
                // asym = ts > 2 tiny ? ct cs cg / max(ts, tiny) : 0;
                // w0 = t > 2 tiny ? ts / max(t, tiny) : ssa_gas
                long long bc = (long long)band * ncell + cell;
                float ct = cloud[bc];
                float cs = cloud[cplane + bc];
                float cg = cloud[2 * cplane + bc];
                float t = t_gas + ct;
                float ts = t_gas * ssa_gas + ct * cs;
                float ts_safe = fmaxf(ts, tiny), t_safe = fmaxf(t, tiny);
                float g12 = (ct * cs * cg) / ts_safe;
                float ssa12 = ts / t_safe;
                float ssa12_b = t > 2.0f * tiny ? w0_b : 0.0f;
                ssa_gas_b = t > 2.0f * tiny ? 0.0f : w0_b;
                float g12_b = ts > 2.0f * tiny ? asym_b : 0.0f;
                ct_b = g12_b * (cs * cg) / ts_safe;
                cs_b = g12_b * (ct * cg) / ts_safe;
                cg_b = g12_b * (ct * cs) / ts_safe;
                float ts_b = -g12_b * g12 / ts_safe * rte::dmax(ts, tiny)
                             + ssa12_b / t_safe;
                float tt_b = t_b - ssa12_b * ssa12 / t_safe
                                   * rte::dmax(t, tiny);
                t_gas_b = tt_b + ts_b * ssa_gas;
                ssa_gas_b += ts_b * t_gas;
                ct_b += ts_b * cs + tt_b;
                cs_b += ts_b * ct;
            } else {
                t_gas_b = t_b;
                ssa_gas_b = w0_b;
            }
            // ssa_gas = big ? ray / t_gas : 0; t_gas = tau + ray
            float ray_b = big ? ssa_gas_b / t_gas : 0.0f;
            if (big) t_gas_b -= ssa_gas_b * ray / (t_gas * t_gas);
            ray_b += t_gas_b;
            float tb = t_gas_b;
            rte::MajorBars mb = rte::major_adjoint(
                d, flav, nflav, ncell, cell, jeta, feta, col_mix, kmajor,
                nullptr, neta, npres1, ngpt, g, tb, 0.0f);
            rte::rayleigh_adjoint(d, flav, nflav, ncell, cell, jeta, feta,
                                  krayl, neta, ngpt, g, ray_b * rs, &mb);
            sm.tb[g] = tb;
            sm.fe[0][g] = mb.fe[0];
            sm.fe[1][g] = mb.fe[1];
            sm.cm[0][g] = mb.cm[0];
            sm.cm[1][g] = mb.cm[1];
            sm.ft[g] = mb.ft;
            sm.fp[g] = mb.fp;
            sm.dense[g] = ray_b * kray;
            sm.band[0][g] = ct_b;
            sm.band[1][g] = cs_b;
            sm.band[2][g] = cg_b;
        }
        rte::gas_bars_reduce(sm, out, d, cell, ncell, ngpt, nflav, nminor,
                             gflav, gpt2band, jeta, feta, msc, klo, kup, ncl,
                             ncu, neta);
    }
}

}  // namespace

extern "C" int launch_fused_sw_bwd(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* msc,
        const void* minor_meta, const void* kmajor, const void* klo,
        const void* kup, const void* krayl, const void* gflav,
        const void* gpt2band, const void* rayscale, const void* cloud,
        const void* mu0, const void* alb_dir, const void* alb_dif,
        const void* inc, const void* incdif, const void* gup,
        const void* gdn, const void* gdir, void* scratch, void* ftemp_b,
        void* fpress_b, void* feta_b, void* col_mix_b, void* msc_b,
        void* rayscale_b, void* cloud_b, void* mu0_b, void* alb_dir_b,
        void* alb_dif_b, void* inc_b, void* incdif_b,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int nbnd, void* stream) {
    if (ncol == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    int nwarps = threads / 32;
    size_t smem = (size_t)(nwarps * (nlay + 1)
                           + rte::GasBarsSmem::floats(threads, nminor, nflav))
                      * sizeof(float)
                  + (size_t)nminor * rte::kMetaFields * sizeof(int);
    cudaError_t err = rte::allow_smem(fused_sw_bwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rte::GasBarsOut out{(float*)ftemp_b, (float*)fpress_b, (float*)feta_b,
                        (float*)col_mix_b, (float*)msc_b, (float*)rayscale_b,
                        (float*)cloud_b, cloud ? 3 : 0, cloud ? nbnd : 0};
    fused_sw_bwd_kernel<<<ncol, threads, smem, (cudaStream_t)stream>>>(
        (const int*)jtemp, (const float*)ftemp, (const int*)jpress,
        (const float*)fpress, (const int*)tropo, (const int*)jeta,
        (const float*)feta, (const float*)col_mix, (const float*)msc,
        (const int*)minor_meta, (const float*)kmajor, (const float*)klo,
        (const float*)kup, (const float*)krayl, (const int*)gflav,
        (const int*)gpt2band, (const float*)rayscale, (const float*)cloud,
        (const float*)mu0, (const float*)alb_dir, (const float*)alb_dif,
        (const float*)inc, (const float*)incdif, (const float*)gup,
        (const float*)gdn, (const float*)gdir, (float*)scratch, out,
        (float*)mu0_b, (float*)alb_dir_b, (float*)alb_dif_b, (float*)inc_b,
        (float*)incdif_b,
        ncol, nlay, ngpt, neta, npres1, nflav, nminor, ncl, ncu, nbnd);
    return (int)cudaGetLastError();
}
