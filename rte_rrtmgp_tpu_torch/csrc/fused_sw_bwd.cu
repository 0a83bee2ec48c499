// Adjoint of the fused SW step (fused_sw.cu): gas optics + Rayleigh +
// by-band cloud increment + Meador-Weaver two-stream + adding +
// broadband sums, backward, one column per block, one thread per
// g-point.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/fused_sw_bwd.py::
// _sw_fused_bwd (pallas_call :694; phases :6-24). Plain twin:
// torch.autograd.grad of rte_rrtmgp_tpu_torch/ops/kernels/fused_sw.py::
// sw_fused_plain (fused_sw.py::sw_fused_bwd_plain).
//
// What bounds it on this card: latency. The function moves 36 B per
// (column, layer, g-point); the adjoint is seven dependent passes over
// each (column, g-point)'s 72 levels, device-memory and L2 round trips
// at every level, with 7 warps a block. Measured on an H100 at 4096 x 72
// (copies cut after each pass, built and timed beside the whole
// kernel), the earlier design took 48.3 ms: 20.4 in
// per-cell sums over g-points, each output summed serially in g-point
// order, 17.0 in the transport adjoint over 13 level fields, 7.5 in
// gathering the gas optics a second and third time, at 128 registers
// and 2 blocks per SM. This design:
//   * sums each cell's cotangents (ftemp, fpress, feta and col_mix per
//     flavor, the minor scalings, rayscale, the cloud inputs by band)
//     with segmented warp scans of every thread's own terms and fixed
//     lists of runs (gas_optics_bwd.cuh::CellSums): one barrier per
//     layer, no atomics, the same bits on every run;
//   * gathers the gas optics twice per (cell, g-point), not three times:
//     in sweep 1 for the layer optics, and in sweep 7, where gas_lin
//     returns them with their derivatives in the descriptors, so the
//     combine, cloud, major, minor and Rayleigh adjoints take one gather;
//   * runs the transport adjoint (transport_bwd.cuh::sw_adjoint) on five
//     fields per (column, level, g-point) instead of thirteen,
//     recomputing each layer's coefficients from its optics, every pass
//     loading the next level before it works on the current one;
//   * keeps the gas adjoint and the sums (sweep 7) out of the transport's
//     sweeps, so their barrier does not hold the sweeps back, and takes
//     registers for 4 blocks per SM (kBlocksPerSM): more resident warps
//     hide more latency than the spilled registers cost (64-72
//     registers, 368-520 B of spill stores; measured: 12.0 ms against
//     15.3 at 2 blocks per SM).
// Sweeps: 1 (down) gas optics -> the layer optics (tau, ssa, g) and the
// direct beam; 2-5 the adding build, the diffuse flux, A-F, A-U; 6 (up)
// A-S and A-C, the layer optics' cotangents replacing the optics; 7
// (down) the combine and cloud increment transposed (with the forward's
// float32 tiny guards), the gas adjoint and the layer's per-cell sums;
// mu0's cotangent per layer from warp partials. Scratch: 4 float fields
// of (column, layer, g-point) and 4 of (column, level, g-point)
// (fused_sw.py::sw_fused_bwd_scratch_bytes: 2.13 GB at 4096 x 72).
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; descriptors layer-major (nlay, ncol); the
// segment table of ops/kernels/adjoint_segments.py for gpt2band, gflav
// and minor_meta.

#include <cfloat>
#include <cmath>

#include "common.cuh"
#include "gas_optics_bwd.cuh"
#include "transport_bwd.cuh"

namespace {

using rte::CellDesc;

// the cells' descriptors
struct Cells {
    const int* __restrict__ jtemp;
    const float* __restrict__ ftemp;
    const int* __restrict__ jpress;
    const float* __restrict__ fpress;
    const int* __restrict__ tropo;
    __device__ __forceinline__ CellDesc at(int cell) const {
        return rte::load_cell(jtemp, ftemp, jpress, fpress, tropo, cell);
    }
};

// The layer optics of gas + Rayleigh + cloud (fused_sw.cu pass 1): the
// absorption/Rayleigh combine and the by-band cloud increment.
struct Optics {
    float t, w0, asym;         // the layer's
    float ssa_gas;             // before the cloud
    float ct, cs, cg;          // the band's cloud (zero without)
};

__device__ __forceinline__ Optics combine(float t_gas, float ray,
                                          const float* __restrict__ cloud,
                                          long long bc, long long cplane) {
    const float tiny = FLT_MIN;
    Optics o;
    float t = t_gas;
    o.ssa_gas = t > 2.0f * tiny ? ray / t : 0.0f;
    float w0 = o.ssa_gas, asym = 0.0f;
    o.ct = o.cs = o.cg = 0.0f;
    if (cloud) {
        o.ct = __ldg(cloud + bc);
        o.cs = __ldg(cloud + cplane + bc);
        o.cg = __ldg(cloud + 2 * cplane + bc);
        float t12 = t + o.ct;
        float tauscat = t * w0 + o.ct * o.cs;
        float g12 = (o.ct * o.cs * o.cg) / fmaxf(tauscat, tiny);
        asym = tauscat > 2.0f * tiny ? g12 : 0.0f;
        w0 = t12 > 2.0f * tiny ? tauscat / fmaxf(t12, tiny) : w0;
        t = t12;
    }
    o.t = t;
    o.w0 = w0;
    o.asym = asym;
    return o;
}

// The combine and cloud increment transposed (with the forward's float32
// tiny guards): from the cotangents of the layer optics to those of the
// gas optical depth t_gas (the tau of the gas optics), of the Rayleigh
// optical depth ray and of the band's cloud (tau, ssa, g). It multiplies
// by three reciprocals instead of dividing eleven times (a float32
// division is a sequence of instructions on the card): measurably faster
// on an H100 (PERF.md's findings on this kernel).
struct CombineBars {
    float tau, ray, ct, cs, cg;
};

__device__ __forceinline__ CombineBars combine_adjoint(
        float t_gas, float ray, const Optics& o, bool cloud, float t_b,
        float w0_b, float asym_b) {
    const float tiny = FLT_MIN;
    const bool big = t_gas > 2.0f * tiny;
    CombineBars r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float t_gas_b, ssa_gas_b;
    if (cloud) {
        // t = t_gas + ct; ts = t_gas ssa_gas + ct cs;
        // asym = ts > 2 tiny ? ct cs cg / max(ts, tiny) : 0;
        // w0 = t > 2 tiny ? ts / max(t, tiny) : ssa_gas
        const float ct = o.ct, cs = o.cs, cg = o.cg;
        float t = t_gas + ct;
        float ts = t_gas * o.ssa_gas + ct * cs;
        const float inv_ts = 1.0f / fmaxf(ts, tiny);
        const float inv_t = 1.0f / fmaxf(t, tiny);
        float g12 = (ct * cs * cg) * inv_ts;
        float ssa12 = ts * inv_t;
        float ssa12_b = t > 2.0f * tiny ? w0_b : 0.0f;
        ssa_gas_b = t > 2.0f * tiny ? 0.0f : w0_b;
        float g12_b = ts > 2.0f * tiny ? asym_b : 0.0f;
        r.ct = g12_b * (cs * cg) * inv_ts;
        r.cs = g12_b * (ct * cg) * inv_ts;
        r.cg = g12_b * (ct * cs) * inv_ts;
        float ts_b = -g12_b * g12 * inv_ts * rte::dmax(ts, tiny)
                     + ssa12_b * inv_t;
        float tt_b = t_b - ssa12_b * ssa12 * inv_t * rte::dmax(t, tiny);
        t_gas_b = tt_b + ts_b * o.ssa_gas;
        ssa_gas_b += ts_b * t_gas;
        r.ct += ts_b * cs + tt_b;
        r.cs += ts_b * ct;
    } else {
        t_gas_b = t_b;
        ssa_gas_b = w0_b;
    }
    // ssa_gas = big ? ray / t_gas : 0; t_gas = tau + ray
    const float inv_tg = 1.0f / t_gas;
    r.ray = big ? ssa_gas_b * inv_tg : 0.0f;
    if (big) t_gas_b -= ssa_gas_b * ray * inv_tg * inv_tg;
    r.ray += t_gas_b;
    r.tau = t_gas_b;
    return r;
}

// one layer's optics from the first sweep's fields
struct Col {
    const float* T;
    const float* W;
    const float* G;
    long long ls;
    const float* __restrict__ mu0;   // (nlay, ncol)
    int ncol, c;
    __device__ __forceinline__ void layer(int l, float* t, float* w0,
                                          float* g, float* mu) const {
        *t = T[l * ls];
        *w0 = W[l * ls];
        *g = G[l * ls];
        *mu = __ldg(mu0 + l * ncol + c);
    }
};

// Sweep 6's per-layer output: the cotangents of the layer optics, where
// the optics were (their last read), and mu0's warp partials.
struct Sink {
    bool active;
    float* T;
    float* W;
    float* G;
    long long ls;
    float* p_mu;           // (nwarps, nlay)
    int nlay;
    __device__ __forceinline__ void layer(int l, const rte::SwBars& b) {
        if (active) {
            T[l * ls] = b.t;
            W[l * ls] = b.w0;
            G[l * ls] = b.asym;
        }
        rte::reduce_level(b.mu, p_mu, nlay, l);
    }
};

template <int NQ, int NS, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) fused_sw_bwd_kernel(
        Cells cells, rte::GasArgs gas, const int* __restrict__ minor_meta,
        const int* __restrict__ seg, const int* __restrict__ gflav,
        const int* __restrict__ gpt2band, const float* __restrict__ rayscale,
        const float* __restrict__ cloud, const float* __restrict__ mu0,
        const float* __restrict__ alb_dir, const float* __restrict__ alb_dif,
        const float* __restrict__ inc, const float* __restrict__ incdif,
        const float* __restrict__ gup, const float* __restrict__ gdn,
        const float* __restrict__ gdir, float* scratch, rte::GasBarsOut out,
        float* mu0_b, float* alb_dir_b, float* alb_dif_b, float* inc_b,
        float* incdif_b, int ncol, int nlay, int nminor, int csr_len) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    const int ngpt = gas.ngpt;
    float* p_mu = smem;                            // (nwarps, nlay)
    float* p_seed = p_mu + nwarps * nlay;          // (nwarps, 1)
    int* meta = (int*)(p_seed + nwarps);           // (nminor, kMetaFields)
    int* csr = meta + nminor * rte::kMetaFields;
    float* part = (float*)(csr + csr_len);
    for (int i = threadIdx.x; i < nminor * rte::kMetaFields; i += blockDim.x)
        meta[i] = minor_meta[i];
    rte::CellSums<NQ, 3, NS> sums;
    sums.init(seg, csr, part);
    rte::GasArgs ga = gas;
    ga.meta = meta;
    __syncthreads();

    const int c = blockIdx.x;
    const bool active = threadIdx.x < ngpt;
    const int g = active ? threadIdx.x : 0;
    const int ncell = nlay * ncol;
    const long long ls = ngpt;
    const long long lay = (long long)ncol * nlay * ngpt;
    const long long lev = (long long)ncol * nlev * ngpt;
    const long long cl = (long long)c * nlay * ngpt + g;
    const long long cv = (long long)c * nlev * ngpt + g;
    float* T = scratch + cl;
    float* W = T + lay;
    float* G = W + lay;
    float* FH = G + lay;
    float* lev0 = scratch + 4 * lay + cv;
    const rte::SwScratch S{lev0, lev0 + lev, lev0 + 2 * lev, lev0 + 3 * lev,
                           FH, ls};
    const int band = __ldg(gpt2band + g);
    const int flav_lo = __ldg(gflav + g), flav_up = __ldg(gflav + ngpt + g);
    const long long cplane = (long long)out.nbnd * ncell;
    const long long crow = (long long)band * ncell;
    const long long gc = (long long)g * ncol + c;
    const float inc_g = active ? __ldg(inc + gc) : 0.0f;

    // ---- sweep 1: the layer optics (fused_sw.cu pass 1) and the beam ----
    if (active) {
        float dir = inc_g * __ldg(mu0 + c);
        for (int l = 0; l < nlay; ++l) {
            const int cell = l * ncol + c;
            const CellDesc d = cells.at(cell);
            const rte::GasLin<NS> gl = rte::gas_lin<false, true>(
                ga, d, d.lower ? flav_lo : flav_up, cell, g, sums.slots);
            const float ray = gl.kray * __ldg(rayscale + cell);
            Optics o = combine(gl.tau + ray, ray, cloud, crow + cell, cplane);
            T[l * ls] = o.t;
            W[l * ls] = o.w0;
            G[l * ls] = o.asym;
            S.dir[l * ls] = dir;
            dir = dir * rte::sw_tns(o.t, __ldg(mu0 + cell));
        }
        S.dir[nlay * ls] = dir;
    }

    // ---- sweeps 2-6: the two-stream + adding adjoint; the layer optics'
    // cotangents replace the optics ----
    const Col col{T, W, G, ls, mu0, ncol, c};
    Sink sink{active, T, W, G, ls, p_mu, nlay};
    rte::SwBoundaryBars bb = rte::sw_adjoint<false>(
        active, col, nlay, inc_g, active ? __ldg(alb_dir + gc) : 0.0f,
        active ? __ldg(alb_dif + gc) : 0.0f,
        active && incdif ? __ldg(incdif + gc) : 0.0f, gup + c, gdn + c,
        gdir + c, ncol, S, sink);
    if (active) {
        alb_dir_b[gc] = bb.alb_dir;
        alb_dif_b[gc] = bb.alb_dif;
        inc_b[gc] = bb.inc;
        if (incdif_b) incdif_b[gc] = bb.inc_dif;
    }
    rte::reduce_level(bb.mu_top, p_seed, 1, 0);

    // ---- sweep 7: per layer, the combine and cloud increment transposed,
    // the gas adjoint from one gather per table entry, and the layer's
    // per-cell sums ----
    float t_b = 0.0f, w0_b = 0.0f, asym_b = 0.0f;
    if (active) {
        t_b = T[0];
        w0_b = W[0];
        asym_b = G[0];
    }
    for (int l = 0; l < nlay; ++l) {
        const int cell = l * ncol + c;
        const CellDesc d = cells.at(cell);
        rte::GasTerms<NQ, 3, NS> v = {};
        float tb = 0.0f;
        if (active) {
            float t_bn = 0.0f, w0_bn = 0.0f, asym_bn = 0.0f;
            if (l + 1 < nlay) {
                t_bn = T[(l + 1) * ls];
                w0_bn = W[(l + 1) * ls];
                asym_bn = G[(l + 1) * ls];
            }
            const rte::GasLin<NS> gl = rte::gas_lin<false, true>(
                ga, d, d.lower ? flav_lo : flav_up, cell, g, sums.slots);
            const float rs = __ldg(rayscale + cell);
            const float ray = gl.kray * rs;
            const float t_gas = gl.tau + ray;
            Optics o = combine(t_gas, ray, cloud, crow + cell, cplane);
            CombineBars cb = combine_adjoint(t_gas, ray, o, cloud != nullptr,
                                             t_b, w0_b, asym_b);
            tb = cb.tau;
            rte::gas_terms(gl, tb, cb.ray * rs, &v);
            if (NQ == 3) {
                v.band[4] = cb.ct;
                v.band[5] = cb.cs;
                v.band[6] = cb.cg;
            }
            v.full[2] = cb.ray * gl.kray;
            t_b = t_bn;
            w0_b = w0_bn;
            asym_b = asym_bn;
        }
        sums.put(v, out, d.lower, cell, ncell, ga.nflav, nminor,
                 [&](int m, float (&w)[3]) {
                     if (active) rte::minor_terms(ga, d, m, cell, g, tb, w);
                 });
    }
    __syncthreads();
    for (int l = threadIdx.x; l < nlay; l += blockDim.x) {
        float s = rte::level_total(p_mu, nwarps, nlay, l);
        if (l == 0) s += rte::level_total(p_seed, nwarps, 1, 0);
        mu0_b[l * ncol + c] = s;
    }
}

// minor slots kept in registers: the flagship k-distribution's deepest
// overlap of minor windows (adjoint_segments.build_segments().nslot)
constexpr int kSlots = 3;

// Blocks of up to kBoundThreads threads (the flagship SW
// k-distribution's 224 g-points) get registers for kBlocksPerSM resident
// blocks per SM: measured on an H100, more resident warps hide the
// sweeps' and gathers' latency better than the few registers spilled to
// the L1-backed local memory cost. Wider k-distributions take a copy
// without that bound.
constexpr int kBoundThreads = 224, kBlocksPerSM = 4;

// the kernel for NQ by-band cloud inputs and a block of ``threads``
template <int NQ>
auto kernel_for(int threads) {
    return threads <= kBoundThreads
               ? fused_sw_bwd_kernel<NQ, kSlots, kBoundThreads, kBlocksPerSM>
               : fused_sw_bwd_kernel<NQ, kSlots, 1024, 1>;
}

// The launch configuration of fused_sw_bwd_kernel.
struct Config {
    int threads;
    size_t smem;
};

Config config(int ngpt, int nlay, int nminor, int nrb, int nrm,
              int csr_len) {
    int threads = (ngpt + 31) / 32 * 32;
    int nwarps = threads / 32;
    size_t floats = (size_t)nwarps * (nlay + 1)
                    + rte::CellSums<3, 3, kSlots>::part_floats(nrb, nrm,
                                                               nwarps);
    size_t ints = (size_t)nminor * rte::kMetaFields + csr_len;
    return Config{threads, (floats + ints) * 4};
}

}  // namespace

// Resident blocks per SM of the kernel at this configuration (with
// clouds), or a negative CUDA error.
extern "C" int occupancy_fused_sw_bwd(int ngpt, int nlay, int nminor,
                                      int nrb, int nrm, int csr_len) {
    Config k = config(ngpt, nlay, nminor, nrb, nrm, csr_len);
    auto kernel = kernel_for<3>(k.threads);
    cudaError_t err = rte::allow_smem(kernel, k.smem);
    int n = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, k.threads, k.smem);
    return err == cudaSuccess ? n : -(int)err;
}

extern "C" int launch_fused_sw_bwd(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* msc,
        const void* minor_meta, const void* kmajor, const void* klo,
        const void* kup, const void* krayl, const void* gflav,
        const void* gpt2band, const void* rayscale, const void* cloud,
        const void* mu0, const void* alb_dir, const void* alb_dif,
        const void* inc, const void* incdif, const void* gup,
        const void* gdn, const void* gdir, const void* seg, void* scratch,
        void* ftemp_b, void* fpress_b, void* feta_b, void* col_mix_b,
        void* msc_b, void* rayscale_b, void* cloud_b, void* mu0_b,
        void* alb_dir_b, void* alb_dif_b, void* inc_b, void* incdif_b,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int nbnd, int nrb, int nrm,
        int csr_len, void* stream) {
    if (ncol == 0) return 0;
    Config k = config(ngpt, nlay, nminor, nrb, nrm, csr_len);
    Cells cells{(const int*)jtemp, (const float*)ftemp, (const int*)jpress,
                (const float*)fpress, (const int*)tropo};
    rte::GasArgs ga{(const int*)jeta, (const float*)feta,
                    (const float*)col_mix, (const float*)msc,
                    (const float*)kmajor, nullptr, (const float*)klo,
                    (const float*)kup, (const float*)krayl, nullptr, nflav,
                    nlay * ncol, neta, npres1, ngpt, ncl, ncu};
    rte::GasBarsOut out{(float*)ftemp_b, (float*)fpress_b, (float*)feta_b,
                        (float*)col_mix_b, (float*)msc_b, (float*)rayscale_b,
                        (float*)cloud_b, cloud ? nbnd : 0};
    auto run = [&](auto kernel) -> int {
        cudaError_t err = rte::allow_smem(kernel, k.smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<ncol, k.threads, k.smem, (cudaStream_t)stream>>>(
            cells, ga, (const int*)minor_meta, (const int*)seg,
            (const int*)gflav, (const int*)gpt2band, (const float*)rayscale,
            (const float*)cloud, (const float*)mu0, (const float*)alb_dir,
            (const float*)alb_dif, (const float*)inc, (const float*)incdif,
            (const float*)gup, (const float*)gdn, (const float*)gdir,
            (float*)scratch, out, (float*)mu0_b, (float*)alb_dir_b,
            (float*)alb_dif_b, (float*)inc_b, (float*)incdif_b, ncol, nlay,
            nminor, csr_len);
        return (int)cudaGetLastError();
    };
    return run(cloud ? kernel_for<3>(k.threads)
                     : kernel_for<0>(k.threads));
}
