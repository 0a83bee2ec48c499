// Adjoint of the fused LW step (fused_lw.cu): gas optics + Planck
// sources + one-angle no-scattering transport + broadband sum, backward,
// one column per block, one thread per g-point.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/fused_lw_bwd.py::
// _lw_fused_bwd (pallas_call :506; derivation :7-36). Plain twin:
// torch.autograd.grad of rte_rrtmgp_tpu_torch/ops/kernels/fused_lw.py::
// lw_fused_plain (fused_lw.py::lw_fused_bwd_plain).
//
// What bounds it on this card: latency. The function moves 24 B per
// (column, layer, g-point); the adjoint is three dependent passes over
// each (column, g-point)'s 72 layers, L2 gathers and device-memory round
// trips at every layer, with 8 warps a block. Measured on an H100 at
// 4096 x 72 (copies cut after each pass, built and timed beside the
// whole kernel), the earlier design took 24.5 ms, 15.6 of them in
// per-cell sums over g-points, each output summed serially in
// g-point order, at 95 registers and 2 blocks per SM. This design:
//   * sums each cell's cotangents (ftemp, fpress, feta and col_mix per
//     flavor, the minor scalings, the cloud absorption by band) with
//     segmented warp scans of every thread's own terms and fixed lists
//     of runs (gas_optics_bwd.cuh::CellSums): one barrier per layer, no
//     atomics, the same bits on every run;
//   * runs the forward's gas optics inside the transport adjoint's down
//     pass, one layer ahead of it (a layer's sources need the Planck
//     fraction of the layer below), instead of a pass of their own;
//   * so gathers the gas optics twice per (cell, g-point): in the down
//     pass for the forward, and in the gas adjoint (gas_adjoint: each
//     table entry once, the cotangents of tau and of the Planck fraction
//     known by then), a third pass after the transport, so that its
//     barrier does not hold the transport's sweeps back;
//   * loads the next layer's scratch before it works on the current
//     one, and takes registers for 4 blocks per SM (kBlocksPerSM; 64
//     registers, 36-40 B of spill stores; measured 8.4 ms against 13.1
//     at 2 blocks per SM).
// Passes: down, the gas optics and the transport's down sweep; up, the
// up sweep and the transport adjoint, the cotangents of tau and of the
// Planck fraction (the layer source, the geometric-mean level sources of
// the two adjacent levels and, for the last layer, the surface source)
// replacing the kept radiances, and those of the temperatures through
// dB/dT = (hi - lo) / tp_delta, summed over the g-points per layer,
// level and column (warp shuffles, then a fixed-order sum of the warp
// partials); down again, the gas adjoint and the per-cell sums. Scratch:
// four float fields of (column, layer, g-point): tau and the Planck
// fraction, and the downward radiance and the up-sweep cotangent kept by
// the transport adjoint's down pass (fused_lw.py::
// lw_fused_bwd_scratch_bytes: 1.21 GB at 4096 x 72).
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

struct Planck {
    const float* __restrict__ tot;
    int ntot, nbnd, band;
    float tp_min, tp_delta;
    // the band's totplnk lerp at t (fused_lw.cu::planck_band) and its
    // derivative in t
    __device__ __forceinline__ void at(float t, float* b, float* db) const {
        float val0 = (t - tp_min) / tp_delta;
        float frac = val0 - truncf(val0);
        int idx = min(max((int)val0, 0), ntot - 2);
        float lo = __ldg(tot + idx * nbnd + band);
        float hi = __ldg(tot + (idx + 1) * nbnd + band);
        *b = lo + frac * (hi - lo);
        *db = (hi - lo) / tp_delta;
    }
    __device__ __forceinline__ float operator()(float t) const {
        float b, db;
        at(t, &b, &db);
        return b;
    }
};

__device__ __forceinline__ float geo_mean(float a, float b) {
    float p = a * b;
    return p > 0.0f ? sqrtf(p) : 0.0f;
}

// minor slots kept in registers: the flagship k-distribution's deepest
// overlap of minor windows (adjoint_segments.build_segments().nslot)
constexpr int kSlots = 2;

// One thread's layers. The down pass computes the gas optics (tau with
// the band's cloud absorption, and the Planck fraction) one layer ahead
// into TAU/PF; the up pass reads them back, one layer ahead. Both give
// layer l's optical depth along the ray and sources (the forward's pass
// 2 arithmetic); pf_c / pf_b hold the Planck fractions of the layer
// last given and of the one below it.
struct Col {
    float* TAU;
    float* PF;
    long long ls;
    const float* __restrict__ tlay;
    const float* __restrict__ tlev;
    const float* __restrict__ tsfc;
    int nlay, ncol, c, g;
    float ds;
    Planck pb;
    Cells cells;
    rte::GasArgs ga;
    rte::SlotList<kSlots> slots;
    int flav_lo, flav_up;
    const float* __restrict__ cloud;
    long long cloud_row;           // band * ncell
    float pf_a = 0.0f, pf_c = 0.0f, pf_b = 0.0f, tau_c = 0.0f;
    float pf_n = 0.0f, tau_n = 0.0f;

    __device__ __forceinline__ void gas(int l, float* tau, float* pf) {
        const int cell = l * ncol + c;
        const CellDesc d = cells.at(cell);
        const rte::GasLin<kSlots> gl = rte::gas_lin<true, false>(
            ga, d, d.lower ? flav_lo : flav_up, cell, g, slots);
        float t = gl.tau;
        if (cloud) t += __ldg(cloud + cloud_row + cell);
        TAU[l * ls] = t;
        PF[l * ls] = gl.pf;
        *tau = t;
        *pf = gl.pf;
    }

    __device__ __forceinline__ void terms(int l, float* tl, float* lay,
                                          float* top, float* bot) const {
        *tl = tau_c * ds;
        *lay = pf_c * pb(__ldg(tlay + l * ncol + c));
        *top = (l == 0 ? pf_c : geo_mean(pf_a, pf_c))
               * pb(__ldg(tlev + l * ncol + c));
        *bot = (l + 1 < nlay ? geo_mean(pf_c, pf_b) : pf_c)
               * pb(__ldg(tlev + (l + 1) * ncol + c));
    }

    __device__ __forceinline__ void down(int l, float* tl, float* lay,
                                         float* top, float* bot) {
        if (l == 0) {
            gas(0, &tau_c, &pf_c);
        } else {
            pf_a = pf_c;
            pf_c = pf_b;
            tau_c = tau_n;
        }
        if (l + 1 < nlay) gas(l + 1, &tau_n, &pf_b);
        terms(l, tl, lay, top, bot);
    }

    __device__ __forceinline__ float surface_source() const {
        return pf_c * pb(__ldg(tsfc + c));
    }

    __device__ __forceinline__ void up(int l, float* tl, float* lay,
                                       float* top, float* bot) {
        if (l == nlay - 1) {
            // pf_c is PF[nlay-1] and pf_a PF[nlay-2] from the down pass
            if (l > 0) tau_n = TAU[(l - 1) * ls];
            if (l > 1) pf_n = PF[(l - 2) * ls];
        } else {
            pf_b = pf_c;
            pf_c = pf_a;
            pf_a = pf_n;
            tau_c = tau_n;
            if (l > 0) tau_n = TAU[(l - 1) * ls];
            if (l > 1) pf_n = PF[(l - 2) * ls];
        }
        terms(l, tl, lay, top, bot);
    }
};

// Takes the transport's cotangents: the tau cotangent of each layer into
// TB and its Planck fraction's into PB, one layer behind, when the level
// below is complete (TB/PB are the transport's kept fields, whose layer
// has been read); the temperatures' into the warp partials.
struct Sink {
    bool active;
    const Col& col;
    float* TB;
    float* PB;
    int c;
    const float* __restrict__ tlay;
    const float* __restrict__ tlev;
    const float* __restrict__ tsfc;
    Planck pb;
    float* emis_b;
    float* inc_b;
    float* p_tlay;          // (nwarps, nlay)
    float* p_tlev;          // (nwarps, nlay+1)
    float* p_tsfc;          // (nwarps, 1)
    float pfb_next = 0.0f;  // Planck-fraction cotangent of the layer below
    float levt_next = 0.0f; // top-level source cotangent of the layer below
    float pfb_sfc = 0.0f;   // the surface source's share of the last layer's

    __device__ __forceinline__ void surface(float e_b, float s_b) {
        float part = 0.0f;
        if (active) {
            *emis_b = e_b;
            float b, db;
            pb.at(__ldg(tsfc + c), &b, &db);
            pfb_sfc = s_b * b;
            part = s_b * col.pf_c * db;
        }
        rte::reduce_level(part, p_tsfc, 1, 0);
    }

    __device__ __forceinline__ void layer(int l, const rte::LwBars& bars) {
        const int nlay = col.nlay, ncol = col.ncol;
        const long long ls = col.ls;
        float part_lay = 0.0f, part_lev = 0.0f;
        if (active) {
            TB[l * ls] = bars.tl * col.ds;
            float pf = col.pf_c;
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
                float pf_dn = col.pf_b;
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

    __device__ __forceinline__ void top(float ib) {
        float part = 0.0f;
        if (active) {
            *inc_b = ib;
            float b, db;
            pb.at(__ldg(tlev + c), &b, &db);
            pfb_next += levt_next * b;
            PB[0] = pfb_next;
            part = levt_next * col.pf_c * db;
        }
        rte::reduce_level(part, p_tlev, col.nlay + 1, 0);
    }
};

template <int NQ, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) fused_lw_bwd_kernel(
        Cells cells, rte::GasArgs gas, const int* __restrict__ minor_meta,
        const int* __restrict__ seg, const int* __restrict__ gflav,
        const int* __restrict__ gpt2band, const float* __restrict__ totplnk,
        const float* __restrict__ tlay, const float* __restrict__ tlev,
        const float* __restrict__ tsfc, const float* __restrict__ emis,
        const float* __restrict__ inc, const float* __restrict__ cloud,
        const float* __restrict__ gup, const float* __restrict__ gdn,
        float* scratch, rte::GasBarsOut out, float* tlay_b, float* tlev_b,
        float* tsfc_b, float* emis_b, float* inc_b, int ncol, int nlay,
        int nminor, int csr_len, int ntot, int nbnd, float tp_min,
        float tp_delta, float ds, float piw) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    const int ngpt = gas.ngpt;
    float* p_tlay = smem;                          // (nwarps, nlay)
    float* p_tlev = p_tlay + nwarps * nlay;        // (nwarps, nlev)
    float* p_tsfc = p_tlev + nwarps * nlev;        // (nwarps, 1)
    int* meta = (int*)(p_tsfc + nwarps);           // (nminor, kMetaFields)
    int* csr = meta + nminor * rte::kMetaFields;
    float* part = (float*)(csr + csr_len);
    for (int i = threadIdx.x; i < nminor * rte::kMetaFields; i += blockDim.x)
        meta[i] = minor_meta[i];
    rte::CellSums<NQ, 2, kSlots> sums;
    sums.init(seg, csr, part);
    rte::GasArgs ga = gas;
    ga.meta = meta;
    __syncthreads();

    const int c = blockIdx.x;
    const bool active = threadIdx.x < ngpt;
    const int g = active ? threadIdx.x : 0;
    const int ncell = nlay * ncol;
    const long long plane = (long long)ncol * nlay * ngpt;
    const long long ls = ngpt;
    float* TAU = scratch + (long long)c * nlay * ngpt + g;
    float* PF = TAU + plane;
    float* RDN = PF + plane;       // the transport adjoint's kept radiances
    float* RR = RDN + plane;       // and up-sweep cotangents
    const int band = __ldg(gpt2band + g);
    const Planck pb{totplnk, ntot, nbnd, band, tp_min, tp_delta};

    const int flav_lo = __ldg(gflav + g), flav_up = __ldg(gflav + ngpt + g);
    Col col{TAU, PF, ls, tlay, tlev, tsfc, nlay, ncol, c, g, ds, pb, cells,
            ga, sums.slots, flav_lo, flav_up, cloud, (long long)band * ncell};
    const long long gc = (long long)g * ncol + c;
    Sink sink{active, col, RDN, RR, c, tlay, tlev, tsfc, pb, emis_b + gc,
              inc_b + gc, p_tlay, p_tlev, p_tsfc};
    rte::lw_adjoint(active, col, nlay, piw, active ? __ldg(inc + gc) : 0.0f,
                    active ? __ldg(emis + gc) : 0.0f, gup + c, gdn + c, ncol,
                    RDN, RR, ls, sink);

    // ---- per layer, the gas adjoint from one gather per table entry for
    // the cotangents of tau and of the Planck fraction, and the layer's
    // per-cell sums ----
    const float* TB = RDN;
    const float* PB = RR;
    float tb_n = active ? TB[0] : 0.0f, pb_n = active ? PB[0] : 0.0f;
    for (int l = 0; l < nlay; ++l) {
        const int cell = l * ncol + c;
        const CellDesc d = cells.at(cell);
        const float tb = tb_n, pbar = pb_n;
        rte::GasTerms<NQ, 2, kSlots> v = {};
        if (active) {
            if (l + 1 < nlay) {
                tb_n = TB[(l + 1) * ls];
                pb_n = PB[(l + 1) * ls];
            }
            rte::gas_adjoint<true, false>(ga, d, d.lower ? flav_lo : flav_up,
                                          cell, g, sums.slots, tb, pbar, 0.0f,
                                          &v);
            if (NQ == 1) v.band[4] = tb;
        }
        sums.put(v, out, d.lower, cell, ncell, ga.nflav, nminor,
                 [&](int m, float (&w)[3]) {
                     if (active) rte::minor_terms(ga, d, m, cell, g, tb, w);
                 });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nlev; i += blockDim.x) {
        if (i < nlay)
            tlay_b[i * ncol + c] = rte::level_total(p_tlay, nwarps, nlay, i);
        tlev_b[i * ncol + c] = rte::level_total(p_tlev, nwarps, nlev, i);
    }
    if (threadIdx.x == 0) tsfc_b[c] = rte::level_total(p_tsfc, nwarps, 1, 0);
}

// Blocks of up to kBoundThreads threads (the flagship LW
// k-distribution's 256 g-points) get registers for kBlocksPerSM resident
// blocks per SM: measured on an H100, more resident warps hide the
// sweeps' and gathers' latency better than the few registers spilled to
// the L1-backed local memory cost. Wider k-distributions take a copy
// without that bound.
constexpr int kBoundThreads = 256, kBlocksPerSM = 4;

// the kernel for NQ by-band cloud inputs and a block of ``threads``
template <int NQ>
auto kernel_for(int threads) {
    return threads <= kBoundThreads
               ? fused_lw_bwd_kernel<NQ, kBoundThreads, kBlocksPerSM>
               : fused_lw_bwd_kernel<NQ, 1024, 1>;
}

// The launch configuration of fused_lw_bwd_kernel.
struct Config {
    int threads;
    size_t smem;
};

Config config(int ngpt, int nlay, int nminor, int nrb, int nrm,
              int csr_len) {
    int threads = (ngpt + 31) / 32 * 32;
    int nwarps = threads / 32;
    size_t floats = (size_t)nwarps * (2 * nlay + 2)
                    + rte::CellSums<1, 2, kSlots>::part_floats(nrb, nrm,
                                                               nwarps);
    size_t ints = (size_t)nminor * rte::kMetaFields + csr_len;
    return Config{threads, (floats + ints) * 4};
}

}  // namespace

// Resident blocks per SM of the kernel at this configuration (with
// clouds), or a negative CUDA error.
extern "C" int occupancy_fused_lw_bwd(int ngpt, int nlay, int nminor,
                                      int nrb, int nrm, int csr_len) {
    Config k = config(ngpt, nlay, nminor, nrb, nrm, csr_len);
    auto kernel = kernel_for<1>(k.threads);
    cudaError_t err = rte::allow_smem(kernel, k.smem);
    int n = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, k.threads, k.smem);
    return err == cudaSuccess ? n : -(int)err;
}

extern "C" int launch_fused_lw_bwd(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* msc,
        const void* minor_meta, const void* kmajor, const void* pfrac_tab,
        const void* klo, const void* kup, const void* gflav,
        const void* gpt2band, const void* totplnk, const void* tlay,
        const void* tlev, const void* tsfc, const void* emis,
        const void* inc, const void* cloud, const void* gup,
        const void* gdn, const void* seg, void* scratch, void* ftemp_b,
        void* fpress_b, void* feta_b, void* col_mix_b, void* msc_b,
        void* cloud_b, void* tlay_b, void* tlev_b, void* tsfc_b,
        void* emis_b, void* inc_b, int ncol, int nlay, int ngpt, int neta,
        int npres1, int nflav, int nminor, int ncl, int ncu, int ntot,
        int nbnd, float tp_min, float tp_delta, float ds, float piw,
        int nrb, int nrm, int csr_len, void* stream) {
    if (ncol == 0) return 0;
    Config k = config(ngpt, nlay, nminor, nrb, nrm, csr_len);
    Cells cells{(const int*)jtemp, (const float*)ftemp, (const int*)jpress,
                (const float*)fpress, (const int*)tropo};
    rte::GasArgs ga{(const int*)jeta, (const float*)feta,
                    (const float*)col_mix, (const float*)msc,
                    (const float*)kmajor, (const float*)pfrac_tab,
                    (const float*)klo, (const float*)kup, nullptr, nullptr,
                    nflav, nlay * ncol, neta, npres1, ngpt, ncl, ncu};
    rte::GasBarsOut out{(float*)ftemp_b, (float*)fpress_b, (float*)feta_b,
                        (float*)col_mix_b, (float*)msc_b, nullptr,
                        (float*)cloud_b, cloud ? nbnd : 0};
    auto run = [&](auto kernel) -> int {
        cudaError_t err = rte::allow_smem(kernel, k.smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<ncol, k.threads, k.smem, (cudaStream_t)stream>>>(
            cells, ga, (const int*)minor_meta, (const int*)seg,
            (const int*)gflav, (const int*)gpt2band, (const float*)totplnk,
            (const float*)tlay, (const float*)tlev, (const float*)tsfc,
            (const float*)emis, (const float*)inc, (const float*)cloud,
            (const float*)gup, (const float*)gdn, (float*)scratch, out,
            (float*)tlay_b, (float*)tlev_b, (float*)tsfc_b, (float*)emis_b,
            (float*)inc_b, ncol, nlay, nminor, csr_len, ntot, nbnd, tp_min,
            tp_delta, ds, piw);
        return (int)cudaGetLastError();
    };
    return run(cloud ? kernel_for<1>(k.threads)
                     : kernel_for<0>(k.threads));
}
