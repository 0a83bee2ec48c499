// The fused LW step: RRTMGP gas optics + Planck sources + one-angle
// no-scattering transport + broadband sums.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/fused_lw.py::
// lw_fused_gas_optics_solve (_fused_lw_kernel, with fused_minors.minor_pass
// and planck_band_pair). Plain twin:
// rte_rrtmgp_tpu_torch/ops/kernels/fused_lw.py::lw_fused_plain.
//
// Layout: a column's g-points are cut into chunks of ``chunk`` (a
// multiple of 32, at most 8 chunks: ops/kernels/onchip.py::
// onchip_geometry); one block of kThreads threads per chunk, and the
// column's chunks are one thread-block cluster. The chunk's layer fields
// live in shared memory, no device-memory scratch:
//   pass 1, every thread, kThreads / chunk layers at a time (thread
//   lane + chunk * k takes g-point g0 + lane and the layers k, k + K, ...):
//   per (layer, g-point) the 8-corner major tau and Planck fraction
//   (major_tau_pf), the minor gases whose window holds the
//   g-point (common.cuh::minor_tau_lane, a minor's reads skipped where its
//   scaling is 0) and the cloud absorption of its band;
//   pass 2, every thread: per level the Planck level source from the
//   totplnk lerp and the geometric mean of the two adjacent layers'
//   Planck fractions (and the surface source), then per layer the layer
//   source, the transmittance and the linear-in-tau sources
//   (transport.cuh::lw_source); the column's temperatures are staged in
//   shared memory as totplnk positions before pass 1, so that pass 2
//   reads no device memory but the small totplnk table;
//   then the chunk's first ``chunk`` threads, one per g-point, sweep: down
//   from the incident flux inc (g-point, column), the surface emission
//   and reflection, and up; each level's flux written in place;
//   then every thread again: the chunk's sums of each level
//   (transport.cuh::ClusterSums::reduce), and the cluster's.
//
// What bounds it on this card: the table gathers of pass 1 (8 corners
// per cell and g-point from kmajor and planck_frac, interleaved as one
// table of pairs built once per k-distribution and resident in the 50 MB
// L2, and the minors'), about two thirds of its time at 4096 x 72, which
// need many warps in flight: registers for 5 blocks per SM broadband;
// then the sources and the cluster's sums (PERF.md). Kept in device
// memory, the layer fields made each layer of the serial sweeps wait a
// memory round trip and cost 0.6 GB of scratch at 4096 x 72; here pass 1
// and pass 2 run kThreads threads per block over the layers, and the
// sweeps read shared memory: 16 B x nlay x chunk and 8 B x nlay per
// block.
//
// Sums: per level, broadband the warp-shuffle sum of each 32 g-points, by
// band each band's g-points of the chunk in ascending order (gpt2band, so
// ragged bands work), then summed over the cluster's shared memory in
// rank order (transport.cuh::ClusterSums), times pi * weight.
// Deterministic, no atomics. Broadband with 32-wide chunks this is the
// warp order of one block that held the whole column; by band, for a
// band inside one chunk, the ascending order of its g-points. With
// band_up/band_dn the kernel gives per-band sums (band, level, column)
// instead of the broadband (level, column).
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; descriptors layer-major (nlay, ncol).

#include <cfloat>
#include <cmath>

#include "common.cuh"
#include "transport.cuh"

namespace {

using rte::CellDesc;

constexpr int kThreads = 256;   // per block: chunk g-points x layer lanes
// registers for 5 blocks per SM broadband (39 KB of shared memory each at
// 72 layers), 4 by band (48 KB: the band sums)
constexpr int kBlocksBroadband = 5;
constexpr int kBlocksByBand = 4;
constexpr int kFields = 2;      // up, dn

// common.cuh::major_tau with the Planck fraction, from kmajor and
// planck_frac interleaved as one table kp (ntemp, neta, npres+1, ngpt) of
// (k, pfrac) pairs: one 8-byte gather per corner instead of two 4-byte
// ones, the same arithmetic in the same order.
__device__ __forceinline__ void major_tau_pf(
        const CellDesc& d, int flav, int nflav, int ncell, int cell,
        const int* __restrict__ jeta, const float* __restrict__ feta,
        const float* __restrict__ col_mix, const float2* __restrict__ kp,
        int neta, int npres1, int ngpt, int g, float* tau, float* pf) {
    float t = 0.0f, p = 0.0f;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * nflav + flav) * ncell + cell;
        int je = jeta[fi];
        float fe = feta[fi];
        float cm = col_mix[fi];
        float ftv = it == 0 ? 1.0f - d.ft : d.ft;
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
            float fpv = dp == 0 ? 1.0f - d.fp : d.fp;
#pragma unroll
            for (int de = 0; de < 2; ++de) {
                float fev = de == 0 ? 1.0f - fe : fe;
                float wgt = (fev * ftv) * fpv;
                long long k = ((long long)(((d.jt + it) * neta + je + de)
                                           * npres1 + d.jp + dp)) * ngpt + g;
                float2 v = __ldg(kp + k);
                t += (wgt * cm) * v.x;
                p += wgt * v.y;
            }
        }
    }
    *tau = t;
    *pf = p;
}

// Band b's totplnk lerp at the table position val0 = (t - tp_min) /
// tp_delta of temperature t (reference interpolate1D: the fraction from
// the unclipped position).
__device__ __forceinline__ float planck_band(float val0, const float* tot,
                                             int ntot, int nbnd, int b) {
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

template <bool BYBAND>
__global__ void __launch_bounds__(kThreads,
                                  BYBAND ? kBlocksByBand : kBlocksBroadband)
fused_lw_kernel(
        const int* __restrict__ jtemp, const float* __restrict__ ftemp,
        const int* __restrict__ jpress, const float* __restrict__ fpress,
        const int* __restrict__ tropo, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ col_mix,
        const float* __restrict__ msc, const int* __restrict__ minor_meta,
        const float2* __restrict__ kp,
        const float* __restrict__ klo, const float* __restrict__ kup,
        const int* __restrict__ gflav, const int* __restrict__ gpt2band,
        const float* __restrict__ totplnk, const float* __restrict__ tlay,
        const float* __restrict__ tlev, const float* __restrict__ tsfc,
        const float* __restrict__ emis, const float* __restrict__ inc,
        const float* __restrict__ cloud, float* __restrict__ up,
        float* __restrict__ dn, float* __restrict__ band_up,
        float* __restrict__ band_dn, int ncol, int nlay, int ngpt, int neta,
        int npres1, int nflav, int nminor, int ncl, int ncu, int ntot,
        int nbnd, float tp_min, float tp_delta, float ds, float piw,
        int chunk) {
    extern __shared__ float smem[];
    namespace cg = cooperative_groups;
    const int nlev = nlay + 1;
    const int nchunk = (int)cg::this_cluster().num_blocks();
    const int rank = (int)cg::this_cluster().block_rank();
    const int c = blockIdx.x / nchunk;
    const size_t lay_n = (size_t)nlay * chunk;
    float* tr_s = smem;                 // (nlay, chunk): tau, then trans
    float* sd_s = tr_s + lay_n;         // Planck fraction, sdn, dn flux
    float* su_s = sd_s + lay_n;         // (nlay, chunk): sup
    float* lv_s = su_s + lay_n;         // (nlev, chunk): source, up flux
    float* top_s = lv_s + (size_t)nlev * chunk;   // (2, chunk)
    // the column's totplnk positions: levels, layers, the surface
    float* pos_s = top_s + 2 * chunk;             // (nlev + nlay + 1)
    const int nwords = (nminor + 31) / 32;
    // (nwords, chunk)
    unsigned* mwords = (unsigned*)(pos_s + nlev + nlay + 1);
    int* meta = (int*)(mwords + nwords * chunk);
    constexpr bool byband = BYBAND;
    rte::ClusterSums sums;
    sums.init((float*)(meta + nminor * rte::kMetaFields), kFields, chunk, nlev,
              byband ? nbnd : 0, gpt2band, rank * chunk, ngpt);
    const int lane = threadIdx.x % chunk;
    const int g = rank * chunk + lane;
    const bool active = g < ngpt;
    for (int i = threadIdx.x; i < nminor * rte::kMetaFields; i += kThreads)
        meta[i] = minor_meta[i];
    for (int i = threadIdx.x; i <= nlev + nlay; i += kThreads) {
        float t = i < nlev ? tlev[i * ncol + c]
                : i < nlev + nlay ? tlay[(i - nlev) * ncol + c] : tsfc[c];
        pos_s[i] = (t - tp_min) / tp_delta;
    }
    // the minors whose g-point window holds the lane's g-point
    for (int w = threadIdx.x / chunk; w < nwords; w += kThreads / chunk)
        mwords[w * chunk + lane] = rte::minor_word(minor_meta, nminor, w, g);
    __syncthreads();

    const int ncell = nlay * ncol;
    const int band = active ? gpt2band[g] : 0;
    const int flav_lo = active ? gflav[g] : 0;
    const int flav_up = active ? gflav[ngpt + g] : 0;
    const int k0 = threadIdx.x / chunk, kstep = kThreads / chunk;

    // ---- pass 1: gas optics, layers in parallel ----
    for (int l = k0; active && l < nlay; l += kstep) {
        int cell = l * ncol + c;
        CellDesc d = rte::load_cell(jtemp, ftemp, jpress, fpress, tropo, cell);
        int flav = d.lower ? flav_lo : flav_up;
        float tau, pf;
        major_tau_pf(d, flav, nflav, ncell, cell, jeta, feta, col_mix, kp,
                     neta, npres1, ngpt, g, &tau, &pf);
        tau = rte::minor_tau_lane(tau, d, meta, mwords + lane, nwords, chunk,
                                  nflav, ncell, cell, jeta, feta, msc, klo,
                                  kup, ncl, ncu, neta, g);
        if (cloud) tau += cloud[(long long)band * ncell + cell];
        tr_s[l * chunk + lane] = tau;
        sd_s[l * chunk + lane] = pf;
    }
    __syncthreads();

    // ---- pass 2a: the level sources (reference :51-240); the top level
    // takes the top layer's Planck fraction, the bottom level and the
    // surface the bottom layer's, the others the geometric mean of the
    // two layers' ----
    for (int lv = k0; active && lv <= nlay; lv += kstep) {
        float pf_a = lv > 0 ? sd_s[(lv - 1) * chunk + lane] : 0.0f;
        float pf_b = lv < nlay ? sd_s[lv * chunk + lane] : 0.0f;
        float pf = lv == 0 ? pf_b : lv == nlay ? pf_a : geo_mean(pf_a, pf_b);
        lv_s[lv * chunk + lane] = pf * planck_band(pos_s[lv], totplnk, ntot,
                                                   nbnd, band);
        if (lv == nlay)
            top_s[chunk + lane] = pf_a * planck_band(
                pos_s[nlev + nlay], totplnk, ntot, nbnd, band);
    }
    __syncthreads();

    // ---- pass 2b: per layer the transmittance and linear-in-tau sources
    // (reference :620-745), in place of tau and the Planck fraction ----
    for (int l = k0; active && l < nlay; l += kstep) {
        const int o = l * chunk + lane;
        float lay = sd_s[o] * planck_band(pos_s[nlev + l], totplnk, ntot,
                                          nbnd, band);
        float trans, sdn, sup;
        rte::lw_source(tr_s[o] * ds, lay, lv_s[o], lv_s[o + chunk], &trans,
                       &sdn, &sup);
        tr_s[o] = trans;
        sd_s[o] = sdn;
        su_s[o] = sup;
    }
    __syncthreads();

    // ---- the sweeps: the chunk's first ``chunk`` threads; each layer's
    // values loaded one layer ahead of their use. Down: level l + 1's
    // flux in place of layer l's sdn; then the surface; up: level l's
    // flux in place of its source ----
    if (threadIdx.x < chunk) {
        float rdn = active ? inc[(long long)g * ncol + c] / piw : 0.0f;
        top_s[lane] = rdn;
        float t = tr_s[lane], s = sd_s[lane];
        for (int l = 0; l < nlay; ++l) {
            const int nx = (l + 1 < nlay ? l + 1 : l) * chunk + lane;
            float tn = tr_s[nx], sn = sd_s[nx];
            if (active) rdn = t * rdn + s;
            sd_s[l * chunk + lane] = rdn;
            t = tn;
            s = sn;
        }
        float rup = 0.0f;
        if (active) {
            float e = emis[(long long)g * ncol + c];
            rup = rdn * (1.0f - e) + e * top_s[chunk + lane];
        }
        lv_s[nlay * chunk + lane] = rup;
        t = tr_s[(nlay - 1) * chunk + lane];
        s = su_s[(nlay - 1) * chunk + lane];
        for (int l = nlay - 1; l >= 0; --l) {
            const int nx = (l > 0 ? l - 1 : 0) * chunk + lane;
            float tn = tr_s[nx], sn = su_s[nx];
            if (active) rup = t * rup + s;
            lv_s[l * chunk + lane] = rup;
            t = tn;
            s = sn;
        }
    }
    __syncthreads();

    // ---- the column's sums: the chunk's, then the cluster's ----
    sums.reduce([&](int f, int lv, int i) {
        if (f == 0) return lv_s[lv * chunk + i];
        return lv == 0 ? top_s[i] : sd_s[(lv - 1) * chunk + i];
    });
    const long long bs = (long long)nlev * ncol;
    sums.finalize([&](int i, auto total) {
        if (byband) {
            int b = i / nlev, lv = i - b * nlev;
            long long ob = (long long)b * bs + (long long)lv * ncol + c;
            band_up[ob] = total(0) * piw;
            band_dn[ob] = total(1) * piw;
        } else {
            up[(long long)i * ncol + c] = piw * total(0);
            dn[(long long)i * ncol + c] = piw * total(1);
        }
    });
}

size_t smem_bytes(int nlay, int chunk, int nminor, int nband) {
    return (size_t)(3 * nlay + (nlay + 1) + 2) * chunk * sizeof(float)
        + (size_t)(2 * nlay + 2) * sizeof(float)
        + (size_t)(nminor + 31) / 32 * chunk * sizeof(unsigned)
        + (size_t)nminor * rte::kMetaFields * sizeof(int)
        + rte::ClusterSums::bytes(kFields, chunk, nlay + 1, nband);
}

}  // namespace

// Shared memory of one block at (nlay, chunk, nminor, nband; 0 for
// broadband), the bytes ops/kernels/onchip.py::onchip_geometry counts.
extern "C" int smem_fused_lw(int nlay, int chunk, int nminor, int nband) {
    return (int)smem_bytes(nlay, chunk, nminor, nband);
}

// Resident blocks per SM * 65536 + clusters the card holds at once, or a
// negative CUDA error (transport.cuh::cluster_occupancy), of the
// instantiation that nband (0: broadband) takes.
extern "C" int occupancy_fused_lw(int nlay, int chunk, int nchunk,
                                  int nminor, int nband) {
    const size_t smem = smem_bytes(nlay, chunk, nminor, nband);
    return nband > 0
        ? rte::cluster_occupancy(fused_lw_kernel<true>, nchunk, kThreads, smem)
        : rte::cluster_occupancy(fused_lw_kernel<false>, nchunk, kThreads,
                                 smem);
}

// kp: kmajor and planck_frac interleaved, (ntemp, neta, npres+1, ngpt, 2).
extern "C" int launch_fused_lw(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* msc,
        const void* minor_meta, const void* kp, const void* klo,
        const void* kup, const void* gflav, const void* gpt2band,
        const void* totplnk, const void* tlay, const void* tlev,
        const void* tsfc, const void* emis, const void* inc,
        const void* cloud, void* up, void* dn, void* band_up, void* band_dn,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int ntot, int nbnd, float tp_min,
        float tp_delta, float ds, float piw, int chunk, void* stream) {
    if (ncol == 0) return 0;
    const int nchunk = (ngpt + chunk - 1) / chunk;
    auto go = [&](auto kernel, int nband) {
        return (int)rte::launch_clusters(
            kernel, ncol, nchunk, kThreads,
            smem_bytes(nlay, chunk, nminor, nband), (cudaStream_t)stream,
            (const int*)jtemp, (const float*)ftemp, (const int*)jpress,
            (const float*)fpress, (const int*)tropo, (const int*)jeta,
            (const float*)feta, (const float*)col_mix, (const float*)msc,
            (const int*)minor_meta, (const float2*)kp, (const float*)klo,
            (const float*)kup, (const int*)gflav, (const int*)gpt2band,
            (const float*)totplnk, (const float*)tlay, (const float*)tlev,
            (const float*)tsfc, (const float*)emis, (const float*)inc,
            (const float*)cloud, (float*)up, (float*)dn, (float*)band_up,
            (float*)band_dn, ncol, nlay, ngpt, neta, npres1, nflav, nminor,
            ncl, ncu, ntot, nbnd, tp_min, tp_delta, ds, piw, chunk);
    };
    return band_up ? go(fused_lw_kernel<true>, nbnd)
                   : go(fused_lw_kernel<false>, 0);
}
