// The fused SW step: RRTMGP gas optics + Rayleigh + by-band cloud
// increment + Meador-Weaver two-stream + Shonk-Hogan adding + broadband
// sums.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/fused_sw.py::
// sw_fused_gas_optics_solve (_fused_sw_kernel, _combine_gas_cloud,
// fused_minors.minor_pass and solver_lanes._sw_body_lm). Plain twin:
// rte_rrtmgp_tpu_torch/ops/kernels/fused_sw.py::sw_fused_plain.
//
// Layout: a column's g-points are cut into chunks of ``chunk`` (a
// multiple of 32, at most 8 chunks: ops/kernels/onchip.py::
// onchip_geometry); one block of kThreads threads per chunk, and the
// column's chunks are one thread-block cluster. The chunk's layer fields
// live in shared memory, no device-memory scratch:
//   pass 1, every thread, kThreads / chunk layers at a time (thread
//   lane + chunk * k takes g-point g0 + lane and the layers k, k + K, ...):
//   per (layer, g-point) the major and minor absorption, Rayleigh, the
//   absorption/Rayleigh combine and the cloud 2-stream increment, and the
//   two-stream coefficients with the reference's clamps and min_mu0
//   (rdif, tdif, rdir and tdir zeroed at night, tns);
//   then the chunk's first ``chunk`` threads, one per g-point, sweep:
//   the direct beam top down (source_dn = tdir * dir, source_up = rdir *
//   dir; each level's beam in place of tns), the adding build bottom up
//   (transport.cuh::adding_up, its four values per layer written in
//   place), the diffuse fluxes top down from the diffuse incident flux
//   incdif (g-point, column; zero when null) (transport.cuh::adding_down),
//   each level's fluxes written in place;
//   then every thread again: the chunk's sums of each level
//   (transport.cuh::ClusterSums::reduce), and the cluster's.
//
// What bounds it on this card: the table gathers (8 kmajor and 4 krayl
// reads per cell and g-point, tables resident in L2), which need many
// warps in flight, and the latency of the three dependent sweeps. Kept in
// device memory, the layer fields (six per column, level and g-point)
// make each layer of the adding build wait a memory round trip: most of
// the step's time on an H100 (PERF.md). Here pass 1 runs kThreads threads
// per block over the layers, and the sweeps read shared memory: 20 B x
// nlay x chunk per block.
//
// Sums: per level, broadband the warp-shuffle sum of each 32 g-points, by
// band each band's g-points of the chunk in ascending order (gpt2band, so
// ragged bands work), then summed over the cluster's shared memory in
// rank order (transport.cuh::ClusterSums). Deterministic, no atomics.
// With band_out the kernel gives per-band sums (3, band, level, column)
// instead of the broadband (3, level, column).
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
constexpr int kBlocksPerSM = 4;
constexpr int kFields = 3;      // up, dn (diffuse), dir

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) fused_sw_kernel(
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
        const float* __restrict__ incdif, float* __restrict__ out,
        float* __restrict__ band_out, int ncol, int nlay, int ngpt, int neta,
        int npres1, int nflav, int nminor, int ncl, int ncu, int nbnd,
        int nband, int chunk) {
    extern __shared__ float4 coef[];          // (nlay, chunk)
    namespace cg = cooperative_groups;
    const int nlev = nlay + 1;
    const int nchunk = (int)cg::this_cluster().num_blocks();
    const int rank = (int)cg::this_cluster().block_rank();
    const int c = blockIdx.x / nchunk;
    float* tns_s = (float*)(coef + (size_t)nlay * chunk);   // (nlay, chunk)
    float* top_s = tns_s + (size_t)nlay * chunk;            // (3, chunk)
    const int nwords = (nminor + 31) / 32;
    unsigned* mwords = (unsigned*)(top_s + kFields * chunk);  // (nwords, chunk)
    int* meta = (int*)(mwords + nwords * chunk);
    const bool byband = band_out != nullptr;
    rte::ClusterSums sums;
    sums.init((float*)(meta + nminor * rte::kMetaFields), kFields, chunk, nlev,
              byband ? nband : 0, gpt2band, rank * chunk, ngpt);
    const int lane = threadIdx.x % chunk;
    const int g = rank * chunk + lane;
    const bool active = g < ngpt;
    for (int i = threadIdx.x; i < nminor * rte::kMetaFields; i += kThreads)
        meta[i] = minor_meta[i];
    // the minors whose g-point window holds the lane's g-point
    for (int w = threadIdx.x / chunk; w < nwords; w += kThreads / chunk)
        mwords[w * chunk + lane] = rte::minor_word(minor_meta, nminor, w, g);
    __syncthreads();

    const int ncell = nlay * ncol;
    const int band = active ? gpt2band[g] : 0;
    const int flav_lo = active ? gflav[g] : 0;
    const int flav_up = active ? gflav[ngpt + g] : 0;
    const float tiny = FLT_MIN;

    // ---- pass 1: optics and two-stream coefficients, layers in parallel
    for (int l = threadIdx.x / chunk; active && l < nlay;
         l += kThreads / chunk) {
        int cell = l * ncol + c;
        CellDesc d = rte::load_cell(jtemp, ftemp, jpress, fpress, tropo, cell);
        int flav = d.lower ? flav_lo : flav_up;
        float tau, unused;
        rte::major_tau(d, flav, nflav, ncell, cell, jeta, feta, col_mix,
                       kmajor, nullptr, neta, npres1, ngpt, g, &tau, &unused);
        tau = rte::minor_tau_lane(tau, d, meta, mwords + lane, nwords,
                                  chunk, nflav, ncell, cell, jeta, feta, msc,
                                  klo, kup, ncl, ncu, neta, g);
        float ray = rte::rayleigh_k(d, flav, nflav, ncell, cell, jeta, feta,
                                    krayl, neta, ngpt, g)
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
            float cg_ = cloud[2 * cplane + bc];
            float t12 = t + ct;
            float tauscat = t * w0 + ct * cs;
            float g12 = (ct * cs * cg_) / fmaxf(tauscat, tiny);
            asym = tauscat > 2.0f * tiny ? g12 : 0.0f;
            w0 = t12 > 2.0f * tiny ? tauscat / fmaxf(t12, tiny) : w0;
            t = t12;
        }
        // Meador-Weaver / PIFM coefficients (reference :985-1127); at
        // night the direct sources are 0 (rdir, tdir zeroed)
        float mu = mu0[cell];
        rte::SwLayer s = rte::sw_layer(t, w0, asym, mu);
        bool day = mu > 0.0f;
        coef[l * chunk + lane] = make_float4(s.rdif, s.tdif,
                                             day ? s.rdir : 0.0f,
                                             day ? s.tdir : 0.0f);
        tns_s[l * chunk + lane] = s.tns;
    }
    __syncthreads();

    // ---- the sweeps: the chunk's first ``chunk`` threads ----
    if (threadIdx.x < chunk) {
        float4* k = coef + lane;
        float* tn = tns_s + lane;
        // direct beam, top down: coef becomes (rdif, tdif, sdn, sup), tns
        // the beam at the layer's bottom
        float dir = active ? inc[(long long)g * ncol + c] * mu0[c] : 0.0f;
        top_s[2 * chunk + lane] = dir;
        float4 q = k[0];
        float tq = tn[0];
        for (int l = 0; l < nlay; ++l) {
            int nx = (l + 1 < nlay ? l + 1 : l) * chunk;
            float4 qn = k[nx];
            float tqn = tn[nx];
            if (active) {
                k[l * chunk] = make_float4(q.x, q.y, q.w * dir, q.z * dir);
                dir = dir * tq;
            }
            tn[l * chunk] = dir;
            q = qn;
            tq = tqn;
        }
        // adding build, bottom up, in place (Eqs 9-13)
        float alb = 0.0f, src = 0.0f, top = 0.0f;
        if (active) {
            alb = alb_dif[(long long)g * ncol + c];
            src = mu0[(nlay - 1) * ncol + c] > 0.0f
                ? dir * alb_dir[(long long)g * ncol + c] : 0.0f;
            top = incdif ? incdif[(long long)g * ncol + c] : 0.0f;
        }
        q = k[(nlay - 1) * chunk];
        for (int v = nlay - 1; v >= 0; --v) {
            float4 qn = k[(v > 0 ? v - 1 : 0) * chunk];
            k[v * chunk] = rte::adding_up(q.x, q.y, q.z, q.w, alb, src);
            q = qn;
        }
        // diffuse fluxes, top down; level v + 1's in place of layer v's
        // values
        rte::adding_down(active, k, chunk, nlay, alb, src, top,
                         [&](float fup, float fdn, int lv) {
                             if (lv > 0) {
                                 *(float2*)(k + (lv - 1) * chunk) =
                                     make_float2(fup, fdn);
                             } else {
                                 top_s[lane] = fup;
                                 top_s[chunk + lane] = fdn;
                             }
                         });
    }
    __syncthreads();

    // ---- the column's sums: the chunk's, then the cluster's; up, dn
    // total = diffuse + direct, dir ----
    sums.reduce([&](int f, int lv, int i) {
        if (lv == 0) return top_s[f * chunk + i];
        int o = (lv - 1) * chunk + i;
        return f == 2 ? tns_s[o] : ((const float*)(coef + o))[f];
    });
    const long long bs = (long long)nlev * ncol;
    sums.finalize([&](int i, auto total) {
        float fd = total(2);
        if (byband) {
            int b = i / nlev, lv = i - b * nlev;
            long long ob = (long long)b * bs + (long long)lv * ncol + c;
            long long bplane = (long long)nband * bs;
            band_out[ob] = total(0);
            band_out[bplane + ob] = total(1) + fd;
            band_out[2 * bplane + ob] = fd;
        } else {
            long long ob = (long long)i * ncol + c;
            out[ob] = total(0);
            out[bs + ob] = total(1) + fd;
            out[2 * bs + ob] = fd;
        }
    });
}

size_t smem_bytes(int nlay, int chunk, int nminor, int nband) {
    return (size_t)nlay * chunk * (sizeof(float4) + sizeof(float))
        + (size_t)kFields * chunk * sizeof(float)
        + (size_t)(nminor + 31) / 32 * chunk * sizeof(unsigned)
        + (size_t)nminor * rte::kMetaFields * sizeof(int)
        + rte::ClusterSums::bytes(kFields, chunk, nlay + 1, nband);
}

}  // namespace

// Shared memory of one block at (nlay, chunk, nminor, nband; 0 for
// broadband), the bytes ops/kernels/onchip.py::onchip_geometry counts.
extern "C" int smem_fused_sw(int nlay, int chunk, int nminor, int nband) {
    return (int)smem_bytes(nlay, chunk, nminor, nband);
}

// Resident blocks per SM * 65536 + clusters the card holds at once, or a
// negative CUDA error (transport.cuh::cluster_occupancy).
extern "C" int occupancy_fused_sw(int nlay, int chunk, int nchunk,
                                  int nminor, int nband) {
    return rte::cluster_occupancy(fused_sw_kernel, nchunk, kThreads,
                                  smem_bytes(nlay, chunk, nminor, nband));
}

extern "C" int launch_fused_sw(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* msc,
        const void* minor_meta, const void* kmajor, const void* klo,
        const void* kup, const void* krayl, const void* gflav,
        const void* gpt2band, const void* rayscale, const void* cloud,
        const void* mu0, const void* alb_dir, const void* alb_dif,
        const void* inc, const void* incdif, void* out, void* band_out,
        int ncol, int nlay, int ngpt, int neta, int npres1, int nflav,
        int nminor, int ncl, int ncu, int nbnd, int nband, int chunk,
        void* stream) {
    if (ncol == 0) return 0;
    const int nchunk = (ngpt + chunk - 1) / chunk;
    return (int)rte::launch_clusters(
        fused_sw_kernel, ncol, nchunk, kThreads,
        smem_bytes(nlay, chunk, nminor, band_out ? nband : 0),
        (cudaStream_t)stream, (const int*)jtemp, (const float*)ftemp,
        (const int*)jpress, (const float*)fpress, (const int*)tropo,
        (const int*)jeta, (const float*)feta, (const float*)col_mix,
        (const float*)msc, (const int*)minor_meta, (const float*)kmajor,
        (const float*)klo, (const float*)kup, (const float*)krayl,
        (const int*)gflav, (const int*)gpt2band, (const float*)rayscale,
        (const float*)cloud, (const float*)mu0, (const float*)alb_dir,
        (const float*)alb_dif, (const float*)inc, (const float*)incdif,
        (float*)out, (float*)band_out, ncol, nlay, ngpt, neta, npres1, nflav,
        nminor, ncl, ncu, nbnd, nband, chunk);
}
