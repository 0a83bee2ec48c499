// LW true two-stream solve (rte_lw(use_2stream=True)) with broadband or
// per-band output.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py::
// lw_two_stream_broadband_lane (_lw2_kernel; reference
// rte_lw_solver_2stream, mo_rte_solver_kernels.F90:377-440). Plain twin:
// rte_rrtmgp_tpu_torch/ops/kernels/solver_lw_2str.py::lw_2stream_plain.
//
// Layout: a column's g-points are cut into chunks of ``chunk`` (a
// multiple of 32, at most 8 chunks: ops/kernels/onchip.py::
// onchip_geometry), one block of kThreads threads per chunk, and the
// column's chunks are one thread-block cluster. The chunk's layer fields
// live in shared memory, no device-memory scratch:
//   pass 1, every thread, kThreads / chunk layers at a time (thread
//   lane + chunk * k takes g-point g0 + lane and the layers k, k + K,
//   ...): the Meador-Weaver Rdif/Tdif with the LW diffusivity secant 1.66
//   and the Toon linear-in-B sources times pi (transport.cuh::lw2_layer;
//   the layer Planck source is not read);
//   then the chunk's first ``chunk`` threads, one per g-point, sweep: the
//   Shonk-Hogan adding build bottom up from the surface albedo 1 - emis
//   and source pi * emis * sfc_src (transport.cuh::adding_up, its four
//   values per layer written in place), the fluxes top down from the
//   incident flux (transport.cuh::adding_down), each level's fluxes
//   written in place;
//   then every thread again: the chunk's sums of each level
//   (transport.cuh::ClusterSums::reduce), and the cluster's.
//
// What bounds it on this card: reading tau, ssa, g and the level sources
// once, 16 B per (column, layer, g-point), which needs many warps in
// flight, and the latency of the two dependent sweeps. Kept in device
// memory, the layer fields (six per column, level and g-point: 449 KB per
// 256-g-point column) make each layer of the adding build wait a memory
// round trip: most of the solve's time on an H100 (PERF.md). Here a
// 32-wide chunk's fields take 16 B x nlay x 32 of shared memory.
//
// Sums: per level, broadband the warp-shuffle sum of each 32 g-points,
// by band each band's g-points of the chunk in ascending order
// (gpt2band, so ragged bands work), then summed over the cluster's shared
// memory in rank order (transport.cuh::ClusterSums). Deterministic, no
// atomics.
//
// Contract (checked by the Python wrapper): float32, contiguous,
// ngpt <= 1024, top of the atmosphere at layer 0.

#include "common.cuh"
#include "transport.cuh"

namespace {

constexpr int kThreads = 256;   // per block: chunk g-points x layer lanes
constexpr int kBlocksPerSM = 6;
constexpr int kFields = 2;      // up, dn

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
solver_lw_2str_kernel(
        const float* __restrict__ tau, const float* __restrict__ ssa,
        const float* __restrict__ asy, const float* __restrict__ lev,
        const float* __restrict__ emis, const float* __restrict__ sfc,
        const float* __restrict__ inc, const int* __restrict__ gpt2band,
        float* __restrict__ up, float* __restrict__ dn,
        float* __restrict__ band_up, float* __restrict__ band_dn, int nlay,
        int ngpt, int nband, int chunk) {
    extern __shared__ float4 coef[];          // (nlay, chunk)
    namespace cg = cooperative_groups;
    const int nlev = nlay + 1;
    const int nchunk = (int)cg::this_cluster().num_blocks();
    const int rank = (int)cg::this_cluster().block_rank();
    const int c = blockIdx.x / nchunk;
    float* top_s = (float*)(coef + (size_t)nlay * chunk);   // (2, chunk)
    const bool byband = band_up != nullptr;
    rte::ClusterSums sums;
    sums.init(top_s + kFields * chunk, kFields, chunk, nlev,
              byband ? nband : 0, gpt2band, rank * chunk, ngpt);

    const int lane = threadIdx.x % chunk;
    const int g = rank * chunk + lane;
    const bool active = g < ngpt;

    // ---- pass 1: layer coefficients and sources, layers in parallel ----
    const float* tp = tau + (long long)c * nlay * ngpt + g;
    const float* wp = ssa + (long long)c * nlay * ngpt + g;
    const float* ap = asy + (long long)c * nlay * ngpt + g;
    const float* lp = lev + (long long)c * nlev * ngpt + g;
    for (int l = threadIdx.x / chunk; active && l < nlay;
         l += kThreads / chunk) {
        long long o = (long long)l * ngpt;
        rte::Lw2Layer s = rte::lw2_layer(__ldg(tp + o), __ldg(wp + o),
                                         __ldg(ap + o), __ldg(lp + o),
                                         __ldg(lp + o + ngpt));
        coef[l * chunk + lane] = make_float4(s.rdif, s.tdif, s.sdn, s.sup);
    }
    __syncthreads();

    // ---- the sweeps: the chunk's first ``chunk`` threads ----
    if (threadIdx.x < chunk) {
        float4* k = coef + lane;
        float alb = 0.0f, src = 0.0f, top = 0.0f;
        if (active) {
            const long long bc = (long long)c * ngpt + g;
            const float e = __ldg(emis + bc);
            alb = 1.0f - e;
            src = 3.14159265358979f * e * __ldg(sfc + bc);
            top = __ldg(inc + bc);
        }
        // adding build, bottom up, in place (Eqs 9-13)
        float4 q = k[(nlay - 1) * chunk];
        for (int v = nlay - 1; v >= 0; --v) {
            float4 qn = k[(v > 0 ? v - 1 : 0) * chunk];
            k[v * chunk] = rte::adding_up(q.x, q.y, q.z, q.w, alb, src);
            q = qn;
        }
        // fluxes, top down; level v + 1's in place of layer v's values
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

    // ---- the column's sums: the chunk's, then the cluster's ----
    sums.reduce([&](int f, int lv, int i) {
        return lv == 0 ? top_s[f * chunk + i]
                       : ((const float*)(coef + (lv - 1) * chunk + i))[f];
    });
    sums.finalize([&](int i, auto total) {
        if (byband) {
            int b = i / nlev, lv = i - b * nlev;
            long long ob = ((long long)c * nlev + lv) * nband + b;
            band_up[ob] = total(0);
            band_dn[ob] = total(1);
        } else {
            long long ob = (long long)c * nlev + i;
            up[ob] = total(0);
            dn[ob] = total(1);
        }
    });
}

size_t smem_bytes(int nlay, int chunk, int nband) {
    return (size_t)nlay * chunk * sizeof(float4)
        + (size_t)kFields * chunk * sizeof(float)
        + rte::ClusterSums::bytes(kFields, chunk, nlay + 1, nband);
}

}  // namespace

// Shared memory of one block at (nlay, chunk, nband; 0 for broadband),
// the bytes ops/kernels/onchip.py::onchip_geometry counts.
extern "C" int smem_solver_lw_2str(int nlay, int chunk, int nband) {
    return (int)smem_bytes(nlay, chunk, nband);
}

// Resident blocks per SM * 65536 + clusters the card holds at once, or a
// negative CUDA error (transport.cuh::cluster_occupancy).
extern "C" int occupancy_solver_lw_2str(int nlay, int chunk, int nchunk,
                                        int nband) {
    return rte::cluster_occupancy(solver_lw_2str_kernel, nchunk, kThreads,
                                  smem_bytes(nlay, chunk, nband));
}

// tau/ssa/asy (column, layer, g-point), lev (column, level, g-point),
// emis/sfc/inc (column, g-point). Broadband up/dn (column, level), or
// with band_up/band_dn (column, level, band) the per-band sums there
// (gpt2band) instead. chunk: g-points per block (onchip_geometry).
extern "C" int launch_solver_lw_2str(
        const void* tau, const void* ssa, const void* asy, const void* lev,
        const void* emis, const void* sfc, const void* inc,
        const void* gpt2band, void* up, void* dn, void* band_up,
        void* band_dn, int ncol, int nlay, int ngpt, int nband, int chunk,
        void* stream) {
    if (ncol == 0) return 0;
    const int nchunk = (ngpt + chunk - 1) / chunk;
    return (int)rte::launch_clusters(
        solver_lw_2str_kernel, ncol, nchunk, kThreads,
        smem_bytes(nlay, chunk, band_up ? nband : 0), (cudaStream_t)stream,
        (const float*)tau, (const float*)ssa, (const float*)asy,
        (const float*)lev, (const float*)emis, (const float*)sfc,
        (const float*)inc, (const int*)gpt2band, (float*)up, (float*)dn,
        (float*)band_up, (float*)band_dn, nlay, ngpt, nband, chunk);
}
