// Minor-gas optical depths of one atmosphere added to tau, and the
// Rayleigh optical depth with the absorption/Rayleigh combine: the staged
// gas-optics gathers of the public gas_optics_lw/sw.
//
// Replaces the TPU kernels rte_rrtmgp_tpu/ops/pallas/minor_gather.py::
// minor_contributions_lane (via ops/gas_optics_pallas.py::
// tau_minor_pallas) and ::rayleigh_k_lane (via tau_rayleigh_pallas, with
// the combine of models/rrtmgp/gas_optics.py:344-358). Plain twins:
// rte_rrtmgp_tpu_torch/ops/kernels/gas_minor.py::gas_minor_plain and
// gas_rayleigh_plain. tau and ssa are (cell, g-point) with g fastest.
//
// gas_minor: tau_out = tau_in + the minors' contributions (tau_out may be
// tau_in: in place). A block of threads takes a run of consecutive cells,
// ``cpb`` cells side by side (one thread per g-point of each), and each
// thread kBatch cells of the run at a time. The minors' metadata is
// staged in shared memory once per block, and each thread's bit mask of
// the minors whose window holds its g-point (common.cuh::minor_word) once
// per thread. For each cell of a batch the thread loads tau and the
// cell's descriptors, then minor by minor (ascending, as the twin) the
// scalings, the flavor's jeta and feta and the four kminor values of all
// kBatch cells before it adds any: kBatch independent chains in flight
// per thread instead of one. A minor whose scaling is 0 at a cell (the
// other atmosphere's: minor_scaling applies the mask) adds exactly
// nothing, and its reads are skipped. The lerp is common.cuh::minor_lerp,
// the one minor_tau_lane calls; no atomics, so two runs give identical
// bits.
//
// gas_rayleigh: one block per cell, one thread per g-point: the krayl
// lerp in the cell's atmosphere (common.cuh::rayleigh_k) times col_h2o +
// col_dry, added to tau, and ssa = tau_rayleigh / tau where tau > 2 tiny.
//
// What bounds them on this card: reading and writing tau (and writing
// ssa), 4 B per (cell, g-point) each; the table gathers hit kminor and
// krayl, which stay resident in L2. A minor's contribution is a chain of
// dependent loads (descriptors, scaling, jeta, table), so gas_minor needs
// many chains in flight per SM: kBatch per thread, at 4 blocks per SM
// (64 registers; capped for more blocks, it spills and slows: PERF.md).
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; cells flattened in the caller's order.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // most per block, unless ngpt needs more
constexpr int kBatch = 4;       // cells per thread in flight

template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) gas_minor_kernel(
        const float* tau_in, float* tau_out, const int* __restrict__ jtemp,
        const float* __restrict__ ftemp, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ msc,
        const int* __restrict__ minor_meta, const float* __restrict__ kminor,
        int ncell, int ngpt, int neta, int nflav, int nminor, int ncont,
        int span) {
    extern __shared__ int meta[];             // (nminor, kMetaFields)
    const int gw = (ngpt + 31) / 32 * 32;     // threads per cell
    const int cpb = blockDim.x / gw;          // cells side by side
    const int nwords = (nminor + 31) / 32;
    unsigned* words = (unsigned*)(meta + nminor * rte::kMetaFields);
    const int g = threadIdx.x % gw;
    const int slot = threadIdx.x / gw;
    for (int i = threadIdx.x; i < nminor * rte::kMetaFields; i += blockDim.x)
        meta[i] = minor_meta[i];
    for (int w = slot; slot < cpb && w < nwords; w += cpb)
        words[w * gw + g] = rte::minor_word(minor_meta, nminor, w, g);
    __syncthreads();
    if (slot >= cpb || g >= ngpt) return;
    const int c0 = blockIdx.x * span;
    const int c1 = min(ncell, c0 + span);
    for (int base = c0 + slot; base < c1; base += cpb * kBatch) {
        int cell[kBatch], jt[kBatch];
        float t[kBatch], ft[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            int ci = base + i * cpb;
            cell[i] = ci < c1 ? ci : base;
            t[i] = tau_in[(long long)cell[i] * ngpt + g];
            jt[i] = jtemp[cell[i]];
            ft[i] = ftemp[cell[i]];
        }
        for (int w = 0; w < nwords; ++w) {
            unsigned bits = words[w * gw + g];
            while (bits) {
                const int m = 32 * w + __ffs(bits) - 1;
                bits &= bits - 1;
                const int* mm = meta + m * rte::kMetaFields;
                const int f = mm[1];
                const int k = mm[4] + (g - mm[2]);
                float s[kBatch], fe[kBatch][2], lo[kBatch][2], hi[kBatch][2];
                int je[kBatch][2];
#pragma unroll
                for (int i = 0; i < kBatch; ++i)
                    s[i] = __ldg(msc + (long long)m * ncell + cell[i]);
#pragma unroll
                for (int i = 0; i < kBatch; ++i)
#pragma unroll
                    for (int it = 0; it < 2; ++it) {
                        int fi = (it * nflav + f) * ncell + cell[i];
                        je[i][it] = s[i] != 0.0f ? __ldg(jeta + fi) : 0;
                        fe[i][it] = s[i] != 0.0f ? __ldg(feta + fi) : 0.0f;
                    }
#pragma unroll
                for (int i = 0; i < kBatch; ++i)
#pragma unroll
                    for (int it = 0; it < 2; ++it) {
                        int row = (jt[i] + it) * neta + je[i][it];
                        lo[i][it] = s[i] != 0.0f
                            ? __ldg(kminor + row * ncont + k) : 0.0f;
                        hi[i][it] = s[i] != 0.0f
                            ? __ldg(kminor + (row + 1) * ncont + k) : 0.0f;
                    }
#pragma unroll
                for (int i = 0; i < kBatch; ++i)
                    if (s[i] != 0.0f)
                        t[i] += s[i] * rte::minor_lerp(ft[i], fe[i], lo[i],
                                                       hi[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
            if (base + i * cpb < c1)
                tau_out[(long long)cell[i] * ngpt + g] = t[i];
    }
}

// Threads per block: as many whole cells (one thread per g-point, in
// whole warps) as kThreads holds, or one cell where ngpt needs more.
int minor_threads(int ngpt) {
    int gw = (ngpt + 31) / 32 * 32;
    return gw > kThreads ? gw : gw * (kThreads / gw);
}

size_t minor_smem(int ngpt, int nminor) {
    int gw = (ngpt + 31) / 32 * 32;
    return (size_t)nminor * rte::kMetaFields * sizeof(int)
        + (size_t)(nminor + 31) / 32 * gw * sizeof(unsigned);
}

// Resident blocks per SM of the instantiation ngpt takes, or a negative
// CUDA error.
int minor_occupancy(int ngpt, int nminor) {
    int blocks = 0;
    int threads = minor_threads(ngpt);
    cudaError_t err = threads > kThreads
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, gas_minor_kernel<1024>, threads,
              minor_smem(ngpt, nminor))
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, gas_minor_kernel<kThreads>, threads,
              minor_smem(ngpt, nminor));
    return err == cudaSuccess ? blocks : -(int)err;
}

__global__ void gas_rayleigh_kernel(
        float* __restrict__ tau, float* __restrict__ ssa,
        const int* __restrict__ jtemp, const float* __restrict__ ftemp,
        const int* __restrict__ tropo, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ krayl,
        const int* __restrict__ gflav, const float* __restrict__ rayscale,
        int ncell, int ngpt, int neta, int nflav) {
    const int cell = blockIdx.x;
    const int g = threadIdx.x;
    if (g >= ngpt) return;
    rte::CellDesc d;
    d.lower = tropo[cell] != 0;
    d.jt = jtemp[cell];
    d.ft = ftemp[cell];
    int flav = gflav[(d.lower ? 0 : 1) * ngpt + g];
    float ray = rte::rayleigh_k(d, flav, nflav, ncell, cell, jeta, feta,
                                krayl, neta, ngpt, g) * rayscale[cell];
    long long o = (long long)cell * ngpt + g;
    float t = tau[o] + ray;
    tau[o] = t;
    if (ssa) ssa[o] = t > 2.0f * FLT_MIN ? ray / t : 0.0f;
}

}  // namespace

// Resident blocks per SM of gas_minor at (ngpt, nminor), or a negative
// CUDA error.
extern "C" int occupancy_gas_minor(int ngpt, int nminor) {
    return minor_occupancy(ngpt, nminor);
}

extern "C" int launch_gas_minor(
        const void* tau_in, void* tau_out, const void* jtemp,
        const void* ftemp, const void* jeta, const void* feta,
        const void* msc, const void* minor_meta, const void* kminor,
        int ncell, int ngpt, int neta, int nflav, int nminor, int ncont,
        void* stream) {
    if (ncell == 0) return 0;
    if (nminor == 0) {
        if (tau_out == tau_in) return 0;
        return (int)cudaMemcpyAsync(tau_out, tau_in,
                                    (size_t)ncell * ngpt * sizeof(float),
                                    cudaMemcpyDeviceToDevice,
                                    (cudaStream_t)stream);
    }
    // as many blocks as the card holds at once, each a run of ``span``
    // consecutive cells (fewer where there are fewer batches)
    const int threads = minor_threads(ngpt);
    const int cpb = threads / ((ngpt + 31) / 32 * 32);
    const size_t smem = minor_smem(ngpt, nminor);
    auto go = [&](auto kernel) {
        long long limit = 0;
        cudaError_t err = rte::allow_smem(kernel, smem);
        if (err == cudaSuccess)
            err = rte::resident_grid(kernel, threads, smem, &limit);
        if (err != cudaSuccess) return (int)err;
        const long long batches = ((long long)ncell + cpb * kBatch - 1)
            / (cpb * kBatch);
        const int grid = (int)(batches < limit ? batches : limit);
        const int span = (int)(((long long)ncell + grid - 1) / grid);
        kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
            (const float*)tau_in, (float*)tau_out, (const int*)jtemp,
            (const float*)ftemp, (const int*)jeta, (const float*)feta,
            (const float*)msc, (const int*)minor_meta,
            (const float*)kminor, ncell, ngpt, neta, nflav, nminor, ncont,
            span);
        return (int)cudaGetLastError();
    };
    return threads > kThreads ? go(gas_minor_kernel<1024>)
                              : go(gas_minor_kernel<kThreads>);
}

extern "C" int launch_gas_rayleigh(
        void* tau, void* ssa, const void* jtemp, const void* ftemp,
        const void* tropo, const void* jeta, const void* feta,
        const void* krayl, const void* gflav, const void* rayscale,
        int ncell, int ngpt, int neta, int nflav, void* stream) {
    if (ncell == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    gas_rayleigh_kernel<<<ncell, threads, 0, (cudaStream_t)stream>>>(
        (float*)tau, (float*)ssa, (const int*)jtemp, (const float*)ftemp,
        (const int*)tropo, (const int*)jeta, (const float*)feta,
        (const float*)krayl, (const int*)gflav, (const float*)rayscale,
        ncell, ngpt, neta, nflav);
    return (int)cudaGetLastError();
}
