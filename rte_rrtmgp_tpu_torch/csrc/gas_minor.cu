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
// gas_rayleigh: tau_out = tau_in + the krayl lerp in the cell's
// atmosphere (common.cuh::rayleigh_k's arithmetic) times col_h2o +
// col_dry, and ssa = tau_rayleigh / tau_out where tau_out > 2 tiny; a null
// tau_in reads as 0 (0 + Rayleigh: the Rayleigh optical depth alone, the
// same bits), a null ssa is not written, and tau_out may be tau_in (in
// place). The public and staged gas optics call it out of place, with no
// clone of tau and no zeros tensor. A run of consecutive cells per block
// as gas_minor, kRayBatch cells per thread, each cell's chain of
// dependent loads (tropo -> the flavor's jeta -> the four krayl values)
// started for the whole batch before any value is used: one block per cell
// and one chain per thread held it at 0.57 ms at 4096 x 72, 2.3x its
// bound (PERF.md).
//
// What bounds them on this card: reading and writing tau (and writing
// ssa), 4 B per (cell, g-point) each; the table gathers hit kminor and
// krayl, which stay resident in L2. A minor's contribution is a chain of
// dependent loads (descriptors, scaling, jeta, table), so gas_minor needs
// many chains in flight per SM: kBatch per thread, at 4 blocks per SM
// (64 registers; capped for more blocks, it spills and slows: PERF.md).
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// the tropopause flags as bytes (torch.bool), contiguous, ngpt <= 1024;
// cells flattened in the caller's order.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // most per block, unless ngpt needs more
constexpr int kBatch = 4;       // gas_minor: cells per thread in flight
constexpr int kRayBatch = 2;    // gas_rayleigh: cells per thread in flight

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

// gas_rayleigh: the same run of cells per block, kRayBatch cells per
// thread; each cell's loads (descriptors, tau, jeta and feta of the
// thread's flavor, the four krayl values) started for all cells of the
// batch before any is used.
template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) gas_rayleigh_kernel(
        const float* tau_in, float* tau_out, float* __restrict__ ssa,
        const int* __restrict__ jtemp, const float* __restrict__ ftemp,
        const unsigned char* __restrict__ tropo,
        const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ krayl,
        const int* __restrict__ gflav, const float* __restrict__ rayscale,
        int ncell, int ngpt, int neta, int nflav, int span) {
    const int gw = (ngpt + 31) / 32 * 32;     // threads per cell
    const int cpb = blockDim.x / gw;          // cells side by side
    const int g = threadIdx.x % gw;
    const int slot = threadIdx.x / gw;
    if (slot >= cpb || g >= ngpt) return;
    const int flav_lo = __ldg(gflav + g), flav_up = __ldg(gflav + ngpt + g);
    const int c0 = blockIdx.x * span;
    const int c1 = min(ncell, c0 + span);
    for (int base = c0 + slot; base < c1; base += cpb * kRayBatch) {
        int cell[kRayBatch], jt[kRayBatch], atm[kRayBatch];
        float ft[kRayBatch], rs[kRayBatch], t[kRayBatch];
#pragma unroll
        for (int i = 0; i < kRayBatch; ++i) {
            int ci = base + i * cpb;
            cell[i] = ci < c1 ? ci : base;
            atm[i] = __ldg(tropo + cell[i]) != 0 ? 0 : 1;
            jt[i] = __ldg(jtemp + cell[i]);
            ft[i] = __ldg(ftemp + cell[i]);
            rs[i] = __ldg(rayscale + cell[i]);
            t[i] = tau_in ? tau_in[(long long)cell[i] * ngpt + g] : 0.0f;
        }
        float fe[kRayBatch][2], lo[kRayBatch][2], hi[kRayBatch][2];
        int je[kRayBatch][2];
#pragma unroll
        for (int i = 0; i < kRayBatch; ++i)
#pragma unroll
            for (int it = 0; it < 2; ++it) {
                int fi = (it * nflav + (atm[i] ? flav_up : flav_lo)) * ncell
                         + cell[i];
                je[i][it] = __ldg(jeta + fi);
                fe[i][it] = __ldg(feta + fi);
            }
#pragma unroll
        for (int i = 0; i < kRayBatch; ++i)
#pragma unroll
            for (int it = 0; it < 2; ++it) {
                long long b = (long long)((jt[i] + it) * neta + je[i][it])
                              * ngpt + g;
                lo[i][it] = __ldg(krayl + b * 2 + atm[i]);
                hi[i][it] = __ldg(krayl + (b + ngpt) * 2 + atm[i]);
            }
#pragma unroll
        for (int i = 0; i < kRayBatch; ++i) {
            if (base + i * cpb >= c1) continue;
            float ray = rte::minor_lerp(ft[i], fe[i], lo[i], hi[i]) * rs[i];
            float tt = t[i] + ray;
            long long o = (long long)cell[i] * ngpt + g;
            tau_out[o] = tt;
            if (ssa) ssa[o] = tt > 2.0f * FLT_MIN ? ray / tt : 0.0f;
        }
    }
}

// As many blocks of ``kernel`` as the card holds at once, each a run of
// ``*span`` consecutive cells (fewer blocks where there are fewer
// batches of ``batch`` cells per thread): the grid, or a negative CUDA
// error.
template <typename K>
int run_grid(K kernel, int threads, size_t smem, int ncell, int cpb,
             int batch, int* span) {
    long long limit = 0;
    cudaError_t err = rte::allow_smem(kernel, smem);
    if (err == cudaSuccess)
        err = rte::resident_grid(kernel, threads, smem, &limit);
    if (err != cudaSuccess) return -(int)err;
    const long long batches = ((long long)ncell + cpb * batch - 1)
        / (cpb * batch);
    const int grid = (int)(batches < limit ? batches : limit);
    *span = (int)(((long long)ncell + grid - 1) / grid);
    return grid;
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
        int span = 0;
        const int grid = run_grid(kernel, threads, smem, ncell, cpb, kBatch,
                                  &span);
        if (grid < 0) return -grid;
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

// Resident blocks per SM of gas_rayleigh at ngpt g-points, or a negative
// CUDA error.
extern "C" int occupancy_gas_rayleigh(int ngpt) {
    int blocks = 0;
    const int threads = minor_threads(ngpt);
    cudaError_t err = threads > kThreads
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, gas_rayleigh_kernel<1024>, threads, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, gas_rayleigh_kernel<kThreads>, threads, 0);
    return err == cudaSuccess ? blocks : -(int)err;
}

// tau_in null: 0 + Rayleigh; tau_out may be tau_in (in place); ssa null:
// no ssa.
extern "C" int launch_gas_rayleigh(
        const void* tau_in, void* tau_out, void* ssa, const void* jtemp,
        const void* ftemp, const void* tropo, const void* jeta,
        const void* feta, const void* krayl, const void* gflav,
        const void* rayscale, int ncell, int ngpt, int neta, int nflav,
        void* stream) {
    if (ncell == 0) return 0;
    const int threads = minor_threads(ngpt);
    const int cpb = threads / ((ngpt + 31) / 32 * 32);
    auto go = [&](auto kernel) {
        int span = 0;
        const int grid = run_grid(kernel, threads, 0, ncell, cpb, kRayBatch,
                                  &span);
        if (grid < 0) return -grid;
        kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const float*)tau_in, (float*)tau_out, (float*)ssa,
            (const int*)jtemp, (const float*)ftemp,
            (const unsigned char*)tropo, (const int*)jeta,
            (const float*)feta, (const float*)krayl, (const int*)gflav,
            (const float*)rayscale, ncell, ngpt, neta, nflav, span);
        return (int)cudaGetLastError();
    };
    return threads > kThreads ? go(gas_rayleigh_kernel<1024>)
                              : go(gas_rayleigh_kernel<kThreads>);
}
