// Major-gas optical depth and (LW) Planck fraction of every cell and
// g-point: the staged gas-optics gather of the public gas_optics_lw/sw.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/major_gather.py::
// major_interp_lane (via ops/gas_optics_pallas.py::tau_major_pallas).
// Plain twin: rte_rrtmgp_tpu_torch/ops/kernels/gas_major.py::
// gas_major_plain.
//
// Layout: a block takes a run of consecutive cells, ``cpb`` cells side by
// side (one thread per g-point of each, in whole warps), and each thread
// kBatch cells of the run at a time; as many blocks as the card holds at
// once (common.cuh::resident_grid). The thread's flavors of both
// atmospheres (gflav) are read once. For a batch the thread loads the
// cells' descriptors (common.cuh::load_cell), then per cell and
// temperature the flavor's jeta, feta and col_mix, then the 8 (temperature,
// eta, pressure) corners of the table, of all kBatch cells before it uses
// any: kBatch chains of dependent loads in flight per thread instead of
// one. The upper atmosphere reads the pressure row above its index. LW
// (PF) reads kmajor and planck_frac interleaved as one table of pairs
// (ntemp, neta, npres+1, ngpt, 2), built once per k-distribution
// (GasOpticsRRTMGP.kmajor_pfrac, the fused LW step's table): one 8-byte
// gather per corner instead of two 4-byte ones; SW reads kmajor. The
// (cell, g-point) loads and stores are coalesced along g.
//
// What bounds it on this card: by bytes, writing tau (and pfrac), 4 B
// per (cell, g-point) each, 0.20 ms at 4096 x 72; but each (cell,
// g-point) gathers 8 corners (8 B each with the Planck fraction) from
// tables of 8-16 MB resident in the 50 MB L2, 4.8 GB of L2 reads per LW
// launch at 4096 x 72, each behind the loads before it (descriptors, then
// jeta, then the table). One cell per block and thread left one such
// chain in flight per thread (0.86 ms LW); kBatch cells per thread keep
// kBatch chains in flight, and the gathers' requests hold it (0.62 ms LW,
// 0.47 SW: PERF.md); 4 cells per thread take more registers and fewer
// blocks per SM, and are slower.
//
// Arithmetic: each (cell, g-point) does common.cuh::major_tau's products
// and sums in their order (corners by temperature, pressure, eta), so the
// outputs are those of the one-cell-per-block kernel it replaced, bit for
// bit; no atomics.
//
// Contract (checked by the Python wrapper): float32 data, int32 indices,
// contiguous, ngpt <= 1024; cells flattened in the caller's order.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // most per block, unless ngpt needs more
constexpr int kBatch = 3;       // cells per thread in flight

template <bool PF, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) gas_major_kernel(
        const int* __restrict__ jtemp, const float* __restrict__ ftemp,
        const int* __restrict__ jpress, const float* __restrict__ fpress,
        const int* __restrict__ tropo, const int* __restrict__ jeta,
        const float* __restrict__ feta, const float* __restrict__ col_mix,
        const float* __restrict__ kmajor, const float2* __restrict__ kp,
        const int* __restrict__ gflav, float* __restrict__ tau,
        float* __restrict__ pfrac, int ncell, int ngpt, int neta,
        int npres1, int nflav, int span) {
    const int gw = (ngpt + 31) / 32 * 32;     // threads per cell
    const int cpb = blockDim.x / gw;          // cells side by side
    const int g = threadIdx.x % gw;
    const int slot = threadIdx.x / gw;
    if (slot >= cpb || g >= ngpt) return;
    const int flav_lo = __ldg(gflav + g), flav_up = __ldg(gflav + ngpt + g);
    const int c0 = blockIdx.x * span;
    const int c1 = min(ncell, c0 + span);
    for (int base = c0 + slot; base < c1; base += cpb * kBatch) {
        int cell[kBatch];
        rte::CellDesc d[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            int ci = base + i * cpb;
            cell[i] = ci < c1 ? ci : base;
            d[i] = rte::load_cell(jtemp, ftemp, jpress, fpress, tropo,
                                  cell[i]);
        }
        int je[kBatch][2];
        float fe[kBatch][2], cm[kBatch][2];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            const int flav = d[i].lower ? flav_lo : flav_up;
#pragma unroll
            for (int it = 0; it < 2; ++it) {
                int fi = (it * nflav + flav) * ncell + cell[i];
                je[i][it] = __ldg(jeta + fi);
                fe[i][it] = __ldg(feta + fi);
                cm[i][it] = __ldg(col_mix + fi);
            }
        }
        // the corners, (temperature, pressure, eta) in major_tau's order
        float2 v[kBatch][8];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int it = c >> 2, dp = (c >> 1) & 1, de = c & 1;
                long long k = ((long long)(((d[i].jt + it) * neta
                                            + je[i][it] + de) * npres1
                                           + d[i].jp + dp)) * ngpt + g;
                v[i][c] = PF ? __ldg(kp + k)
                             : make_float2(__ldg(kmajor + k), 0.0f);
            }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            float t = 0.0f, p = 0.0f;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int it = c >> 2, dp = (c >> 1) & 1, de = c & 1;
                float ftv = it == 0 ? 1.0f - d[i].ft : d[i].ft;
                float fpv = dp == 0 ? 1.0f - d[i].fp : d[i].fp;
                float fev = de == 0 ? 1.0f - fe[i][it] : fe[i][it];
                float wgt = (fev * ftv) * fpv;
                t += (wgt * cm[i][it]) * v[i][c].x;
                if (PF) p += wgt * v[i][c].y;
            }
            if (base + i * cpb < c1) {
                long long o = (long long)cell[i] * ngpt + g;
                tau[o] = t;
                if (PF) pfrac[o] = p;
            }
        }
    }
}

// Threads per block: as many whole cells (one thread per g-point, in
// whole warps) as kThreads holds, or one cell where ngpt needs more.
int major_threads(int ngpt) {
    int gw = (ngpt + 31) / 32 * 32;
    return gw > kThreads ? gw : gw * (kThreads / gw);
}

// fn(kernel) for the instantiation that (ngpt, pf) takes.
template <typename Fn>
int with_kernel(int ngpt, bool pf, Fn&& fn) {
    if (major_threads(ngpt) > kThreads)
        return pf ? fn(gas_major_kernel<true, 1024>)
                  : fn(gas_major_kernel<false, 1024>);
    return pf ? fn(gas_major_kernel<true, kThreads>)
              : fn(gas_major_kernel<false, kThreads>);
}

}  // namespace

// Resident blocks per SM of the instantiation (ngpt, pf: with the Planck
// fraction) takes, or a negative CUDA error; the launcher starts that
// many per SM.
extern "C" int occupancy_gas_major(int ngpt, int pf) {
    return with_kernel(ngpt, pf != 0, [&](auto kernel) {
        int blocks = 0;
        cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, major_threads(ngpt), 0);
        return err == cudaSuccess ? blocks : -(int)err;
    });
}

// kp: kmajor and planck_frac interleaved, (ntemp, neta, npres+1, ngpt, 2),
// read where pfrac is given (LW); otherwise kmajor (ntemp, neta, npres+1,
// ngpt).
extern "C" int launch_gas_major(
        const void* jtemp, const void* ftemp, const void* jpress,
        const void* fpress, const void* tropo, const void* jeta,
        const void* feta, const void* col_mix, const void* kmajor,
        const void* kp, const void* gflav, void* tau, void* pfrac,
        int ncell, int ngpt, int neta, int npres1, int nflav, void* stream) {
    if (ncell == 0) return 0;
    // as many blocks as the card holds at once, each a run of ``span``
    // consecutive cells (fewer where there are fewer batches)
    const int threads = major_threads(ngpt);
    const int cpb = threads / ((ngpt + 31) / 32 * 32);
    return with_kernel(ngpt, pfrac != nullptr, [&](auto kernel) {
        long long limit = 0;
        cudaError_t err = rte::resident_grid(kernel, threads, 0, &limit);
        if (err != cudaSuccess) return (int)err;
        const long long batches = ((long long)ncell + cpb * kBatch - 1)
            / (cpb * kBatch);
        const int grid = (int)(batches < limit ? batches : limit);
        const int span = (int)(((long long)ncell + grid - 1) / grid);
        kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const int*)jtemp, (const float*)ftemp, (const int*)jpress,
            (const float*)fpress, (const int*)tropo, (const int*)jeta,
            (const float*)feta, (const float*)col_mix, (const float*)kmajor,
            (const float2*)kp, (const int*)gflav, (float*)tau,
            (float*)pfrac, ncell, ngpt, neta, npres1, nflav, span);
        return (int)cudaGetLastError();
    });
}
