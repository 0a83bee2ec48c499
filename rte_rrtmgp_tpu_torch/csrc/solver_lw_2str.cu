// LW true two-stream solve (rte_lw(use_2stream=True)) with broadband or
// per-band output.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py::
// lw_two_stream_broadband_lane (_lw2_kernel; reference
// rte_lw_solver_2stream, mo_rte_solver_kernels.F90:377-440). Plain twin:
// rte_rrtmgp_tpu_torch/ops/kernels/solver_lw_2str.py::lw_2stream_plain.
//
// Layout: one block per column, one thread per g-point, contiguous
// (column, layer, g-point) fields, so every load is coalesced along g.
// Pass 1, top down: per layer the Meador-Weaver Rdif/Tdif with the LW
// diffusivity secant 1.66 and the Toon linear-in-B sources times pi
// (transport.cuh::lw2_layer; the layer Planck source is not read), into
// wrapper-allocated scratch laid out (field, column, level, g-point).
// Passes 2 and 3: Shonk-Hogan adding (transport.cuh::adding, the SW
// solvers' code) from the surface albedo 1 - emis and source
// pi * emis * sfc_src, and the incident flux at the top.
//
// What bounds it on this card: reading tau, ssa, g and the level
// sources, 16 B per (column, layer, g-point), and the scratch traffic
// (six fields, about 14 x 4 B per (column, level, g-point)), which the
// TPU kernel keeps in VMEM and this kernel in device memory: a
// 256-g-point column's six fields at 73 levels take 449 KB, twice an
// SM's shared memory.
//
// Broadband sums: warp-shuffle sums per level into shared memory, then
// fixed-order sums of the warp partials; per-band sums: common.cuh::
// BandSums (gpt2band, so ragged bands work). Deterministic, no atomics.
//
// Contract (checked by the Python wrapper): float32, contiguous,
// ngpt <= 1024, top of the atmosphere at layer 0.

#include "common.cuh"
#include "transport.cuh"

namespace {

__global__ void solver_lw_2str_kernel(
        const float* __restrict__ tau, const float* __restrict__ ssa,
        const float* __restrict__ asy, const float* __restrict__ lev,
        const float* __restrict__ emis, const float* __restrict__ sfc,
        const float* __restrict__ inc, const int* __restrict__ gpt2band,
        float* scratch, float* up, float* dn, float* band_up,
        float* band_dn, int ncol, int nlay, int ngpt, int nband) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    float* p_up = smem;                       // (nwarps, nlev) each
    float* p_dn = p_up + nwarps * nlev;
    const bool byband = band_up != nullptr;
    rte::BandSums bands = {};
    if (byband) bands.init(p_dn + nwarps * nlev, gpt2band, ngpt, nband);

    const int c = blockIdx.x;
    const bool active = threadIdx.x < ngpt;
    const int g = active ? threadIdx.x : 0;   // idle lanes never read
    const long long field = (long long)ncol * nlev * ngpt;
    float* R = scratch + (long long)c * nlev * ngpt + g;     // rdif
    float* T = R + field;                                    // tdif
    float* SDN = T + field;                                  // source_dn
    float* SUP = SDN + field;     // source_up, then 1/(1-r*alb)
    float* ALB = SUP + field;                                // albedo at levels
    float* SRC = ALB + field;                                // source at levels
    const long long lay0 = (long long)c * nlay * ngpt + g;
    const long long lev0 = (long long)c * nlev * ngpt + g;
    const long long bo = (long long)c * nlev * nband;
    const rte::LevelSink up_s{p_up, nlev, byband ? band_up + bo : nullptr,
                              nband, 1, 1.0f, nullptr};
    const rte::LevelSink dn_s{p_dn, nlev, byband ? band_dn + bo : nullptr,
                              nband, 1, 1.0f, nullptr};

    // ---- pass 1: coefficients and sources per layer ----
    if (active) {
        float top = __ldg(lev + lev0);
        for (int l = 0; l < nlay; ++l) {
            long long ol = lay0 + (long long)l * ngpt;
            float bot = __ldg(lev + lev0 + (long long)(l + 1) * ngpt);
            rte::Lw2Layer s = rte::lw2_layer(__ldg(tau + ol), __ldg(ssa + ol),
                                             __ldg(asy + ol), top, bot);
            long long o = (long long)l * ngpt;
            R[o] = s.rdif;
            T[o] = s.tdif;
            SDN[o] = s.sdn;
            SUP[o] = s.sup;
            top = bot;
        }
    }

    // ---- passes 2 and 3: adding from the surface and the incident flux
    float alb_sfc = 0.0f, src_sfc = 0.0f, top = 0.0f;
    if (active) {
        long long bc = (long long)c * ngpt + g;
        float e = __ldg(emis + bc);
        alb_sfc = 1.0f - e;
        src_sfc = 3.14159265358979f * e * __ldg(sfc + bc);
        top = __ldg(inc + bc);
    }
    rte::adding(active, R, T, SDN, SUP, ALB, SRC, nlay, ngpt, alb_sfc,
                src_sfc, top, up_s, dn_s, bands);
    if (byband) return;

    __syncthreads();
    for (int lv = threadIdx.x; lv < nlev; lv += blockDim.x) {
        long long o = (long long)c * nlev + lv;
        up[o] = rte::level_total(p_up, nwarps, nlev, lv);
        dn[o] = rte::level_total(p_dn, nwarps, nlev, lv);
    }
}

}  // namespace

// tau/ssa/asy (column, layer, g-point), lev (column, level, g-point),
// emis/sfc/inc (column, g-point); scratch 6 x (column, level, g-point).
// Broadband up/dn (column, level), or with band_up/band_dn (column,
// level, band) the per-band sums there (gpt2band) instead.
extern "C" int launch_solver_lw_2str(
        const void* tau, const void* ssa, const void* asy, const void* lev,
        const void* emis, const void* sfc, const void* inc,
        const void* gpt2band, void* scratch, void* up, void* dn,
        void* band_up, void* band_dn, int ncol, int nlay, int ngpt,
        int nband, void* stream) {
    if (ncol == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    size_t smem = (size_t)2 * (threads / 32) * (nlay + 1) * sizeof(float)
        + (band_up ? rte::BandSums::bytes(threads, nband) : 0);
    cudaError_t err = rte::allow_smem(solver_lw_2str_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    solver_lw_2str_kernel<<<ncol, threads, smem, (cudaStream_t)stream>>>(
        (const float*)tau, (const float*)ssa, (const float*)asy,
        (const float*)lev, (const float*)emis, (const float*)sfc,
        (const float*)inc, (const int*)gpt2band, (float*)scratch,
        (float*)up, (float*)dn, (float*)band_up, (float*)band_dn, ncol, nlay,
        ngpt, nband);
    return (int)cudaGetLastError();
}
