// SW two-stream solve with broadband output: the solver of the public
// rte_sw.
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/solver_sw_kernel.py::
// sw_two_stream_broadband_lane (reference mo_rte_solver_kernels.F90:
// 503-609, 985-1127, 1135-1245). Plain twin:
// rte_rrtmgp_tpu_torch/ops/kernels/solver_sw.py::sw_2stream_plain.
//
// Layout: one block per column, one thread per g-point; tau/ssa/g
// (column, layer, g-point) with g fastest, mu0 (column, layer). Pass 1,
// top down: the Meador-Weaver coefficients with the reference's clamps
// (transport.cuh::sw_layer, the code of the fused SW kernel), night
// masking by mu0 > 0 per layer, and the direct beam. Passes 2 and 3: the
// adding sweeps (transport.cuh::sw_adding) from the diffuse flux at the
// top, over per-thread layer columns in wrapper-allocated scratch laid
// out (field, column, level, g-point). Total down = diffuse + direct.
//
// What bounds it on this card: reading tau, ssa and g, 12 B per (column,
// layer, g-point), and the scratch traffic (six fields, about 14 x 4 B
// per (column, level, g-point)).
//
// Broadband sums are deterministic: warp-shuffle sums per level into
// shared memory, then fixed-order sums of the warp partials. No atomics.
//
// Contract (checked by the Python wrapper): float32, contiguous,
// ngpt <= 1024, top of the atmosphere at layer 0.

#include "common.cuh"
#include "transport.cuh"

namespace {

__global__ void solver_sw_kernel(
        const float* __restrict__ tau, const float* __restrict__ ssa,
        const float* __restrict__ asy, const float* __restrict__ mu0,
        const float* __restrict__ alb_dir, const float* __restrict__ alb_dif,
        const float* __restrict__ inc, const float* __restrict__ inc_dif,
        float* __restrict__ scratch, float* __restrict__ out,
        int ncol, int nlay, int ngpt) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    float* p_up = smem;                       // (nwarps, nlev) each
    float* p_dn = p_up + nwarps * nlev;
    float* p_dir = p_dn + nwarps * nlev;

    const int c = blockIdx.x;
    const int g = threadIdx.x;
    const bool active = g < ngpt;
    const long long field = (long long)ncol * nlev * ngpt;
    float* R = scratch + (long long)c * nlev * ngpt + g;   // rdif
    float* T = R + field;                                  // tdif
    float* SDN = T + field;                                // source_dn
    float* SUP = SDN + field;                              // source_up, then 1/(1-r*alb)
    float* ALB = SUP + field;                              // albedo at levels
    float* SRC = ALB + field;                              // source at levels
    const long long o_lay0 = (long long)c * nlay * ngpt + g;
    const long long o_bc = (long long)c * ngpt + g;
    const float* mu_c = mu0 + (long long)c * nlay;

    // ---- pass 1: two-stream coefficients, direct beam ----
    float dir = active ? inc[o_bc] * mu_c[0] : 0.0f;
    rte::reduce_level(dir, p_dir, nlev, 0);
    for (int l = 0; l < nlay; ++l) {
        if (active) {
            long long oi = o_lay0 + (long long)l * ngpt;
            float mu = mu_c[l];
            rte::SwLayer s = rte::sw_layer(tau[oi], ssa[oi], asy[oi], mu);
            bool day = mu > 0.0f;
            long long o = (long long)l * ngpt;
            R[o] = s.rdif;
            T[o] = s.tdif;
            SUP[o] = day ? s.rdir * dir : 0.0f;
            SDN[o] = day ? s.tdir * dir : 0.0f;
            dir = dir * s.tns;
        }
        rte::reduce_level(dir, p_dir, nlev, l + 1);
    }

    // ---- passes 2 and 3: adding (Eqs 9-13) from the diffuse TOA flux ----
    float alb_sfc = 0.0f, src_sfc = 0.0f, top = 0.0f;
    if (active) {
        alb_sfc = alb_dif[o_bc];
        src_sfc = mu_c[nlay - 1] > 0.0f ? dir * alb_dir[o_bc] : 0.0f;
        top = inc_dif ? inc_dif[o_bc] : 0.0f;
    }
    rte::sw_adding(active, R, T, SDN, SUP, ALB, SRC, nlay, ngpt, alb_sfc,
                   src_sfc, top, p_up, p_dn);

    __syncthreads();
    const long long oplane = (long long)ncol * nlev;
    const long long o_out = (long long)c * nlev;
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
        float fd = rte::level_total(p_dir, nwarps, nlev, lev);
        out[o_out + lev] = rte::level_total(p_up, nwarps, nlev, lev);
        out[oplane + o_out + lev] =
            rte::level_total(p_dn, nwarps, nlev, lev) + fd;
        out[2 * oplane + o_out + lev] = fd;
    }
}

}  // namespace

extern "C" int launch_solver_sw(
        const void* tau, const void* ssa, const void* asy, const void* mu0,
        const void* alb_dir, const void* alb_dif, const void* inc,
        const void* inc_dif, void* scratch, void* out, int ncol, int nlay,
        int ngpt, void* stream) {
    if (ncol == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    size_t smem = (size_t)3 * (threads / 32) * (nlay + 1) * sizeof(float);
    cudaError_t err = rte::allow_smem(solver_sw_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    solver_sw_kernel<<<ncol, threads, smem, (cudaStream_t)stream>>>(
        (const float*)tau, (const float*)ssa, (const float*)asy,
        (const float*)mu0, (const float*)alb_dir, (const float*)alb_dif,
        (const float*)inc, (const float*)inc_dif, (float*)scratch,
        (float*)out, ncol, nlay, ngpt);
    return (int)cudaGetLastError();
}
