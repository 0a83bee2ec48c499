// Adjoint of the SW two-stream solve with broadband output (the public
// layout of launch_solver_sw).
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/solver_sw_bwd.py::
// _sw_bwd_lane (pallas_call :402; derivation :12-25, :51-374). Plain
// twin: torch.autograd.grad of rte_rrtmgp_tpu_torch/ops/kernels/
// solver_sw.py::sw_2stream_plain (ops/kernels/solver_sw_bwd.py::
// sw_2stream_bwd_plain).
//
// Layout: one block per column, one thread per g-point, as the forward
// kernel. Per thread (transport_bwd.cuh::sw_adjoint): three passes
// compute the direct beam, the adding build and the diffuse flux; then
// the adjoints of the diffuse sweep (up), of the adding build (down) and
// of the beam with the Meador-Weaver chain (up). Every pass recomputes
// the layer coefficients it needs from tau, ssa, g and mu0 and loads the
// next level's values before it works on the current one. The cotangents
// of tau, ssa and g have one owner each. The mu0 cotangent of a layer is
// a sum over the column's g-points: warp-shuffle sums into shared
// memory, then a fixed-order sum of the warp partials (deterministic, no
// atomics).
//
// What bounds it on this card: the scratch traffic and its latency, five
// float fields of (column, level, g-point) (transport_bwd.cuh::
// SwScratch) written once and read two or three times, against the 36 B
// per (column, layer, g-point) the function must move, in six dependent
// sweeps; the Meador-Weaver chain's about 300 operations per (column,
// layer, g-point) stay below the float32 rate.
//
// Contract (checked by the Python wrapper): float32, contiguous, ngpt <=
// 1024, top of the atmosphere at layer 0.

#include "common.cuh"
#include "transport_bwd.cuh"

namespace {

struct Col {
    const float* tau;
    const float* ssa;
    const float* asy;
    const float* mu0;      // this column's (nlay,) cosines
    int ls;
    __device__ void layer(int l, float* t, float* w0, float* g,
                          float* mu) const {
        long long o = (long long)l * ls;
        *t = __ldg(tau + o);
        *w0 = __ldg(ssa + o);
        *g = __ldg(asy + o);
        *mu = __ldg(mu0 + l);
    }
};

struct Sink {
    float* tau_b;
    float* ssa_b;
    float* g_b;
    float* p_mu;           // (nwarps, nlay) warp partials of mu0's cotangent
    int ls, nlay;
    bool active;
    __device__ void layer(int l, const rte::SwBars& b) {
        if (active) {
            long long o = (long long)l * ls;
            tau_b[o] = b.t;
            ssa_b[o] = b.w0;
            g_b[o] = b.asym;
        }
        rte::reduce_level(b.mu, p_mu, nlay, l);
    }
};

__global__ void solver_sw_bwd_kernel(
        const float* __restrict__ tau, const float* __restrict__ ssa,
        const float* __restrict__ asy, const float* __restrict__ mu0,
        const float* __restrict__ alb_dir, const float* __restrict__ alb_dif,
        const float* __restrict__ inc, const float* __restrict__ inc_dif,
        const float* __restrict__ gup, const float* __restrict__ gdn,
        const float* __restrict__ gdir, float* scratch, float* tau_b,
        float* ssa_b, float* g_b, float* mu0_b, float* alb_dir_b,
        float* alb_dif_b, float* inc_b, float* inc_dif_b, int ncol,
        int nlay, int ngpt) {
    extern __shared__ float smem[];
    const int nwarps = blockDim.x >> 5;
    float* p_mu = smem;                        // (nwarps, nlay)
    float* p_seed = p_mu + nwarps * nlay;      // (nwarps, 1)
    const int c = blockIdx.x;
    const int nlev = nlay + 1;
    const bool active = threadIdx.x < ngpt;
    const int g = active ? threadIdx.x : 0;
    const long long lay0 = (long long)c * nlay * ngpt + g;
    const long long bc = (long long)c * ngpt + g;
    const long long field = (long long)ncol * nlev * ngpt;
    float* lev0 = scratch + (long long)c * nlev * ngpt + g;
    const rte::SwScratch S{lev0, lev0 + field, lev0 + 2 * field,
                           lev0 + 3 * field, scratch + 4 * field + lay0,
                           ngpt};
    Col col{tau + lay0, ssa + lay0, asy + lay0, mu0 + (long long)c * nlay,
            ngpt};
    Sink sink{tau_b + lay0, ssa_b + lay0, g_b + lay0, p_mu, ngpt, nlay,
              active};
    const long long cl = (long long)c * nlev;
    rte::SwBoundaryBars bb = rte::sw_adjoint<true>(
        active, col, nlay, active ? __ldg(inc + bc) : 0.0f,
        active ? __ldg(alb_dir + bc) : 0.0f,
        active ? __ldg(alb_dif + bc) : 0.0f,
        active ? __ldg(inc_dif + bc) : 0.0f, gup + cl, gdn + cl, gdir + cl,
        1, S, sink);
    if (active) {
        alb_dir_b[bc] = bb.alb_dir;
        alb_dif_b[bc] = bb.alb_dif;
        inc_b[bc] = bb.inc;
        inc_dif_b[bc] = bb.inc_dif;
    }
    rte::reduce_level(bb.mu_top, p_seed, 1, 0);
    __syncthreads();
    for (int l = threadIdx.x; l < nlay; l += blockDim.x) {
        float s = rte::level_total(p_mu, nwarps, nlay, l);
        if (l == 0) s += rte::level_total(p_seed, nwarps, 1, 0);
        mu0_b[(long long)c * nlay + l] = s;
    }
}

}  // namespace

// Resident blocks per SM of the kernel for ngpt g-points and nlay
// layers, or a negative CUDA error.
extern "C" int occupancy_solver_sw_bwd(int ngpt, int nlay) {
    int threads = (ngpt + 31) / 32 * 32;
    size_t smem = (size_t)(threads / 32) * (nlay + 1) * sizeof(float);
    cudaError_t err = rte::allow_smem(solver_sw_bwd_kernel, smem);
    int n = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, solver_sw_bwd_kernel, threads, smem);
    return err == cudaSuccess ? n : -(int)err;
}

extern "C" int launch_solver_sw_bwd(
        const void* tau, const void* ssa, const void* asy, const void* mu0,
        const void* alb_dir, const void* alb_dif, const void* inc,
        const void* inc_dif, const void* gup, const void* gdn,
        const void* gdir, void* scratch, void* tau_b, void* ssa_b,
        void* g_b, void* mu0_b, void* alb_dir_b, void* alb_dif_b,
        void* inc_b, void* inc_dif_b, int ncol, int nlay, int ngpt,
        void* stream) {
    if (ncol == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    size_t smem = (size_t)(threads / 32) * (nlay + 1) * sizeof(float);
    cudaError_t err = rte::allow_smem(solver_sw_bwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    solver_sw_bwd_kernel<<<ncol, threads, smem, (cudaStream_t)stream>>>(
        (const float*)tau, (const float*)ssa, (const float*)asy,
        (const float*)mu0, (const float*)alb_dir, (const float*)alb_dif,
        (const float*)inc, (const float*)inc_dif, (const float*)gup,
        (const float*)gdn, (const float*)gdir, (float*)scratch,
        (float*)tau_b, (float*)ssa_b, (float*)g_b, (float*)mu0_b,
        (float*)alb_dir_b, (float*)alb_dif_b, (float*)inc_b,
        (float*)inc_dif_b, ncol, nlay, ngpt);
    return (int)cudaGetLastError();
}
