// Adjoint of the one-angle LW no-scattering solve with broadband output
// (the public layout of launch_solver_lw: a scalar secant, no rescaling,
// no Jacobian).
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/solver_lw_bwd.py::
// _lw_bwd_lane (pallas_call :207; derivation :12-44). Plain twin:
// torch.autograd.grad of rte_rrtmgp_tpu_torch/ops/kernels/solver_lw.py::
// lw_noscat_plain (ops/kernels/solver_lw_bwd.py::lw_noscat_bwd_plain).
//
// Layout: one block per column, one thread per g-point, as the forward
// kernel. Per thread (transport_bwd.cuh::lw_adjoint): a down pass
// recomputes the layer terms from tau and the sources and keeps, per
// layer, the downward radiance and the cotangent of the upward radiance
// (carried top down from the flux cotangents); the up pass recomputes the
// layer terms again, runs the up sweep forward and the down sweep's
// adjoint backward, and turns each layer's cotangents into those of tau
// and the sources. The two kept fields live in the tau and lay_source
// cotangent outputs, each read just before its own layer's cotangent is
// written there, so the kernel needs no scratch. Every (column, g-point)
// cotangent has one owner: no sums across threads, nothing to reduce.
//
// What bounds it on this card: the bytes. Inputs tau, lay (ncol, nlay,
// ngpt) and lev (ncol, nlay+1, ngpt) are read twice, the outputs written
// once plus the kept fields' write and read: about 28 B per (column,
// layer, g-point) against the 24 B the function must move.
//
// Contract (checked by the Python wrapper): float32, contiguous, ngpt <=
// 1024, top of the atmosphere at layer 0.

#include "common.cuh"
#include "transport_bwd.cuh"

namespace {

struct Col {
    const float* tau;
    const float* lay;
    const float* lev;
    int ls;
    float ds;
    float ssrc;
    __device__ void layer(int l, float* tl, float* ly, float* top,
                          float* bot) const {
        *tl = __ldg(tau + (long long)l * ls) * ds;
        *ly = __ldg(lay + (long long)l * ls);
        *top = __ldg(lev + (long long)l * ls);
        *bot = __ldg(lev + (long long)(l + 1) * ls);
    }
    __device__ void down(int l, float* tl, float* ly, float* top,
                         float* bot) const {
        layer(l, tl, ly, top, bot);
    }
    __device__ void up(int l, float* tl, float* ly, float* top,
                       float* bot) const {
        layer(l, tl, ly, top, bot);
    }
    __device__ float surface_source() const { return ssrc; }
};

struct Sink {
    float* tau_b;
    float* lay_b;
    float* lev_b;
    float* emis_b;
    float* ssrc_b;
    float* inc_b;
    int ls;
    float ds;
    bool active;
    float levt_next;        // top-level cotangent of the layer below
    __device__ void surface(float e, float s) {
        if (active) {
            *emis_b = e;
            *ssrc_b = s;
        }
    }
    __device__ void layer(int l, const rte::LwBars& b) {
        if (!active) return;
        tau_b[(long long)l * ls] = b.tl * ds;
        lay_b[(long long)l * ls] = b.lay;
        lev_b[(long long)(l + 1) * ls] = b.bot + levt_next;
        levt_next = b.top;
    }
    __device__ void top(float inc) {
        if (!active) return;
        *inc_b = inc;
        lev_b[0] = levt_next;
    }
};

__global__ void solver_lw_bwd_kernel(
        const float* __restrict__ tau, const float* __restrict__ lay,
        const float* __restrict__ lev, const float* __restrict__ emis,
        const float* __restrict__ ssrc, const float* __restrict__ inc,
        const float* __restrict__ gup, const float* __restrict__ gdn,
        float* tau_b, float* lay_b, float* lev_b, float* emis_b,
        float* ssrc_b, float* inc_b, int nlay, int ngpt, float ds,
        float piw) {
    const int c = blockIdx.x;
    const bool active = threadIdx.x < ngpt;
    const int g = active ? threadIdx.x : 0;
    const long long lay0 = (long long)c * nlay * ngpt + g;
    const long long lev0 = (long long)c * (nlay + 1) * ngpt + g;
    const long long bc = (long long)c * ngpt + g;
    float e = active ? __ldg(emis + bc) : 0.0f;
    float s = active ? __ldg(ssrc + bc) : 0.0f;
    float i = active ? __ldg(inc + bc) : 0.0f;
    Col col{tau + lay0, lay + lay0, lev + lev0, ngpt, ds, s};
    Sink sink{tau_b + lay0, lay_b + lay0, lev_b + lev0, emis_b + bc,
              ssrc_b + bc, inc_b + bc, ngpt, ds, active, 0.0f};
    // the kept radiances in the tau and lay_source cotangents
    rte::lw_adjoint(active, col, nlay, piw, i, e,
                    gup + (long long)c * (nlay + 1),
                    gdn + (long long)c * (nlay + 1), 1, tau_b + lay0,
                    lay_b + lay0, ngpt, sink);
}

}  // namespace

// Resident blocks per SM of the kernel for ngpt g-points, or a negative
// CUDA error.
extern "C" int occupancy_solver_lw_bwd(int ngpt) {
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, solver_lw_bwd_kernel, (ngpt + 31) / 32 * 32, 0);
    return err == cudaSuccess ? n : -(int)err;
}

extern "C" int launch_solver_lw_bwd(
        const void* tau, const void* lay, const void* lev, const void* emis,
        const void* ssrc, const void* inc, const void* gup, const void* gdn,
        void* tau_b, void* lay_b, void* lev_b, void* emis_b, void* ssrc_b,
        void* inc_b, int ncol, int nlay, int ngpt, float ds, float piw,
        void* stream) {
    if (ncol == 0) return 0;
    int threads = (ngpt + 31) / 32 * 32;
    solver_lw_bwd_kernel<<<ncol, threads, 0, (cudaStream_t)stream>>>(
        (const float*)tau, (const float*)lay, (const float*)lev,
        (const float*)emis, (const float*)ssrc, (const float*)inc,
        (const float*)gup, (const float*)gdn, (float*)tau_b, (float*)lay_b,
        (float*)lev_b, (float*)emis_b, (float*)ssrc_b, (float*)inc_b, nlay,
        ngpt, ds, piw);
    return (int)cudaGetLastError();
}
