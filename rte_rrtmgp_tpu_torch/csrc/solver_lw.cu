// One-angle LW no-scattering solve with broadband output: the solver of
// the public rte_lw (one launch per quadrature angle).
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py::
// lw_noscat_broadband_lane (reference mo_rte_solver_kernels.F90:51-240).
// Plain twin: rte_rrtmgp_tpu_torch/ops/kernels/solver_lw.py::
// lw_noscat_plain.
//
// Layout: one block per column, one thread per g-point, sequential over
// layers; tau/lay (column, layer, g-point) and lev (column, level,
// g-point) with g fastest, so every load is coalesced. Per layer a
// thread forms exp(-tau * ds) (ds a scalar or one secant per (column,
// g-point)) and the linear-in-tau sources (transport.cuh::lw_source, the
// code of the fused LW kernel), runs the down sweep from the incident
// flux, the surface emission and reflection, and the up sweep. The
// per-layer terms are recomputed from the inputs in each sweep instead
// of being stored. Templates select Tang rescaling (ssa, g; a second
// down sweep, with the radiances of the first sweeps kept in one scratch
// field) and the surface Jacobian.
//
// What bounds it on this card: reading tau, lay and lev, 12 B per
// (column, layer, g-point), twice without rescaling (once per sweep) and
// three times with it.
//
// Broadband sums are deterministic: warp-shuffle sums per level into
// shared memory, then fixed-order sums of the warp partials, times
// pi * weight. No atomics.
//
// Contract (checked by the Python wrapper): float32, contiguous,
// ngpt <= 1024, top of the atmosphere at layer 0.

#include "common.cuh"
#include "transport.cuh"

namespace {

template <bool RESCALE>
__device__ __forceinline__ void lw_layer(
        const float* __restrict__ tau, const float* __restrict__ lay,
        const float* __restrict__ lev, const float* __restrict__ ssa,
        const float* __restrict__ asy, long long o_lay, long long o_lev,
        int ngpt, float ds, float* t, float* sdn, float* sup, float* an,
        float* cn) {
    float tl = tau[o_lay] * ds;
    if (RESCALE) {
        // Tang 2018 rescaling (reference :148-178)
        float w = ssa[o_lay];
        float wb = w * (1.0f - asy[o_lay]) * 0.5f;
        float scale = 1.0f - w + wb;
        *cn = 0.4f * wb / scale;
        tl = tl * scale;
    }
    rte::lw_source(tl, lay[o_lay], lev[o_lev], lev[o_lev + ngpt], t, sdn,
                   sup);
    if (RESCALE) *an = 1.0f - *t * *t;
}

template <bool RESCALE, bool JAC>
__global__ void solver_lw_kernel(
        const float* __restrict__ tau, const float* __restrict__ lay,
        const float* __restrict__ lev, const float* __restrict__ ssa,
        const float* __restrict__ asy, const float* __restrict__ emis,
        const float* __restrict__ sfc, const float* __restrict__ sfc_jac,
        const float* __restrict__ inc, const float* __restrict__ ds_field,
        float* __restrict__ scratch, float* __restrict__ up,
        float* __restrict__ dn, float* __restrict__ jac,
        int nlay, int ngpt, float ds_scalar, float piw) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nwarps = blockDim.x >> 5;
    float* p_up = smem;                       // (nwarps, nlev) each
    float* p_dn = p_up + nwarps * nlev;
    float* p_jac = p_dn + nwarps * nlev;

    const int c = blockIdx.x;
    const int g = threadIdx.x;
    const bool active = g < ngpt;
    const long long o_lay0 = (long long)c * nlay * ngpt + g;
    const long long o_lev0 = (long long)c * nlev * ngpt + g;
    const long long o_bc = (long long)c * ngpt + g;
    float* rad = scratch + o_lay0;            // RESCALE: radiance at layer tops
    float ds = 0.0f, rdn_top = 0.0f;
    if (active) {
        ds = ds_field ? ds_field[o_bc] : ds_scalar;
        rdn_top = inc[o_bc] / piw;
    }
    float t = 0.0f, sdn = 0.0f, sup = 0.0f, an = 0.0f, cn = 0.0f;

    // ---- down sweep (reference lw_transport_noscat_dn :681-708) ----
    float rdn = rdn_top;
    if (!RESCALE) rte::reduce_level(rdn, p_dn, nlev, 0);
    for (int l = 0; l < nlay; ++l) {
        if (active) {
            lw_layer<RESCALE>(tau, lay, lev, ssa, asy,
                              o_lay0 + (long long)l * ngpt,
                              o_lev0 + (long long)l * ngpt, ngpt, ds, &t,
                              &sdn, &sup, &an, &cn);
            if (RESCALE) rad[(long long)l * ngpt] = rdn;
            rdn = t * rdn + sdn;
        }
        if (!RESCALE) rte::reduce_level(rdn, p_dn, nlev, l + 1);
    }

    // ---- surface emission + reflection (:198-202), then the up sweep ----
    float rup = 0.0f, rjac = 0.0f;
    if (active) {
        float e = emis[o_bc];
        rup = rdn * (1.0f - e) + e * sfc[o_bc];
        if (JAC) rjac = e * sfc_jac[o_bc];
    }
    rte::reduce_level(rup, p_up, nlev, nlay);
    if (JAC) rte::reduce_level(rjac, p_jac, nlev, nlay);
    for (int l = nlay - 1; l >= 0; --l) {
        if (active) {
            lw_layer<RESCALE>(tau, lay, lev, ssa, asy,
                              o_lay0 + (long long)l * ngpt,
                              o_lev0 + (long long)l * ngpt, ngpt, ds, &t,
                              &sdn, &sup, &an, &cn);
            rup = t * rup + sup;
            if (RESCALE) {
                // adjustment from the downwelling radiance at the layer's
                // top edge (reference lw_transport_1rescl :784-793)
                float* r = rad + (long long)l * ngpt;
                rup = rup + cn * (an * *r - t * sdn - sup);
                *r = rup;
            }
            if (JAC) rjac = t * rjac;
        }
        rte::reduce_level(rup, p_up, nlev, l);
        if (JAC) rte::reduce_level(rjac, p_jac, nlev, l);
    }

    if (RESCALE) {
        // ---- second down sweep, adjusted from the upwelling field ----
        rdn = rdn_top;
        rte::reduce_level(rdn, p_dn, nlev, 0);
        for (int l = 0; l < nlay; ++l) {
            if (active) {
                lw_layer<RESCALE>(tau, lay, lev, ssa, asy,
                                  o_lay0 + (long long)l * ngpt,
                                  o_lev0 + (long long)l * ngpt, ngpt, ds,
                                  &t, &sdn, &sup, &an, &cn);
                float adj = cn * (an * rad[(long long)l * ngpt] - t * sup
                                  - sdn);
                rdn = t * rdn + sdn + adj;
            }
            rte::reduce_level(rdn, p_dn, nlev, l + 1);
        }
    }

    __syncthreads();
    const long long o_out = (long long)c * nlev;
    for (int lev_i = threadIdx.x; lev_i < nlev; lev_i += blockDim.x) {
        up[o_out + lev_i] = piw * rte::level_total(p_up, nwarps, nlev, lev_i);
        dn[o_out + lev_i] = piw * rte::level_total(p_dn, nwarps, nlev, lev_i);
        if (JAC)
            jac[o_out + lev_i] = piw * rte::level_total(p_jac, nwarps, nlev,
                                                        lev_i);
    }
}

template <bool RESCALE, bool JAC>
cudaError_t launch(const void* tau, const void* lay, const void* lev,
                   const void* ssa, const void* asy, const void* emis,
                   const void* sfc, const void* sfc_jac, const void* inc,
                   const void* ds_field, void* scratch, void* up, void* dn,
                   void* jac, int ncol, int nlay, int ngpt, float ds_scalar,
                   float piw, cudaStream_t stream) {
    int threads = (ngpt + 31) / 32 * 32;
    size_t smem = (size_t)3 * (threads / 32) * (nlay + 1) * sizeof(float);
    cudaError_t err = rte::allow_smem(solver_lw_kernel<RESCALE, JAC>, smem);
    if (err != cudaSuccess) return err;
    solver_lw_kernel<RESCALE, JAC><<<ncol, threads, smem, stream>>>(
        (const float*)tau, (const float*)lay, (const float*)lev,
        (const float*)ssa, (const float*)asy, (const float*)emis,
        (const float*)sfc, (const float*)sfc_jac, (const float*)inc,
        (const float*)ds_field, (float*)scratch, (float*)up, (float*)dn,
        (float*)jac, nlay, ngpt, ds_scalar, piw);
    return cudaGetLastError();
}

}  // namespace

extern "C" int launch_solver_lw(
        const void* tau, const void* lay, const void* lev, const void* ssa,
        const void* asy, const void* emis, const void* sfc,
        const void* sfc_jac, const void* inc, const void* ds_field,
        void* scratch, void* up, void* dn, void* jac,
        int ncol, int nlay, int ngpt, float ds_scalar, float piw,
        void* stream) {
    if (ncol == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    bool rescale = ssa != nullptr, jacobian = jac != nullptr;
    cudaError_t err;
    if (rescale && jacobian)
        err = launch<true, true>(tau, lay, lev, ssa, asy, emis, sfc, sfc_jac,
                                 inc, ds_field, scratch, up, dn, jac, ncol,
                                 nlay, ngpt, ds_scalar, piw, s);
    else if (rescale)
        err = launch<true, false>(tau, lay, lev, ssa, asy, emis, sfc,
                                  sfc_jac, inc, ds_field, scratch, up, dn,
                                  jac, ncol, nlay, ngpt, ds_scalar, piw, s);
    else if (jacobian)
        err = launch<false, true>(tau, lay, lev, ssa, asy, emis, sfc,
                                  sfc_jac, inc, ds_field, scratch, up, dn,
                                  jac, ncol, nlay, ngpt, ds_scalar, piw, s);
    else
        err = launch<false, false>(tau, lay, lev, ssa, asy, emis, sfc,
                                   sfc_jac, inc, ds_field, scratch, up, dn,
                                   jac, ncol, nlay, ngpt, ds_scalar, piw, s);
    return (int)err;
}
