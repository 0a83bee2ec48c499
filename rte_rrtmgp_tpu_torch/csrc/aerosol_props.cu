// MERRA/GOCART aerosol optics by band, alone or folded into the clouds'.
//
// No TPU kernel corresponds: the JAX package forms these in plain JAX
// (rte_rrtmgp_tpu/models/rrtmgp/aerosol_optics.py::_tau_triplet). Plain
// twin: rte_rrtmgp_tpu_torch/ops/kernels/aerosol_props.py::
// aerosol_props_plain (reference mo_aerosol_optics_rrtmgp_merra.F90,
// compute_aerosol_optics).
//
// Per (column, layer) cell: the size bin (the last bin whose [lo, hi]
// holds the size), the RH pair and weight (irh2 the first grid point
// >= rh, irh1 the one below, weight 0 below the grid, above it or on the
// first point), the rows of the species in the concatenated
// (species, rh, bin) table (row 0 is zero: type 0 or unknown), then per
// band
//   v_q = lo_q + w * (hi_q - lo_q),  tau = mass * v_ext,
//   tau*ssa = tau * v_ssa,  tau*ssa*g = tau*ssa * v_g
// and, by mode:
//   0 lanes: (tau, tau*ssa, tau*ssa*g), (3, nbnd, nlay, ncol);
//   1 LW:    the absorption tau - tau*ssa, plus the clouds' (ct - cts)
//            where they are given, (nbnd, nlay, ncol);
//   2 SW:    the delta-scaled (f = g^2) aerosols combined with the
//            delta-scaled clouds where they are given (the tau-weighted
//            sum of increment_2stream_by_2stream), (3, nbnd, nlay, ncol)
//            = (tau, ssa, g).
//
// What bounds it on this card: memory traffic (16 B of per-cell input,
// the clouds' lanes where folded, the output lanes; the table of a few
// tens of KB stays in L1/L2). The design: one thread per cell looping
// over the bands, so the per-cell lookup is done once; a block is 32
// columns x 8 layers, so each warp's output writes (cell index
// lay * ncol + col, column fastest) are 128 B runs, and the 8 warps of a
// block share the 32 B sectors of their (ncol, nlay) inputs through L1.
// The mode is a template parameter and the band loop is unrolled by 4,
// so that the loads of several bands are in flight at once.
//
// Contract (checked by the Python wrapper): float32 data, int32 types,
// contiguous (ncol, nlay) inputs and (nbnd, nlay, ncol) cloud lanes.

#include "common.cuh"

namespace {

enum { kLanes = 0, kLW = 1, kSW = 2 };

struct Offsets {
    int dust, salt, sulf, bcar_rh, bcar, ocar_rh, ocar;
};

// The delta-Eddington-scaled (tau, ssa, g), f = g^2, of (tau, tau*ssa,
// tau*ssa*g) (the twin's delta_scaled_band).
__device__ __forceinline__ void delta_scaled(float t, float ts, float tsg,
                                             float& dt, float& dssa,
                                             float& dg) {
    const float eps = 1.1920928955078125e-07f;    // FLT_EPSILON
    const float tiny = 1.1754943508222875e-38f;   // FLT_MIN
    if (ts == 0.0f && tsg == 0.0f) {
        // what the divisions below give (ssa = g = 0), without them: a
        // division of 0 takes the division's slow path, and most cells
        // hold no aerosol or no cloud
        dt = t;
        dssa = 0.0f;
        dg = 0.0f;
        return;
    }
    float g = tsg / fmaxf(ts, eps);
    float ssa = ts / fmaxf(t, eps);
    float f = g * g;
    float wf = ssa * f;
    dt = (1.0f - wf) * t;
    dssa = wf < 1.0f ? (ssa - wf) / fmaxf(1.0f - wf, tiny) : 0.0f;
    dg = f < 1.0f ? (g - f) / fmaxf(1.0f - f, tiny) : 0.0f;
}

template <int kMode>
__global__ void aerosol_props_kernel(
        const int* __restrict__ atype, const float* __restrict__ size,
        const float* __restrict__ mass, const float* __restrict__ rh,
        const float* __restrict__ bin_lims, const float* __restrict__ rh_grid,
        const float* __restrict__ table, const float* __restrict__ c_t,
        const float* __restrict__ c_ts, const float* __restrict__ c_tsg,
        float* __restrict__ out, int ncol, int nlay, int nbnd, int nbin,
        int nrh, Offsets off) {
    int col = blockIdx.x * 32 + threadIdx.x;
    int lay = blockIdx.y * 8 + threadIdx.y;
    if (col >= ncol || lay >= nlay) return;
    int in = col * nlay + lay;
    int kind = atype[in];
    float s = size[in];
    float m = mass[in];
    float h = rh[in];

    int ibin = 0;
    for (int i = 0; i < nbin; ++i)
        if (s >= __ldg(bin_lims + i) && s <= __ldg(bin_lims + nbin + i))
            ibin = i;
    int nbelow = 0;
    for (int i = 0; i < nrh; ++i) nbelow += h > __ldg(rh_grid + i);
    int irh1 = nbelow == 0 ? 0 : min(nbelow, nrh) - 1;
    int irh2 = min(nbelow, nrh - 1);
    float w = 0.0f;
    if (irh1 != irh2) {
        float g1 = __ldg(rh_grid + irh1);
        w = (h - g1) / (__ldg(rh_grid + irh2) - g1);
    }
    int r1 = 0, r2 = 0;
    switch (kind) {
        case 1: r1 = r2 = off.dust + ibin; break;
        case 2: r1 = off.salt + irh1 * nbin + ibin;
                r2 = off.salt + irh2 * nbin + ibin; break;
        case 3: r1 = off.sulf + irh1; r2 = off.sulf + irh2; break;
        case 4: r1 = off.bcar_rh + irh1; r2 = off.bcar_rh + irh2; break;
        case 5: r1 = r2 = off.bcar; break;
        case 6: r1 = off.ocar_rh + irh1; r2 = off.ocar_rh + irh2; break;
        case 7: r1 = r2 = off.ocar; break;
        default: break;
    }
    const float* lo = table + (long long)r1 * 3 * nbnd;
    const float* hi = table + (long long)r2 * 3 * nbnd;
    long long ncell = (long long)ncol * nlay;
    long long plane = ncell * nbnd;
    long long cell = (long long)lay * ncol + col;
#pragma unroll 4
    for (int b = 0; b < nbnd; ++b) {
        float v[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            float a = __ldg(lo + q * nbnd + b);
            v[q] = a + w * (__ldg(hi + q * nbnd + b) - a);
        }
        float t = m * v[0];
        float ts = t * v[1];
        float tsg = ts * v[2];
        long long o = b * ncell + cell;
        if (kMode == kLanes) {
            out[o] = t;
            out[plane + o] = ts;
            out[2 * plane + o] = tsg;
        } else if (kMode == kLW) {
            float a = t - ts;
            out[o] = c_t != nullptr ? (c_t[o] - c_ts[o]) + a : a;
        } else {
            float at, assa, ag;
            delta_scaled(t, ts, tsg, at, assa, ag);
            if (c_t != nullptr) {
                // the clouds' delta-scaled increment combined with the
                // aerosols' (the twin's combine_band_2str)
                const float tiny = 1.1754943508222875e-38f;
                float ct, cssa, cg;
                delta_scaled(c_t[o], c_ts[o], c_tsg[o], ct, cssa, cg);
                // each division only where its result is kept
                float tt = ct + at;
                float scat = ct * cssa + at * assa;
                float gg = 0.0f, ssa = 0.0f;
                if (scat > 2.0f * tiny)
                    gg = (ct * cssa * cg + at * assa * ag) / scat;
                if (tt > 2.0f * tiny) ssa = scat / tt;
                at = tt;
                assa = ssa;
                ag = gg;
            }
            out[o] = at;
            out[plane + o] = assa;
            out[2 * plane + o] = ag;
        }
    }
}

}  // namespace

extern "C" {

int launch_aerosol_props(const void* atype, const void* size,
                         const void* mass, const void* rh,
                         const void* bin_lims, const void* rh_grid,
                         const void* table, const void* c_t,
                         const void* c_ts, const void* c_tsg, void* out,
                         int ncol, int nlay, int nbnd, int nbin, int nrh,
                         int dust, int salt, int sulf, int bcar_rh, int bcar,
                         int ocar_rh, int ocar, int mode, void* stream) {
    if ((long long)ncol * nlay == 0) return 0;
    Offsets off{dust, salt, sulf, bcar_rh, bcar, ocar_rh, ocar};
    dim3 block(32, 8);
    dim3 grid((unsigned)((ncol + 31) / 32), (unsigned)((nlay + 7) / 8));
    auto kernel = mode == kLanes ? aerosol_props_kernel<kLanes>
                  : mode == kLW  ? aerosol_props_kernel<kLW>
                                 : aerosol_props_kernel<kSW>;
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int*)atype, (const float*)size, (const float*)mass,
        (const float*)rh, (const float*)bin_lims, (const float*)rh_grid,
        (const float*)table, (const float*)c_t, (const float*)c_ts,
        (const float*)c_tsg, (float*)out, ncol, nlay, nbnd, nbin, nrh, off);
    return (int)cudaGetLastError();
}

}  // extern "C"
