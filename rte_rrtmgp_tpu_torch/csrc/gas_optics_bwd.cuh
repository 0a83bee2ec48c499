// Adjoints of the gas-optics lookups in common.cuh (major_tau,
// minor_tau, rayleigh_k) and the per-cell sums of their cotangents over a
// column's g-points, for the fused backward kernels (fused_lw_bwd.cu,
// fused_sw_bwd.cu). The derivation is that of the JAX package's fused
// adjoints (rte_rrtmgp_tpu/ops/pallas/fused_lw_bwd.py:19-36, the major,
// minor and cloud adjoints; fused_sw_bwd.py:21-24, Rayleigh).
//
// A descriptor of one cell (ftemp, fpress, feta and col_mix per flavor,
// the minor scaling rows) is read by every g-point of the column, so its
// cotangent is a sum over g-points: ftemp and fpress over all of them,
// feta and col_mix per flavor (the flavor of a g-point is its band's, in
// the cell's atmosphere), the minor scaling over the minor's g-point
// window, the by-band cloud inputs over the band. The sums are
// deterministic: each thread leaves its g-point's terms in shared memory,
// then one thread per output sums them in g-point order (no atomics; two
// runs on the same inputs give the same bits).
#pragma once

#include "common.cuh"

namespace rte {

// Cotangents of one (cell, g-point)'s descriptor reads through the major
// lookup: ftemp, fpress, and feta/col_mix at the g-point's flavor for
// each temperature corner.
struct MajorBars {
    float ft, fp, fe[2], cm[2];
};

// Adjoint of major_tau: tb, pb the cotangents of tau and of the Planck
// fraction (pb unused without pfrac_tab).
__device__ __forceinline__ MajorBars major_adjoint(
        const CellDesc& d, int flav, int nflav, int ncell, int cell,
        const int* __restrict__ jeta, const float* __restrict__ feta,
        const float* __restrict__ col_mix, const float* __restrict__ kmajor,
        const float* __restrict__ pfrac_tab, int neta, int npres1, int ngpt,
        int g, float tb, float pb) {
    MajorBars r = {0.0f, 0.0f, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * nflav + flav) * ncell + cell;
        int je = jeta[fi];
        float fe = feta[fi];
        float cm = col_mix[fi];
        float ftv = it == 0 ? 1.0f - d.ft : d.ft;
        float st = it == 0 ? -1.0f : 1.0f;
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
            float fpv = dp == 0 ? 1.0f - d.fp : d.fp;
            float sp = dp == 0 ? -1.0f : 1.0f;
#pragma unroll
            for (int de = 0; de < 2; ++de) {
                float fev = de == 0 ? 1.0f - fe : fe;
                float se = de == 0 ? -1.0f : 1.0f;
                long long k = ((long long)(((d.jt + it) * neta + je + de)
                                           * npres1 + d.jp + dp)) * ngpt + g;
                float kv = __ldg(kmajor + k);
                float a = cm * kv * tb;
                if (pfrac_tab) a += __ldg(pfrac_tab + k) * pb;
                r.ft += st * (fev * fpv) * a;
                r.fp += sp * (fev * ftv) * a;
                r.fe[it] += se * (ftv * fpv) * a;
                r.cm[it] += (fev * ftv * fpv) * kv * tb;
            }
        }
    }
    return r;
}

// Adjoint of rayleigh_k for the cotangent kb of k: adds to the ftemp and
// feta terms of the cell's major flavor.
__device__ __forceinline__ void rayleigh_adjoint(
        const CellDesc& d, int flav, int nflav, int ncell, int cell,
        const int* __restrict__ jeta, const float* __restrict__ feta,
        const float* __restrict__ krayl, int neta, int ngpt, int g, float kb,
        MajorBars* r) {
    int atm = d.lower ? 0 : 1;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * nflav + flav) * ncell + cell;
        int je = jeta[fi];
        float fe = feta[fi];
        float ftv = it == 0 ? 1.0f - d.ft : d.ft;
        long long base = ((long long)((d.jt + it) * neta + je) * ngpt + g);
        float lo = __ldg(krayl + base * 2 + atm);
        float hi = __ldg(krayl + (base + ngpt) * 2 + atm);
        r->fe[it] += ftv * (hi - lo) * kb;
        r->ft += (it == 0 ? -1.0f : 1.0f) * ((1.0f - fe) * lo + fe * hi) * kb;
    }
}

// Shared-memory staging of one layer's per-g-point terms (each an array
// of blockDim entries) and of the per-minor and per-flavor partials.
struct GasBarsSmem {
    float* tb;             // cotangent of the gas tau (the minors' input)
    float* fe[2];
    float* cm[2];
    float* ft;
    float* fp;
    float* dense;          // a third all-g sum (SW: rayscale), or null
    float* band[3];        // by-band sums (LW: 1, SW: 3 cloud inputs)
    float* mfe[2];         // (nminor,) per minor
    float* mft;            // (nminor,)
    float* major_fe[2];    // (nflav,)
    float* ft_total;       // (1,)
    int* meta;             // (nminor, kMetaFields)

    // floats needed for blockDim threads, nminor minors and nflav flavors
    __host__ __device__ static int floats(int threads, int nminor,
                                          int nflav) {
        return 11 * threads + 3 * nminor + 2 * nflav + 1;
    }

    __device__ static GasBarsSmem carve(float* p, int threads, int nminor,
                                        int nflav) {
        GasBarsSmem s;
        s.tb = p;
        s.fe[0] = p + threads;
        s.fe[1] = p + 2 * threads;
        s.cm[0] = p + 3 * threads;
        s.cm[1] = p + 4 * threads;
        s.ft = p + 5 * threads;
        s.fp = p + 6 * threads;
        s.dense = p + 7 * threads;
        s.band[0] = p + 8 * threads;
        s.band[1] = p + 9 * threads;
        s.band[2] = p + 10 * threads;
        float* q = p + 11 * threads;
        s.mfe[0] = q;
        s.mfe[1] = q + nminor;
        s.mft = q + 2 * nminor;
        s.major_fe[0] = q + 3 * nminor;
        s.major_fe[1] = q + 3 * nminor + nflav;
        s.ft_total = q + 3 * nminor + 2 * nflav;
        return s;
    }
};

// Where the per-cell cotangents go; a null pointer is not written.
struct GasBarsOut {
    float* ftemp;          // (ncell,)
    float* fpress;         // (ncell,)
    float* feta;           // (2, nflav, ncell)
    float* col_mix;        // (2, nflav, ncell)
    float* msc;            // (nminor, ncell)
    float* dense;          // (ncell,) the third all-g sum, or null
    float* band;           // (nband_out, nbnd, ncell), or null
    int nband_out;         // 1 (LW cloud) or 3 (SW cloud), 0 without
    int nbnd;
};

// Per-cell sums of one layer's terms, after every thread has written its
// g-point's entries of sm (tb, fe, cm, ft, fp, and dense and band where
// used). Every thread of the block calls it; it ends with a barrier, so
// the staging may be reused for the next layer.
__device__ __forceinline__ void gas_bars_reduce(
        const GasBarsSmem& sm, const GasBarsOut& out, const CellDesc& d,
        int cell, int ncell, int ngpt, int nflav, int nminor,
        const int* __restrict__ gflav, const int* __restrict__ gpt2band,
        const int* __restrict__ jeta, const float* __restrict__ feta,
        const float* __restrict__ msc, const float* __restrict__ klo,
        const float* __restrict__ kup, int ncl, int ncu, int neta) {
    __syncthreads();
    const int* flav_of = gflav + (d.lower ? 0 : 1) * ngpt;
    const int r_band = nflav;
    const int r_minor = r_band + out.nbnd;
    const int r_ft = r_minor + nminor;
    const int nroles = r_ft + 3;
    for (int r = threadIdx.x; r < nroles; r += blockDim.x) {
        if (r < r_band) {
            // feta (major part) and col_mix of flavor r
            float fe0 = 0.0f, fe1 = 0.0f, cm0 = 0.0f, cm1 = 0.0f;
            for (int g = 0; g < ngpt; ++g) {
                if (__ldg(flav_of + g) != r) continue;
                fe0 += sm.fe[0][g];
                fe1 += sm.fe[1][g];
                cm0 += sm.cm[0][g];
                cm1 += sm.cm[1][g];
            }
            sm.major_fe[0][r] = fe0;
            sm.major_fe[1][r] = fe1;
            out.col_mix[(long long)r * ncell + cell] = cm0;
            out.col_mix[(long long)(nflav + r) * ncell + cell] = cm1;
        } else if (r < r_minor) {
            // by-band inputs of band b
            int b = r - r_band;
            for (int q = 0; q < out.nband_out; ++q) {
                float s = 0.0f;
                for (int g = 0; g < ngpt; ++g)
                    if (__ldg(gpt2band + g) == b) s += sm.band[q][g];
                out.band[((long long)q * out.nbnd + b) * ncell + cell] = s;
            }
        } else if (r < r_ft) {
            // minor m over its g-point window (minor_tau's lerp)
            int m = r - r_minor;
            const int* mm = sm.meta + m * kMetaFields;
            int f = mm[1], g0 = mm[2], w = mm[3], start = mm[4];
            const float* tab = mm[0] ? klo : kup;
            int ncont = mm[0] ? ncl : ncu;
            float scal = msc[(long long)m * ncell + cell];
            float sb = 0.0f, fe_b[2] = {0.0f, 0.0f}, ft_b = 0.0f;
            for (int it = 0; it < 2; ++it) {
                int fi = (it * nflav + f) * ncell + cell;
                int row = (d.jt + it) * neta + jeta[fi];
                float fe = feta[fi];
                float ftv = it == 0 ? 1.0f - d.ft : d.ft;
                float st = it == 0 ? -1.0f : 1.0f;
                for (int j = 0; j < w; ++j) {
                    float tb = sm.tb[g0 + j];
                    float lo = __ldg(tab + row * ncont + start + j);
                    float hi = __ldg(tab + (row + 1) * ncont + start + j);
                    float lerp = (1.0f - fe) * lo + fe * hi;
                    sb += ftv * lerp * tb;
                    fe_b[it] += scal * ftv * (hi - lo) * tb;
                    ft_b += scal * st * lerp * tb;
                }
            }
            out.msc[(long long)m * ncell + cell] = sb;
            sm.mfe[0][m] = fe_b[0];
            sm.mfe[1][m] = fe_b[1];
            sm.mft[m] = ft_b;
        } else if (r == r_ft) {
            float s = 0.0f;
            for (int g = 0; g < ngpt; ++g) s += sm.ft[g];
            *sm.ft_total = s;
        } else if (r == r_ft + 1) {
            float s = 0.0f;
            for (int g = 0; g < ngpt; ++g) s += sm.fp[g];
            out.fpress[cell] = s;
        } else if (out.dense) {
            float s = 0.0f;
            for (int g = 0; g < ngpt; ++g) s += sm.dense[g];
            out.dense[cell] = s;
        }
    }
    __syncthreads();
    // feta: the major part plus the minors of flavor r; ftemp: the major
    // part plus every minor's
    for (int r = threadIdx.x; r <= nflav; r += blockDim.x) {
        if (r < nflav) {
            for (int it = 0; it < 2; ++it) {
                float s = sm.major_fe[it][r];
                for (int m = 0; m < nminor; ++m)
                    if (sm.meta[m * kMetaFields + 1] == r) s += sm.mfe[it][m];
                out.feta[(long long)(it * nflav + r) * ncell + cell] = s;
            }
        } else {
            float s = *sm.ft_total;
            for (int m = 0; m < nminor; ++m) s += sm.mft[m];
            out.ftemp[cell] = s;
        }
    }
    __syncthreads();
}

}  // namespace rte
