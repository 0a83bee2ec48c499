// Radiative transfer shared by the fused kernels and the stand-alone
// solvers: the LW linear-in-tau layer source, the SW Meador-Weaver layer
// coefficients, the LW two-stream layer coefficients and sources, and the
// adding sweeps over per-thread layer columns (SW and LW two-stream).
#pragma once

#include <cfloat>
#include <cmath>

#include "common.cuh"

namespace rte {

// LW transmittance and linear-in-tau sources of one layer at optical
// depth tl along the ray (Clough et al. 1992 Eq 13; reference
// lw_source_noscat :620-675, the small-tau series below sqrt(sqrt(eps))).
// sdn exits the layer bottom, sup its top.
__device__ __forceinline__ void lw_source(float tl, float lay, float lev_top,
                                          float lev_bot, float* trans,
                                          float* sdn, float* sup) {
    const float tau_thresh = sqrtf(sqrtf(FLT_EPSILON));
    float t = expf(-tl);
    float fact_big = (1.0f - t) / fmaxf(tl, FLT_MIN) - t;
    float fact_small = tl * (0.5f + tl * (-1.0f / 3.0f + tl * 0.125f));
    float fact = tl > tau_thresh ? fact_big : fact_small;
    *sdn = (1.0f - t) * lev_bot + 2.0f * fact * (lay - lev_bot);
    *sup = (1.0f - t) * lev_top + 2.0f * fact * (lay - lev_top);
    *trans = t;
}

// SW two-stream coefficients of one layer (Zdunkowski PIFM gammas,
// Meador-Weaver Eqs 14/15/25/26; reference sw_dif_and_source :985-1127)
// with min_k = 1e4 eps, min_mu0 = sqrt(eps), |1 - (k mu0)^2| >= eps and the
// Hogan/Ukkonen energy clamps on rdir/tdir.
struct SwLayer {
    float rdif, tdif, rdir, tdir, tns;
};

__device__ __forceinline__ SwLayer sw_layer(float t, float w0, float asym,
                                            float mu) {
    const float eps = FLT_EPSILON;
    const float min_k = 1.0e4f * FLT_EPSILON;
    const float min_mu0 = sqrtf(FLT_EPSILON);
    float mu_s = fmaxf(min_mu0, mu);
    float g1 = (8.0f - w0 * (5.0f + 3.0f * asym)) * 0.25f;
    float g2 = 3.0f * (w0 * (1.0f - asym)) * 0.25f;
    float k = sqrtf(fmaxf((g1 - g2) * (g1 + g2), min_k));
    float e1 = expf(-t * k);
    float e2 = e1 * e1;
    float rt = 1.0f / (k * (1.0f + e2) + g1 * (1.0f - e2));
    SwLayer s;
    s.rdif = rt * g2 * (1.0f - e2);
    s.tdif = rt * 2.0f * k * e1;
    float k_mu = k * mu_s;
    float den = 1.0f - k_mu * k_mu;
    den = fabsf(den) >= eps ? den : eps;
    float rt2 = w0 * rt / den;
    float g3 = (2.0f - 3.0f * mu_s * asym) * 0.25f;
    float g4 = 1.0f - g3;
    float a1 = g1 * g4 + g2 * g3;
    float a2 = g1 * g3 + g2 * g4;
    float kg3 = k * g3;
    float kg4 = k * g4;
    float tns = expf(-t / mu_s);
    float rdir = rt2 * ((1.0f - k_mu) * (a2 + kg3)
                        - (1.0f + k_mu) * (a2 - kg3) * e2
                        - 2.0f * (kg3 - a2 * k_mu) * e1 * tns);
    float tdir = -rt2 * ((1.0f + k_mu) * (a1 + kg4) * tns
                         - (1.0f - k_mu) * (a1 - kg4) * e2 * tns
                         - 2.0f * (kg4 + a1 * k_mu) * e1);
    s.rdir = fminf(fmaxf(rdir, 0.0f), 1.0f - tns);
    s.tdir = fminf(fmaxf(tdir, 0.0f), 1.0f - tns - s.rdir);
    s.tns = tns;
    return s;
}

// LW two-stream coefficients and sources of one layer, top and bottom
// level Planck sources top/bot: Meador-Weaver Rdif/Tdif with the LW
// diffusivity secant 1.66 (Fu et al. 1997; reference lw_two_stream
// :854-909) and the Toon et al. 1989 linear-in-B sources times pi
// (reference lw_source_2str :917-967), zero where tau <= 1e-8. The layer
// Planck source is not used by the linear-in-B form.
struct Lw2Layer {
    float rdif, tdif, sdn, sup;
};

__device__ __forceinline__ Lw2Layer lw2_layer(float t, float w0, float asym,
                                              float top, float bot) {
    const float pi = 3.14159265358979f;
    float g1 = 1.66f * (1.0f - 0.5f * w0 * (1.0f + asym));
    float g2 = 1.66f * 0.5f * w0 * (1.0f - asym);
    float k = sqrtf(fmaxf((g1 - g2) * (g1 + g2), 1.0e-12f));
    float e1 = expf(-t * k);
    float e2 = e1 * e1;
    float rt = 1.0f / (k * (1.0f + e2) + g1 * (1.0f - e2));
    Lw2Layer s;
    s.rdif = rt * g2 * (1.0f - e2);
    s.tdif = rt * 2.0f * k * e1;
    float safe = t * (g1 + g2);
    float z = (bot - top) / (safe > 0.0f ? safe : 1.0f);
    bool thin = t <= 1.0e-8f;
    s.sup = thin ? 0.0f
                 : pi * ((z + top) - s.rdif * (-z + top) - s.tdif * (z + bot));
    s.sdn = thin ? 0.0f
                 : pi * ((-z + bot) - s.rdif * (z + bot) - s.tdif * (-z + top));
    return s;
}

// Shonk-Hogan adding (Eqs 9-13; reference adding :1135-1245) over one
// thread's layer columns, stride ngpt, from any surface albedo and
// source: the SW diffuse solve and the LW two-stream one. R, T, SDN, SUP
// per layer in; SUP is overwritten with 1 / (1 - R * albedo below), ALB
// and SRC receive the albedo and upward source at the levels. Then the
// top-down sweep from the diffuse flux fdn_top; the up and down fluxes of
// every level go to the sinks ``up``/``dn`` (broadband or by band; every
// thread of the block must call this).
__device__ __forceinline__ void adding(
        bool active, const float* R, const float* T, const float* SDN,
        float* SUP, float* ALB, float* SRC, int nlay, int ngpt,
        float alb_sfc, float src_sfc, float fdn_top, const LevelSink& up,
        const LevelSink& dn, BandSums& bands) {
    float alb = 0.0f, src = 0.0f;
    if (active) {
        alb = alb_sfc;
        src = src_sfc;
        long long o = (long long)nlay * ngpt;
        ALB[o] = alb;
        SRC[o] = src;
        for (int v = nlay - 1; v >= 0; --v) {
            long long ov = (long long)v * ngpt;
            float r = R[ov];
            float td = T[ov];
            float dd = 1.0f / (1.0f - r * alb);
            float src_v = SUP[ov] + td * dd * (src + alb * SDN[ov]);
            alb = r + td * td * alb * dd;
            src = src_v;
            SUP[ov] = dd;
            ALB[ov] = alb;
            SRC[ov] = src;
        }
    }
    float fdn = active ? fdn_top : 0.0f;
    float fup = active ? fdn * alb + src : 0.0f;
    up.put(bands, fup, 0);
    dn.put(bands, fdn, 0);
    for (int v = 0; v < nlay; ++v) {
        if (active) {
            long long ov = (long long)v * ngpt;
            long long on = ov + ngpt;
            float src_n = SRC[on];
            fdn = (T[ov] * fdn + R[ov] * src_n + SDN[ov]) * SUP[ov];
            fup = fdn * ALB[on] + src_n;
        }
        up.put(bands, fup, v + 1);
        dn.put(bands, fdn, v + 1);
    }
}

}  // namespace rte
