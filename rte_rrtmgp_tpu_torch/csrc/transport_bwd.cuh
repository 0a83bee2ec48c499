// Adjoints of the transport in transport.cuh, per (column, g-point): the
// LW linear-in-tau source and the one-angle sweeps, the SW Meador-Weaver
// layer coefficients with their clamps, the direct beam and the
// Shonk-Hogan adding. Shared by the backward kernels (solver_lw_bwd.cu,
// solver_sw_bwd.cu, fused_lw_bwd.cu, fused_sw_bwd.cu) as transport.cuh is
// shared by the forward ones.
//
// The derivations are those of the JAX package's adjoint kernels:
// rte_rrtmgp_tpu/ops/pallas/solver_lw_bwd.py:12-44 (steps A1-A5) and
// ops/pallas/solver_sw_bwd.py:12-25 (phases P0, A-F, A-U, A-S, A-C). At a
// clamp the gradient splits half and half on a tie, as jnp.maximum's and
// jnp.clip's do; the float32 eps/tiny/min_mu0 of the forward kernels are
// used in every dtype.
//
// Each driver walks one thread's layers. The caller's Col gives a layer's
// inputs (recomputed on every read, nothing of the forward is kept but
// the few per-level values below) and its Sink takes the cotangents, one
// layer at a time from the surface up. Every thread of a block must call
// a driver (``active`` false for the idle lanes), because a Sink may sum
// over the block at each layer.
#pragma once

#include <cfloat>
#include <cmath>

#include "transport.cuh"

namespace rte {

// d max(x, c) / dx, with jnp.maximum's half at a tie.
__device__ __forceinline__ float dmax(float x, float c) {
    return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

// ---------------------------------------------------------------------------
// LW
// ---------------------------------------------------------------------------

// Cotangents of one layer's inputs: the optical depth along the ray, the
// layer source and the sources at its top and bottom levels.
struct LwBars {
    float tl, lay, top, bot;
};

// Step A1 (solver_lw_bwd.py:34-44): from the cotangents of the layer's
// sources sdn/sup and of its transmittance (trans_b, from the sweeps)
// back to tl = tau * ds and the Planck sources.
__device__ __forceinline__ LwBars lw_source_adjoint(float tl, float lay,
                                                    float top, float bot,
                                                    float sdn_b, float sup_b,
                                                    float trans_b) {
    const float tau_thresh = sqrtf(sqrtf(FLT_EPSILON));
    float t = expf(-tl);
    float tlm = fmaxf(tl, FLT_MIN);
    bool big = tl > tau_thresh;
    float fact = big ? (1.0f - t) / tlm - t
                     : tl * (0.5f + tl * (-1.0f / 3.0f + tl * 0.125f));
    LwBars b;
    b.lay = 2.0f * fact * (sdn_b + sup_b);
    float coef = 1.0f - t - 2.0f * fact;
    b.bot = coef * sdn_b;
    b.top = coef * sup_b;
    float fact_b = 2.0f * ((lay - bot) * sdn_b + (lay - top) * sup_b);
    trans_b -= bot * sdn_b + top * sup_b;
    float dfact;
    if (big) {
        trans_b += fact_b * (-1.0f / tlm - 1.0f);
        dfact = -(1.0f - t) / (tlm * tlm);
    } else {
        dfact = 0.5f + tl * (-2.0f / 3.0f + tl * 0.375f);
    }
    b.tl = fact_b * dfact - t * trans_b;
    return b;
}

// The one-angle no-scattering solve's adjoint (steps A2-A5). Col::layer(l,
// &tl, &lay, &top, &bot) gives layer l's optical depth along the ray and
// sources; gup/gdn are the column's broadband flux cotangents by level
// (stride gs). RDN/RR are this thread's layer scratch (stride ls): the
// downward radiance and the up-sweep cotangent at each layer's top, kept
// from the down pass (the only forward state kept). Sink::surface(emis_b,
// ssrc_b) is called once, Sink::layer(l, bars) for l = nlay-1 .. 0 after
// RDN[l] and RR[l] have been read (so the Sink may overwrite them), and
// Sink::top(inc_b) last.
template <class Col, class Sink>
__device__ __forceinline__ void lw_adjoint(
        bool active, const Col& col, int nlay, float piw, float inc,
        float emis, float ssrc, const float* gup, const float* gdn, int gs,
        float* RDN, float* RR, long long ls, Sink& sink) {
    float rdn = 0.0f, R = 0.0f;
    if (active) {
        // down pass: rdn[l+1] = t rdn[l] + sdn; R[l+1] = piw gup[l+1] + t R[l]
        rdn = inc / piw;
        R = piw * __ldg(gup);
        for (int l = 0; l < nlay; ++l) {
            float tl, lay, top, bot, t, sdn, sup;
            col.layer(l, &tl, &lay, &top, &bot);
            lw_source(tl, lay, top, bot, &t, &sdn, &sup);
            RDN[l * ls] = rdn;
            RR[l * ls] = R;
            rdn = t * rdn + sdn;
            R = piw * __ldg(gup + (long long)(l + 1) * gs) + t * R;
        }
    }
    // surface (A3): rup[N] = (1 - emis) rdn[N] + emis ssrc
    float rup = rdn * (1.0f - emis) + emis * ssrc;
    float D = 0.0f;
    if (active) D = piw * __ldg(gdn + (long long)nlay * gs)
                    + (1.0f - emis) * R;
    sink.surface(active ? R * (ssrc - rdn) : 0.0f, active ? emis * R : 0.0f);
    // up pass: the up sweep forward with A4's and A2's cotangents
    for (int l = nlay - 1; l >= 0; --l) {
        LwBars b = {0.0f, 0.0f, 0.0f, 0.0f};
        if (active) {
            float tl, lay, top, bot, t, sdn, sup;
            col.layer(l, &tl, &lay, &top, &bot);
            lw_source(tl, lay, top, bot, &t, &sdn, &sup);
            float rdn_l = RDN[l * ls], R_l = RR[l * ls];
            float trans_b = R_l * rup + rdn_l * D;
            rup = t * rup + sup;
            float sdn_b = D;
            D = piw * __ldg(gdn + (long long)l * gs) + t * D;
            b = lw_source_adjoint(tl, lay, top, bot, sdn_b, R_l, trans_b);
        }
        sink.layer(l, b);
    }
    sink.top(active ? D / piw : 0.0f);
}

// ---------------------------------------------------------------------------
// SW
// ---------------------------------------------------------------------------

// transport.cuh::sw_layer with every intermediate the adjoint reads
// (the same arithmetic in the same order).
struct SwLayerAD {
    float mu_s, g1, g2, karg, k, e1, e2, rt, rdif, tdif, k_mu, den0, den,
          rt2, g3, g4, a1, a2, kg3, kg4, tns, Qr, Qt, rdir0, hi_r, rdir,
          tdir0, hi_t, tdir;
};

__device__ __forceinline__ SwLayerAD sw_layer_ad(float t, float w0,
                                                 float asym, float mu) {
    const float eps = FLT_EPSILON;
    const float min_k = 1.0e4f * FLT_EPSILON;
    const float min_mu0 = sqrtf(FLT_EPSILON);
    SwLayerAD s;
    s.mu_s = fmaxf(min_mu0, mu);
    s.g1 = (8.0f - w0 * (5.0f + 3.0f * asym)) * 0.25f;
    s.g2 = 3.0f * (w0 * (1.0f - asym)) * 0.25f;
    s.karg = (s.g1 - s.g2) * (s.g1 + s.g2);
    s.k = sqrtf(fmaxf(s.karg, min_k));
    s.e1 = expf(-t * s.k);
    s.e2 = s.e1 * s.e1;
    s.rt = 1.0f / (s.k * (1.0f + s.e2) + s.g1 * (1.0f - s.e2));
    s.rdif = s.rt * s.g2 * (1.0f - s.e2);
    s.tdif = s.rt * 2.0f * s.k * s.e1;
    s.k_mu = s.k * s.mu_s;
    s.den0 = 1.0f - s.k_mu * s.k_mu;
    s.den = fabsf(s.den0) >= eps ? s.den0 : eps;
    s.rt2 = w0 * s.rt / s.den;
    s.g3 = (2.0f - 3.0f * s.mu_s * asym) * 0.25f;
    s.g4 = 1.0f - s.g3;
    s.a1 = s.g1 * s.g4 + s.g2 * s.g3;
    s.a2 = s.g1 * s.g3 + s.g2 * s.g4;
    s.kg3 = s.k * s.g3;
    s.kg4 = s.k * s.g4;
    s.tns = expf(-t / s.mu_s);
    s.Qr = (1.0f - s.k_mu) * (s.a2 + s.kg3)
           - (1.0f + s.k_mu) * (s.a2 - s.kg3) * s.e2
           - 2.0f * (s.kg3 - s.a2 * s.k_mu) * s.e1 * s.tns;
    s.Qt = (1.0f + s.k_mu) * (s.a1 + s.kg4) * s.tns
           - (1.0f - s.k_mu) * (s.a1 - s.kg4) * s.e2 * s.tns
           - 2.0f * (s.kg4 + s.a1 * s.k_mu) * s.e1;
    s.rdir0 = s.rt2 * s.Qr;
    s.tdir0 = -s.rt2 * s.Qt;
    s.hi_r = 1.0f - s.tns;
    s.rdir = fminf(fmaxf(s.rdir0, 0.0f), s.hi_r);
    s.hi_t = 1.0f - s.tns - s.rdir;
    s.tdir = fminf(fmaxf(s.tdir0, 0.0f), s.hi_t);
    return s;
}

// Cotangents of one layer's optics and cosine.
struct SwBars {
    float t, w0, asym, mu;
};

// Phase A-C (solver_sw_bwd.py:260-362): the Meador-Weaver/PIFM chain
// transposed, from the cotangents of rdif, tdif, rdir, tdir and the
// direct transmittance tns.
__device__ __forceinline__ SwBars sw_layer_adjoint(
        const SwLayerAD& s, float t, float w0, float asym, float mu,
        float rdif_b, float tdif_b, float rdir_b, float tdir_b,
        float tns_b) {
    const float min_k = 1.0e4f * FLT_EPSILON;
    const float min_mu0 = sqrtf(FLT_EPSILON);
    // tdir = min(max(tdir0, 0), hi_t), hi_t = 1 - tns - rdir
    float mt = fmaxf(s.tdir0, 0.0f);
    float wt = mt < s.hi_t ? 1.0f : (mt == s.hi_t ? 0.5f : 0.0f);
    float tdir0_b = tdir_b * wt * dmax(s.tdir0, 0.0f);
    float hi_t_b = tdir_b * (1.0f - wt);
    rdir_b -= hi_t_b;
    tns_b -= hi_t_b;
    // rdir = min(max(rdir0, 0), hi_r), hi_r = 1 - tns
    float mr = fmaxf(s.rdir0, 0.0f);
    float wr = mr < s.hi_r ? 1.0f : (mr == s.hi_r ? 0.5f : 0.0f);
    float rdir0_b = rdir_b * wr * dmax(s.rdir0, 0.0f);
    tns_b -= rdir_b * (1.0f - wr);

    // rdir0 = rt2 Qr ; tdir0 = -rt2 Qt
    float rt2_b = rdir0_b * s.Qr - tdir0_b * s.Qt;
    float Qr_b = rdir0_b * s.rt2;
    float Qt_b = -tdir0_b * s.rt2;
    const float kmu = s.k_mu, e1 = s.e1, e2 = s.e2, tns = s.tns;
    float kmu_b = Qr_b * (-(s.a2 + s.kg3) - (s.a2 - s.kg3) * e2
                          + 2.0f * s.a2 * e1 * tns)
                + Qt_b * ((s.a1 + s.kg4) * tns + (s.a1 - s.kg4) * e2 * tns
                          - 2.0f * s.a1 * e1);
    float a2_b = Qr_b * ((1.0f - kmu) - (1.0f + kmu) * e2
                         + 2.0f * kmu * e1 * tns);
    float kg3_b = Qr_b * ((1.0f - kmu) + (1.0f + kmu) * e2
                          - 2.0f * e1 * tns);
    float a1_b = Qt_b * ((1.0f + kmu) * tns - (1.0f - kmu) * e2 * tns
                         - 2.0f * kmu * e1);
    float kg4_b = Qt_b * ((1.0f + kmu) * tns + (1.0f - kmu) * e2 * tns
                          - 2.0f * e1);
    float e2_b = Qr_b * (-(1.0f + kmu) * (s.a2 - s.kg3))
               + Qt_b * (-(1.0f - kmu) * (s.a1 - s.kg4) * tns);
    float e1_b = Qr_b * (-2.0f * (s.kg3 - s.a2 * kmu) * tns)
               + Qt_b * (-2.0f * (s.kg4 + s.a1 * kmu));
    tns_b += Qr_b * (-2.0f * (s.kg3 - s.a2 * kmu) * e1)
           + Qt_b * ((1.0f + kmu) * (s.a1 + s.kg4)
                     - (1.0f - kmu) * (s.a1 - s.kg4) * e2);

    // rdif = rt g2 (1 - e2) ; tdif = 2 rt k e1
    float rt_b = rdif_b * s.g2 * (1.0f - e2) + tdif_b * 2.0f * s.k * e1;
    float g2_b = rdif_b * s.rt * (1.0f - e2);
    e2_b -= rdif_b * s.rt * s.g2;
    float k_b = tdif_b * 2.0f * s.rt * e1;
    e1_b += tdif_b * 2.0f * s.rt * s.k;

    // rt2 = w0 rt / den ; den = |den0| >= eps ? den0 : eps
    float w0_b = rt2_b * s.rt / s.den;
    rt_b += rt2_b * w0 / s.den;
    float den_b = -rt2_b * s.rt2 / s.den;
    float den0_b = fabsf(s.den0) >= FLT_EPSILON ? den_b : 0.0f;
    kmu_b -= 2.0f * kmu * den0_b;

    // rt = 1 / A, A = k (1 + e2) + g1 (1 - e2)
    float A_b = -rt_b * s.rt * s.rt;
    k_b += A_b * (1.0f + e2);
    float g1_b = A_b * (1.0f - e2);
    e2_b += A_b * (s.k - s.g1);

    // kg3 = k g3 ; kg4 = k g4 ; kmu = k mu_s
    k_b += kg3_b * s.g3 + kg4_b * s.g4 + kmu_b * s.mu_s;
    float g3_b = kg3_b * s.k;
    float g4_b = kg4_b * s.k;
    float mus_b = kmu_b * s.k;

    // a1 = g1 g4 + g2 g3 ; a2 = g1 g3 + g2 g4
    g1_b += a1_b * s.g4 + a2_b * s.g3;
    g4_b += a1_b * s.g1 + a2_b * s.g2;
    g2_b += a1_b * s.g3 + a2_b * s.g4;
    g3_b += a1_b * s.g2 + a2_b * s.g1;

    // g4 = 1 - g3 ; g3 = (2 - 3 mu_s asym) / 4
    g3_b -= g4_b;
    mus_b -= 0.75f * asym * g3_b;
    float asym_b = -0.75f * s.mu_s * g3_b;

    // e2 = e1^2 ; tns = exp(-t / mu_s) ; e1 = exp(-t k)
    e1_b += 2.0f * e1 * e2_b;
    float t_b = -tns_b * tns / s.mu_s - e1_b * e1 * s.k;
    mus_b += tns_b * tns * t / (s.mu_s * s.mu_s);
    k_b -= e1_b * e1 * t;

    // k = sqrt(max(karg, min_k)) ; karg = g1^2 - g2^2
    float karg_b = dmax(s.karg, min_k) * k_b / (2.0f * s.k);
    g1_b += 2.0f * s.g1 * karg_b;
    g2_b -= 2.0f * s.g2 * karg_b;

    // g1 = 2 - w0 (5 + 3 asym) / 4 ; g2 = (3/4) w0 (1 - asym)
    w0_b += -0.25f * (5.0f + 3.0f * asym) * g1_b
            + 0.75f * (1.0f - asym) * g2_b;
    asym_b += -0.75f * w0 * g1_b - 0.75f * w0 * g2_b;

    SwBars b;
    b.t = t_b;
    b.w0 = w0_b;
    b.asym = asym_b;
    b.mu = mus_b * dmax(mu, min_mu0);     // mu_s = max(min_mu0, mu)
    return b;
}

// Scratch fields of one thread, each with nlay+1 levels.
enum SwField {
    kR, kT, kSdn, kSupDen, kDir, kAlb, kSrc, kFdnAlbB, kSrcB, kRb, kTdb,
    kSdnb, kSupb, kSwFields
};

// Boundary cotangents of the SW solve.
struct SwBoundaryBars {
    float alb_dir, alb_dif, inc, inc_dif, mu_top;   // mu_top: mu0 of layer 0
};

// The two-stream + adding solve's adjoint. Col::layer(l, &t, &w0, &asym,
// &mu) gives layer l's optics and cosine; gu/gd/gr are the column's
// broadband cotangents of up, down total and direct by level (stride
// gs); S is this thread's scratch, field f at level v at S[f * fs + v *
// ls]. Passes (solver_sw_bwd.py): P0 recompute (down: coefficients and
// beam; up: the adding build; down: the diffuse flux), A-F (up), A-U
// (down), then A-S with A-C (up), where Sink::layer(l, bars) takes each
// layer's cotangents for l = nlay-1 .. 0, after the Col has read layer l
// for the last time. Returns the boundary cotangents.
template <class Col, class Sink>
__device__ __forceinline__ SwBoundaryBars sw_adjoint(
        bool active, const Col& col, int nlay, float inc, float alb_dir,
        float alb_dif, float top, const float* gu, const float* gd,
        const float* gr, int gs, float* S, long long fs, long long ls,
        Sink& sink) {
    auto at = [&](int f, int v) -> float& {
        return S[(long long)f * fs + (long long)v * ls];
    };
    auto cot = [&](const float* g, int v) {
        return __ldg(g + (long long)v * gs);
    };
    SwBoundaryBars bb = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float mu_top = 0.0f, dir = 0.0f, Src_bN = 0.0f;
    bool day_sfc = false;
    if (active) {
        // ---- P0: coefficients and the direct beam, top down ----
        float t, w0, asym, mu;
        col.layer(0, &t, &w0, &asym, &mu);
        mu_top = mu;
        dir = inc * mu_top;
        for (int l = 0; l < nlay; ++l) {
            col.layer(l, &t, &w0, &asym, &mu);
            SwLayer s = sw_layer(t, w0, asym, mu);
            bool day = mu > 0.0f;
            at(kR, l) = s.rdif;
            at(kT, l) = s.tdif;
            at(kSupDen, l) = day ? s.rdir * dir : 0.0f;
            at(kSdn, l) = day ? s.tdir * dir : 0.0f;
            at(kDir, l) = dir;
            dir = dir * s.tns;
            if (l == nlay - 1) day_sfc = day;
        }
        at(kDir, nlay) = dir;
        // ---- P0: the adding build, bottom up (transport.cuh::adding)
        float alb = alb_dif;
        float src = day_sfc ? dir * alb_dir : 0.0f;
        at(kAlb, nlay) = alb;
        at(kSrc, nlay) = src;
        for (int v = nlay - 1; v >= 0; --v) {
            float r = at(kR, v), td = at(kT, v);
            float dd = 1.0f / (1.0f - r * alb);
            float src_v = at(kSupDen, v) + td * dd * (src + alb * at(kSdn, v));
            alb = r + td * td * alb * dd;
            src = src_v;
            at(kSupDen, v) = dd;
            at(kAlb, v) = alb;
            at(kSrc, v) = src;
        }
        // ---- P0: the diffuse flux down ----
        float fdn = top;
        at(kFdnAlbB, 0) = fdn;
        for (int v = 0; v < nlay; ++v) {
            fdn = (at(kT, v) * fdn + at(kR, v) * at(kSrc, v + 1)
                   + at(kSdn, v)) * at(kSupDen, v);
            at(kFdnAlbB, v + 1) = fdn;
        }
        // ---- A-F: adjoint of the diffuse sweep, bottom up. Leaves
        // td_b, r_b, sdn_b per layer and the sweep's albedo and source
        // cotangents per level (the albedo's over fdn) ----
        float Ff = cot(gd, nlay) + cot(gu, nlay) * at(kAlb, nlay);
        for (int v = nlay - 1; v >= 0; --v) {
            float Fh = Ff;
            float d = at(kSupDen, v), r = at(kR, v), td = at(kT, v);
            float fd = at(kFdnAlbB, v), sn = at(kSrc, v + 1);
            float prod = td * fd + r * sn + at(kSdn, v);
            float dd = Fh * prod * d * d;
            at(kTdb, v) = Fh * d * fd;
            at(kRb, v) = Fh * d * sn + dd * at(kAlb, v + 1);
            at(kSdnb, v) = Fh * d;
            at(kFdnAlbB, v + 1) = cot(gu, v + 1) * at(kFdnAlbB, v + 1)
                                  + dd * r;
            at(kSrcB, v + 1) = cot(gu, v + 1) + Fh * d * r;
            Ff = cot(gd, v) + cot(gu, v) * at(kAlb, v) + td * d * Fh;
        }
        at(kFdnAlbB, 0) = cot(gu, 0) * at(kFdnAlbB, 0);
        at(kSrcB, 0) = cot(gu, 0);
        bb.inc_dif = Ff;
        // ---- A-U: adjoint of the adding build, top down ----
        float ab_c = 0.0f, sb_c = 0.0f;
        for (int v = 0; v < nlay; ++v) {
            float r = at(kR, v), td = at(kT, v), ab = at(kAlb, v + 1);
            float d = at(kSupDen, v), sdn = at(kSdn, v);
            float ab_h = at(kFdnAlbB, v) + ab_c;
            float sb = at(kSrcB, v) + sb_c;
            float inner = at(kSrc, v + 1) + ab * sdn;
            float rb = at(kRb, v) + ab_h;
            float tdb = at(kTdb, v) + ab_h * 2.0f * td * ab * d;
            float d_h = ab_h * td * td * ab;
            float ab_acc = ab_h * td * td * d;
            at(kSupb, v) = sb;
            tdb += sb * d * inner;
            d_h += sb * td * inner;
            sb_c = sb * td * d;
            ab_acc += sb * td * d * sdn;
            float sdnb = at(kSdnb, v) + sb * td * d * ab;
            float ddh = d_h * d * d;
            rb += ddh * ab;
            ab_acc += ddh * r;
            ab_c = ab_acc;
            at(kRb, v) = rb;
            at(kTdb, v) = tdb;
            at(kSdnb, v) = sdnb;
        }
        bb.alb_dif = at(kFdnAlbB, nlay) + ab_c;
        Src_bN = at(kSrcB, nlay) + sb_c;
        bb.alb_dir = day_sfc ? Src_bN * dir : 0.0f;
    }
    // ---- A-S and A-C: the beam's adjoint bottom up, each layer's
    // Meador-Weaver chain transposed on the way ----
    float Dh = 0.0f;
    if (active)
        Dh = cot(gd, nlay) + cot(gr, nlay)
             + (day_sfc ? Src_bN * alb_dir : 0.0f);
    for (int l = nlay - 1; l >= 0; --l) {
        SwBars b = {0.0f, 0.0f, 0.0f, 0.0f};
        if (active) {
            float t, w0, asym, mu;
            col.layer(l, &t, &w0, &asym, &mu);
            SwLayerAD s = sw_layer_ad(t, w0, asym, mu);
            bool day = mu > 0.0f;
            float dirl = at(kDir, l);
            float supb = at(kSupb, l), sdnb = at(kSdnb, l);
            float tns_b = dirl * Dh;
            float rdir_b = day ? supb * dirl : 0.0f;
            float tdir_b = day ? sdnb * dirl : 0.0f;
            float dl_src = day ? s.rdir * supb + s.tdir * sdnb : 0.0f;
            Dh = cot(gd, l) + cot(gr, l) + dl_src + s.tns * Dh;
            b = sw_layer_adjoint(s, t, w0, asym, mu, at(kRb, l),
                                 at(kTdb, l), rdir_b, tdir_b, tns_b);
        }
        sink.layer(l, b);
    }
    // the beam's seed: dir[0] = inc * mu0 of layer 0
    bb.inc = Dh * mu_top;
    bb.mu_top = Dh * inc;
    return bb;
}

}  // namespace rte
