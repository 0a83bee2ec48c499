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
// inputs (read again on every pass; the drivers keep only the few fields
// named below in device memory, and recompute the rest) and its Sink
// takes the cotangents, one layer at a time from the surface up. The
// passes load the next layer's values before they work on the current
// one, so that a level's loads overlap the last level's arithmetic: the
// sweeps are dependent over the levels and wait on memory otherwise.
// Every thread of a block must call a driver (``active`` false for the
// idle lanes), because a Sink may sum over the block at each layer.
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
// layer source and the sources at its top and bottom levels; and coef, of
// which bot = coef * sdn_b and top = coef * sup_b (a kernel that adds the
// bottom term into a level's cotangent forms it as one fused multiply-add
// with coef, as a compiler fuses bot's product into that sum).
struct LwBars {
    float tl, lay, top, bot, coef;
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
    b.coef = coef;
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

// The one-angle no-scattering solve's adjoint (steps A2-A5), which the
// fused LW adjoint calls (solver_lw_bwd.cu runs the same steps from
// shared memory, in the same expressions). The Col gives layer l's optical
// depth along the ray and sources:
// col.down(l, &tl, &lay, &top, &bot) on the down pass (l = 0 .. nlay-1
// in order, so a Col may compute its layers there), col.up(l, ...) on
// the up pass (l = nlay-1 .. 0), and col.surface_source() after the down
// pass. gup/gdn are the column's broadband flux cotangents by level
// (stride gs). RDN/RR are this thread's layer scratch (stride ls): the
// downward radiance and the up-sweep cotangent at each layer's top, kept
// from the down pass (the only forward state kept); the up pass reads
// layer l-1's while it works on layer l. Sink::surface(emis_b, ssrc_b) is
// called once, Sink::layer(l, bars) for l = nlay-1 .. 0 after RDN[l] and
// RR[l] have been read (so the Sink may overwrite them), and
// Sink::top(inc_b) last.
template <class Col, class Sink>
__device__ __forceinline__ void lw_adjoint(
        bool active, Col& col, int nlay, float piw, float inc, float emis,
        const float* gup, const float* gdn, int gs, float* RDN, float* RR,
        long long ls, Sink& sink) {
    float rdn = 0.0f, R = 0.0f;
    if (active) {
        // down pass: rdn[l+1] = t rdn[l] + sdn; R[l+1] = piw gup[l+1] + t R[l]
        rdn = inc / piw;
        R = piw * __ldg(gup);
        for (int l = 0; l < nlay; ++l) {
            float tl, lay, top, bot, t, sdn, sup;
            col.down(l, &tl, &lay, &top, &bot);
            lw_source(tl, lay, top, bot, &t, &sdn, &sup);
            RDN[l * ls] = rdn;
            RR[l * ls] = R;
            rdn = t * rdn + sdn;
            R = piw * __ldg(gup + (long long)(l + 1) * gs) + t * R;
        }
    }
    // surface (A3): rup[N] = (1 - emis) rdn[N] + emis ssrc
    float ssrc = active ? col.surface_source() : 0.0f;
    float rup = rdn * (1.0f - emis) + emis * ssrc;
    float D = 0.0f;
    if (active) D = piw * __ldg(gdn + (long long)nlay * gs)
                    + (1.0f - emis) * R;
    sink.surface(active ? R * (ssrc - rdn) : 0.0f, active ? emis * R : 0.0f);
    // up pass: the up sweep forward with A4's and A2's cotangents
    float rdn_n = 0.0f, R_n = 0.0f;
    if (active) {
        rdn_n = RDN[(nlay - 1) * ls];
        R_n = RR[(nlay - 1) * ls];
    }
    for (int l = nlay - 1; l >= 0; --l) {
        LwBars b = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (active) {
            float rdn_l = rdn_n, R_l = R_n;
            if (l > 0) {
                rdn_n = RDN[(l - 1) * ls];
                R_n = RR[(l - 1) * ls];
            }
            float tl, lay, top, bot, t, sdn, sup;
            col.up(l, &tl, &lay, &top, &bot);
            lw_source(tl, lay, top, bot, &t, &sdn, &sup);
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
// direct transmittance tns. Divisions by den and mu_s are products with
// their reciprocals: a float32 division is a sequence of instructions,
// and this chain runs once per (column, layer, g-point) in a
// latency-bound sweep (measured faster on an H100: PERF.md's findings on
// rows 15 and 17).
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
    const float inv_den = 1.0f / s.den;
    float w0_b = rt2_b * s.rt * inv_den;
    rt_b += rt2_b * w0 * inv_den;
    float den_b = -rt2_b * s.rt2 * inv_den;
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
    const float inv_mus = 1.0f / s.mu_s;
    float t_b = -tns_b * tns * inv_mus - e1_b * e1 * s.k;
    mus_b += tns_b * tns * t * inv_mus * inv_mus;
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

// One thread's scratch for sw_adjoint: five fields, element (v) at
// p[v * ls]. The names give the first content; each field is reused once
// its first content is dead (A-U writes its results where it has read
// the last value):
//   dir (nlay+1 levels): the direct beam at the top of each level;
//   alb (nlay+1): the adding albedo below each level, then rb of layer v
//     at v+1;
//   src (nlay+1): the adding upward source, then tdb of layer v at v+1;
//   fdn (nlay+1): the diffuse downward flux, then sdnb of layer v at v;
//   fh (nlay): the diffuse sweep's cotangent entering layer v from below
//     (A-F), then supb of layer v.
struct SwScratch {
    float* dir;
    float* alb;
    float* src;
    float* fdn;
    float* fh;
    long long ls;
};

// Boundary cotangents of the SW solve.
struct SwBoundaryBars {
    float alb_dir, alb_dif, inc, inc_dif, mu_top;   // mu_top: mu0 of layer 0
};

// Direct transmittance of a layer: sw_layer's tns, bit for bit.
__device__ __forceinline__ float sw_tns(float t, float mu) {
    return expf(-t / fmaxf(sqrtf(FLT_EPSILON), mu));
}

// The two-stream + adding solve's adjoint, for one thread's layers.
// col.layer(l, &t, &w0, &asym, &mu) gives layer l's optics and cosine
// (read on every pass: each pass recomputes the Meador-Weaver
// coefficients it needs from them, which costs less than keeping the
// five coefficients in device memory); gu/gd/gr are the column's
// broadband cotangents of up, down total and direct by level (stride
// gs). With BEAM the first pass writes the direct beam to S.dir; without,
// the caller has written it (the beam of sw_tns from inc * mu of layer
// 0). Passes (solver_sw_bwd.py): the beam (down), the adding build (up),
// the diffuse flux (down), A-F (up), A-U (down), then A-S with A-C (up),
// where Sink::layer(l, bars) takes each layer's cotangents for l =
// nlay-1 .. 0. A-F keeps only its running cotangent per layer; A-U
// recomputes A-F's per-layer results from it. Each pass loads the next
// layer's inputs before it works on the current one, so the loads of one
// level overlap the arithmetic of the last. Returns the boundary
// cotangents.
template <bool BEAM, class Col, class Sink>
__device__ __forceinline__ SwBoundaryBars sw_adjoint(
        bool active, const Col& col, int nlay, float inc, float alb_dir,
        float alb_dif, float top, const float* gu, const float* gd,
        const float* gr, int gs, const SwScratch& S, Sink& sink) {
    float* __restrict__ DIR = S.dir;
    float* __restrict__ ALB = S.alb;
    float* __restrict__ SRC = S.src;
    float* __restrict__ FDN = S.fdn;
    float* __restrict__ FH = S.fh;
    const long long ls = S.ls;
    auto cot = [&](const float* g, int v) {
        return __ldg(g + (long long)v * gs);
    };
    SwBoundaryBars bb = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float mu_top = 0.0f, Src_bN = 0.0f, dirN = 0.0f;
    bool day_sfc = false;
    const int N = nlay;
    // the current and the next layer's optics
    float t, w0, asym, mu, tn, w0n, asymn, mun;
    auto next = [&]() { t = tn; w0 = w0n; asym = asymn; mu = mun; };
    if (active) {
        col.layer(0, &t, &w0, &asym, &mu);
        mu_top = mu;
        // ---- the beam, top down ----
        if (BEAM) {
            float dir = inc * mu_top;
            for (int l = 0; l < N; ++l) {
                if (l + 1 < N) col.layer(l + 1, &tn, &w0n, &asymn, &mun);
                DIR[l * ls] = dir;
                dir = dir * sw_tns(t, mu);
                next();
            }
            DIR[N * ls] = dir;
        }
        // ---- the adding build, bottom up (transport.cuh::adding) ----
        col.layer(N - 1, &t, &w0, &asym, &mu);
        day_sfc = mu > 0.0f;
        dirN = DIR[N * ls];
        float alb = alb_dif;
        float src = day_sfc ? dirN * alb_dir : 0.0f;
        ALB[N * ls] = alb;
        SRC[N * ls] = src;
        float dirv = DIR[(N - 1) * ls], dirn = 0.0f;
        for (int v = N - 1; v >= 0; --v) {
            if (v > 0) {
                col.layer(v - 1, &tn, &w0n, &asymn, &mun);
                dirn = DIR[(v - 1) * ls];
            }
            SwLayer s = sw_layer(t, w0, asym, mu);
            bool day = mu > 0.0f;
            float supdir = day ? s.rdir * dirv : 0.0f;
            float sdn = day ? s.tdir * dirv : 0.0f;
            float dd = 1.0f / (1.0f - s.rdif * alb);
            float src_v = supdir + s.tdif * dd * (src + alb * sdn);
            alb = s.rdif + s.tdif * s.tdif * alb * dd;
            src = src_v;
            ALB[v * ls] = alb;
            SRC[v * ls] = src;
            next();
            dirv = dirn;
        }
        // ---- the diffuse flux, top down ----
        col.layer(0, &t, &w0, &asym, &mu);
        float fdn = top, dir = inc * mu_top;
        FDN[0] = fdn;
        float ab = ALB[ls], sn = SRC[ls], abn = 0.0f, snn = 0.0f;
        for (int v = 0; v < N; ++v) {
            if (v + 1 < N) {
                col.layer(v + 1, &tn, &w0n, &asymn, &mun);
                abn = ALB[(v + 2) * ls];
                snn = SRC[(v + 2) * ls];
            }
            SwLayer s = sw_layer(t, w0, asym, mu);
            float sdn = mu > 0.0f ? s.tdir * dir : 0.0f;
            float dd = 1.0f / (1.0f - s.rdif * ab);
            fdn = (s.tdif * fdn + s.rdif * sn + sdn) * dd;
            FDN[(v + 1) * ls] = fdn;
            dir = dir * s.tns;
            next();
            ab = abn;
            sn = snn;
        }
        // ---- A-F: adjoint of the diffuse sweep, bottom up; keeps the
        // cotangent entering each layer from below ----
        col.layer(N - 1, &t, &w0, &asym, &mu);
        float alb_hi = ALB[N * ls];
        float Ff = cot(gd, N) + cot(gu, N) * alb_hi;
        float alb_v = ALB[(N - 1) * ls], albn = 0.0f;
        for (int v = N - 1; v >= 0; --v) {
            if (v > 0) {
                col.layer(v - 1, &tn, &w0n, &asymn, &mun);
                albn = ALB[(v - 1) * ls];
            }
            SwLayer s = sw_layer(t, w0, asym, mu);
            float d = 1.0f / (1.0f - s.rdif * alb_hi);
            float Fh = Ff;
            FH[v * ls] = Fh;
            Ff = cot(gd, v) + cot(gu, v) * alb_v + s.tdif * d * Fh;
            next();
            alb_hi = alb_v;
            alb_v = albn;
        }
        bb.inc_dif = Ff;
        // ---- A-U: adjoint of the adding build, top down, with A-F's
        // per-layer results recomputed from its kept cotangent ----
        col.layer(0, &t, &w0, &asym, &mu);
        dir = inc * mu_top;
        float ab_c = 0.0f, sb_c = 0.0f;
        float fd = FDN[0];
        float albB = cot(gu, 0) * fd, srcB = cot(gu, 0);
        float Fh = FH[0];
        ab = ALB[ls];
        sn = SRC[ls];
        float fdn_n = 0.0f, Fh_n = 0.0f;
        for (int v = 0; v < N; ++v) {
            fdn_n = FDN[(v + 1) * ls];
            if (v + 1 < N) {
                col.layer(v + 1, &tn, &w0n, &asymn, &mun);
                Fh_n = FH[(v + 1) * ls];
                abn = ALB[(v + 2) * ls];
                snn = SRC[(v + 2) * ls];
            }
            SwLayer s = sw_layer(t, w0, asym, mu);
            const float r = s.rdif, td = s.tdif;
            float sdn = mu > 0.0f ? s.tdir * dir : 0.0f;
            float d = 1.0f / (1.0f - r * ab);
            // A-F at layer v (solver_sw_bwd.py A-F)
            float prod = td * fd + r * sn + sdn;
            float ddF = Fh * prod * d * d;
            float tdb = Fh * d * fd;
            float rb = Fh * d * sn + ddF * ab;
            float sdnb = Fh * d;
            // A-U at layer v
            float ab_h = albB + ab_c;
            float sb = srcB + sb_c;
            float inner = sn + ab * sdn;
            rb = rb + ab_h;
            tdb = tdb + ab_h * 2.0f * td * ab * d;
            float d_h = ab_h * td * td * ab;
            float ab_acc = ab_h * td * td * d;
            tdb += sb * d * inner;
            d_h += sb * td * inner;
            sb_c = sb * td * d;
            ab_acc += sb * td * d * sdn;
            sdnb = sdnb + sb * td * d * ab;
            float ddh = d_h * d * d;
            rb += ddh * ab;
            ab_acc += ddh * r;
            ab_c = ab_acc;
            FH[v * ls] = sb;
            ALB[(v + 1) * ls] = rb;
            SRC[(v + 1) * ls] = tdb;
            FDN[v * ls] = sdnb;
            // A-F's cotangents of the albedo and source of level v+1
            albB = cot(gu, v + 1) * fdn_n + ddF * r;
            srcB = cot(gu, v + 1) + Fh * d * r;
            dir = dir * s.tns;
            next();
            fd = fdn_n;
            Fh = Fh_n;
            ab = abn;
            sn = snn;
        }
        bb.alb_dif = albB + ab_c;
        Src_bN = srcB + sb_c;
        bb.alb_dir = day_sfc ? Src_bN * dirN : 0.0f;
    }
    // ---- A-S and A-C: the beam's adjoint bottom up, each layer's
    // Meador-Weaver chain transposed on the way ----
    float Dh = 0.0f;
    float dirl = 0.0f, supb = 0.0f, sdnb = 0.0f, rb = 0.0f, tdb = 0.0f;
    float dirn = 0.0f, supbn = 0.0f, sdnbn = 0.0f, rbn = 0.0f, tdbn = 0.0f;
    if (active) {
        Dh = cot(gd, N) + cot(gr, N) + (day_sfc ? Src_bN * alb_dir : 0.0f);
        col.layer(N - 1, &t, &w0, &asym, &mu);
        dirl = DIR[(N - 1) * ls];
        supb = FH[(N - 1) * ls];
        sdnb = FDN[(N - 1) * ls];
        rb = ALB[N * ls];
        tdb = SRC[N * ls];
    }
    for (int l = N - 1; l >= 0; --l) {
        SwBars b = {0.0f, 0.0f, 0.0f, 0.0f};
        if (active) {
            if (l > 0) {
                col.layer(l - 1, &tn, &w0n, &asymn, &mun);
                dirn = DIR[(l - 1) * ls];
                supbn = FH[(l - 1) * ls];
                sdnbn = FDN[(l - 1) * ls];
                rbn = ALB[l * ls];
                tdbn = SRC[l * ls];
            }
            SwLayerAD s = sw_layer_ad(t, w0, asym, mu);
            bool day = mu > 0.0f;
            float tns_b = dirl * Dh;
            float rdir_b = day ? supb * dirl : 0.0f;
            float tdir_b = day ? sdnb * dirl : 0.0f;
            float dl_src = day ? s.rdir * supb + s.tdir * sdnb : 0.0f;
            Dh = cot(gd, l) + cot(gr, l) + dl_src + s.tns * Dh;
            b = sw_layer_adjoint(s, t, w0, asym, mu, rb, tdb, rdir_b, tdir_b,
                                 tns_b);
            next();
            dirl = dirn;
            supb = supbn;
            sdnb = sdnbn;
            rb = rbn;
            tdb = tdbn;
        }
        sink.layer(l, b);
    }
    // the beam's seed: dir[0] = inc * mu0 of layer 0
    bb.inc = Dh * mu_top;
    bb.mu_top = Dh * inc;
    return bb;
}

}  // namespace rte
