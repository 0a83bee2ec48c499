// The gas optics of one (cell, g-point), their adjoint, and the per-cell
// sums of the descriptors' cotangents over a column's g-points, for the
// fused backward kernels (fused_lw_bwd.cu, fused_sw_bwd.cu). The
// derivation is that of the JAX package's fused adjoints
// (rte_rrtmgp_tpu/ops/pallas/fused_lw_bwd.py:19-36, the major, minor and
// cloud adjoints; fused_sw_bwd.py:21-24, Rayleigh).
//
// gas_lin is common.cuh's major_tau, minor_tau and rayleigh_k, term for
// term, with their derivatives in the cell's descriptors, from one
// gather per table entry; it reads the minors of a g-point from the slot
// table of ops/kernels/adjoint_segments.py (a few per g-point, in minor
// order) instead of scanning every minor. gas_adjoint, for an adjoint
// that knows the cotangents of tau, the Planck fraction and the Rayleigh
// k before it gathers, forms every entry's contribution to the
// descriptors' cotangents from the value it has just loaded and keeps no
// derivatives: fewer registers than gas_lin with gas_terms.
//
// A descriptor of one cell is read by every g-point of the column, so its
// cotangent is a sum over g-points: ftemp, fpress (and the SW Rayleigh
// scale) over all of them, feta and col_mix per flavor (a g-point's
// flavor is its band's, in the cell's atmosphere), the minor scalings
// over their windows (each minor's feta share at its own flavor), the
// by-band cloud inputs over the band. The TPU kernel summed per lane
// (columns on lanes, g-points in a loop); here g-points are threads, so
// each of these is a reduction across the block. CellSums::put does all
// of one cell's at once: every thread holds its own terms, segmented
// warp scans (__shfl_up_sync) sum them over runs of consecutive g-points
// of one band and flavor, of one minor slot, or of the whole warp; the
// last lane of each run leaves the run's sum in shared memory; after one
// barrier, one thread per output adds its runs in a fixed order. Two
// alternating partial buffers make that one barrier per cell enough. No
// atomics: two runs on the same inputs give the same bits.
#pragma once

#include "common.cuh"

namespace rte {

constexpr int kSegHeader = 8;     // adjoint_segments.HEADER

// One thread's minor slots: the first NS in registers, the rest (only
// where more than NS minor windows overlap) read from the segment table.
template <int NS>
struct SlotList {
    int m[NS];            // minor of slot s, -1 for none
    int code[NS];         // run code of slot s (adjoint_segments)
    const int* tab;       // this thread's per-thread table entries
    int threads, n;
    __device__ __forceinline__ int minor(int s) const {
        return __ldg(tab + (2 + 2 * s) * threads);
    }
    __device__ __forceinline__ int run_code(int s) const {
        return __ldg(tab + (1 + 2 * s) * threads);
    }
};

// The cell descriptors beyond CellDesc and the tables.
struct GasArgs {
    const int* __restrict__ jeta;
    const float* __restrict__ feta;
    const float* __restrict__ col_mix;
    const float* __restrict__ msc;
    const float* __restrict__ kmajor;
    const float* __restrict__ pfrac_tab;
    const float* __restrict__ klo;
    const float* __restrict__ kup;
    const float* __restrict__ krayl;
    const int* meta;               // (nminor, kMetaFields), shared memory
    int nflav, ncell, neta, npres1, ngpt, ncl, ncu;
};

// Minor m's absorption coefficient at g-point g of one cell (the 2-D
// lerp of minor_tau) and its derivatives in the feta of its flavor for
// each temperature corner and in ftemp.
__device__ __forceinline__ float minor_k(const GasArgs& a, const CellDesc& d,
                                         int m, int cell, int g, float* dfe,
                                         float* dft) {
    const int* mm = a.meta + m * kMetaFields;
    const int f = mm[1];
    const float* tab = mm[0] ? a.klo : a.kup;
    const int ncont = mm[0] ? a.ncl : a.ncu;
    const int kc = mm[4] + (g - mm[2]);
    float kk = 0.0f;
    *dft = 0.0f;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * a.nflav + f) * a.ncell + cell;
        int row = (d.jt + it) * a.neta + __ldg(a.jeta + fi);
        float fe = __ldg(a.feta + fi);
        float ftv = it == 0 ? 1.0f - d.ft : d.ft;
        float lo = __ldg(tab + row * ncont + kc);
        float hi = __ldg(tab + (row + 1) * ncont + kc);
        kk += ((1.0f - fe) * ftv) * lo + (fe * ftv) * hi;
        dfe[it] = ftv * (hi - lo);
        *dft += (it == 0 ? -1.0f : 1.0f) * ((1.0f - fe) * lo + fe * hi);
    }
    return kk;
}

// Gas optics of g-point g at one cell: tau (major and minors), with PF
// the Planck fraction, with RAY the Rayleigh k, and their derivatives in
// the cell's descriptors, each table entry gathered once: t_* of the
// major tau, p_* of the Planck fraction, r_* of the Rayleigh k; per
// minor slot s < NS, d tau / d scaling (m_k) and d tau / d feta at the
// minor's flavor (m_fe); m_ft: d tau / d ftemp of all the minors. The
// forward arithmetic is common.cuh's major_tau, minor_tau and rayleigh_k,
// term for term; the minors are the g-point's slots (in minor order), not
// a scan of every minor. A caller that reads only the forward values
// gets only those: the compiler drops the rest.
template <int NS>
struct GasLin {
    float tau, pf, kray;
    float t_ft, t_fp, t_fe[2], t_cm[2];
    float p_ft, p_fp, p_fe[2];
    float r_ft, r_fe[2];
    float m_k[NS], m_fe[NS][2], m_ft;
};

template <bool PF, bool RAY, int NS>
__device__ __forceinline__ GasLin<NS> gas_lin(const GasArgs& a,
                                              const CellDesc& d, int flav,
                                              int cell, int g,
                                              const SlotList<NS>& slots) {
    GasLin<NS> r = {};
    const int atm = d.lower ? 0 : 1;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * a.nflav + flav) * a.ncell + cell;
        int je = __ldg(a.jeta + fi);
        float fe = __ldg(a.feta + fi);
        float cm = __ldg(a.col_mix + fi);
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
                float wgt = (fev * ftv) * fpv;
                long long k = ((long long)(((d.jt + it) * a.neta + je + de)
                                           * a.npres1 + d.jp + dp))
                              * a.ngpt + g;
                float kv = __ldg(a.kmajor + k);
                r.tau += (wgt * cm) * kv;
                float ck = cm * kv;
                r.t_ft += st * (fev * fpv) * ck;
                r.t_fp += sp * (fev * ftv) * ck;
                r.t_fe[it] += se * (ftv * fpv) * ck;
                r.t_cm[it] += wgt * kv;
                if (PF) {
                    float pv = __ldg(a.pfrac_tab + k);
                    r.pf += wgt * pv;
                    r.p_ft += st * (fev * fpv) * pv;
                    r.p_fp += sp * (fev * ftv) * pv;
                    r.p_fe[it] += se * (ftv * fpv) * pv;
                }
            }
        }
        if (RAY) {
            long long base = (long long)((d.jt + it) * a.neta + je) * a.ngpt
                             + g;
            float lo = __ldg(a.krayl + base * 2 + atm);
            float hi = __ldg(a.krayl + (base + a.ngpt) * 2 + atm);
            r.kray += ((1.0f - fe) * ftv) * lo + (fe * ftv) * hi;
            r.r_fe[it] = ftv * (hi - lo);
            r.r_ft += st * ((1.0f - fe) * lo + fe * hi);
        }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        if (s >= slots.n || slots.m[s] < 0) break;
        const int m = slots.m[s];
        float dfe[2], dft;
        float kk = minor_k(a, d, m, cell, g, dfe, &dft);
        float scal = __ldg(a.msc + (long long)m * a.ncell + cell);
        r.tau += scal * kk;
        r.m_k[s] = kk;
        r.m_fe[s][0] = scal * dfe[0];
        r.m_fe[s][1] = scal * dfe[1];
        r.m_ft += scal * dft;
    }
    for (int s = NS; s < slots.n; ++s) {
        const int m = slots.minor(s);
        if (m < 0) break;
        float dfe[2], dft;
        float kk = minor_k(a, d, m, cell, g, dfe, &dft);
        float scal = __ldg(a.msc + (long long)m * a.ncell + cell);
        r.tau += scal * kk;
        r.m_ft += scal * dft;
    }
    return r;
}

// One (cell, g-point)'s terms of the per-cell sums, for NQ by-band
// values (LW cloud: 1, SW cloud: 3, none: 0), NF sums over all g-points
// (ftemp, fpress, and SW the Rayleigh scale) and NS minor slots.
template <int NQ, int NF, int NS>
struct GasTerms {
    float band[4 + NQ];            // feta x2, col_mix x2 at the flavor; q
    float minor[NS][3];            // per slot: scaling, feta x2
    float full[NF];                // ftemp, fpress[, dense]
};

// Adjoint of gas_lin for the cotangents tb of tau, pb of the Planck
// fraction (PF) and kb of the Rayleigh k (RAY): the descriptors' terms
// into o (band[0..3], minor, full[0..1]; the rest is the caller's), each
// table entry gathered once. Returns the Rayleigh k (RAY).
template <bool PF, bool RAY, int NQ, int NF, int NS>
__device__ __forceinline__ float gas_adjoint(const GasArgs& a,
                                             const CellDesc& d, int flav,
                                             int cell, int g,
                                             const SlotList<NS>& slots,
                                             float tb, float pb, float kb,
                                             GasTerms<NQ, NF, NS>* o) {
    float ft = 0.0f, fp = 0.0f, kr = 0.0f;
    const int atm = d.lower ? 0 : 1;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * a.nflav + flav) * a.ncell + cell;
        int je = __ldg(a.jeta + fi);
        float fe = __ldg(a.feta + fi);
        float cm = __ldg(a.col_mix + fi);
        float ftv = it == 0 ? 1.0f - d.ft : d.ft;
        float st = it == 0 ? -1.0f : 1.0f;
        float fe_b = 0.0f, cm_b = 0.0f;
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
            float fpv = dp == 0 ? 1.0f - d.fp : d.fp;
            float sp = dp == 0 ? -1.0f : 1.0f;
#pragma unroll
            for (int de = 0; de < 2; ++de) {
                float fev = de == 0 ? 1.0f - fe : fe;
                float se = de == 0 ? -1.0f : 1.0f;
                long long k = ((long long)(((d.jt + it) * a.neta + je + de)
                                           * a.npres1 + d.jp + dp))
                              * a.ngpt + g;
                float kv = __ldg(a.kmajor + k);
                float w = cm * kv * tb;
                if (PF) w += __ldg(a.pfrac_tab + k) * pb;
                ft += st * (fev * fpv) * w;
                fp += sp * (fev * ftv) * w;
                fe_b += se * (ftv * fpv) * w;
                cm_b += (fev * ftv * fpv) * kv * tb;
            }
        }
        if (RAY) {
            long long base = (long long)((d.jt + it) * a.neta + je) * a.ngpt
                             + g;
            float lo = __ldg(a.krayl + base * 2 + atm);
            float hi = __ldg(a.krayl + (base + a.ngpt) * 2 + atm);
            kr += ((1.0f - fe) * ftv) * lo + (fe * ftv) * hi;
            fe_b += ftv * (hi - lo) * kb;
            ft += st * ((1.0f - fe) * lo + fe * hi) * kb;
        }
        o->band[it] = fe_b;
        o->band[2 + it] = cm_b;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        o->minor[s][0] = o->minor[s][1] = o->minor[s][2] = 0.0f;
        if (s >= slots.n || slots.m[s] < 0) continue;
        const int m = slots.m[s];
        float dfe[2], dft;
        float kk = minor_k(a, d, m, cell, g, dfe, &dft);
        float sb = __ldg(a.msc + (long long)m * a.ncell + cell) * tb;
        o->minor[s][0] = kk * tb;
        o->minor[s][1] = dfe[0] * sb;
        o->minor[s][2] = dfe[1] * sb;
        ft += dft * sb;
    }
    for (int s = NS; s < slots.n; ++s) {
        const int m = slots.minor(s);
        if (m < 0) break;
        float dfe[2], dft;
        minor_k(a, d, m, cell, g, dfe, &dft);
        ft += dft * __ldg(a.msc + (long long)m * a.ncell + cell) * tb;
    }
    o->full[0] = ft;
    o->full[1] = fp;
    return kr;
}

// gas_adjoint's terms from a GasLin, for the cotangents tb of tau and kb
// of the Rayleigh k.
template <int NQ, int NF, int NS>
__device__ __forceinline__ void gas_terms(const GasLin<NS>& l, float tb,
                                          float kb,
                                          GasTerms<NQ, NF, NS>* o) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        o->band[it] = tb * l.t_fe[it] + kb * l.r_fe[it];
        o->band[2 + it] = tb * l.t_cm[it];
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        o->minor[s][0] = tb * l.m_k[s];
        o->minor[s][1] = tb * l.m_fe[s][0];
        o->minor[s][2] = tb * l.m_fe[s][1];
    }
    o->full[0] = tb * (l.t_ft + l.m_ft) + kb * l.r_ft;
    o->full[1] = tb * l.t_fp;
}

// The terms of slot s >= NS (scaling, feta x2) for the tau cotangent tb,
// which gas_adjoint does not keep: gathered again.
__device__ __forceinline__ void minor_terms(const GasArgs& a,
                                            const CellDesc& d, int m,
                                            int cell, int g, float tb,
                                            float (&v)[3]) {
    float dfe[2], dft;
    float kk = minor_k(a, d, m, cell, g, dfe, &dft);
    float sb = __ldg(a.msc + (long long)m * a.ncell + cell) * tb;
    v[0] = kk * tb;
    v[1] = dfe[0] * sb;
    v[2] = dfe[1] * sb;
}

// Where the per-cell cotangents go; a null pointer is not written.
struct GasBarsOut {
    float* ftemp;          // (ncell,)
    float* fpress;         // (ncell,)
    float* feta;           // (2, nflav, ncell)
    float* col_mix;        // (2, nflav, ncell)
    float* msc;            // (nminor, ncell)
    float* dense;          // (ncell,) the third all-g sum, or null
    float* band;           // (NQ, nbnd, ncell), or null
    int nbnd;              // bands of ``band`` (bands without g-points: 0)
};

// Inclusive sum over the lanes [lane - back, lane] of a warp, for N
// values at once (Hillis-Steele: fixed order); ``span`` bounds the runs'
// lengths. Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ void seg_scan(float (&v)[N], int back, int span) {
    for (int off = 1; off < span; off <<= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            float y = __shfl_up_sync(0xffffffffu, v[i], off);
            if (off <= back) v[i] += y;
        }
    }
}

// The per-cell sums over a column's g-points (one thread each), from the
// segment table of ops/kernels/adjoint_segments.py.
template <int NQ, int NF, int NS>
struct CellSums {
    static constexpr int NB = 4 + NQ;
    int band_code;
    SlotList<NS> slots;
    int nrb, nrm, span_b, span_m, nband;
    const int* csr;        // the output lists, in shared memory
    float* part;           // two partial buffers
    int stride, parity;

    // shared memory for the partials
    __host__ static int part_floats(int nrb, int nrm, int nwarps) {
        return 2 * (nrb * NB + nrm * 3 + nwarps * NF);
    }

    // Read this thread's codes and slots, copy the lists to ``csr_smem``
    // (no barrier: the caller's first barrier must come before put).
    __device__ __forceinline__ void init(const int* __restrict__ seg,
                                         int* csr_smem, float* part_smem) {
        const int* h = seg;
        const int nslot = h[0];
        nrb = h[1];
        nrm = h[2];
        span_b = h[3];
        span_m = h[4];
        nband = h[5];
        const int threads = h[6];
        const int len = h[7];
        const int* pt = seg + kSegHeader;
        const int t = threadIdx.x;
        band_code = __ldg(pt + t);
        slots.tab = pt + t;
        slots.threads = threads;
        slots.n = nslot;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            slots.code[s] = s < nslot ? slots.run_code(s) : 0;
            slots.m[s] = s < nslot ? slots.minor(s) : -1;
        }
        const int* src = pt + (1 + 2 * nslot) * threads;
        for (int i = t; i < len; i += blockDim.x) csr_smem[i] = src[i];
        csr = csr_smem;
        part = part_smem;
        stride = nrb * NB + nrm * 3 + (blockDim.x >> 5) * NF;
        parity = 0;
    }

    // Sum one cell's terms (every thread of the block calls it, idle
    // lanes with zero terms) and write the cell's cotangents. deep(m, w)
    // gives the terms of minor m in a slot s >= NS. One barrier.
    template <class Deep>
    __device__ __forceinline__ void put(GasTerms<NQ, NF, NS>& v,
                                        const GasBarsOut& out, bool lower,
                                        int cell, int ncell, int nflav,
                                        int nminor, Deep&& deep) {
        float* P = part + parity * stride;
        parity ^= 1;
        float* Pb = P;
        float* Pm = Pb + nrb * NB;
        float* Pf = Pm + nrm * 3;
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        seg_scan(v.band, band_code & 31, span_b);
        if (band_code >> 5) {
            float* q = Pb + ((band_code >> 5) - 1) * NB;
#pragma unroll
            for (int i = 0; i < NB; ++i) q[i] = v.band[i];
        }
        auto minor_run = [&](float (&w)[3], int code) {
            seg_scan(w, code & 31, span_m);
            if (code >> 5) {
                float* q = Pm + ((code >> 5) - 1) * 3;
                q[0] = w[0];
                q[1] = w[1];
                q[2] = w[2];
            }
        };
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            if (s >= slots.n) break;
            minor_run(v.minor[s], slots.code[s]);
        }
        for (int s = NS; s < slots.n; ++s) {
            const int m = slots.minor(s);
            float w[3] = {0.0f, 0.0f, 0.0f};
            if (m >= 0) deep(m, w);
            minor_run(w, slots.run_code(s));
        }
#pragma unroll
        for (int i = 0; i < NF; ++i) {
            float s = warp_sum(v.full[i]);
            if (lane == 0) Pf[warp * NF + i] = s;
        }
        __syncthreads();
        // one thread per output: flavors, bands, minors, full sums
        const int nbo = NQ > 0 ? out.nbnd : 0;
        const int nroles = nflav + nbo + nminor + NF;
        const int* band_first = csr;
        const int* flav_first = band_first + nband + 1
                                + (lower ? 0 : nflav + 1);
        const int* mflav_first = band_first + nband + 1 + 2 * (nflav + 1);
        const int* minor_first = mflav_first + nflav + 1;
        for (int r = threadIdx.x; r < nroles; r += blockDim.x) {
            if (r < nflav) {
                float fe0 = 0.0f, fe1 = 0.0f, cm0 = 0.0f, cm1 = 0.0f;
                for (int i = flav_first[r]; i < flav_first[r + 1]; ++i) {
                    const float* q = Pb + csr[i] * NB;
                    fe0 += q[0];
                    fe1 += q[1];
                    cm0 += q[2];
                    cm1 += q[3];
                }
                for (int i = mflav_first[r]; i < mflav_first[r + 1]; ++i) {
                    const float* q = Pm + csr[i] * 3;
                    fe0 += q[1];
                    fe1 += q[2];
                }
                out.feta[(long long)r * ncell + cell] = fe0;
                out.feta[(long long)(nflav + r) * ncell + cell] = fe1;
                out.col_mix[(long long)r * ncell + cell] = cm0;
                out.col_mix[(long long)(nflav + r) * ncell + cell] = cm1;
            } else if (r < nflav + nbo) {
                const int b = r - nflav;
                float s[NQ > 0 ? NQ : 1] = {};
                if (b < nband) {
                    for (int i = band_first[b]; i < band_first[b + 1]; ++i) {
                        const float* q = Pb + csr[i] * NB + 4;
#pragma unroll
                        for (int k = 0; k < NQ; ++k) s[k] += q[k];
                    }
                }
#pragma unroll
                for (int k = 0; k < NQ; ++k)
                    out.band[((long long)k * out.nbnd + b) * ncell + cell] =
                        s[k];
            } else if (r < nflav + nbo + nminor) {
                const int m = r - nflav - nbo;
                float s = 0.0f;
                for (int i = minor_first[m]; i < minor_first[m + 1]; ++i)
                    s += Pm[csr[i] * 3];
                out.msc[(long long)m * ncell + cell] = s;
            } else {
                const int k = r - nflav - nbo - nminor;
                float s = 0.0f;
                for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
                    s += Pf[w * NF + k];
                float* dst = k == 0 ? out.ftemp : k == 1 ? out.fpress
                                                         : out.dense;
                dst[cell] = s;
            }
        }
    }
};

}  // namespace rte
