// Helpers shared by the kernels: deterministic block sums and the
// gas-optics table lookups.
#pragma once

#include <cuda_runtime.h>

namespace rte {

constexpr int kMetaFields = 5;   // minor_meta row: lower, flavor, g0, width, start

// Sum over the 32 lanes of a warp (xor butterfly: every lane gets the
// same, order-fixed result).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Deterministic block reduction, step 1: the warp's sum of v goes to
// partial[warp * nlev + lev]. Every thread of the block must call it.
__device__ __forceinline__ void reduce_level(float v, float* partial,
                                             int nlev, int lev) {
    float s = warp_sum(v);
    if ((threadIdx.x & 31) == 0) partial[(threadIdx.x >> 5) * nlev + lev] = s;
}

// Step 2 (after __syncthreads): the warp partials of each level summed in
// warp order.
__device__ __forceinline__ float level_total(const float* partial,
                                             int nwarps, int nlev, int lev) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += partial[w * nlev + lev];
    return s;
}

// Per-band sums over the block's g-points (one thread each), one level at
// a time, deterministic: every thread stores its value in a shared slot,
// and after one barrier thread b (b < nband, strided by the block size)
// sums the slots of band b's g-points in ascending g-point order. No
// atomics. Band membership is read from gpt2band, so ragged or reordered
// bands work. Two slot buffers alternate: a call overwrites the buffer of
// the call before last only after every thread has passed the last
// call's barrier, so one barrier per call suffices. Every thread of the
// block must make every call. Shared memory: bytes(blockDim.x, nband).
struct BandSums {
    float* slots;          // 2 x blockDim.x
    int* members;          // blockDim.x: the g-points grouped by band
    int* first;            // nband + 1 offsets into members
    int nband;
    int parity;

    static __host__ __device__ size_t bytes(int nthreads, int nband) {
        return (size_t)(3 * nthreads + nband + 1) * sizeof(float);
    }

    // Carve the buffers from shared memory and build the band lists from
    // gpt2band (ngpt entries); ends with a barrier.
    __device__ void init(float* smem, const int* gpt2band, int ngpt,
                         int nband_) {
        const int n = blockDim.x;
        slots = smem;
        members = (int*)(smem + 2 * n);
        first = members + n;
        nband = nband_;
        parity = 0;
        int* band_of = (int*)slots;
        for (int i = threadIdx.x; i < ngpt; i += n) band_of[i] = gpt2band[i];
        __syncthreads();
        // g's place: the g-points of lower bands, then those of its own
        // band with a lower index
        for (int g = threadIdx.x; g < ngpt; g += n) {
            int b = band_of[g], pos = 0;
            for (int h = 0; h < ngpt; ++h) {
                int bh = band_of[h];
                pos += bh < b || (bh == b && h < g);
            }
            members[pos] = g;
        }
        for (int b = threadIdx.x; b <= nband; b += n) {
            int cnt = 0;
            for (int h = 0; h < ngpt; ++h) cnt += band_of[h] < b;
            first[b] = cnt;
        }
        __syncthreads();
    }

    // scale * (band b's sum of v) to out[b * stride].
    __device__ void put(float v, float* out, long long stride,
                        float scale) {
        float* s = slots + parity * blockDim.x;
        parity ^= 1;
        s[threadIdx.x] = v;
        __syncthreads();
        for (int b = threadIdx.x; b < nband; b += blockDim.x) {
            float t = 0.0f;
            for (int k = first[b]; k < first[b + 1]; ++k) t += s[members[k]];
            t *= scale;
            out[b * stride] = t;
        }
    }
};

// One flux field summed over g-points at each level: broadband into the
// warp partials (reduce_level; level_total once the sweeps are done), or,
// when ``band`` is set, per band straight into the output, element (lev,
// b) at band[lev * s_lev + b * s_band], scaled.
struct LevelSink {
    float* partial;        // broadband: (nwarps, nlev) in shared memory
    int nlev;
    float* band;           // by band: null for broadband
    long long s_lev, s_band;
    float scale;

    __device__ __forceinline__ void put(BandSums& bs, float v,
                                        int lev) const {
        if (band)
            bs.put(v, band + lev * s_lev, s_band, scale);
        else
            reduce_level(v, partial, nlev, lev);
    }
};

// Fields read through element strides, so that a permuted or broadcast
// tensor view needs no copy: Field2 is (i, column), Field3 (i, layer,
// column), i a g-point or a band. A null p marks an absent field. They
// are kernel inputs, never written by the kernel, so they load through
// the read-only path (__ldg), which a plain pointer in a struct would
// not get and without which their loads stay ordered behind the
// kernel's scratch stores.
struct Field2 {
    const float* p;
    int s0, sc;
    __device__ __forceinline__ float at(int i, int c) const {
        return __ldg(p + (long long)i * s0 + (long long)c * sc);
    }
};

// One (i, column) line of a Field3, indexed by layer.
struct Line {
    const float* p;
    int sl;
    __device__ __forceinline__ float operator[](int l) const {
        return __ldg(p + (long long)l * sl);
    }
};

struct Field3 {
    const float* p;
    int s0, sl, sc;
    __device__ __forceinline__ Line line(int i, int c) const {
        return Line{p ? p + (long long)i * s0 + (long long)c * sc : nullptr,
                    sl};
    }
};

// The launchers' host-side constructors of the fields from a pointer
// and its element strides.
inline Field2 f2(const void* p, int s0, int sc) {
    return Field2{(const float*)p, s0, sc};
}

inline Field3 f3(const void* p, int s0, int sl, int sc) {
    return Field3{(const float*)p, s0, sl, sc};
}

// Major-gas tau (and, with pfrac_tab, the Planck fraction) of g-point g
// at one cell: the 8-corner lerp over (temperature, eta, pressure) of the
// plain (ntemp, neta, npres+1, ngpt) tables, the upper atmosphere reading
// the pressure row above its index (reference interpolate3D_byflav).
struct CellDesc {
    int jt, jp;        // lower temperature index, pressure base row
    float ft, fp;      // temperature and pressure fractions
    bool lower;        // cell below the tropopause
};

__device__ __forceinline__ CellDesc load_cell(const int* jtemp,
                                              const float* ftemp,
                                              const int* jpress,
                                              const float* fpress,
                                              const int* tropo, int cell) {
    CellDesc d;
    d.lower = tropo[cell] != 0;
    d.jt = jtemp[cell];
    d.ft = ftemp[cell];
    d.jp = jpress[cell] + (d.lower ? 0 : 1);
    d.fp = fpress[cell];
    return d;
}

__device__ __forceinline__ void major_tau(
        const CellDesc& d, int flav, int nflav, int ncell, int cell,
        const int* __restrict__ jeta, const float* __restrict__ feta,
        const float* __restrict__ col_mix,
        const float* __restrict__ kmajor, const float* __restrict__ pfrac_tab,
        int neta, int npres1, int ngpt, int g, float* tau, float* pf) {
    float t = 0.0f, p = 0.0f;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * nflav + flav) * ncell + cell;
        int je = jeta[fi];
        float fe = feta[fi];
        float cm = col_mix[fi];
        float ftv = it == 0 ? 1.0f - d.ft : d.ft;
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
            float fpv = dp == 0 ? 1.0f - d.fp : d.fp;
#pragma unroll
            for (int de = 0; de < 2; ++de) {
                float fev = de == 0 ? 1.0f - fe : fe;
                float wgt = (fev * ftv) * fpv;
                long long k = ((long long)(((d.jt + it) * neta + je + de)
                                           * npres1 + d.jp + dp)) * ngpt + g;
                t += (wgt * cm) * __ldg(kmajor + k);
                if (pfrac_tab) p += wgt * __ldg(pfrac_tab + k);
            }
        }
    }
    *tau = t;
    *pf = p;
}

// Word w of g-point g's minor mask: bit m - 32 w set where minor m's
// g-point window (minor_meta rows lower, flavor, g0, width, start) holds
// g.
__device__ __forceinline__ unsigned minor_word(
        const int* __restrict__ minor_meta, int nminor, int w, int g) {
    unsigned bits = 0;
    for (int m = 32 * w; m < nminor && m < 32 * w + 32; ++m) {
        int g0 = __ldg(minor_meta + m * kMetaFields + 2);
        int width = __ldg(minor_meta + m * kMetaFields + 3);
        bits |= (g >= g0 && g < g0 + width ? 1u : 0u) << (m - 32 * w);
    }
    return bits;
}

// The 2-D (temperature x eta) lerp of one minor, or of the Rayleigh
// table, at one cell from values already loaded: the temperature fraction
// ft, and per temperature it (jt, jt + 1) the feta of the flavor and the
// table's values at the lower and upper eta rows. minor_tau_lane,
// rayleigh_k and gas_minor.cu's kernels all go through it, so rows 2, 3, 5
// and 6 share its arithmetic and order.
__device__ __forceinline__ float minor_lerp(float ft, const float* fe,
                                            const float* lo,
                                            const float* hi) {
    float kk = 0.0f;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        float ftv = it == 0 ? 1.0f - ft : ft;
        kk += ((1.0f - fe[it]) * ftv) * lo[it] + (fe[it] * ftv) * hi[it];
    }
    return kk;
}

// Minor-gas contributions to g-point g at one cell (reference
// gas_optical_depths_minor): per minor whose window holds g, read from
// its mask words (words[w * wstride], minor_word), in ascending order,
// minor_lerp of its kminor column times its scaling row; meta in shared
// memory, lower-atmosphere minors first. A minor whose scaling is 0 at
// this cell (the other atmosphere's) adds exactly nothing (tau + 0 x kk
// is tau for a finite kk), and its table reads are skipped.
__device__ __forceinline__ float minor_tau_lane(
        float tau, const CellDesc& d, const int* meta, const unsigned* words,
        int nwords, int wstride, int nflav, int ncell, int cell,
        const int* __restrict__ jeta, const float* __restrict__ feta,
        const float* __restrict__ msc, const float* __restrict__ klo,
        const float* __restrict__ kup, int ncl, int ncu, int neta, int g) {
    for (int w = 0; w < nwords; ++w) {
        unsigned bits = words[w * wstride];
        while (bits) {
            const int m = 32 * w + __ffs(bits) - 1;
            bits &= bits - 1;
            const float s = msc[(long long)m * ncell + cell];
            if (s == 0.0f) continue;
            const int* mm = meta + m * kMetaFields;
            int f = mm[1];
            const float* tab = mm[0] ? klo : kup;
            int ncont = mm[0] ? ncl : ncu;
            int k = mm[4] + (g - mm[2]);
            float fe[2], lo[2], hi[2];
#pragma unroll
            for (int it = 0; it < 2; ++it) {
                int fi = (it * nflav + f) * ncell + cell;
                int row = (d.jt + it) * neta + jeta[fi];
                fe[it] = feta[fi];
                lo[it] = __ldg(tab + row * ncont + k);
                hi[it] = __ldg(tab + (row + 1) * ncont + k);
            }
            tau += s * minor_lerp(d.ft, fe, lo, hi);
        }
    }
    return tau;
}

// Rayleigh absorption coefficient of g-point g at one cell (reference
// compute_tau_rayleigh): the 2-D (temperature x eta) lerp of krayl
// (ntemp, neta, ngpt, 2) in the cell's atmosphere atm (0 below the
// tropopause); the caller scales it by col_h2o + col_dry.
__device__ __forceinline__ float rayleigh_k(
        const CellDesc& d, int flav, int nflav, int ncell, int cell,
        const int* __restrict__ jeta, const float* __restrict__ feta,
        const float* __restrict__ krayl, int neta, int ngpt, int g) {
    int atm = d.lower ? 0 : 1;
    float fe[2], lo[2], hi[2];
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        int fi = (it * nflav + flav) * ncell + cell;
        fe[it] = feta[fi];
        long long base = (long long)((d.jt + it) * neta + jeta[fi]) * ngpt
                         + g;
        lo[it] = __ldg(krayl + base * 2 + atm);
        hi[it] = __ldg(krayl + (base + ngpt) * 2 + atm);
    }
    return minor_lerp(d.ft, fe, lo, hi);
}

// Dynamic shared memory beyond 48 KB must be opted into per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// As many blocks of ``kernel`` as the card holds at once at ``threads``
// threads and ``smem`` bytes of dynamic shared memory (the current
// device's SMs times the resident blocks per SM), queried once per
// (device, kernel, threads, smem) and host thread: the gathers launch
// several times per step, on steps whose pace the host sets.
template <typename K>
cudaError_t resident_grid(K kernel, int threads, size_t smem,
                          long long* limit) {
    struct Key {
        int dev;
        const void* fn;
        int threads;
        size_t smem;
        long long limit;
    };
    constexpr int kKeys = 16;
    thread_local Key keys[kKeys];
    thread_local int nkeys = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const void* fn = (const void*)kernel;
    for (int i = 0; i < nkeys && i < kKeys; ++i)
        if (keys[i].dev == dev && keys[i].fn == fn
                && keys[i].threads == threads && keys[i].smem == smem) {
            *limit = keys[i].limit;
            return cudaSuccess;
        }
    int nsm = 0, per = 0;
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                            threads, smem);
    if (err != cudaSuccess) return err;
    if (per == 0) return cudaErrorInvalidConfiguration;
    *limit = (long long)per * nsm;
    keys[nkeys++ % kKeys] = Key{dev, fn, threads, smem, *limit};
    return cudaSuccess;
}

}  // namespace rte

extern "C" const char* rte_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
