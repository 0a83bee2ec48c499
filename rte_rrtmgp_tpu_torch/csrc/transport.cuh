// Radiative transfer shared by the fused kernels and the stand-alone
// solvers: the LW linear-in-tau layer source, the SW Meador-Weaver layer
// coefficients, the LW two-stream layer coefficients and sources, and the
// on-chip adding with its cluster-wide sums (the fused SW step, the SW
// and LW two-stream solves; the sums also serve the fused LW step, the LW
// no-scattering solve and the SW solve's adjoint), and the ring sweeps of
// the LW no-scattering solve and its adjoint.
#pragma once

#include <cfloat>
#include <cmath>

#include <cooperative_groups.h>

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

// ---- on-chip adding: the layer fields of one chunk of a column's
// g-points in shared memory, the column's chunks one thread-block cluster
// (the fused SW step, the SW and LW two-stream solves) ----

// One layer of the adding build, bottom up (Shonk-Hogan Eqs 9-13;
// reference adding :1135-1245): from the layer's rdif r, tdif t and
// sources sdn, sup and the albedo and source of the level below it (alb, src,
// replaced by those of the level above), the four values that the down
// sweep needs: a = t dd and b = (r src + sdn) dd with dd = 1 / (1 - r
// alb), and the level below's alb and src. The down sweep is then fdn' =
// a fdn + b, fup' = fdn' alb + src (adding_down).
__device__ __forceinline__ float4 adding_up(float r, float t, float sdn,
                                            float sup, float& alb,
                                            float& src) {
    float dd = 1.0f / (1.0f - r * alb);
    float4 k = make_float4(t * dd, (r * src + sdn) * dd, alb, src);
    float src_v = sup + t * dd * (src + alb * sdn);
    alb = r + t * t * alb * dd;
    src = src_v;
    return k;
}

// The down sweep over adding_up's values k[v * stride] (v the layer, top
// first) from the diffuse flux fdn_top and the albedo and source of the
// top level: put(fup, fdn, level) at every level. Each layer's values
// are loaded one layer ahead of their use. An idle lane passes 0.
template <class Put>
__device__ __forceinline__ void adding_down(bool active, const float4* k,
                                            int stride, int nlay, float alb,
                                            float src, float fdn_top,
                                            Put&& put) {
    float fdn = active ? fdn_top : 0.0f;
    float fup = active ? fdn * alb + src : 0.0f;
    put(fup, fdn, 0);
    float4 q = k[0];
    for (int v = 0; v < nlay; ++v) {
        float4 n = k[(v + 1 < nlay ? v + 1 : v) * stride];
        if (active) {
            fdn = q.x * fdn + q.y;
            fup = fdn * q.z + q.w;
        }
        put(fup, fdn, v + 1);
        q = n;
    }
}

// ---- serial sweeps from shared memory (the LW no-scattering solve and
// its adjoint) ----

// Layers a ring sweep loads ahead of their use; a field it reads needs
// this many rows before its first layer and after its last that the
// kernel may read (padding, or another field's rows), never used.
constexpr int kRingAhead = 4;

// One serial sweep of a thread over nlay layers, down (layer 0 first) or
// up: load(l, v) reads layer l's NF values, step(l, v) advances the
// recurrence and may write layer l's values. A ring of kRingAhead
// layers' values: right after a layer is stepped through, the layer
// kRingAhead further on is loaded into its slot, so that a step waits on
// no shared-memory load. The loads run up to kRingAhead layers past
// either end (never used); a step writes only its own layer, loaded
// before and not loaded again. Whole groups of kRingAhead layers run
// without a per-layer test, the remainder after them (a test per step
// cost the LW solve 6-19%, PERF.md).
template <int NF, class Load, class Step>
__device__ __forceinline__ void ring_sweep(int nlay, bool down, Load&& load,
                                           Step&& step) {
    auto at = [&](int i) { return down ? i : nlay - 1 - i; };
    float v[kRingAhead][NF];
#pragma unroll
    for (int u = 0; u < kRingAhead; ++u) load(at(u), v[u]);
    int i0 = 0;
    for (; i0 + kRingAhead <= nlay; i0 += kRingAhead) {
#pragma unroll
        for (int u = 0; u < kRingAhead; ++u) {
            step(at(i0 + u), v[u]);
            load(at(i0 + u + kRingAhead), v[u]);
        }
    }
#pragma unroll
    for (int u = 0; u < kRingAhead - 1; ++u)
        if (i0 + u < nlay) step(at(i0 + u), v[u]);
}

// The sums over the g-points of a column whose g-points are spread over
// the blocks of a thread-block cluster, one chunk of ``lanes`` g-points
// each, deterministic and without atomics: the fluxes of each level, or
// the SW adjoint's mu0 cotangent of each layer (its "levels"). The sweeps
// leave each field's value of every (level, g-point) of the chunk in
// shared memory (zero on an idle lane); reduce() then sums them, all
// threads of the block together: broadband per level each 32 g-points'
// warp-shuffle sum (common.cuh::warp_sum), by band per level each band's
// g-points of the chunk in ascending order (band membership from
// gpt2band, so ragged or reordered bands work; a band with none of them
// sums to 0), into ``part`` at the same offset in every block.
// finalize() sums the blocks' parts over the cluster's distributed shared
// memory, ranks in order and within a rank its warps in order (so
// broadband, with 32-wide chunks, in the warp order of a block that held
// the whole column), each rank taking a run of the outputs, between two
// cluster barriers.
struct ClusterSums {
    float* part;           // nf x (nw or nband) x nlev
    int* members;          // lanes: the chunk's g-points grouped by band
    int* first;            // nband + 1 offsets into members
    int* band_of;          // lanes: each g-point's band
    int nf, nw, nlev, nband;
    bool byband;

    static __host__ __device__ size_t bytes(int nf, int lanes, int nlev,
                                            int nband) {
        return nband > 0
            ? (size_t)(nf * nband * nlev + 2 * lanes + nband + 1)
                  * sizeof(float)
            : (size_t)nf * (lanes / 32) * nlev * sizeof(float);
    }

    // smem: bytes(nf, lanes, nlev, nband) of shared memory, nband 0 for
    // broadband sums; by band the chunk's band lists from gpt2band (the
    // chunk's g-points g0 .. g0 + lanes - 1 below ngpt). Every thread of
    // the block calls it; by band it ends with a block barrier.
    __device__ void init(float* smem, int nf_, int lanes, int nlev_,
                         int nband_, const int* gpt2band, int g0,
                         int ngpt) {
        nf = nf_;
        nw = lanes / 32;
        nlev = nlev_;
        nband = nband_;
        byband = nband_ > 0;
        part = smem;
        if (!byband) return;
        members = (int*)(smem + nf * nband * nlev);
        band_of = members + lanes;
        first = band_of + lanes;
        const int m = ngpt - g0 < lanes ? ngpt - g0 : lanes;
        for (int i = threadIdx.x; i < m; i += blockDim.x)
            band_of[i] = __ldg(gpt2band + g0 + i);
        __syncthreads();
        for (int i = threadIdx.x; i < m; i += blockDim.x) {
            int b = band_of[i], pos = 0;
            for (int h = 0; h < m; ++h) {
                int bh = band_of[h];
                pos += bh < b || (bh == b && h < i);
            }
            members[pos] = i;
        }
        for (int b = threadIdx.x; b <= nband; b += blockDim.x) {
            int cnt = 0;
            for (int h = 0; h < m; ++h) cnt += band_of[h] < b;
            first[b] = cnt;
        }
        __syncthreads();
    }

    // After the sweeps and a block barrier, every thread of the block:
    // the chunk's sums of val(f, lev, lane), field f's value of g-point
    // g0 + lane at level lev, into part. Broadband warp k of the block
    // takes levels k, k + nwarps, ... and sums every field and warp of
    // each; by band a thread takes one (band, level) item and sums every
    // field of it. No integer division per warp sum.
    template <class Val>
    __device__ void reduce(Val&& val) {
        if (byband) {
            for (int it = threadIdx.x; it < nband * nlev; it += blockDim.x) {
                const int b = it / nlev, lev = it - b * nlev;
                for (int f = 0; f < nf; ++f) {
                    float t = 0.0f;
                    for (int k = first[b]; k < first[b + 1]; ++k)
                        t += val(f, lev, members[k]);
                    part[f * nband * nlev + it] = t;
                }
            }
            return;
        }
        const int lane = threadIdx.x & 31;
        for (int lev = threadIdx.x >> 5; lev < nlev;
             lev += blockDim.x >> 5)
            for (int f = 0; f < nf; ++f)
                for (int w = 0; w < nw; ++w) {
                    float s = warp_sum(val(f, lev, w * 32 + lane));
                    if (lane == 0) part[(f * nw + w) * nlev + lev] = s;
                }
    }

    // reduce() for fields f0 .. f1 - 1, taken by the block's threads t0
    // and up (so that the threads below t0 can still be sweeping), from
    // row(f, lev): the values of field f at level lev, g-point g0 + i at
    // row(f, lev)[i]. Broadband each warp sum by one thread: the 32
    // values of one warp's g-points at one level added pairwise in the
    // xor butterfly's order, so with warp_sum's bits, one (field, warp,
    // level) item per thread, levels fastest, so that rows padded to an
    // odd stride are read without bank conflicts; by band one (band,
    // level) item per thread, as reduce(). The threads t0 and up call it
    // once the fields' values are final.
    template <class Row>
    __device__ void reduce_by_thread(Row&& row, int f0, int f1,
                                     int t0 = 0) {
        const int tid = (int)threadIdx.x - t0, nt = (int)blockDim.x - t0;
        if (tid < 0) return;
        if (byband) {
            for (int it = tid; it < nband * nlev; it += nt) {
                const int b = it / nlev, lev = it - b * nlev;
                for (int f = f0; f < f1; ++f) {
                    const float* r = row(f, lev);
                    float t = 0.0f;
                    for (int k = first[b]; k < first[b + 1]; ++k)
                        t += r[members[k]];
                    part[f * nband * nlev + it] = t;
                }
            }
            return;
        }
        const int per = nw * nlev;
        for (int it = tid; it < (f1 - f0) * per; it += nt) {
            const int df = it / per, r = it - df * per;
            const int w = r / nlev, lev = r - w * nlev, f = f0 + df;
            const float* v = row(f, lev) + w * 32;
            float x[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) x[i] = v[i] + v[i + 16];
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] += x[i + 8];
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] += x[i + 4];
            x[0] += x[2];
            x[1] += x[3];
            part[(f * nw + w) * nlev + lev] = x[0] + x[1];
        }
    }

    // After reduce, every thread of every block of the cluster: emit(i,
    // total) for each output item i (broadband the level, by band band *
    // nlev + level), each rank taking an equal run of consecutive items,
    // one per thread (so that a warp's remote loads are contiguous),
    // total(f) the cluster's sum of field f for it. With one partial per
    // rank (by band, or 32-wide chunks) all nr partials of an item are
    // loaded before any is added, so that the remote loads overlap
    // instead of waiting one behind the other; wider chunks' warps are
    // summed one after the other. At most 8 ranks (ops/kernels/onchip.py).
    template <class Emit>
    __device__ void finalize(Emit&& emit) {
        namespace cg = cooperative_groups;
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        constexpr int kRanks = 8;
        const int nr = (int)cluster.num_blocks();
        const int rank = (int)cluster.block_rank();
        const int items = byband ? nband * nlev : nlev;
        const int rows = byband ? nband : nw;
        const int per = byband ? 1 : nw;        // partials per rank
        const int span = (items + nr - 1) / nr;
        const int end = min(items, (rank + 1) * span);
        for (int i = rank * span + (int)threadIdx.x; i < end;
             i += (int)blockDim.x) {
            auto total = [&](int f) {
                const float* p = part + f * rows * nlev + i;
                float s = 0.0f;
                if (per == 1) {
                    float v[kRanks];
#pragma unroll
                    for (int q = 0; q < kRanks; ++q)
                        v[q] = q < nr ? *cluster.map_shared_rank(p, q)
                                      : 0.0f;
#pragma unroll
                    for (int q = 0; q < kRanks; ++q)
                        if (q < nr) s += v[q];
                    return s;
                }
                for (int q = 0; q < nr; ++q) {
                    const float* r = cluster.map_shared_rank(p, q);
                    for (int w = 0; w < per; ++w) s += r[w * nlev];
                }
                return s;
            };
            emit(i, total);
        }
        cluster.sync();   // no block leaves while another reads its part
    }
};

// Launch ``kernel`` on ncol clusters of nchunk blocks each (block
// c * nchunk + rank holds chunk ``rank`` of column c), dynamic shared
// memory smem, and return the launch error.
template <typename K, typename... Args>
cudaError_t launch_clusters(K kernel, int ncol, int nchunk, int threads,
                            size_t smem, cudaStream_t stream,
                            Args... args) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(ncol * nchunk));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)nchunk;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// Resident blocks per SM of ``kernel`` and the clusters of nchunk blocks
// that the card holds at once (both at shared memory smem), packed as
// blocks * 65536 + clusters, or a negative CUDA error.
template <typename K>
int cluster_occupancy(K kernel, int nchunk, int threads, size_t smem) {
    cudaError_t err = allow_smem(kernel, smem);
    int blocks = 0, clusters = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, threads, smem);
    if (err == cudaSuccess) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((unsigned)(nchunk * 1024));
        cfg.blockDim = dim3((unsigned)threads);
        cfg.dynamicSmemBytes = smem;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = (unsigned)nchunk;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    }
    return err == cudaSuccess ? blocks * 65536 + clusters : -(int)err;
}

}  // namespace rte
