// One-angle LW no-scattering solve with broadband or per-band output. One
// kernel, three launchers:
//   launch_solver_lw        the public rte_lw's solver (one launch per
//                           quadrature angle): contiguous (column, layer,
//                           g-point) fields, a scalar secant or one per
//                           (column, g-point), output (column, level), or
//                           per-band sums (column, level, band);
//   launch_solver_lw_lanes  the staged branch's solver: (g-point, layer,
//                           column) fields through any element strides,
//                           output (level, column);
//   launch_solver_lw_pfrac  the same with the sources formed in the
//                           kernel from the Planck fraction and the band
//                           values of each g-point's band (gpt2band, so
//                           ragged bands work), plus the by-band cloud
//                           absorption.
//
// Replaces the TPU kernels rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py::
// lw_noscat_broadband_lane and ops/pallas/solver_lanes.py::
// lw_noscat_broadband_lanes and ::lw_noscat_broadband_lanes_pfrac
// (reference mo_rte_solver_kernels.F90:51-240, Planck sources
// compute_Planck_source :568-710). Plain twins:
// rte_rrtmgp_tpu_torch/ops/kernels/solver_lw.py::lw_noscat_plain and
// ops/kernels/solver_lanes.py::lw_noscat_lanes_plain,
// ::lw_noscat_lanes_pfrac_plain.
//
// Layout: a column's g-points are cut into chunks of ``chunk`` (a
// multiple of 32, at most 8 chunks: ops/kernels/onchip.py::
// onchip_geometry), one block of kThreads threads per chunk, and the
// column's chunks are one thread-block cluster. Every input is read
// through its element strides (common.cuh::Field3), so the gathers'
// (column, layer, g-point) output passed as a permuted view keeps g
// fastest and the loads coalesced; a band field is read at the thread's
// band. The chunk's layer fields live in shared memory, one row of
// ``chunk`` g-points per layer padded to chunk + 1 floats (the sums read
// across rows), each field with kAhead padding rows at either end; no
// device-memory scratch:
//   pass 1, every thread, kThreads / chunk layers at a time (thread
//   lane + chunk * k takes g-point g0 + lane and the layers k, k + K,
//   ...), each input read once, kUnroll layers' inputs loaded before any
//   is used: per layer exp(-tau * ds) and the linear-in-tau sources
//   (transport.cuh::lw_source, the code of the fused LW kernel); with
//   RESCALE Tang's scaled depth and cn (an = 1 - t^2 is recomputed in the
//   sweeps); with PFRAC first tau (plus the cloud absorption of the
//   thread's band) and the Planck fraction staged in shared memory, then,
//   after a barrier, per layer the layer source and the level sources of
//   its top and bottom (interior levels from the geometric mean of the
//   adjacent layers' fractions, 0 where their product is not positive)
//   and the transmittance and sources;
//   then the chunk's first ``chunk`` threads, one per g-point, sweep, a
//   ring of kAhead layers' values loaded ahead of their use
//   (transport.cuh::ring_sweep):
//   down from the incident flux, the surface emission and reflection, up;
//   with RESCALE the radiance at each layer top kept by the first down
//   sweep, adjusted in the up sweep and a second down sweep (Tang 2018);
//   with JAC the surface Jacobian's sweep, bottom up, last. Each level's
//   flux is written in place of a layer value the sweeps no longer need;
//   nothing is summed inside the recurrences. Meanwhile the block's other
//   threads take the chunk's sums of each level of a field that is final
//   (transport.cuh::ClusterSums::reduce_by_thread): the down flux during
//   the up sweep, with RESCALE the up flux during the second down sweep;
//   then every thread the other fields' sums, and the cluster's sums
//   (ClusterSums::finalize).
//
// What bounds it on this card: reading tau and the sources (or tau, the
// Planck fraction and the band fields), 12 B per (column, layer,
// g-point), 20 B with rescaling, once, which needs many warps in flight:
// pass 1 alone runs near the card's rate (0.32 ms of the path's 0.53 at
// 4096 x 72, its bound 0.28); then the serial sweeps on one warp per
// chunk, while the block holds its shared memory. Walked in device
// memory, one block per column and one thread per g-point, each sweep
// read the inputs again (the down sweep alone at 82% of the card's rate)
// and the rescaled variant round-tripped the radiances through a 0.30 GB
// scratch at 4096 x 72 (PERF.md). Shared memory per block: 12 B x (nlay +
// 2 kAhead) x (chunk + 1) (20 with RESCALE, 16 with PFRAC), 16 B x chunk
// and the sums.
//
// Sums: per level, broadband each 32 g-points' sum added pairwise in the
// warp butterfly's order (common.cuh::warp_sum's bits), by band each
// band's g-points of the chunk in ascending order (gpt2band, so ragged or
// reordered bands work), then summed over the cluster's shared memory in
// rank order (transport.cuh::ClusterSums), times pi * weight; the
// Jacobian is always broadband. Deterministic, no atomics. Broadband with
// 32-wide chunks this is the warp order of one block that held the whole
// column; by band, for a band inside one chunk, the ascending order of
// its g-points. So rows 7 and 10 give the one-block kernel's bits; row
// 11 does not: nvcc compiles its sources' products otherwise, within an
// ulp or two (PERF.md).
//
// Contract (checked by the Python wrappers): float32, ngpt <= 1024, the
// column height within onchip_geometry's limit, offsets within 32-bit
// strides, top of the atmosphere at layer 0.

#include "common.cuh"
#include "transport.cuh"

namespace {

using rte::Field2;
using rte::Field3;
using rte::Line;
using rte::f2;
using rte::f3;

constexpr int kThreads = 256;   // per block: chunk g-points x layer lanes
constexpr int kAhead = rte::kRingAhead;  // sweeps: layers loaded ahead
                                         // of their use; each field's
                                         // padding rows at both ends
constexpr int kExtra = 4;       // per g-point: dn at the top, up and the
                                // Jacobian at the surface, PFRAC's surface
                                // source

struct LwArgs {
    Field3 tau, lay, lev, ssa, asy;      // lay/lev: without PFRAC
    Field3 pfrac, pb_lay, pb_lev, cld;   // PFRAC; cld.p null: no cloud
    Field2 emis, sfc, sfc_jac, inc;      // sfc: without PFRAC
    Field2 ds, pb_sfc;                   // ds.p null: ds_scalar
    const int* gpt2band;                 // PFRAC, or by-band output
    float* up;
    float* dn;
    float* jac;
    float* band_up;                      // by band: (column, level, band);
    float* band_dn;                      // null: broadband up/dn
    int out_sl, out_sc;                  // output strides of (level, column)
    int nlay, ngpt, nband, chunk;
    float ds_scalar, piw;
};

__device__ __forceinline__ float geometric_mean(float a, float b) {
    float pp = a * b;
    return pp > 0.0f ? sqrtf(pp) : 0.0f;
}

// Resident blocks per SM that the registers are capped for: the shared
// memory at 72 layers and 32-wide chunks leaves room for 6 (broadband), 5
// (PFRAC, by band) or 4 (RESCALE).
__host__ __device__ constexpr int blocks_per_sm(bool rescale, bool pfrac,
                                                bool byband) {
    return rescale ? 4 : (pfrac || byband) ? 5 : 6;
}

// Pass 1: layers per thread whose inputs are loaded before any is used; 2
// within the 40 registers of 6 blocks per SM (3 spilled there), 3 where
// the cap is higher (PERF.md).
__host__ __device__ constexpr int pass1_unroll(bool rescale, bool pfrac,
                                               bool byband) {
    return blocks_per_sm(rescale, pfrac, byband) == 6 ? 2 : 3;
}

template <bool RESCALE, bool JAC, bool PFRAC, bool BYBAND>
__global__ void __launch_bounds__(kThreads,
                                  blocks_per_sm(RESCALE, PFRAC, BYBAND))
solver_lw_kernel(const LwArgs a) {
    extern __shared__ float smem[];
    namespace cg = cooperative_groups;
    const int nlay = a.nlay, ngpt = a.ngpt, chunk = a.chunk;
    const int nlev = nlay + 1;
    const int nchunk = (int)cg::this_cluster().num_blocks();
    const int rank = (int)cg::this_cluster().block_rank();
    const int c = blockIdx.x / nchunk;
    const int ld = chunk + 1;           // a layer's row, padded: the sums
                                        // read across rows
    // a field: nlay rows, and kAhead padding rows at either end for the
    // sweeps' loads
    const size_t rows = (size_t)(nlay + 2 * kAhead) * ld;
    float* tr_s = smem + kAhead * ld;   // (nlay, ld): PFRAC tau, then
                                        // trans, then JAC's flux
    float* sd_s = tr_s + rows;          // sdn, then dn flux
    float* su_s = sd_s + rows;          // sup, then (no RESCALE) up flux
    float* cn_s = su_s + rows;          // RESCALE: Tang's cn
    float* rad_s = cn_s + (RESCALE ? rows : 0);    // RESCALE: the radiance
                                        // at the layer top, then up flux
    float* pf_s = rad_s + (RESCALE ? rows : 0);    // PFRAC: the Planck
                                                   // fraction
    float* ex_s = smem + (RESCALE ? 5 : PFRAC ? 4 : 3) * rows;  // (kExtra,
                                                                //  chunk)
    float* part = ex_s + kExtra * chunk;
    rte::ClusterSums sums, jsums;       // jsums: by band, the Jacobian
    sums.init(part, BYBAND ? 2 : 2 + JAC, chunk, nlev, BYBAND ? a.nband : 0,
              a.gpt2band, rank * chunk, ngpt);
    if (BYBAND && JAC)
        jsums.init(part + rte::ClusterSums::bytes(2, chunk, nlev, a.nband)
                              / sizeof(float),
                   1, chunk, nlev, 0, nullptr, 0, ngpt);

    const int lane = threadIdx.x % chunk;
    const int g = rank * chunk + lane;
    const bool active = g < ngpt;
    const int gg = active ? g : 0;      // idle lanes never read
    const int k0 = threadIdx.x / chunk, kstep = kThreads / chunk;
    const float ds = a.ds.p ? a.ds.at(gg, c) : a.ds_scalar;
    constexpr int kUnroll = pass1_unroll(RESCALE, PFRAC, BYBAND);

    // ---- pass 1: the layers' transmittance and sources, layers in
    // parallel, each input read once; each thread loads kUnroll layers'
    // inputs before it uses any ----
    if (!PFRAC) {
        const Line tau = a.tau.line(gg, c), lay = a.lay.line(gg, c);
        const Line lev = a.lev.line(gg, c);
        const Line ssa = a.ssa.line(gg, c), asy = a.asy.line(gg, c);
        for (int l0 = k0; active && l0 < nlay; l0 += kUnroll * kstep) {
            float tv[kUnroll], ly[kUnroll], top[kUnroll], bot[kUnroll];
            float w[kUnroll], as[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int l = min(l0 + u * kstep, nlay - 1);
                tv[u] = tau[l];
                ly[u] = lay[l];
                top[u] = lev[l];
                bot[u] = lev[l + 1];
                if (RESCALE) {
                    w[u] = ssa[l];
                    as[u] = asy[l];
                }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int l = l0 + u * kstep;
                if (l >= nlay) break;
                const int o = l * ld + lane;
                float tl = tv[u] * ds;
                if (RESCALE) {
                    // Tang 2018 rescaling (reference :148-178)
                    float wb = w[u] * (1.0f - as[u]) * 0.5f;
                    float scale = 1.0f - w[u] + wb;
                    cn_s[o] = 0.4f * wb / scale;
                    tl = tl * scale;
                }
                float t, sdn, sup;
                rte::lw_source(tl, ly[u], top[u], bot[u], &t, &sdn, &sup);
                tr_s[o] = t;
                sd_s[o] = sdn;
                su_s[o] = sup;
            }
        }
    } else {
        // tau (plus the cloud absorption of the thread's band) and the
        // Planck fraction staged first, then per layer the sources from
        // the band values: the top level takes the top layer's Planck
        // fraction, the bottom level and the surface the bottom layer's,
        // the others the geometric mean of the two layers', each level
        // source formed in the layer's own expression
        const int b = active ? a.gpt2band[gg] : 0;
        const Line tau = a.tau.line(gg, c), pf = a.pfrac.line(gg, c);
        const Line cld = a.cld.line(b, c), pbl = a.pb_lay.line(b, c);
        const Line pbv = a.pb_lev.line(b, c);
        for (int l0 = k0; active && l0 < nlay; l0 += kUnroll * kstep) {
            float tv[kUnroll], cv[kUnroll], pv[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int l = min(l0 + u * kstep, nlay - 1);
                tv[u] = tau[l];
                cv[u] = cld.p ? cld[l] : 0.0f;
                pv[u] = pf[l];
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int l = l0 + u * kstep;
                if (l >= nlay) break;
                float tl = tv[u];
                if (cld.p) tl += cv[u];
                tr_s[l * ld + lane] = tl;
                pf_s[l * ld + lane] = pv[u];
            }
        }
        __syncthreads();
        for (int l0 = k0; active && l0 < nlay; l0 += kUnroll * kstep) {
            float bl[kUnroll], bt[kUnroll], bb[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int l = min(l0 + u * kstep, nlay - 1);
                bl[u] = pbl[l];
                bt[u] = pbv[l];
                bb[u] = pbv[l + 1];
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int l = l0 + u * kstep;
                if (l >= nlay) break;
                const int o = l * ld + lane;
                float p = pf_s[o];
                float top = (l == 0 ? p : geometric_mean(p, pf_s[o - ld]))
                            * bt[u];
                float bot = (l == nlay - 1 ? p
                             : geometric_mean(pf_s[o + ld], p)) * bb[u];
                float t, sdn, sup;
                rte::lw_source(tr_s[o] * ds, p * bl[u], top, bot, &t, &sdn,
                               &sup);
                tr_s[o] = t;
                sd_s[o] = sdn;
                su_s[o] = sup;
                if (l == nlay - 1)
                    ex_s[3 * chunk + lane] = p * a.pb_sfc.at(b, c);
            }
        }
    }
    __syncthreads();

    // ---- the sweeps, on the chunk's first ``chunk`` threads (an idle
    // lane writes zero fluxes), and the chunk's sums of each level
    // (transport.cuh::ClusterSums::reduce_by_thread) on the other threads
    // as soon as a field is final: the down flux during the up sweep, or
    // with RESCALE the up flux during the second down sweep ----
    const float* up_s = RESCALE ? rad_s : su_s;
    // field f's values at level lv: 0 up, 1 dn, 2 the Jacobian
    auto level = [&](int f, int lv) -> const float* {
        if (f == 0) return lv < nlay ? up_s + lv * ld : ex_s + chunk;
        if (f == 1) return lv == 0 ? ex_s : sd_s + (lv - 1) * ld;
        return lv < nlay ? tr_s + lv * ld : ex_s + 2 * chunk;
    };
    const bool sweeper = threadIdx.x < chunk;
    float* tr = tr_s + lane;
    float* sd = sd_s + lane;
    float* su = su_s + lane;
    float* cn = cn_s + lane;
    float* rad = rad_s + lane;
    const float rdn_top = sweeper && active ? a.inc.at(g, c) / a.piw : 0.0f;
    float rdn = rdn_top, rup = 0.0f, e = 0.0f;
    if (sweeper) {
        ex_s[lane] = rdn_top;
        // down (reference lw_transport_noscat_dn :681-708): level l + 1's
        // flux in place of layer l's sdn; with RESCALE the radiance at
        // each layer top kept, the sources left for the later sweeps
        rte::ring_sweep<2>(nlay, true,
                 [&](int l, float* v) {
                     v[0] = tr[l * ld];
                     v[1] = sd[l * ld];
                 },
                 [&](int l, const float* v) {
                     if (RESCALE) rad[l * ld] = rdn;
                     if (active) rdn = v[0] * rdn + v[1];
                     if (!RESCALE) sd[l * ld] = rdn;
                 });
    }
    if (!RESCALE) __syncthreads();      // the down flux is final

    // the Jacobian's sweep, bottom up: level l's in place of layer l's
    // transmittance, which no sweep after it reads
    auto jacobian = [&]() {
        float rjac = active ? e * a.sfc_jac.at(g, c) : 0.0f;
        ex_s[2 * chunk + lane] = rjac;
        rte::ring_sweep<1>(nlay, false,
                 [&](int l, float* v) { v[0] = tr[l * ld]; },
                 [&](int l, const float* v) {
                     if (active) rjac = v[0] * rjac;
                     tr[l * ld] = rjac;
                 });
    };
    if (sweeper) {
        // surface emission and reflection (:198-202), then up: level l's
        // flux in place of its sup (RESCALE: of its radiance)
        if (active) {
            e = a.emis.at(g, c);
            float src = PFRAC ? ex_s[3 * chunk + lane] : a.sfc.at(g, c);
            rup = rdn * (1.0f - e) + e * src;
        }
        ex_s[chunk + lane] = rup;
        // t, sup, and with RESCALE sdn, cn and the radiance
        rte::ring_sweep<RESCALE ? 5 : 2>(
            nlay, false,
            [&](int l, float* v) {
                v[0] = tr[l * ld];
                v[1] = su[l * ld];
                if (RESCALE) {
                    v[2] = sd[l * ld];
                    v[3] = cn[l * ld];
                    v[4] = rad[l * ld];
                }
            },
            [&](int l, const float* v) {
                if (active) {
                    rup = v[0] * rup + v[1];
                    if (RESCALE) {
                        // adjustment from the downwelling radiance at the
                        // layer's top edge (reference lw_transport_1rescl
                        // :784-793)
                        float an = 1.0f - v[0] * v[0];
                        rup = rup + v[3] * (an * v[4] - v[0] * v[2] - v[1]);
                    }
                }
                (RESCALE ? rad : su)[l * ld] = rup;
            });
        if (JAC && !RESCALE) jacobian();
    } else if (!RESCALE) {
        sums.reduce_by_thread(level, 1, 2, chunk);
    }
    __syncthreads();

    if (RESCALE) {
        if (sweeper) {
            // second down sweep, adjusted from the upwelling field: t,
            // sdn, sup, cn and the radiance
            rdn = rdn_top;
            rte::ring_sweep<5>(nlay, true,
                     [&](int l, float* v) {
                         v[0] = tr[l * ld];
                         v[1] = sd[l * ld];
                         v[2] = su[l * ld];
                         v[3] = cn[l * ld];
                         v[4] = rad[l * ld];
                     },
                     [&](int l, const float* v) {
                         if (active) {
                             float an = 1.0f - v[0] * v[0];
                             float adj = v[3] * (an * v[4] - v[0] * v[2]
                                                 - v[1]);
                             rdn = v[0] * rdn + v[1] + adj;
                         }
                         sd[l * ld] = rdn;
                     });
            if (JAC) jacobian();
        } else {
            sums.reduce_by_thread(level, 0, 1, chunk);
        }
        __syncthreads();
    }

    // ---- the rest of the column's sums: the chunk's, then the
    // cluster's ----
    sums.reduce_by_thread(level, RESCALE ? 1 : 0, RESCALE ? 2 : 1);
    if (JAC && !BYBAND) sums.reduce_by_thread(level, 2, 3);
    if (BYBAND && JAC)
        jsums.reduce_by_thread([&](int, int lv) { return level(2, lv); },
                               0, 1);
    auto out = [&](int lv) {
        return (long long)lv * a.out_sl + (long long)c * a.out_sc;
    };
    sums.finalize([&](int i, auto total) {
        if (BYBAND) {
            int b = i / nlev, lv = i - b * nlev;
            long long ob = ((long long)c * nlev + lv) * a.nband + b;
            a.band_up[ob] = total(0) * a.piw;
            a.band_dn[ob] = total(1) * a.piw;
        } else {
            a.up[out(i)] = a.piw * total(0);
            a.dn[out(i)] = a.piw * total(1);
            if (JAC) a.jac[out(i)] = a.piw * total(2);
        }
    });
    if (BYBAND && JAC)
        jsums.finalize([&](int i, auto total) {
            a.jac[out(i)] = a.piw * total(0);
        });
}

size_t smem_bytes(int nlay, int chunk, int nband, bool rescale, bool jac,
                  bool pfrac) {
    const int nlev = nlay + 1;
    return ((size_t)(nlay + 2 * kAhead) * (rescale ? 5 : pfrac ? 4 : 3)
                * (chunk + 1)
            + (size_t)kExtra * chunk) * sizeof(float)
        + rte::ClusterSums::bytes(nband > 0 ? 2 : 2 + jac, chunk, nlev, nband)
        + (nband > 0 && jac ? rte::ClusterSums::bytes(1, chunk, nlev, 0) : 0);
}

// fn(kernel) for the instantiation of (rescale, jac, pfrac, byband); PFRAC
// runs neither rescaling, the Jacobian nor by-band sums.
template <typename Fn>
int with_kernel(bool rescale, bool jac, bool pfrac, bool byband, Fn&& fn) {
    if (pfrac) return fn(solver_lw_kernel<false, false, true, false>);
    if (byband) {
        if (rescale)
            return jac ? fn(solver_lw_kernel<true, true, false, true>)
                       : fn(solver_lw_kernel<true, false, false, true>);
        return jac ? fn(solver_lw_kernel<false, true, false, true>)
                   : fn(solver_lw_kernel<false, false, false, true>);
    }
    if (rescale)
        return jac ? fn(solver_lw_kernel<true, true, false, false>)
                   : fn(solver_lw_kernel<true, false, false, false>);
    return jac ? fn(solver_lw_kernel<false, true, false, false>)
               : fn(solver_lw_kernel<false, false, false, false>);
}

int run(const LwArgs& a, int ncol, bool pfrac, void* stream) {
    if (ncol == 0) return 0;
    const bool rescale = a.ssa.p != nullptr, jac = a.jac != nullptr;
    const bool byband = a.band_up != nullptr;
    const int nchunk = (a.ngpt + a.chunk - 1) / a.chunk;
    const size_t smem = smem_bytes(a.nlay, a.chunk, byband ? a.nband : 0,
                                   rescale, jac, pfrac);
    return with_kernel(rescale, jac, pfrac, byband, [&](auto kernel) {
        return (int)rte::launch_clusters(kernel, ncol, nchunk, kThreads,
                                         smem, (cudaStream_t)stream, a);
    });
}

}  // namespace

// Shared memory of one block at (nlay, chunk, nband; 0 for broadband) of
// the variant (rescale, jac, pfrac), the bytes ops/kernels/onchip.py::
// onchip_geometry counts.
extern "C" int smem_solver_lw(int nlay, int chunk, int nband, int rescale,
                              int jac, int pfrac) {
    return (int)smem_bytes(nlay, chunk, nband, rescale, jac, pfrac);
}

// Resident blocks per SM * 65536 + clusters the card holds at once, or a
// negative CUDA error (transport.cuh::cluster_occupancy), of the variant's
// instantiation.
extern "C" int occupancy_solver_lw(int nlay, int chunk, int nchunk,
                                   int nband, int rescale, int jac,
                                   int pfrac) {
    const size_t smem = smem_bytes(nlay, chunk, nband, rescale, jac, pfrac);
    return with_kernel(rescale, jac, pfrac, nband > 0, [&](auto kernel) {
        return rte::cluster_occupancy(kernel, nchunk, kThreads, smem);
    });
}

// The public layout: (column, layer, g-point) contiguous fields; with
// band_up/band_dn (column, level, band) per-band sums there (gpt2band)
// instead of the broadband up/dn (the Jacobian stays broadband). chunk:
// g-points per block (onchip_geometry).
extern "C" int launch_solver_lw(
        const void* tau, const void* lay, const void* lev, const void* ssa,
        const void* asy, const void* emis, const void* sfc,
        const void* sfc_jac, const void* inc, const void* ds_field,
        const void* gpt2band, void* up, void* dn, void* jac, void* band_up,
        void* band_dn, int ncol, int nlay, int ngpt, int nband,
        float ds_scalar, float piw, int chunk, void* stream) {
    LwArgs a = {};
    a.gpt2band = (const int*)gpt2band;
    a.band_up = (float*)band_up;
    a.band_dn = (float*)band_dn;
    a.nband = nband;
    const int sl = ngpt, sc = nlay * ngpt;
    a.tau = f3(tau, 1, sl, sc);
    a.lay = f3(lay, 1, sl, sc);
    a.lev = f3(lev, 1, sl, (nlay + 1) * ngpt);
    a.ssa = f3(ssa, 1, sl, sc);
    a.asy = f3(asy, 1, sl, sc);
    a.emis = f2(emis, 1, ngpt);
    a.sfc = f2(sfc, 1, ngpt);
    a.sfc_jac = f2(sfc_jac, 1, ngpt);
    a.inc = f2(inc, 1, ngpt);
    a.ds = f2(ds_field, 1, ngpt);
    a.up = (float*)up;
    a.dn = (float*)dn;
    a.jac = (float*)jac;
    a.out_sl = 1;
    a.out_sc = nlay + 1;
    a.nlay = nlay;
    a.ngpt = ngpt;
    a.chunk = chunk;
    a.ds_scalar = ds_scalar;
    a.piw = piw;
    return run(a, ncol, false, stream);
}

// The lane layout: (g-point, layer, column) fields, (g-point, column)
// boundary fields, each with its element strides; output (level, column).
extern "C" int launch_solver_lw_lanes(
        const void* tau, int tau0, int tau1, int tau2,
        const void* lay, int lay0, int lay1, int lay2,
        const void* lev, int lev0, int lev1, int lev2,
        const void* ssa, int ssa0, int ssa1, int ssa2,
        const void* asy, int asy0, int asy1, int asy2,
        const void* emis, int emis0, int emis1,
        const void* sfc, int sfc0, int sfc1,
        const void* sfc_jac, int jac0, int jac1,
        const void* inc, int inc0, int inc1,
        void* up, void* dn, void* jac, int ncol, int nlay, int ngpt,
        float ds, float piw, int chunk, void* stream) {
    LwArgs a = {};
    a.tau = f3(tau, tau0, tau1, tau2);
    a.lay = f3(lay, lay0, lay1, lay2);
    a.lev = f3(lev, lev0, lev1, lev2);
    a.ssa = f3(ssa, ssa0, ssa1, ssa2);
    a.asy = f3(asy, asy0, asy1, asy2);
    a.emis = f2(emis, emis0, emis1);
    a.sfc = f2(sfc, sfc0, sfc1);
    a.sfc_jac = f2(sfc_jac, jac0, jac1);
    a.inc = f2(inc, inc0, inc1);
    a.up = (float*)up;
    a.dn = (float*)dn;
    a.jac = (float*)jac;
    a.out_sl = ncol;
    a.out_sc = 1;
    a.nlay = nlay;
    a.ngpt = ngpt;
    a.chunk = chunk;
    a.ds_scalar = ds;
    a.piw = piw;
    return run(a, ncol, false, stream);
}

// The lane layout with in-kernel Planck sources: band fields (band,
// layer, column) and (band, column), read at gpt2band[g].
extern "C" int launch_solver_lw_pfrac(
        const void* tau, int tau0, int tau1, int tau2,
        const void* pfrac, int pf0, int pf1, int pf2,
        const void* pb_lay, int pbl0, int pbl1, int pbl2,
        const void* pb_lev, int pbv0, int pbv1, int pbv2,
        const void* pb_sfc, int pbs0, int pbs1,
        const void* cld, int cld0, int cld1, int cld2,
        const void* emis, int emis0, int emis1,
        const void* inc, int inc0, int inc1,
        const void* gpt2band, void* up, void* dn,
        int ncol, int nlay, int ngpt, float ds, float piw, int chunk,
        void* stream) {
    LwArgs a = {};
    a.tau = f3(tau, tau0, tau1, tau2);
    a.pfrac = f3(pfrac, pf0, pf1, pf2);
    a.pb_lay = f3(pb_lay, pbl0, pbl1, pbl2);
    a.pb_lev = f3(pb_lev, pbv0, pbv1, pbv2);
    a.pb_sfc = f2(pb_sfc, pbs0, pbs1);
    a.cld = f3(cld, cld0, cld1, cld2);
    a.emis = f2(emis, emis0, emis1);
    a.inc = f2(inc, inc0, inc1);
    a.gpt2band = (const int*)gpt2band;
    a.up = (float*)up;
    a.dn = (float*)dn;
    a.out_sl = ncol;
    a.out_sc = 1;
    a.nlay = nlay;
    a.ngpt = ngpt;
    a.chunk = chunk;
    a.ds_scalar = ds;
    a.piw = piw;
    return run(a, ncol, true, stream);
}
