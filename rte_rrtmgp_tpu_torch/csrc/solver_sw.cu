// SW two-stream solve with broadband or per-band output. One kernel, three
// launchers:
//   launch_solver_sw           the public rte_sw's solver: contiguous
//                              (column, layer, g-point) fields, mu0
//                              (column, layer), output (3, column, level),
//                              or per-band sums (3, column, level, band);
//   launch_solver_sw_lanes     the staged branch's solver: (g-point,
//                              layer, column) fields through any element
//                              strides, mu0 (layer, column), output
//                              (3, level, column);
//   launch_solver_sw_combined  the same from the absorption and Rayleigh
//                              depths, with the Rayleigh combine and the
//                              by-band delta-scaled cloud increment done in
//                              the kernel (gpt2band, so ragged bands work).
//
// Replaces the TPU kernels rte_rrtmgp_tpu/ops/pallas/solver_sw_kernel.py::
// sw_two_stream_broadband_lane and ops/pallas/solver_lanes.py::
// sw_two_stream_broadband_lanes and ::sw_two_stream_broadband_lanes_combined
// (reference mo_rte_solver_kernels.F90:503-609, 985-1127, 1135-1245;
// combine_abs_and_rayleigh :1954-2036; increment_2stream_by_2stream).
// Plain twins: rte_rrtmgp_tpu_torch/ops/kernels/solver_sw.py::
// sw_2stream_plain and ops/kernels/solver_lanes.py::sw_2stream_lanes_plain,
// ::sw_2stream_lanes_combined_plain.
//
// Layout: a column's g-points are cut into chunks of ``chunk`` (a
// multiple of 32, at most 8 chunks: ops/kernels/onchip.py::
// onchip_geometry), one block of kThreads threads per chunk, and the
// column's chunks are one thread-block cluster. Every input is read
// through its element strides (common.cuh::Field3), so the gathers'
// (column, layer, g-point) output passed as a permuted view keeps g
// fastest and the loads coalesced. The chunk's layer fields live in
// shared memory, no device-memory scratch:
//   pass 1, every thread, kThreads / chunk layers at a time (thread
//   lane + chunk * k takes g-point g0 + lane and the layers k, k + K,
//   ...): the layer's optics (with COMBINED: ssa = tau_ray / tau where
//   tau > 2 tiny, then the tau-weighted combine with the cloud of the
//   thread's band, float32 tiny guards as in the TPU kernel), the
//   Meador-Weaver coefficients with the reference's clamps
//   (transport.cuh::sw_layer), rdir and tdir zeroed at night (mu0 > 0 per
//   layer), tns;
//   then the chunk's first ``chunk`` threads, one per g-point, sweep: the
//   direct beam top down (source_dn = tdir * dir, source_up = rdir * dir;
//   each level's beam in place of tns), the adding build bottom up
//   (transport.cuh::adding_up, its four values per layer written in
//   place), the diffuse fluxes top down from the diffuse incident flux
//   (zero when absent) (transport.cuh::adding_down), each level's fluxes
//   written in place;
//   then every thread again: the chunk's sums of each level
//   (transport.cuh::ClusterSums::reduce), and the cluster's
//   (ClusterSums::finalize). Total down = diffuse + direct.
//
// What bounds it on this card: reading tau, ssa and g (or the two depths
// and the band cloud), 12 B per (column, layer, g-point), which needs
// many warps in flight, and the latency of the three dependent sweeps,
// one warp per chunk. Kept in device memory, the layer fields (six per
// column, level and g-point) make each layer of the adding build wait a
// memory round trip: most of the solve's time on an H100 (PERF.md). Here
// they take 20 B x nlay x chunk of shared memory per block.
//
// Sums: per level, broadband the warp-shuffle sum of each 32 g-points,
// by band each band's g-points of the chunk in ascending order
// (gpt2band, so ragged or reordered bands work), then summed over the
// cluster's shared memory in rank order (transport.cuh::ClusterSums):
// broadband with 32-wide chunks in the warp order of one block that held
// the whole column. Deterministic, no atomics.
//
// Contract (checked by the Python wrappers): float32, ngpt <= 1024, the
// column height within onchip_geometry's limit, offsets within 32-bit
// strides, top of the atmosphere at layer 0.

#include <cfloat>

#include "common.cuh"
#include "transport.cuh"

namespace {

using rte::Field2;
using rte::Field3;
using rte::Line;
using rte::f2;
using rte::f3;

constexpr int kThreads = 256;   // per block: chunk g-points x layer lanes
constexpr int kBlocksPerSM = 4;
constexpr int kFields = 3;      // up, dn (diffuse), dir

struct SwArgs {
    Field3 tau, ssa, asy;        // COMBINED: tau_abs, tau_ray; asy unused
    Field3 ct, cs, cg;           // COMBINED: cloud by band; ct.p null: none
    Field2 mu0;                  // (layer, column)
    Field2 alb_dir, alb_dif, inc, inc_dif;   // inc_dif.p null: no diffuse
    const int* gpt2band;         // COMBINED, or by-band output
    float* out;                  // up, dn total, dir planes
    long long out_plane;
    int out_sl, out_sc;          // output strides of (level, column)
    float* band_out;             // by band: (3, column, level, band); or null
    int ncol, nlay, ngpt, nband, chunk;
};

// The layer optics of one thread's (column, g-point).
template <bool COMBINED>
struct SwColumn {
    Line tau, ssa, asy, ct, cs, cg;

    __device__ SwColumn(const SwArgs& a, int g, int c) {
        tau = a.tau.line(g, c);
        ssa = a.ssa.line(g, c);
        if (COMBINED) {
            int b = a.gpt2band[g];
            ct = a.ct.line(b, c);
            cs = a.cs.line(b, c);
            cg = a.cg.line(b, c);
        } else {
            asy = a.asy.line(g, c);
        }
    }

    __device__ __forceinline__ void layer(int l, float* t, float* w0,
                                          float* g) const {
        if (!COMBINED) {
            *t = tau[l];
            *w0 = ssa[l];
            *g = asy[l];
            return;
        }
        // combine_abs_and_rayleigh, then the by-band 2-stream increment
        // (JAX solver_lanes.py:704-721, float32 tiny in every guard)
        const float two_tiny = 2.0f * FLT_MIN;
        float ray = ssa[l];
        float t_gas = tau[l] + ray;
        float ssa_gas = t_gas > two_tiny ? ray / t_gas : 0.0f;
        if (!ct.p) {
            *t = t_gas;
            *w0 = ssa_gas;
            *g = 0.0f;
            return;
        }
        float o_tau = ct[l], o_ssa = cs[l], o_g = cg[l];
        float tt = t_gas + o_tau;
        float tauscat = t_gas * ssa_gas + o_tau * o_ssa;
        float g12 = (o_tau * o_ssa * o_g) / fmaxf(tauscat, FLT_MIN);
        float ssa12 = tauscat / fmaxf(tt, FLT_MIN);
        *t = tt;
        *g = tauscat > two_tiny ? g12 : 0.0f;
        *w0 = tt > two_tiny ? ssa12 : ssa_gas;
    }
};

template <bool COMBINED>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
solver_sw_kernel(const SwArgs a) {
    extern __shared__ float4 coef[];          // (nlay, chunk)
    namespace cg = cooperative_groups;
    const int nlay = a.nlay, ngpt = a.ngpt, chunk = a.chunk;
    const int nlev = nlay + 1;
    const int nchunk = (int)cg::this_cluster().num_blocks();
    const int rank = (int)cg::this_cluster().block_rank();
    const int c = blockIdx.x / nchunk;
    float* tns_s = (float*)(coef + (size_t)nlay * chunk);   // (nlay, chunk)
    float* top_s = tns_s + (size_t)nlay * chunk;            // (3, chunk)
    const bool byband = a.band_out != nullptr;
    rte::ClusterSums sums;
    sums.init(top_s + kFields * chunk, kFields, chunk, nlev,
              byband ? a.nband : 0, a.gpt2band, rank * chunk, ngpt);
    const int lane = threadIdx.x % chunk;
    const int g = rank * chunk + lane;
    const bool active = g < ngpt;
    const SwColumn<COMBINED> col(a, active ? g : 0, c);

    // ---- pass 1: two-stream coefficients, layers in parallel ----
    for (int l = threadIdx.x / chunk; active && l < nlay;
         l += kThreads / chunk) {
        float mu = a.mu0.at(l, c);
        float t, w0, asym;
        col.layer(l, &t, &w0, &asym);
        rte::SwLayer s = rte::sw_layer(t, w0, asym, mu);
        bool day = mu > 0.0f;
        coef[l * chunk + lane] = make_float4(s.rdif, s.tdif,
                                             day ? s.rdir : 0.0f,
                                             day ? s.tdir : 0.0f);
        tns_s[l * chunk + lane] = s.tns;
    }
    __syncthreads();

    // ---- the sweeps: the chunk's first ``chunk`` threads ----
    if (threadIdx.x < chunk) {
        float4* k = coef + lane;
        float* tn = tns_s + lane;
        // direct beam, top down: coef becomes (rdif, tdif, sdn, sup), tns
        // the beam at the layer's bottom
        float dir = active ? a.inc.at(g, c) * a.mu0.at(0, c) : 0.0f;
        top_s[2 * chunk + lane] = dir;
        float4 q = k[0];
        float tq = tn[0];
        for (int l = 0; l < nlay; ++l) {
            int nx = (l + 1 < nlay ? l + 1 : l) * chunk;
            float4 qn = k[nx];
            float tqn = tn[nx];
            if (active) {
                k[l * chunk] = make_float4(q.x, q.y, q.w * dir, q.z * dir);
                dir = dir * tq;
            }
            tn[l * chunk] = dir;
            q = qn;
            tq = tqn;
        }
        // adding build, bottom up, in place (Eqs 9-13)
        float alb = 0.0f, src = 0.0f, top = 0.0f;
        if (active) {
            alb = a.alb_dif.at(g, c);
            src = a.mu0.at(nlay - 1, c) > 0.0f ? dir * a.alb_dir.at(g, c)
                                               : 0.0f;
            top = a.inc_dif.p ? a.inc_dif.at(g, c) : 0.0f;
        }
        q = k[(nlay - 1) * chunk];
        for (int v = nlay - 1; v >= 0; --v) {
            float4 qn = k[(v > 0 ? v - 1 : 0) * chunk];
            k[v * chunk] = rte::adding_up(q.x, q.y, q.z, q.w, alb, src);
            q = qn;
        }
        // diffuse fluxes, top down; level v + 1's in place of layer v's
        // values
        rte::adding_down(active, k, chunk, nlay, alb, src, top,
                         [&](float fup, float fdn, int lv) {
                             if (lv > 0) {
                                 *(float2*)(k + (lv - 1) * chunk) =
                                     make_float2(fup, fdn);
                             } else {
                                 top_s[lane] = fup;
                                 top_s[chunk + lane] = fdn;
                             }
                         });
    }
    __syncthreads();

    // ---- the column's sums: the chunk's, then the cluster's; up, dn
    // total = diffuse + direct, dir ----
    sums.reduce([&](int f, int lv, int i) {
        if (lv == 0) return top_s[f * chunk + i];
        int o = (lv - 1) * chunk + i;
        return f == 2 ? tns_s[o] : ((const float*)(coef + o))[f];
    });
    sums.finalize([&](int i, auto total) {
        float fd = total(2);
        if (byband) {
            int b = i / nlev, lv = i - b * nlev;
            long long ob = ((long long)c * nlev + lv) * a.nband + b;
            long long bplane = (long long)a.ncol * nlev * a.nband;
            a.band_out[ob] = total(0);
            a.band_out[bplane + ob] = total(1) + fd;
            a.band_out[2 * bplane + ob] = fd;
        } else {
            long long o = (long long)i * a.out_sl + (long long)c * a.out_sc;
            a.out[o] = total(0);
            a.out[a.out_plane + o] = total(1) + fd;
            a.out[2 * a.out_plane + o] = fd;
        }
    });
}

size_t smem_bytes(int nlay, int chunk, int nband) {
    return (size_t)nlay * chunk * (sizeof(float4) + sizeof(float))
        + (size_t)kFields * chunk * sizeof(float)
        + rte::ClusterSums::bytes(kFields, chunk, nlay + 1, nband);
}

template <bool COMBINED>
int run(const SwArgs& a, void* stream) {
    if (a.ncol == 0) return 0;
    const int nchunk = (a.ngpt + a.chunk - 1) / a.chunk;
    return (int)rte::launch_clusters(
        solver_sw_kernel<COMBINED>, a.ncol, nchunk, kThreads,
        smem_bytes(a.nlay, a.chunk, a.band_out ? a.nband : 0),
        (cudaStream_t)stream, a);
}

SwArgs base(void* out, int ncol, int nlay, int ngpt, int chunk,
            bool lanes) {
    SwArgs a = {};
    a.out = (float*)out;
    a.out_plane = (long long)ncol * (nlay + 1);
    a.out_sl = lanes ? ncol : 1;
    a.out_sc = lanes ? 1 : nlay + 1;
    a.ncol = ncol;
    a.nlay = nlay;
    a.ngpt = ngpt;
    a.chunk = chunk;
    return a;
}

}  // namespace

// Shared memory of one block at (nlay, chunk, nband; 0 for broadband),
// the bytes ops/kernels/onchip.py::onchip_geometry counts.
extern "C" int smem_solver_sw(int nlay, int chunk, int nband) {
    return (int)smem_bytes(nlay, chunk, nband);
}

// Resident blocks per SM * 65536 + clusters the card holds at once, or a
// negative CUDA error (transport.cuh::cluster_occupancy), of the plain
// (combined 0) or the COMBINED kernel.
extern "C" int occupancy_solver_sw(int nlay, int chunk, int nchunk,
                                   int nband, int combined) {
    size_t smem = smem_bytes(nlay, chunk, nband);
    return combined
        ? rte::cluster_occupancy(solver_sw_kernel<true>, nchunk, kThreads,
                                 smem)
        : rte::cluster_occupancy(solver_sw_kernel<false>, nchunk, kThreads,
                                 smem);
}

// The public layout: (column, layer, g-point) contiguous fields; with
// band_out (3, column, level, band) per-band sums there (gpt2band) instead
// of the broadband ``out``. chunk: g-points per block (onchip_geometry).
extern "C" int launch_solver_sw(
        const void* tau, const void* ssa, const void* asy, const void* mu0,
        const void* alb_dir, const void* alb_dif, const void* inc,
        const void* inc_dif, const void* gpt2band, void* out,
        void* band_out, int ncol, int nlay, int ngpt, int nband, int chunk,
        void* stream) {
    SwArgs a = base(out, ncol, nlay, ngpt, chunk, false);
    a.gpt2band = (const int*)gpt2band;
    a.band_out = (float*)band_out;
    a.nband = nband;
    const int sl = ngpt, sc = nlay * ngpt;
    a.tau = f3(tau, 1, sl, sc);
    a.ssa = f3(ssa, 1, sl, sc);
    a.asy = f3(asy, 1, sl, sc);
    a.mu0 = f2(mu0, 1, nlay);
    a.alb_dir = f2(alb_dir, 1, ngpt);
    a.alb_dif = f2(alb_dif, 1, ngpt);
    a.inc = f2(inc, 1, ngpt);
    a.inc_dif = f2(inc_dif, 1, ngpt);
    return run<false>(a, stream);
}

// The lane layout: (g-point, layer, column) fields, mu0 (layer, column),
// (g-point, column) boundary fields, each with its element strides.
extern "C" int launch_solver_sw_lanes(
        const void* tau, int tau0, int tau1, int tau2,
        const void* ssa, int ssa0, int ssa1, int ssa2,
        const void* asy, int asy0, int asy1, int asy2,
        const void* mu0, int mu_l, int mu_c,
        const void* alb_dir, int ad0, int ad1,
        const void* alb_dif, int af0, int af1,
        const void* inc, int inc0, int inc1,
        const void* inc_dif, int id0, int id1,
        void* out, int ncol, int nlay, int ngpt, int chunk, void* stream) {
    SwArgs a = base(out, ncol, nlay, ngpt, chunk, true);
    a.tau = f3(tau, tau0, tau1, tau2);
    a.ssa = f3(ssa, ssa0, ssa1, ssa2);
    a.asy = f3(asy, asy0, asy1, asy2);
    a.mu0 = f2(mu0, mu_l, mu_c);
    a.alb_dir = f2(alb_dir, ad0, ad1);
    a.alb_dif = f2(alb_dif, af0, af1);
    a.inc = f2(inc, inc0, inc1);
    a.inc_dif = f2(inc_dif, id0, id1);
    return run<false>(a, stream);
}

// The lane layout from the absorption and Rayleigh depths, with the
// by-band cloud (tau, ssa, g) read at gpt2band[g].
extern "C" int launch_solver_sw_combined(
        const void* tau_abs, int ta0, int ta1, int ta2,
        const void* tau_ray, int tr0, int tr1, int tr2,
        const void* ct, int ct0, int ct1, int ct2,
        const void* cs, int cs0, int cs1, int cs2,
        const void* cg, int cg0, int cg1, int cg2,
        const void* mu0, int mu_l, int mu_c,
        const void* alb_dir, int ad0, int ad1,
        const void* alb_dif, int af0, int af1,
        const void* inc, int inc0, int inc1,
        const void* inc_dif, int id0, int id1,
        const void* gpt2band, void* out, int ncol, int nlay, int ngpt,
        int chunk, void* stream) {
    SwArgs a = base(out, ncol, nlay, ngpt, chunk, true);
    a.tau = f3(tau_abs, ta0, ta1, ta2);
    a.ssa = f3(tau_ray, tr0, tr1, tr2);
    a.ct = f3(ct, ct0, ct1, ct2);
    a.cs = f3(cs, cs0, cs1, cs2);
    a.cg = f3(cg, cg0, cg1, cg2);
    a.mu0 = f2(mu0, mu_l, mu_c);
    a.alb_dir = f2(alb_dir, ad0, ad1);
    a.alb_dif = f2(alb_dif, af0, af1);
    a.inc = f2(inc, inc0, inc1);
    a.inc_dif = f2(inc_dif, id0, id1);
    a.gpt2band = (const int*)gpt2band;
    return run<true>(a, stream);
}
