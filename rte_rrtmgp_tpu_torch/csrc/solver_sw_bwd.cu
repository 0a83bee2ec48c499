// Adjoint of the SW two-stream solve with broadband output (the public
// layout of launch_solver_sw).
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/solver_sw_bwd.py::
// _sw_bwd_lane (pallas_call :402; derivation :12-25, :51-374). Plain
// twin: torch.autograd.grad of rte_rrtmgp_tpu_torch/ops/kernels/
// solver_sw.py::sw_2stream_plain (ops/kernels/solver_sw_bwd.py::
// sw_2stream_bwd_plain).
//
// Layout: the forward kernel's (solver_sw.cu): a column's g-points in
// chunks of ``chunk`` (a multiple of 32, at most 8 chunks: ops/kernels/
// onchip.py::onchip_geometry), one block of kThreads threads per chunk,
// the column's chunks one thread-block cluster. The chunk's state lives
// in shared memory, no device-memory scratch. Phases (solver_sw_bwd.py
// P0, A-F, A-U, A-S, A-C; the arithmetic of transport_bwd.cuh::
// sw_adjoint, whose layer terms are kept here instead of recomputed):
//   P0, every thread, kThreads / chunk layers at a time: the
//   Meador-Weaver coefficients of each (layer, g-point) with the
//   reference's clamps (transport.cuh::sw_layer), rdir and tdir zeroed at
//   night, tns;
//   then the chunk's first ``chunk`` threads, one per g-point, sweep
//   through them: the direct beam (down) and the adding build (up),
//   which keeps each layer's denominator; the diffuse flux (down) and,
//   on the next ``chunk`` threads at the same time, A-F (up), which
//   needs only the build; A-U (down) and A-S (up), which leave the
//   cotangents of each layer's rdif, tdif (A-U), rdir, tdir and tns (A-S)
//   in shared memory, and the boundary cotangents;
//   then every thread again, layers in parallel, A-C: the Meador-Weaver
//   chain transposed (transport_bwd.cuh::sw_layer_ad, sw_layer_adjoint)
//   from each layer's inputs and those five cotangents, giving the
//   cotangents of tau, ssa and g (one owner each) and of mu0.
// The mu0 cotangent of a layer is a sum over the column's g-points: each
// 32 g-points' warp-shuffle sum, then the cluster's sum in rank order
// (transport.cuh::ClusterSums), and the beam's seed at the top likewise
// (deterministic, no atomics; with 32-wide chunks the warp order of a
// block that held the whole column).
//
// What bounds it on this card: the six dependent sweeps, one warp per
// chunk, and the Meador-Weaver chain and its transpose, about 300
// operations per (column, layer, g-point), which need many warps in
// flight. The function needs 24 B per (column, layer, g-point): tau, ssa
// and g in, their cotangents out; this kernel moves 36 B, since A-C reads
// the optics again rather than keep P0's in shared memory. Kept in
// device memory, the sweeps' state makes each layer wait a memory round
// trip, and one thread walking every phase holds too many registers for
// more than 12 warps per SM (PERF.md). Here the state takes 44 B x nlay x
// chunk of shared memory per block (and the column's flux cotangents, 12
// B per level), two blocks per SM, and the chain runs on all 16 warps.
//
// Contract (checked by the Python wrapper): float32, contiguous, ngpt <=
// 1024, the column height within onchip_geometry's limit, top of the
// atmosphere at layer 0.

#include "common.cuh"
#include "transport_bwd.cuh"

namespace {

constexpr int kThreads = 256;   // per block: chunk g-points x layer lanes
constexpr int kBlocksPerSM = 2;
constexpr int kFields = 2;      // the mu0 cotangent by layer; the seed

struct BwdArgs {
    const float* tau;            // (column, layer, g-point)
    const float* ssa;
    const float* asy;
    const float* mu0;            // (column, layer)
    const float* alb_dir;        // (column, g-point)
    const float* alb_dif;
    const float* inc;
    const float* inc_dif;
    const float* gup;            // (column, level)
    const float* gdn;
    const float* gdir;
    float* tau_b;
    float* ssa_b;
    float* g_b;
    float* mu0_b;
    float* alb_dir_b;
    float* alb_dif_b;
    float* inc_b;
    float* inc_dif_b;
    int ncol, nlay, ngpt, chunk;
};

// One g-point's fields in the chunk's shared memory, element v at p[v *
// s]: per layer K = (rdif, tdif, rdir, tdir), TN = tns, DD = 1 / (1 -
// rdif alb) with alb the adding albedo below the layer (the build's
// denominator, which the diffuse sweep, A-F and A-U reuse) and FH; per
// level DIR, ALB, SRC and FDN. Each field is reused once its first
// content is dead, as in transport_bwd.cuh::SwScratch:
//   DIR: the direct beam at the top of each level;
//   ALB: the adding albedo below each level, then rdif's cotangent of
//     layer v at v + 1;
//   SRC: the adding upward source, then tdif's cotangent of layer v at
//     v + 1;
//   FDN: the diffuse downward flux, then source_dn's cotangent of layer v;
//   FH: the diffuse sweep's cotangent entering layer v from below (A-F),
//     then source_up's cotangent of layer v;
//   K.z, K.w, TN: then the cotangents of rdir, tdir (not yet masked at
//     night) and tns.
// gu, gd, gr: the column's flux cotangents by level, in shared memory.
struct Lane {
    float4* K;
    float* TN;
    float* DD;
    float* FH;
    float* DIR;
    float* ALB;
    float* SRC;
    float* FDN;
    const float* gu;
    const float* gd;
    const float* gr;
    int s;
};

// A g-point's boundary inputs.
struct Bounds {
    float inc, alb_dir, mu_top;
    bool day_sfc;
    long long bc;

    __device__ Bounds(const BwdArgs& a, int c, int g) {
        bc = (long long)c * a.ngpt + g;
        inc = __ldg(a.inc + bc);
        alb_dir = __ldg(a.alb_dir + bc);
        const float* mu0 = a.mu0 + (long long)c * a.nlay;
        mu_top = __ldg(mu0);
        day_sfc = __ldg(mu0 + a.nlay - 1) > 0.0f;
    }
};

// The direct beam (down) and the adding build (up, Eqs 9-13), keeping
// each layer's denominator. Each loop loads its next layer's values
// before it works on the current one.
__device__ __forceinline__ void beam_build(const BwdArgs& a, const Bounds& x,
                                           const Lane& f) {
    const int N = a.nlay, s = f.s;
    float4* __restrict__ K = f.K;
    float* __restrict__ TN = f.TN;
    float* __restrict__ DD = f.DD;
    float* __restrict__ DIR = f.DIR;
    float* __restrict__ ALB = f.ALB;
    float* __restrict__ SRC = f.SRC;
    float dir = x.inc * x.mu_top;
    float tq = TN[0];
    for (int l = 0; l < N; ++l) {
        float tqn = TN[(l + 1 < N ? l + 1 : l) * s];
        DIR[l * s] = dir;
        dir = dir * tq;
        tq = tqn;
    }
    DIR[N * s] = dir;
    float alb = __ldg(a.alb_dif + x.bc);
    float src = x.day_sfc ? dir * x.alb_dir : 0.0f;
    ALB[N * s] = alb;
    SRC[N * s] = src;
    float4 q = K[(N - 1) * s];
    float dv = DIR[(N - 1) * s];
    for (int v = N - 1; v >= 0; --v) {
        const int vn = (v > 0 ? v - 1 : 0) * s;
        float4 qn = K[vn];
        float dn = DIR[vn];
        float supdir = q.z * dv;
        float sdn = q.w * dv;
        float dd = 1.0f / (1.0f - q.x * alb);
        float src_v = supdir + q.y * dd * (src + alb * sdn);
        alb = q.x + q.y * q.y * alb * dd;
        src = src_v;
        DD[v * s] = dd;
        ALB[v * s] = alb;
        SRC[v * s] = src;
        q = qn;
        dv = dn;
    }
}

// The diffuse flux, top down from the diffuse incident flux.
__device__ __forceinline__ void diffuse(const BwdArgs& a, const Bounds& x,
                                        const Lane& f) {
    const int N = a.nlay, s = f.s;
    const float4* __restrict__ K = f.K;
    const float* __restrict__ DD = f.DD;
    const float* __restrict__ DIR = f.DIR;
    const float* __restrict__ SRC = f.SRC;
    float* __restrict__ FDN = f.FDN;
    float fdn = __ldg(a.inc_dif + x.bc);
    FDN[0] = fdn;
    float4 q = K[0];
    float dv = DIR[0], sn = SRC[s], dd = DD[0];
    for (int v = 0; v < N; ++v) {
        const int vn = (v + 1 < N ? v + 1 : v) * s;
        float4 qn = K[vn];
        float dn = DIR[vn], snn = SRC[vn + s], ddn = DD[vn];
        float sdn = q.w * dv;
        fdn = (q.y * fdn + q.x * sn + sdn) * dd;
        FDN[(v + 1) * s] = fdn;
        q = qn;
        dv = dn;
        sn = snn;
        dd = ddn;
    }
}

// A-F: adjoint of the diffuse sweep, bottom up; keeps the cotangent
// entering each layer from below. Needs only the build's results, so it
// runs beside the diffuse sweep.
__device__ __forceinline__ void adjoint_diffuse(const BwdArgs& a,
                                                const Bounds& x,
                                                const Lane& f) {
    const int N = a.nlay, s = f.s;
    const float4* __restrict__ K = f.K;
    const float* __restrict__ DD = f.DD;
    const float* __restrict__ ALB = f.ALB;
    float* __restrict__ FH = f.FH;
    const float* gu = f.gu;
    const float* gd = f.gd;
    float Ff = gd[N] + gu[N] * ALB[N * s];
    float td = K[(N - 1) * s].y, d = DD[(N - 1) * s];
    float alb_v = ALB[(N - 1) * s];
    for (int v = N - 1; v >= 0; --v) {
        const int vn = (v > 0 ? v - 1 : 0) * s;
        float tdn = K[vn].y, dn = DD[vn], albn = ALB[vn];
        float Fh = Ff;
        FH[v * s] = Fh;
        Ff = gd[v] + gu[v] * alb_v + td * d * Fh;
        td = tdn;
        d = dn;
        alb_v = albn;
    }
    a.inc_dif_b[x.bc] = Ff;
}

// A-U (adjoint of the adding build, top down, with A-F's per-layer
// results recomputed from its kept cotangent) and A-S (the beam's
// adjoint, bottom up). A-S leaves the cotangents of each layer's rdir,
// tdir (unmasked) and tns in place of their values. Writes the boundary
// cotangents and returns the beam's seed, the cotangent of mu0 of layer
// 0 through dir[0] = inc * mu0.
__device__ __forceinline__ float adjoint_build_beam(const BwdArgs& a,
                                                    const Bounds& x,
                                                    const Lane& f) {
    const int N = a.nlay, s = f.s;
    float4* __restrict__ K = f.K;
    float* __restrict__ TN = f.TN;
    const float* __restrict__ DD = f.DD;
    float* __restrict__ FH = f.FH;
    const float* __restrict__ DIR = f.DIR;
    float* __restrict__ ALB = f.ALB;
    float* __restrict__ SRC = f.SRC;
    float* __restrict__ FDN = f.FDN;
    const float* gu = f.gu;
    const float* gd = f.gd;
    const float* gr = f.gr;
    const float dirN = DIR[N * s];

    // ---- A-U ----
    float ab_c = 0.0f, sb_c = 0.0f;
    float fd = FDN[0];
    float albB = gu[0] * fd, srcB = gu[0];
    float Fh = FH[0];
    float4 q = K[0];
    float dv = DIR[0], ab = ALB[s], sn = SRC[s], fdn_n = FDN[s];
    float d = DD[0];
    for (int v = 0; v < N; ++v) {
        const int vn = (v + 1 < N ? v + 1 : v) * s;
        float Fh_n = FH[vn];
        float4 qn = K[vn];
        float dn = DIR[vn], ddn = DD[vn];
        float abn = ALB[vn + s], snn = SRC[vn + s], fdn_nn = FDN[vn + s];
        const float r = q.x, td = q.y;
        float sdn = q.w * dv;
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
        FH[v * s] = sb;
        ALB[(v + 1) * s] = rb;
        SRC[(v + 1) * s] = tdb;
        FDN[v * s] = sdnb;
        // A-F's cotangents of the albedo and source of level v+1
        albB = gu[v + 1] * fdn_n + ddF * r;
        srcB = gu[v + 1] + Fh * d * r;
        fd = fdn_n;
        Fh = Fh_n;
        q = qn;
        dv = dn;
        d = ddn;
        ab = abn;
        sn = snn;
        fdn_n = fdn_nn;
    }
    a.alb_dif_b[x.bc] = albB + ab_c;
    const float Src_bN = srcB + sb_c;
    a.alb_dir_b[x.bc] = x.day_sfc ? Src_bN * dirN : 0.0f;

    // ---- A-S ----
    float Dh = gd[N] + gr[N] + (x.day_sfc ? Src_bN * x.alb_dir : 0.0f);
    q = K[(N - 1) * s];
    float tq = TN[(N - 1) * s];
    dv = DIR[(N - 1) * s];
    float supb = FH[(N - 1) * s], sdnb = FDN[(N - 1) * s];
    for (int l = N - 1; l >= 0; --l) {
        const int ln = (l > 0 ? l - 1 : 0) * s;
        float4 qn = K[ln];
        float tqn = TN[ln], dn = DIR[ln], supbn = FH[ln], sdnbn = FDN[ln];
        float tns_b = dv * Dh;
        float dl_src = q.z * supb + q.w * sdnb;   // 0 at night
        Dh = gd[l] + gr[l] + dl_src + tq * Dh;
        K[l * s] = make_float4(q.x, q.y, supb * dv, sdnb * dv);
        TN[l * s] = tns_b;
        q = qn;
        tq = tqn;
        dv = dn;
        supb = supbn;
        sdnb = sdnbn;
    }
    a.inc_b[x.bc] = Dh * x.mu_top;
    return Dh * x.inc;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
solver_sw_bwd_kernel(const BwdArgs a) {
    extern __shared__ float4 coef[];          // (nlay, chunk)
    namespace cg = cooperative_groups;
    const int nlay = a.nlay, ngpt = a.ngpt, chunk = a.chunk;
    const int nlev = nlay + 1;
    const int nchunk = (int)cg::this_cluster().num_blocks();
    const int rank = (int)cg::this_cluster().block_rank();
    const int c = blockIdx.x / nchunk;
    float* tns_s = (float*)(coef + (size_t)nlay * chunk);   // (nlay, chunk)
    float* dd_s = tns_s + (size_t)nlay * chunk;             // (nlay, chunk)
    float* fh_s = dd_s + (size_t)nlay * chunk;              // (nlay, chunk)
    float* dir_s = fh_s + (size_t)nlay * chunk;             // (nlev, chunk)
    float* alb_s = dir_s + (size_t)nlev * chunk;
    float* src_s = alb_s + (size_t)nlev * chunk;
    float* fdn_s = src_s + (size_t)nlev * chunk;
    float* cot_s = fdn_s + (size_t)nlev * chunk;            // (3, nlev)
    rte::ClusterSums sums;
    sums.init(cot_s + 3 * nlev, kFields, chunk, nlay, 0, nullptr, 0, ngpt);
    // the warp partials of field k (the mu0 cotangent, the seed) at
    // layer l: sums.part[(k * nw + lane / 32) * nlay + l]
    const int nw = chunk / 32;
    const int lane = threadIdx.x % chunk;
    const int g = rank * chunk + lane;
    const bool active = g < ngpt;
    const long long lay0 = (long long)c * nlay * ngpt + g;
    const float* mu0 = a.mu0 + (long long)c * nlay;

    // ---- P0: the forward coefficients, layers in parallel; the
    // column's flux cotangents ----
    for (int l = threadIdx.x / chunk; active && l < nlay;
         l += kThreads / chunk) {
        const long long o = lay0 + (long long)l * ngpt;
        const float mu = __ldg(mu0 + l);
        rte::SwLayer s = rte::sw_layer(__ldg(a.tau + o), __ldg(a.ssa + o),
                                       __ldg(a.asy + o), mu);
        const bool day = mu > 0.0f;
        coef[l * chunk + lane] = make_float4(s.rdif, s.tdif,
                                             day ? s.rdir : 0.0f,
                                             day ? s.tdir : 0.0f);
        tns_s[l * chunk + lane] = s.tns;
    }
    for (int i = threadIdx.x; i < 3 * nlev; i += kThreads) {
        const int k = i / nlev;
        const float* src = k == 0 ? a.gup : (k == 1 ? a.gdn : a.gdir);
        cot_s[i] = __ldg(src + (long long)c * nlev + (i - k * nlev));
    }
    __syncthreads();

    // ---- the sweeps: the chunk's first ``chunk`` threads, and for A-F,
    // beside the diffuse sweep, the next ``chunk`` ----
    const Lane f{coef + lane, tns_s + lane, dd_s + lane, fh_s + lane,
                 dir_s + lane, alb_s + lane, src_s + lane, fdn_s + lane,
                 cot_s, cot_s + nlev, cot_s + 2 * nlev, chunk};
    const bool sweeper = threadIdx.x < chunk;
    const bool second = !sweeper && threadIdx.x < 2 * chunk;
    if (sweeper && active) beam_build(a, Bounds(a, c, g), f);
    __syncthreads();
    if (sweeper && active) diffuse(a, Bounds(a, c, g), f);
    if (second && active) adjoint_diffuse(a, Bounds(a, c, g), f);
    __syncthreads();
    if (sweeper) {
        float seed = active ? adjoint_build_beam(a, Bounds(a, c, g), f)
                            : 0.0f;
        seed = rte::warp_sum(seed);
        if ((threadIdx.x & 31) == 0)
            sums.part[(nw + lane / 32) * nlay] = seed;
    }
    __syncthreads();

    // ---- A-C: the Meador-Weaver chain transposed, layers in parallel
    // (a warp's 32 lanes share a layer); the warp's sum of the mu0
    // cotangent of its layer ----
    for (int l = threadIdx.x / chunk; l < nlay; l += kThreads / chunk) {
        const int o = l * chunk + lane;
        float mu_b = 0.0f;
        if (active) {
            const long long og = lay0 + (long long)l * ngpt;
            const float t = __ldg(a.tau + og), w0 = __ldg(a.ssa + og);
            const float asym = __ldg(a.asy + og), mu = __ldg(mu0 + l);
            const rte::SwLayerAD s = rte::sw_layer_ad(t, w0, asym, mu);
            const bool day = mu > 0.0f;
            const float4 q = coef[o];
            rte::SwBars b = rte::sw_layer_adjoint(
                s, t, w0, asym, mu, alb_s[o + chunk], src_s[o + chunk],
                day ? q.z : 0.0f, day ? q.w : 0.0f, tns_s[o]);
            a.tau_b[og] = b.t;
            a.ssa_b[og] = b.w0;
            a.g_b[og] = b.asym;
            mu_b = b.mu;
        }
        mu_b = rte::warp_sum(mu_b);
        if ((threadIdx.x & 31) == 0) sums.part[(lane / 32) * nlay + l] = mu_b;
    }

    // ---- the mu0 cotangent of each layer: the cluster's sums of the
    // warp partials; layer 0 adds the seed's ----
    sums.finalize([&](int i, auto total) {
        float s = total(0);
        if (i == 0) s += total(1);
        a.mu0_b[(long long)c * nlay + i] = s;
    });
}

size_t smem_bytes(int nlay, int chunk) {
    return (size_t)nlay * chunk * (sizeof(float4) + 3 * sizeof(float))
        + (size_t)4 * (nlay + 1) * chunk * sizeof(float)
        + (size_t)3 * (nlay + 1) * sizeof(float)
        + rte::ClusterSums::bytes(kFields, chunk, nlay, 0);
}

}  // namespace

// Shared memory of one block at (nlay, chunk), the bytes
// ops/kernels/onchip.py::onchip_geometry counts.
extern "C" int smem_solver_sw_bwd(int nlay, int chunk) {
    return (int)smem_bytes(nlay, chunk);
}

// Resident blocks per SM * 65536 + clusters the card holds at once, or a
// negative CUDA error (transport.cuh::cluster_occupancy).
extern "C" int occupancy_solver_sw_bwd(int nlay, int chunk, int nchunk) {
    return rte::cluster_occupancy(solver_sw_bwd_kernel, nchunk, kThreads,
                                  smem_bytes(nlay, chunk));
}

// tau/ssa/asy (column, layer, g-point), mu0 (column, layer), the
// albedos and incident fluxes (column, g-point), the flux cotangents
// (column, level); the cotangents of each input, in its shape. chunk:
// g-points per block (onchip_geometry).
extern "C" int launch_solver_sw_bwd(
        const void* tau, const void* ssa, const void* asy, const void* mu0,
        const void* alb_dir, const void* alb_dif, const void* inc,
        const void* inc_dif, const void* gup, const void* gdn,
        const void* gdir, void* tau_b, void* ssa_b, void* g_b, void* mu0_b,
        void* alb_dir_b, void* alb_dif_b, void* inc_b, void* inc_dif_b,
        int ncol, int nlay, int ngpt, int chunk, void* stream) {
    if (ncol == 0) return 0;
    BwdArgs a = {(const float*)tau, (const float*)ssa, (const float*)asy,
                 (const float*)mu0, (const float*)alb_dir,
                 (const float*)alb_dif, (const float*)inc,
                 (const float*)inc_dif, (const float*)gup,
                 (const float*)gdn, (const float*)gdir, (float*)tau_b,
                 (float*)ssa_b, (float*)g_b, (float*)mu0_b,
                 (float*)alb_dir_b, (float*)alb_dif_b, (float*)inc_b,
                 (float*)inc_dif_b, ncol, nlay, ngpt, chunk};
    const int nchunk = (ngpt + chunk - 1) / chunk;
    return (int)rte::launch_clusters(solver_sw_bwd_kernel, ncol, nchunk,
                                     kThreads, smem_bytes(nlay, chunk),
                                     (cudaStream_t)stream, a);
}
