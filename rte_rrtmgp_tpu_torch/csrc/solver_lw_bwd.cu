// Adjoint of the one-angle LW no-scattering solve with broadband output
// (the public layout of launch_solver_lw: a scalar secant, no rescaling,
// no Jacobian).
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/solver_lw_bwd.py::
// _lw_bwd_lane (pallas_call :207; derivation :12-44). Plain twin:
// torch.autograd.grad of rte_rrtmgp_tpu_torch/ops/kernels/solver_lw.py::
// lw_noscat_plain (ops/kernels/solver_lw_bwd.py::lw_noscat_bwd_plain).
//
// Layout: a column's g-points are cut into chunks of ``chunk`` (a
// multiple of 32, at most 8 chunks: ops/kernels/onchip.py::
// onchip_geometry), one block of kThreads threads per chunk. Every
// cotangent has one owner and the flux cotangents are per level, so the
// blocks share nothing (no cluster). The chunk's layer fields live in
// shared memory, one row of ``chunk`` g-points per layer; no device
// scratch:
//   pass 1, every thread, kThreads / chunk layers at a time, kUnroll
//   layers' inputs loaded before any is used: tau, lay and lev read once;
//   tl = tau * ds and lev kept, and the layer's sources sdn, sup
//   (transport.cuh::lw_source); the column's flux cotangents by level;
//   then the chunk's first ``chunk`` threads, one per g-point, sweep
//   (transport.cuh::ring_sweep, each step's transmittance exp(-tl)
//   recomputed as lw_source forms it): down, the forward radiance rdn and
//   the up sweep's cotangent R (steps A5, A4 of the derivation), each
//   layer's values at its top kept, rdn in place of the spent sdn; the
//   surface (A3); up, the up radiance rup forward and the down sweep's
//   adjoint D (A2), each layer's values at its bottom kept, rup in place
//   of the spent sup;
//   pass 3, every thread again, per (layer, g-point), lay read again:
//   the transmittance's cotangent R rup + rdn D and A1
//   (transport_bwd.cuh::lw_source_adjoint) in the expressions of
//   rte::lw_adjoint, which row 16 calls; tau_b and lay_b written, the top
//   term and coef staged in place of tl and rup; after a barrier lev_b,
//   level l the fused multiply-add of layer l - 1's coef and D onto layer
//   l's top term, the sum the one-block kernel's sink formed.
// lay_b, lev_b and the surface and incident cotangents are the one-block
// kernel's bit for bit, tau_b within an ulp or two of the largest value
// (nvcc fused its products otherwise inside that kernel's up pass;
// PERF.md).
//
// What bounds it on this card: the bytes, reading tau, lay and lev and
// writing their cotangents, 24 B per (column, layer, g-point) (28 with
// lay read twice), which needs many warps in flight; then the two serial
// sweeps on one warp per chunk, while its block holds its shared memory,
// and step A1's arithmetic (an exp and three divisions per element).
// Walked in device memory, one block per column and one thread per
// g-point, each thread read the inputs twice, one layer ahead, and kept
// its forward radiance and up-sweep cotangent in the tau and lay
// cotangents' memory (1.44 ms at 4096 x 72; PERF.md). Shared memory per
// block: 4 B x chunk x (6 nlay + 1 + kAhead) (tl, sdn, sup, R, D: nlay
// rows each after kAhead padding rows, lev: nlay + 1) and 8 B x (nlay +
// 1) for the flux cotangents: 4 blocks per SM at 72 layers (keeping lay
// too, 3 were slower), the tallest column 298 layers at 256 g-points.
//
// Contract (checked by the Python wrapper): float32, contiguous, ngpt <=
// 1024, the column height within onchip_geometry's limit, top of the
// atmosphere at layer 0.

#include "common.cuh"
#include "transport_bwd.cuh"

namespace {

constexpr int kThreads = 256;   // per block: chunk g-points x layer lanes
constexpr int kAhead = rte::kRingAhead;
constexpr int kUnroll = 3;      // pass 1: layers whose loads are in flight
                                // together per thread
constexpr int kBlocksPerSm = 4; // registers capped for the 4 blocks per SM
                                // that the shared memory at 72 layers and
                                // 32-wide chunks leaves room for

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
solver_lw_bwd_kernel(
        const float* __restrict__ tau, const float* __restrict__ lay,
        const float* __restrict__ lev, const float* __restrict__ emis,
        const float* __restrict__ ssrc, const float* __restrict__ inc,
        const float* __restrict__ gup, const float* __restrict__ gdn,
        float* __restrict__ tau_b, float* __restrict__ lay_b,
        float* __restrict__ lev_b, float* __restrict__ emis_b,
        float* __restrict__ ssrc_b, float* __restrict__ inc_b, int nlay,
        int ngpt, int chunk, float ds, float piw) {
    extern __shared__ float smem[];
    const int nlev = nlay + 1;
    const int nchunk = (ngpt + chunk - 1) / chunk;
    const int c = blockIdx.x / nchunk;
    const int rank = blockIdx.x - c * nchunk;
    const int ld = chunk;
    const size_t fld = (size_t)nlay * ld;
    // the swept fields first, adjacent: the down sweep's loads past the
    // last layer read the next field's rows, the up sweep's loads above
    // the first layer the field before's, or the kAhead padding rows
    // before the first field
    float* tl_s = smem + kAhead * ld;   // tau * ds, then pass 3's top term
    float* dn_s = tl_s + fld;           // sdn, then rdn
    float* up_s = dn_s + fld;           // sup, then rup, then pass 3's
                                        // coef
    float* r_s = up_s + fld;            // R, the up sweep's cotangent
    float* d_s = r_s + fld;             // D, the down sweep's cotangent
    float* lv_s = d_s + fld;            // lev: nlev rows
    float* gu_s = lv_s + (size_t)nlev * ld;  // the column's flux
    float* gd_s = gu_s + nlev;               // cotangents by level

    const int lane = threadIdx.x % chunk;
    const int g = rank * chunk + lane;
    const bool active = g < ngpt;
    const int gg = active ? g : 0;      // idle lanes never read
    const int k0 = threadIdx.x / chunk, kstep = kThreads / chunk;
    const long long lay0 = (long long)c * nlay * ngpt + gg;
    const long long lev0 = (long long)c * nlev * ngpt + gg;
    const long long bc = (long long)c * ngpt + gg;

    // ---- pass 1: each input read once, layers in parallel ----
    for (int lv = threadIdx.x; lv < nlev; lv += kThreads) {
        gu_s[lv] = __ldg(gup + (long long)c * nlev + lv);
        gd_s[lv] = __ldg(gdn + (long long)c * nlev + lv);
    }
    for (int l0 = k0; active && l0 < nlay; l0 += kUnroll * kstep) {
        float tv[kUnroll], ly[kUnroll], top[kUnroll], bot[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long l = min(l0 + u * kstep, nlay - 1);
            tv[u] = __ldg(tau + lay0 + l * ngpt);
            ly[u] = __ldg(lay + lay0 + l * ngpt);
            top[u] = __ldg(lev + lev0 + l * ngpt);
            bot[u] = __ldg(lev + lev0 + (l + 1) * ngpt);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int l = l0 + u * kstep;
            if (l >= nlay) break;
            const int o = l * ld + lane;
            float tl = tv[u] * ds;
            float t, sdn, sup;
            rte::lw_source(tl, ly[u], top[u], bot[u], &t, &sdn, &sup);
            tl_s[o] = tl;
            lv_s[o] = top[u];
            dn_s[o] = sdn;
            up_s[o] = sup;
            if (l == nlay - 1) lv_s[nlay * ld + lane] = bot[u];
        }
    }
    __syncthreads();

    // ---- the sweeps, on the chunk's first ``chunk`` threads (an idle
    // lane's values are never written out): each layer's values at its
    // top (down) or bottom (up) kept for pass 3 ----
    if (threadIdx.x < chunk) {
        float* tl = tl_s + lane;
        float* dn = dn_s + lane;
        float* up = up_s + lane;
        float* r = r_s + lane;
        float* d = d_s + lane;
        float e = 0.0f, s = 0.0f, rdn = 0.0f, R = 0.0f;
        if (active) {
            e = __ldg(emis + bc);
            s = __ldg(ssrc + bc);
            rdn = __ldg(inc + bc) / piw;
            R = piw * gu_s[0];
        }
        // down: rdn[l+1] = t rdn[l] + sdn; R[l+1] = piw gup[l+1] + t R[l];
        // layer l's rdn in place of its sdn, its R in R's field
        rte::ring_sweep<3>(nlay, true,
                           [&](int l, float* v) {
                               v[0] = tl[l * ld];
                               v[1] = dn[l * ld];
                               v[2] = gu_s[l + 1];
                           },
                           [&](int l, const float* v) {
                               float t = expf(-v[0]);
                               dn[l * ld] = rdn;
                               r[l * ld] = R;
                               rdn = t * rdn + v[1];
                               R = piw * v[2] + t * R;
                           });
        // surface (A3): rup[N] = (1 - emis) rdn[N] + emis ssrc
        float rup = rdn * (1.0f - e) + e * s;
        float D = piw * gd_s[nlay] + (1.0f - e) * R;
        if (active) {
            emis_b[bc] = R * (s - rdn);
            ssrc_b[bc] = e * R;
        }
        // up: the up sweep forward and A2's cotangent D; layer l's rup in
        // place of its sup, its D in D's field
        rte::ring_sweep<3>(nlay, false,
                           [&](int l, float* v) {
                               v[0] = tl[l * ld];
                               v[1] = up[l * ld];
                               v[2] = gd_s[l];
                           },
                           [&](int l, const float* v) {
                               float t = expf(-v[0]);
                               up[l * ld] = rup;
                               d[l * ld] = D;
                               rup = t * rup + v[1];
                               D = piw * v[2] + t * D;
                           });
        if (active) inc_b[bc] = D / piw;
    }
    __syncthreads();

    // ---- pass 3: A4's transmittance cotangent and A1 per (layer,
    // g-point) in the one-block kernel's expressions; tau_b and lay_b
    // written, the top term and coef staged ----
    for (int l = k0; active && l < nlay; l += kstep) {
        const int o = l * ld + lane;
        const float R_l = r_s[o], D_l = d_s[o];
        float trans_b = R_l * up_s[o] + dn_s[o] * D_l;
        rte::LwBars b = rte::lw_source_adjoint(
            tl_s[o], __ldg(lay + lay0 + (long long)l * ngpt), lv_s[o],
            lv_s[o + ld], D_l, R_l, trans_b);
        tau_b[lay0 + (long long)l * ngpt] = b.tl * ds;
        lay_b[lay0 + (long long)l * ngpt] = b.lay;
        tl_s[o] = b.top;
        up_s[o] = b.coef;
    }
    __syncthreads();
    // level l: layer l - 1's bottom term (coef times its sdn_b = D) fused
    // onto layer l's top term, 0 below the surface
    for (int lv = k0; active && lv < nlev; lv += kstep) {
        float v = tl_s[lane];
        if (lv > 0) {
            const int o = (lv - 1) * ld + lane;
            v = fmaf(up_s[o], d_s[o], lv < nlay ? tl_s[o + ld] : 0.0f);
        }
        lev_b[lev0 + (long long)lv * ngpt] = v;
    }
}

size_t smem_bytes(int nlay, int chunk) {
    return ((size_t)chunk * (6 * nlay + 1 + kAhead)
            + 2 * (size_t)(nlay + 1)) * sizeof(float);
}

}  // namespace

// Shared memory of one block at (nlay, chunk), the bytes
// ops/kernels/onchip.py::onchip_geometry counts.
extern "C" int smem_solver_lw_bwd(int nlay, int chunk) {
    return (int)smem_bytes(nlay, chunk);
}

// Resident blocks per SM of the kernel at (nlay, chunk), or a negative
// CUDA error.
extern "C" int occupancy_solver_lw_bwd(int nlay, int chunk) {
    const size_t smem = smem_bytes(nlay, chunk);
    int n = 0;
    cudaError_t err = rte::allow_smem(solver_lw_bwd_kernel, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, solver_lw_bwd_kernel, kThreads, smem);
    return err == cudaSuccess ? n : -(int)err;
}

// chunk: g-points per block (onchip_geometry).
extern "C" int launch_solver_lw_bwd(
        const void* tau, const void* lay, const void* lev, const void* emis,
        const void* ssrc, const void* inc, const void* gup, const void* gdn,
        void* tau_b, void* lay_b, void* lev_b, void* emis_b, void* ssrc_b,
        void* inc_b, int ncol, int nlay, int ngpt, float ds, float piw,
        int chunk, void* stream) {
    if (ncol == 0) return 0;
    const size_t smem = smem_bytes(nlay, chunk);
    cudaError_t err = rte::allow_smem(solver_lw_bwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int nchunk = (ngpt + chunk - 1) / chunk;
    solver_lw_bwd_kernel<<<ncol * nchunk, kThreads, smem,
                           (cudaStream_t)stream>>>(
        (const float*)tau, (const float*)lay, (const float*)lev,
        (const float*)emis, (const float*)ssrc, (const float*)inc,
        (const float*)gup, (const float*)gdn, (float*)tau_b, (float*)lay_b,
        (float*)lev_b, (float*)emis_b, (float*)ssrc_b, (float*)inc_b, nlay,
        ngpt, chunk, ds, piw);
    return (int)cudaGetLastError();
}
