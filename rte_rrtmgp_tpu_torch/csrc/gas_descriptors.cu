// The gas-optics descriptors of one call in one launch, and their
// adjoint: the column amounts (reference compute_gas_taus, rrtmgp/
// frontend/mo_gas_optics_rrtmgp.F90:538-609, with the dry-air column of
// rte/kernels/mo_gas_optics_utils.F90:127-152) and the interpolation
// coefficients (rrtmgp_interpolation, rrtmgp/kernels/
// mo_gas_optics_rrtmgp_kernels.F90:37-170) that the major, minor and
// Rayleigh lookups and the fused kernels read.
//
// No TPU kernel corresponds: the JAX package forms these in plain JAX
// (rte_rrtmgp_tpu/ops/gas_optics.py, interpolation; rte_rrtmgp_tpu/
// models/rrtmgp/gas_optics.py, the column amounts). Plain twins:
// rte_rrtmgp_tpu_torch/ops/gas_optics.py::column_amounts and
// ::interpolation (the forward), rte_rrtmgp_tpu_torch/ops/kernels/
// gas_descriptors.py::gas_descriptors_bwd_plain (the adjoint's closed
// form).
//
// gas_descriptors: one thread per cell of the (ncol, nlay) cells. It
// reads its play, tlay, the two levels around it (or a given col_dry) and
// each gas's vmr, forms col_dry, writes col_gas (row 0 col_dry, row k the
// vmr of gas k times col_dry), then the temperature and pressure indices
// and fractions, the tropopause flag, and for both temperature corners
// and every flavor the mixed column, the eta index and fraction. Each gas
// comes as a pointer with a column and a layer stride (0 for a profile's
// column stride, both 0 for a scalar on the device), as a host value, or
// absent (zeros), all in the parameter struct, by value: a launch makes
// no copy and no wait. The tables (temp_ref, the vmr_ref ratio of each
// flavor, the flavor rows) are the k-distribution's, made on the device
// once. Every operation is the twin's on the card, in the twin's order,
// rounded as the twin rounds it (__fmul_rn and friends: nvcc contracts
// nothing; a division by a host scalar is the product with its
// reciprocal, formed on the host, as PyTorch's CUDA division by a scalar
// is; logf as torch.log), so the outputs equal the twin's on the card
// bit for bit.
//
// gas_descriptors_bwd: from the cotangents of col_gas, ftemp, fpress,
// col_mix and feta (the indices and the tropopause flag are piecewise
// constant), those of play and tlay, and per cell those of col_dry (when
// given), of each vmr that needs one, and of the levels through this
// layer's pressure thickness (summed into the levels by the wrapper).
// One thread per cell accumulates the col_gas rows' cotangents in its
// own column of shared memory (one slot per row) in a fixed order: no
// atomics, two runs give identical bits.
//
// Layout: the outputs are contiguous (n0, n1) cells, (nlay, ncol) for the
// fused kernels (layer_major) or (ncol, nlay) for the public API, and a
// block is a tile of 32 cells along n1 by 8 along n0, so every store is
// coalesced; the inputs are read through (column, layer) strides.
//
// What bounds them on this card: the bytes written (col_gas and the
// coefficients, about 100 B a cell at 19 gases and 10 flavors) and read.
//
// Contract (checked by the Python wrapper): play, tlay, plev, col_dry,
// the tables, outputs and cotangents of one dtype, float32 or float64
// (f64); a vmr float32 or float64 whatever the data's; the flavor rows
// int64 (2, nflav); outputs and cotangents contiguous; every offset
// within 32-bit strides; at most kMaxGas gases.

#include "common.cuh"

namespace {

constexpr int kTileX = 32;        // cells of a tile along n1
constexpr int kTileY = 8;         // along n0
constexpr int kThreads = kTileX * kTileY;
constexpr int kMaxGas = 64;

// The constants, formed on the host as the twin forms them.
enum Const {
    kT0,          // temp_ref_min - temp_ref_delta
    kInvDT,       // 1 / temp_ref_delta, in the data's precision
    kPLog0,       // press_ref_log[0]
    kInvDP,       // 1 / press_ref_log_delta, in the data's precision
    kTrop,        // the tropopause pressure
    kTwoTiny,     // 2 x the data type's smallest normal
    kEtaM1,       // neta - 1
    kPresM1,      // npres - 1
    kMH2O, kMDry, kAvogad, kGrav,
    kNConst
};

enum Kind { kAbsent = 0, kF32 = 1, kF64 = 2, kValue = 3 };

struct GasSrc {
    const void* p;
    int s_col, s_lay;   // element strides, 0 along a broadcast axis
    int kind;
    double value;       // kValue: the host scalar
};

struct Inputs {
    GasSrc gas[kMaxGas];      // gas k is row k + 1 of col_gas
    const void* play; int p_col, p_lay;
    const void* tlay; int t_col, t_lay;
    const void* plev; int l_col, l_lev;
    const void* col_dry; int d_col, d_lay;   // null: from the pressures
    const void* temp_ref;     // (ntemp,)
    const void* vmr_ratio;    // (2, nflav, ntemp)
    const long long* flavor;  // (2, nflav) rows of col_gas
    int ngas, nflav, ntemp, neta, h2o;       // h2o: its row of col_gas
    int ncol, nlay, layer_major;
    double c[kNConst];
};

struct Outputs {
    void* col_gas; int* jtemp; void* ftemp; int* jpress; void* fpress;
    unsigned char* tropo; int* jeta; void* col_mix; void* feta;
};

struct Cotangents {
    const void* col_gas; const void* ftemp; const void* fpress;
    const void* col_mix; const void* feta;
    void* dplay; void* dtlay;
    void* dcol_dry;           // null unless col_dry is given and needs one
    void* dthick;             // null unless plev needs one
    void* dvmr;               // (nslot, n0, n1)
    int slot[kMaxGas];        // gas k's plane of dvmr, -1 for none
};

__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
    return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
    return __ddiv_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float log_(float a) { return logf(a); }
__device__ __forceinline__ double log_(double a) { return log(a); }

// torch.clamp of a float: NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_(T v, T lo, T hi) {
    return isnan(v) ? v : fmin(fmax(v, lo), hi);
}

template <typename T>
__device__ __forceinline__ T at(const void* p, int col, int lay, int s_col,
                                int s_lay) {
    return __ldg((const T*)p + (long long)col * s_col
                 + (long long)lay * s_lay);
}

template <typename T>
__device__ __forceinline__ T vmr(const GasSrc& g, int col, int lay) {
    const long long off = (long long)col * g.s_col + (long long)lay * g.s_lay;
    switch (g.kind) {
        case kF32: return (T)__ldg((const float*)g.p + off);
        case kF64: return (T)__ldg((const double*)g.p + off);
        case kValue: return (T)g.value;
        default: return T(0);
    }
}

// The cell's (col, lay) and its place in the (n0, n1) outputs.
struct Cell {
    int col, lay;
    long long at;
};

__device__ __forceinline__ bool tile_cell(const Inputs& in, Cell* c) {
    const int n0 = in.layer_major ? in.nlay : in.ncol;
    const int n1 = in.layer_major ? in.ncol : in.nlay;
    const int tiles1 = (n1 + kTileX - 1) / kTileX;
    const int i = (int)(blockIdx.x / tiles1) * kTileY + threadIdx.y;
    const int j = (int)(blockIdx.x % tiles1) * kTileX + threadIdx.x;
    if (i >= n0 || j >= n1) return false;
    c->col = in.layer_major ? j : i;
    c->lay = in.layer_major ? i : j;
    c->at = (long long)i * n1 + j;
    return true;
}

// The dry-air column as ops/gas_optics.py::get_col_dry forms it, and the
// terms its adjoint reads.
template <typename T>
struct Dry {
    T col, fact, den, diff;
};

template <typename T>
__device__ __forceinline__ Dry<T> dry_column(const Inputs& in, const Cell& c,
                                             T v) {
    Dry<T> d;
    const T lo = at<T>(in.plev, c.col, c.lay, in.l_col, in.l_lev);
    const T hi = at<T>(in.plev, c.col, c.lay + 1, in.l_col, in.l_lev);
    d.diff = sub_rn(lo, hi);
    d.fact = div_rn(T(1), add_rn(v, T(1)));
    const T m_air = mul_rn(add_rn(mul_rn(v, T(in.c[kMH2O])), T(in.c[kMDry])),
                           d.fact);
    const T num = mul_rn(mul_rn(mul_rn(fabs(d.diff), T(10)),
                                T(in.c[kAvogad])), d.fact);
    d.den = mul_rn(mul_rn(mul_rn(m_air, T(1000)), T(100)), T(in.c[kGrav]));
    d.col = div_rn(num, d.den);
    return d;
}

template <typename T>
__device__ __forceinline__ T cell_col_dry(const Inputs& in, const Cell& c) {
    if (in.col_dry) return at<T>(in.col_dry, c.col, c.lay, in.d_col, in.d_lay);
    return dry_column(in, c, vmr<T>(in.gas[in.h2o - 1], c.col, c.lay)).col;
}

// row k of col_gas at the cell: col_dry, or the vmr of gas k - 1 times it
template <typename T>
__device__ __forceinline__ T col_row(const Inputs& in, const Cell& c, T cd,
                                     long long k) {
    return k == 0 ? cd : mul_rn(vmr<T>(in.gas[k - 1], c.col, c.lay), cd);
}

// The temperature and pressure coefficients of a cell.
template <typename T>
struct TP {
    int jtemp, jpress;
    T ftemp, fpress;
    bool tropo;
};

template <typename T>
__device__ __forceinline__ TP<T> temp_press(const Inputs& in, T p, T t) {
    TP<T> r;
    const T inv_dt = T(in.c[kInvDT]);
    const T loctemp = mul_rn(sub_rn(t, T(in.c[kT0])), inv_dt);
    int jt1 = (int)floor(loctemp);
    jt1 = min(max(jt1, 1), in.ntemp - 1);
    r.ftemp = mul_rn(sub_rn(t, __ldg((const T*)in.temp_ref + jt1 - 1)),
                     inv_dt);
    r.jtemp = jt1 - 1;
    const T locpress = add_rn(mul_rn(sub_rn(log_(p), T(in.c[kPLog0])),
                                     T(in.c[kInvDP])), T(1));
    const T jp = clamp_(trunc(locpress), T(1), T(in.c[kPresM1]));
    r.fpress = sub_rn(locpress, jp);
    r.jpress = (int)jp - 1;
    r.tropo = p > T(in.c[kTrop]);
    return r;
}

// The mixing of one flavor at one temperature corner.
template <typename T>
struct Mix {
    T c1, c2, r, cm;
    long long g1, g2;
};

template <typename T>
__device__ __forceinline__ Mix<T> mix(const Inputs& in, const Cell& c, T cd,
                                      const TP<T>& tp, int it, int f) {
    Mix<T> m;
    const int jt = min(max(tp.jtemp + it, 0), in.ntemp - 1);
    m.g1 = __ldg(in.flavor + f);
    m.g2 = __ldg(in.flavor + in.nflav + f);
    m.c1 = col_row(in, c, cd, m.g1);
    m.c2 = col_row(in, c, cd, m.g2);
    m.r = __ldg((const T*)in.vmr_ratio
                + ((long long)(tp.tropo ? 0 : 1) * in.nflav + f) * in.ntemp
                + jt);
    m.cm = add_rn(m.c1, mul_rn(m.r, m.c2));
    return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gas_descriptors_kernel(
        const Inputs in, const Outputs out) {
    Cell c;
    if (!tile_cell(in, &c)) return;
    const long long ncell = (long long)in.ncol * in.nlay;
    const T p = at<T>(in.play, c.col, c.lay, in.p_col, in.p_lay);
    const T t = at<T>(in.tlay, c.col, c.lay, in.t_col, in.t_lay);
    const T cd = cell_col_dry<T>(in, c);
    T* cg = (T*)out.col_gas + c.at;
    for (int k = 0; k <= in.ngas; ++k) cg[k * ncell] = col_row(in, c, cd, k);
    const TP<T> tp = temp_press(in, p, t);
    out.jtemp[c.at] = tp.jtemp;
    ((T*)out.ftemp)[c.at] = tp.ftemp;
    out.jpress[c.at] = tp.jpress;
    ((T*)out.fpress)[c.at] = tp.fpress;
    out.tropo[c.at] = tp.tropo ? 1 : 0;
    const T two_tiny = T(in.c[kTwoTiny]);
    const T eta_m1 = T(in.c[kEtaM1]);
    for (int it = 0; it < 2; ++it) {
        for (int f = 0; f < in.nflav; ++f) {
            const Mix<T> m = mix(in, c, cd, tp, it, f);
            const T eta = m.cm > two_tiny ? div_rn(m.c1, m.cm) : T(0.5);
            const T loceta = mul_rn(eta, eta_m1);
            const T tl = trunc(loceta);
            const long long o = (long long)(it * in.nflav + f) * ncell + c.at;
            out.jeta[o] = min((int)tl + 1, in.neta - 1) - 1;
            ((T*)out.col_mix)[o] = m.cm;
            ((T*)out.feta)[o] = sub_rn(loceta, tl);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gas_descriptors_bwd_kernel(
        const Inputs in, const Cotangents g) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* acc = (T*)smem + threadIdx.y * kTileX + threadIdx.x;
    Cell c;
    if (!tile_cell(in, &c)) return;
    const long long ncell = (long long)in.ncol * in.nlay;
    const T p = at<T>(in.play, c.col, c.lay, in.p_col, in.p_lay);
    const T t = at<T>(in.tlay, c.col, c.lay, in.t_col, in.t_lay);
    Dry<T> dry{};
    T v_h2o = T(0);
    if (!in.col_dry) {
        v_h2o = vmr<T>(in.gas[in.h2o - 1], c.col, c.lay);
        dry = dry_column(in, c, v_h2o);
    }
    const T cd = in.col_dry
        ? at<T>(in.col_dry, c.col, c.lay, in.d_col, in.d_lay) : dry.col;
    const T* gc = (const T*)g.col_gas + c.at;
    for (int k = 0; k <= in.ngas; ++k) acc[k * kThreads] = gc[k * ncell];
    const TP<T> tp = temp_press(in, p, t);
    const T two_tiny = T(in.c[kTwoTiny]);
    const T eta_m1 = T(in.c[kEtaM1]);
    for (int it = 0; it < 2; ++it) {
        for (int f = 0; f < in.nflav; ++f) {
            const Mix<T> m = mix(in, c, cd, tp, it, f);
            const long long o = (long long)(it * in.nflav + f) * ncell + c.at;
            // col_mix = c1 + r c2; feta = (neta - 1) c1 / col_mix, where
            // col_mix passes twice the smallest normal, else constant
            T dcm = ((const T*)g.col_mix)[o];
            T d1 = T(0);
            if (m.cm > two_tiny) {
                const T deta = ((const T*)g.feta)[o] * eta_m1;
                const T eta = m.c1 / m.cm;
                d1 = deta / m.cm;
                dcm -= (deta * eta) / m.cm;
            }
            acc[m.g1 * kThreads] += d1 + dcm;
            acc[m.g2 * kThreads] += dcm * m.r;
        }
    }
    // col_gas[k] = vmr_k col_dry
    T dcd = acc[0];
    for (int k = 1; k <= in.ngas; ++k)
        dcd += acc[k * kThreads] * vmr<T>(in.gas[k - 1], c.col, c.lay);
    T dh2o = T(0);
    if (!in.col_dry) {
        // col_dry = 10 dp A fact / (1e5 g m_air), m_air = (m_dry + m_h2o
        // v) fact: fact cancels, d col_dry / d v = -col_dry m_h2o /
        // (m_dry + m_h2o v), d col_dry / d dp = 10 A fact / den
        const T mh = T(in.c[kMH2O]);
        dh2o = -(dcd * dry.col) * mh / (T(in.c[kMDry]) + mh * v_h2o);
        if (g.dthick) {
            const T sgn = dry.diff > T(0) ? T(1)
                : (dry.diff < T(0) ? T(-1) : T(0));
            ((T*)g.dthick)[c.at] =
                dcd * ((T(10) * T(in.c[kAvogad]) * dry.fact) / dry.den) * sgn;
        }
    } else if (g.dcol_dry) {
        ((T*)g.dcol_dry)[c.at] = dcd;
    }
    for (int k = 1; k <= in.ngas; ++k) {
        const int s = g.slot[k - 1];
        if (s < 0) continue;
        T d = acc[k * kThreads] * cd;
        if (k == in.h2o) d += dh2o;
        ((T*)g.dvmr)[s * ncell + c.at] = d;
    }
    ((T*)g.dtlay)[c.at] = ((const T*)g.ftemp)[c.at] * T(in.c[kInvDT]);
    ((T*)g.dplay)[c.at] = ((const T*)g.fpress)[c.at] * T(in.c[kInvDP]) / p;
}

int tiles(const Inputs& in) {
    const int n0 = in.layer_major ? in.nlay : in.ncol;
    const int n1 = in.layer_major ? in.ncol : in.nlay;
    return ((n1 + kTileX - 1) / kTileX) * ((n0 + kTileY - 1) / kTileY);
}

// The launch's inputs from the launcher's arguments; ngas past kMaxGas is
// refused by the wrapper.
Inputs inputs(const void* const* gas_ptr, const int* gas_kind,
              const int* gas_strides, const double* gas_value, int ngas,
              const void* play, int p0, int p1, const void* tlay, int t0,
              int t1, const void* plev, int l0, int l1, const void* col_dry,
              int d0, int d1, const void* temp_ref, const void* vmr_ratio,
              const void* flavor, int nflav, int ntemp, int neta, int h2o,
              int ncol, int nlay, int layer_major, const double* consts) {
    Inputs in{};
    for (int k = 0; k < ngas; ++k)
        in.gas[k] = GasSrc{gas_ptr[k], gas_strides[2 * k],
                           gas_strides[2 * k + 1], gas_kind[k], gas_value[k]};
    in.play = play; in.p_col = p0; in.p_lay = p1;
    in.tlay = tlay; in.t_col = t0; in.t_lay = t1;
    in.plev = plev; in.l_col = l0; in.l_lev = l1;
    in.col_dry = col_dry; in.d_col = d0; in.d_lay = d1;
    in.temp_ref = temp_ref;
    in.vmr_ratio = vmr_ratio;
    in.flavor = (const long long*)flavor;
    in.ngas = ngas; in.nflav = nflav; in.ntemp = ntemp; in.neta = neta;
    in.h2o = h2o; in.ncol = ncol; in.nlay = nlay;
    in.layer_major = layer_major;
    for (int i = 0; i < kNConst; ++i) in.c[i] = consts[i];
    return in;
}

}  // namespace

// col_gas (ngas + 1, n0, n1) and the coefficients (jtemp, ftemp, jpress,
// fpress, tropo (n0, n1); jeta, col_mix, feta (2, nflav, n0, n1)),
// contiguous; f64 selects double data. Nothing is launched for no cells.
extern "C" int launch_gas_descriptors(
        const void* const* gas_ptr, const int* gas_kind,
        const int* gas_strides, const double* gas_value, int ngas,
        const void* play, int p0, int p1, const void* tlay, int t0, int t1,
        const void* plev, int l0, int l1, const void* col_dry, int d0,
        int d1, const void* temp_ref, const void* vmr_ratio,
        const void* flavor, int nflav, int ntemp, int neta, int h2o,
        int ncol, int nlay, int layer_major, int f64, const double* consts,
        void* col_gas, void* jtemp, void* ftemp, void* jpress, void* fpress,
        void* tropo, void* jeta, void* col_mix, void* feta, void* stream) {
    if (ncol == 0 || nlay == 0) return 0;
    if (ngas > kMaxGas) return (int)cudaErrorInvalidValue;
    const Inputs in = inputs(gas_ptr, gas_kind, gas_strides, gas_value, ngas,
                             play, p0, p1, tlay, t0, t1, plev, l0, l1,
                             col_dry, d0, d1, temp_ref, vmr_ratio, flavor,
                             nflav, ntemp, neta, h2o, ncol, nlay,
                             layer_major, consts);
    const Outputs out{col_gas, (int*)jtemp, ftemp, (int*)jpress, fpress,
                      (unsigned char*)tropo, (int*)jeta, col_mix, feta};
    auto go = [&](auto kernel) {
        kernel<<<tiles(in), dim3(kTileX, kTileY), 0,
                 (cudaStream_t)stream>>>(in, out);
        return (int)cudaGetLastError();
    };
    return f64 ? go(gas_descriptors_kernel<double>)
               : go(gas_descriptors_kernel<float>);
}

// The cotangents of play and tlay (n0, n1), and where asked (non-null) of
// a given col_dry, of the layers' pressure thickness (signed as plev[lay]
// - plev[lay + 1]: the wrapper sums it into the levels) and of the vmrs
// with a slot (slot[k] >= 0: plane slot[k] of dvmr, per cell), from those
// of col_gas, ftemp, fpress, col_mix and feta, all contiguous.
extern "C" int launch_gas_descriptors_bwd(
        const void* const* gas_ptr, const int* gas_kind,
        const int* gas_strides, const double* gas_value, int ngas,
        const void* play, int p0, int p1, const void* tlay, int t0, int t1,
        const void* plev, int l0, int l1, const void* col_dry, int d0,
        int d1, const void* temp_ref, const void* vmr_ratio,
        const void* flavor, int nflav, int ntemp, int neta, int h2o,
        int ncol, int nlay, int layer_major, int f64, const double* consts,
        const void* g_col_gas, const void* g_ftemp, const void* g_fpress,
        const void* g_col_mix, const void* g_feta, void* dplay, void* dtlay,
        void* dcol_dry, void* dthick, void* dvmr, const int* slot,
        void* stream) {
    if (ncol == 0 || nlay == 0) return 0;
    if (ngas > kMaxGas) return (int)cudaErrorInvalidValue;
    const Inputs in = inputs(gas_ptr, gas_kind, gas_strides, gas_value, ngas,
                             play, p0, p1, tlay, t0, t1, plev, l0, l1,
                             col_dry, d0, d1, temp_ref, vmr_ratio, flavor,
                             nflav, ntemp, neta, h2o, ncol, nlay,
                             layer_major, consts);
    Cotangents g{};
    g.col_gas = g_col_gas; g.ftemp = g_ftemp; g.fpress = g_fpress;
    g.col_mix = g_col_mix; g.feta = g_feta;
    g.dplay = dplay; g.dtlay = dtlay; g.dcol_dry = dcol_dry;
    g.dthick = dthick; g.dvmr = dvmr;
    for (int k = 0; k < kMaxGas; ++k) g.slot[k] = k < ngas ? slot[k] : -1;
    auto go = [&](auto kernel, auto zero) {
        using T = decltype(zero);
        const size_t smem = (size_t)(ngas + 1) * kThreads * sizeof(T);
        cudaError_t err = rte::allow_smem(kernel, smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<tiles(in), dim3(kTileX, kTileY), smem,
                 (cudaStream_t)stream>>>(in, g);
        return (int)cudaGetLastError();
    };
    return f64 ? go(gas_descriptors_bwd_kernel<double>, 0.0)
               : go(gas_descriptors_bwd_kernel<float>, 0.0f);
}
