"""SSM: the Simple Spectral Model gas optics, on tensors.

Counterpart of ``rte_rrtmgp_tpu.models.ssm`` (reference
ssm/mo_optics_ssm.F90, ``ty_optics_ssm``, and ssm/
mo_optics_ssm_kernels.F90): a small gas-optics scheme on an explicit
wavenumber grid (one g-point per wavenumber "band") whose absorption
coefficients are sums of "triangles" of ln(kappa) per gas,

    kappa(gas, nu) = sum_over_triangles kappa0 * exp(-|nu - nu0| / l),

evaluated at configure time in float64; at run time

    tau(col, lay, nu) = [sum_gas layer_mass(gas) * kappa(gas, nu)] * p/pref,

a (ncol*nlay, ngas) x (ngas, nnu) contraction (``torch.einsum``, as the
JAX package's ``einsum``; no kernel of its own) times the pressure
broadening. In float32 on a CUDA device the contraction runs in cuBLAS:
``torch.backends.cuda.matmul.allow_tf32`` must stay False (PyTorch's
default), or it is rounded to TF32's 10-bit mantissa. Planck sources are
analytic B_nu; the SW variant carries a blackbody stellar spectrum
normalized to the TSI. The tables are float64 tensors on one device and
are cast to the inputs' dtype at each call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import constants
from ..config import resolve_device
from ..gas_concs import GasConcs
from ..ops.planck import planck_source
from ..optical_props import OpticalProps1scl, OpticalProps2str
from ..sources import SourcesLW
from ..spectral import SpectralGrid
from .base import infer_top_at_1

__all__ = ["OpticsSSM", "ssm_lw_defaults", "ssm_sw_defaults",
           "TSUN_SSM", "TSI_SSM"]

TSUN_SSM = 5760.0   # default stellar temperature [K] (mo_optics_ssm.F90:40)
TSI_SSM = 1360.0    # default total solar irradiance [W/m2] (:41)

MOL_WEIGHTS = {"h2o": 0.018, "co2": 0.044, "o3": 0.048}  # kg/mol (:43-45)

# default cloud optical properties (:47-54)
KAPPA_CLD_LW, KAPPA_CLD_SW = 50.0, 0.0001   # m2/kg
SSA_CLD_LW, SSA_CLD_SW = 0.0, 0.9999
G_CLD_LW, G_CLD_SW = 0.0, 0.85

_NNU_DEF = 41

# default spectroscopy (mo_optics_ssm.F90:72-85): rows of
# (gas_index[1-based], kappa0 [m2/kg], nu0 [cm-1], l [cm-1])
TRIANGLES_LW_DEF = np.array([
    [1.0, 282.0, 0.0, 64.0],       # h2o rotational band
    [1.0, 24.0, 1600.0, 52.0],     # h2o vibrational band
    [2.0, 110.0, 667.0, 12.0],     # co2 15-micron band
])
GASES_LW_DEF = ("h2o", "co2")
TRIANGLES_SW_DEF = np.array([
    [1.0, 1.0, 0.0, 1200.0],       # h2o
    [2.0, 0.0, 0.0, 1000000.0],    # o3 placeholder (no triangle yet)
])
GASES_SW_DEF = ("h2o", "o3")


@dataclasses.dataclass(frozen=True)
class OpticsSSM:
    """Configured SSM optics. Build with :meth:`OpticsSSM.configure` or
    :func:`ssm_lw_defaults` / :func:`ssm_sw_defaults`."""
    grid: SpectralGrid
    gas_names: tuple
    mol_weights: np.ndarray          # (ngas,) [kg/mol]
    absorption_coeffs: torch.Tensor  # (ngas, nnu) [m2/kg], float64
    nus: torch.Tensor                # (nnu,) [cm^-1], float64
    dnus: torch.Tensor               # (nnu,) band widths, float64
    toa_src: torch.Tensor            # (nnu,) [W/m2], zeros for LW, float64
    tstar: float = 0.0
    tsi: float = 0.0
    pref: float = 500.0e2            # reference pressure [Pa] (:101)
    m_dry: float = 0.029             # [kg/mol] (:102)
    kappa_cld: float = 0.0
    g_cld: float = 0.0
    ssa_cld: float = 0.0

    # ------------------------------------------------------------------
    @staticmethod
    def configure(gas_names, triangle_params, nus, nu_min, nu_max,
                  tstar: float = 0.0, tsi: float = 0.0,
                  kappa_cld: float = 0.0, g_cld: float = 0.0,
                  ssa_cld: float = 0.0, *, device=None) -> "OpticsSSM":
        """Build from triangle spectroscopy (reference configure_with_values,
        mo_optics_ssm.F90:165-352), the tables on ``device`` (default: the
        CUDA device)."""
        device = resolve_device(device)
        nus = np.asarray(nus, np.float64)
        tri = np.asarray(triangle_params, np.float64)
        nnu = nus.shape[0]
        ngas = len(gas_names)

        if not np.all((nus > nu_min) & (nus < nu_max)):
            raise ValueError("ssm: nus must lie strictly inside (nu_min, nu_max)")
        gi = tri[:, 0]
        if not np.all((gi >= 1) & (gi <= ngas) & (gi == np.floor(gi))):
            raise ValueError("ssm: gas index in triangle_params must be integer in 1..ngas")
        if np.any(tri[:, 1] < 0):
            raise ValueError("ssm: kappa0 must be >= 0")
        if np.any(tri[:, 3] <= 0):
            raise ValueError("ssm: triangle width l must be > 0")
        if tstar < 0 or tsi < 0:
            raise ValueError("ssm: tstar/tsi must be >= 0")

        # band edges at midpoints between nus (reference :259-270)
        edges_lo = np.empty(nnu)
        edges_hi = np.empty(nnu)
        mid = 0.5 * (nus[:-1] + nus[1:])
        edges_lo[0], edges_lo[1:] = nu_min, mid
        edges_hi[-1], edges_hi[:-1] = nu_max, mid
        grid = SpectralGrid.from_arrays(np.stack([edges_lo, edges_hi], -1))
        dnus = edges_hi - edges_lo

        mol_weights = np.empty(ngas)
        for i, name in enumerate(gas_names):
            key = name.strip().lower()
            if key not in MOL_WEIGHTS:
                raise ValueError(f"ssm: unknown molecular weight for gas '{name}'")
            mol_weights[i] = MOL_WEIGHTS[key]

        # kappa(gas, nu) = sum of triangles (reference :301-308)
        k = np.zeros((ngas, nnu))
        for row in tri:
            g = int(row[0]) - 1
            k[g] += row[1] * np.exp(-np.abs(nus - row[2]) / row[3])

        if tstar > 0:
            # normalized blackbody insolation (reference :313-324)
            src = planck_source(torch.tensor(tstar, dtype=torch.float64),
                                torch.from_numpy(nus),
                                torch.from_numpy(dnus)).numpy()
            toa = src * tsi / src.sum()
        else:
            toa = np.zeros(nnu)

        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        return OpticsSSM(grid=grid,
                         gas_names=tuple(n.strip().lower() for n in gas_names),
                         mol_weights=mol_weights, absorption_coeffs=t(k),
                         nus=t(nus), dnus=t(dnus), toa_src=t(toa),
                         tstar=tstar, tsi=tsi, kappa_cld=kappa_cld,
                         g_cld=g_cld, ssa_cld=ssa_cld)

    # ------------------------------------------------------------------
    def source_is_internal(self) -> bool:
        return self.tstar <= 0.0

    def source_is_external(self) -> bool:
        return self.tstar > 0.0

    def press_min(self): return 0.0
    def press_max(self): return float("inf")
    def temp_min(self): return 0.0
    def temp_max(self): return float("inf")

    @property
    def ngpt(self) -> int:
        return self.grid.ngpt

    @property
    def device(self) -> torch.device:
        return self.absorption_coeffs.device

    def _tensor(self, x, dtype=None):
        """A tensor on this object's device; numpy views of any strides
        (reversed ones included) are copied."""
        if not isinstance(x, torch.Tensor):
            x = np.ascontiguousarray(x)
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _layer_mass(self, plev, gas_concs: GasConcs, ncol, nlay, dtype):
        """(ncol, nlay, ngas) per-gas layer mass [kg/m2] (reference
        compute_layer_mass, mo_optics_ssm_kernels.F90:84-108): mass =
        vmr * (M_gas/M_dry) * |dp| / g. Gases absent from the store add
        zero (reference get_layer_mass :609-614)."""
        dp = (plev[:, 1:] - plev[:, :-1]).abs()
        cols = []
        for i, name in enumerate(self.gas_names):
            if name in gas_concs:
                vmr = gas_concs.get_vmr(name, ncol, nlay).to(dtype)
            else:
                vmr = plev.new_zeros((ncol, nlay), dtype=dtype)
            cols.append(vmr * float(self.mol_weights[i] / self.m_dry))
        mmr = torch.stack(cols, dim=-1)
        return mmr * (dp / constants.grav)[:, :, None]

    def _compute_tau(self, play, plev, gas_concs: GasConcs):
        """tau = (layer_mass @ kappa) * p/pref (reference compute_tau,
        mo_optics_ssm_kernels.F90:29-82)."""
        ncol, nlay = play.shape
        dtype = play.dtype
        mass = self._layer_mass(plev, gas_concs, ncol, nlay, dtype)
        tau = torch.einsum("clg,gn->cln", mass,
                           self.absorption_coeffs.to(dtype))
        if self.pref > 0:
            tau = tau * (play / self.pref)[:, :, None]
        return tau

    # ------------------------------------------------------------------
    def gas_optics_lw(self, play, plev, tlay, tsfc, gas_concs: GasConcs,
                      *, tlev=None, col_dry=None, scattering: bool = False,
                      top_at_1: Optional[bool] = None
                      ) -> Tuple[OpticalProps1scl, SourcesLW]:
        """LW optical depth and Planck sources (reference gas_optics_int,
        mo_optics_ssm.F90:359-453). ``tlev`` is required (reference
        :439-441)."""
        if not self.source_is_internal():
            raise ValueError("ssm: configured for external (SW) sources")
        if tlev is None:
            raise ValueError("ssm: tlev (level temperatures) is required")
        play = self._tensor(play)
        top = infer_top_at_1(play, top_at_1)
        tau = self._compute_tau(play, self._tensor(plev), gas_concs)
        dtype = tau.dtype
        nus, dnus = self.nus.to(dtype), self.dnus.to(dtype)
        src = lambda t: planck_source(self._tensor(t, dtype), nus, dnus)
        sources = SourcesLW(
            lay_source=src(tlay), lev_source=src(tlev), sfc_source=src(tsfc),
            sfc_source_jac=tau.new_zeros((play.shape[0], self.ngpt)),
            grid=self.grid)
        if scattering:
            props = OpticalProps2str(tau=tau, ssa=torch.zeros_like(tau),
                                     g=torch.zeros_like(tau), grid=self.grid,
                                     top_at_1=top)
        else:
            props = OpticalProps1scl(tau=tau, grid=self.grid, top_at_1=top)
        return props, sources

    def gas_optics_sw(self, play, plev, tlay, gas_concs: GasConcs,
                      *, col_dry=None, scattering: bool = True,
                      top_at_1: Optional[bool] = None
                      ) -> Tuple[OpticalProps2str, torch.Tensor]:
        """SW optical depth and the TOA stellar source (ncol, ngpt)
        (reference gas_optics_ext, mo_optics_ssm.F90:460-534)."""
        if not self.source_is_external():
            raise ValueError("ssm: configured for internal (LW) sources")
        play = self._tensor(play)
        top = infer_top_at_1(play, top_at_1)
        tau = self._compute_tau(play, self._tensor(plev), gas_concs)
        toa = self.toa_src.to(tau.dtype)[None, :].expand(play.shape[0],
                                                         self.ngpt)
        if scattering:
            props = OpticalProps2str(tau=tau, ssa=torch.zeros_like(tau),
                                     g=torch.zeros_like(tau), grid=self.grid,
                                     top_at_1=top)
            return props, toa
        return OpticalProps1scl(tau=tau, grid=self.grid, top_at_1=top), toa

    # ------------------------------------------------------------------
    def cloud_optics(self, clwp, ciwp, reliq=None, deice=None,
                     *, scattering: bool = True,
                     top_at_1: bool = True) -> OpticalProps2str:
        """Gray cloud optics: tau = 1000 (lwp + iwp) kappa_cld with scalar
        ssa and g (reference cloud_optics, mo_optics_ssm.F90:540-585;
        particle sizes are accepted and ignored, as in the reference)."""
        clwp, ciwp = self._tensor(clwp), self._tensor(ciwp)
        tau = (1000.0 * (clwp + ciwp) * self.kappa_cld)[:, :, None].expand(
            *clwp.shape, self.ngpt).contiguous()
        if not scattering:
            return OpticalProps1scl(tau=tau * (1.0 - self.ssa_cld),
                                    grid=self.grid, top_at_1=top_at_1)
        return OpticalProps2str(tau=tau,
                                ssa=torch.full_like(tau, self.ssa_cld),
                                g=torch.full_like(tau, self.g_cld),
                                grid=self.grid, top_at_1=top_at_1)


def ssm_lw_defaults(*, device=None) -> OpticsSSM:
    """Default LW configuration (reference configure_with_defaults,
    mo_optics_ssm.F90:125-145): h2o/co2 triangles on 41 wavenumbers in
    [50, 3000] cm^-1 with limits [0, 3500], on ``device`` (default: the
    CUDA device)."""
    nus = np.linspace(50.0, 3000.0, _NNU_DEF)
    return OpticsSSM.configure(GASES_LW_DEF, TRIANGLES_LW_DEF, nus,
                               0.0, 3500.0,
                               kappa_cld=KAPPA_CLD_LW, g_cld=G_CLD_LW,
                               ssa_cld=SSA_CLD_LW, device=device)


def ssm_sw_defaults(*, device=None) -> OpticsSSM:
    """Default SW configuration: h2o/o3 on 41 wavenumbers in
    [1000, 45000] cm^-1 with limits [0, 50000], Tstar=5760 K, TSI=1360,
    on ``device`` (default: the CUDA device)."""
    nus = np.linspace(1000.0, 45000.0, _NNU_DEF)
    return OpticsSSM.configure(GASES_SW_DEF, TRIANGLES_SW_DEF, nus,
                               0.0, 50000.0, tstar=TSUN_SSM, tsi=TSI_SSM,
                               kappa_cld=KAPPA_CLD_SW, g_cld=G_CLD_SW,
                               ssa_cld=SSA_CLD_SW, device=device)
