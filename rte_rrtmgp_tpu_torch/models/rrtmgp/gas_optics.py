"""RRTMGP gas-optics front end for the fused LW and SW steps.

Counterpart of ``rte_rrtmgp_tpu.models.rrtmgp.gas_optics`` (reference
``ty_gas_optics_rrtmgp`` run-time methods, rrtmgp/frontend/
mo_gas_optics_rrtmgp.F90): column amounts, the interpolation descriptors,
the minor-gas scaling rows and Rayleigh scaling (the descriptor prep,
plain PyTorch as it is plain JAX in the JAX package), then one call of
the fused LW or SW kernel (``ops/kernels``). Cell inputs are (ncol, nlay)
top-at-0; the kernels take layer-major (nlay, ncol) cells.
"""
from __future__ import annotations

import torch

from ... import constants
from ...gas_concs import GasConcs
from ...ops.gas_optics import InterpCoeffs, interpolation, minor_scaling
from ...ops.kernels.fused_lw import LWFusedInputs, lw_fused
from ...ops.kernels.fused_sw import SWFusedInputs, sw_fused
from .kdist import KDist

__all__ = ["GasOpticsRRTMGP", "get_col_dry", "interp_tlev"]


def get_col_dry(vmr_h2o, plev):
    """Dry-air molecules per cm^2 per layer (reference
    ``get_layer_number``, rte/kernels/mo_gas_optics_utils.F90:127-152)."""
    delta_plev = torch.abs(plev[:, :-1] - plev[:, 1:])
    fact = 1.0 / (1.0 + vmr_h2o)
    m_air = (constants.m_dry + constants.m_h2o * vmr_h2o) * fact
    return (10.0 * delta_plev * constants.avogad * fact
            / (1000.0 * m_air * 100.0 * constants.grav))


def interp_tlev(tlay, play, plev):
    """Pressure-weighted interpolation/extrapolation of layer temperatures
    to levels (reference source() :893-911)."""
    t0 = tlay[:, :1] + (plev[:, :1] - play[:, :1]) * (
        tlay[:, 1:2] - tlay[:, :1]) / (play[:, 1:2] - play[:, :1])
    tn = tlay[:, -1:] + (plev[:, -1:] - play[:, -1:]) * (
        tlay[:, -1:] - tlay[:, -2:-1]) / (play[:, -1:] - play[:, -2:-1])
    interior = (play[:, :-1] * tlay[:, :-1] * (plev[:, 1:-1] - play[:, 1:])
                + play[:, 1:] * tlay[:, 1:] * (play[:, :-1] - plev[:, 1:-1])
                ) / (plev[:, 1:-1] * (play[:, :-1] - play[:, 1:]))
    return torch.cat([t0, interior, tn], dim=1)


class GasOpticsRRTMGP:
    """Gas-optics provider over a :class:`KDist` whose tables live on one
    device; the static per-g-point and per-minor metadata is moved there
    once, here."""

    def __init__(self, kdist: KDist):
        self.kdist = kdist
        self.grid = kdist.grid
        dev = kdist.kmajor.device
        i32 = torch.int32
        self.gpoint_flavor = torch.as_tensor(kdist.gpoint_flavor, dtype=i32,
                                             device=dev)
        self.gpt2band = torch.as_tensor(kdist.grid.gpt2band, dtype=i32,
                                        device=dev)
        minors = []
        for lower, mset in ((1, kdist.minor_lower), (0, kdist.minor_upper)):
            for m in range(len(mset)):
                g0, g1 = mset.limits_gpt[m]
                minors.append((lower, int(mset.flavor[m]), int(g0),
                               int(g1 - g0 + 1), int(mset.kminor_start[m])))
        self.minors = tuple(minors)
        self.minor_meta = torch.as_tensor(self.minors, dtype=i32,
                                          device=dev).reshape(-1, 5)

    @property
    def ngpt(self) -> int:
        return self.kdist.ngpt

    def _check_key_species_present(self, gas_concs: GasConcs):
        """Reference check_key_species_present (:1403-1422)."""
        kd = self.kdist
        key = {kd.gas_names[g - 1] for pair in kd.flavor.T for g in pair
               if g > 0}
        missing = sorted(g for g in key if g not in gas_concs)
        if missing:
            raise ValueError(f"gas_optics: required gases {missing} are not provided")

    def col_gas(self, play, plev, gas_concs: GasConcs):
        """VMR gather + column amounts (reference compute_gas_taus
        :538-609): (ngas+1, ncol, nlay) with col_gas[0] = col_dry and
        col_gas[i] = vmr_i * col_dry; plus col_dry and the 1-based h2o
        row (a zeros row is appended when the k-distribution has no h2o)."""
        kd = self.kdist
        ncol, nlay = play.shape
        vmrs = [gas_concs.get_vmr(g, ncol, nlay).to(play.dtype)
                if g in gas_concs else torch.zeros_like(play)
                for g in kd.gas_names]
        idx_h2o = kd.idx_gas("h2o")
        vmr_h2o = vmrs[idx_h2o - 1] if idx_h2o > 0 else torch.zeros_like(play)
        col_dry = get_col_dry(vmr_h2o, plev)
        if idx_h2o < 0:
            vmrs = vmrs + [torch.zeros_like(play)]
            idx_h2o = len(vmrs)
        col_gas = torch.stack([col_dry] + [v * col_dry for v in vmrs])
        return col_gas, col_dry, idx_h2o

    def interp(self, play, tlay, col_gas) -> InterpCoeffs:
        kd = self.kdist
        return interpolation(
            play, tlay, col_gas, flavor=kd.flavor, neta=kd.neta,
            press_ref_log=kd.press_ref_log, temp_ref=kd.temp_ref,
            press_ref_log_delta=kd.press_ref_log_delta,
            temp_ref_min=kd.temp_ref_min, temp_ref_delta=kd.temp_ref_delta,
            press_ref_trop_log=kd.press_ref_trop_log, vmr_ref=kd.vmr_ref)

    def _descriptors(self, play, plev, tlay, gas_concs):
        """Layer-major interpolation state and minor scaling rows."""
        self._check_key_species_present(gas_concs)
        kd = self.kdist
        col_gas, col_dry, idx_h2o = self.col_gas(play, plev, gas_concs)
        play_c, tlay_c = play.T, tlay.T
        col_gas_c = col_gas.transpose(1, 2)
        co = self.interp(play_c, tlay_c, col_gas_c)
        co = InterpCoeffs(*(t.contiguous() for t in co))
        kw = dict(play=play_c, tlay=tlay_c, col_gas=col_gas_c,
                  idx_h2o=idx_h2o)
        msc = torch.cat([minor_scaling(co, kd.minor_lower, lower=True, **kw),
                         minor_scaling(co, kd.minor_upper, lower=False, **kw)])
        return co, msc.contiguous(), col_gas_c, col_dry.T, idx_h2o

    def lw_fused_inputs(self, play, plev, tlay, tsfc, gas_concs, *,
                        sfc_emis, tlev=None, cloud_tau_abs=None, ds,
                        weight) -> LWFusedInputs:
        """Descriptor prep for the fused LW kernel. sfc_emis (ngpt, ncol);
        cloud_tau_abs optional (nbnd, nlay, ncol) by-band absorption."""
        kd = self.kdist
        if not kd.source_is_internal():
            raise ValueError("rrtmgp gas optics: k-distribution is SW")
        co, msc, _, _, _ = self._descriptors(play, plev, tlay, gas_concs)
        if tlev is None:
            tlev = interp_tlev(tlay, play, plev)
        return LWFusedInputs(
            co=co, minor_scale=msc, minors=self.minors,
            minor_meta=self.minor_meta, kmajor=kd.kmajor,
            planck_frac=kd.planck_frac, kminor_lower=kd.kminor_lower,
            kminor_upper=kd.kminor_upper, gpoint_flavor=self.gpoint_flavor,
            gpt2band=self.gpt2band, totplnk=kd.totplnk,
            tp_min=kd.temp_ref_min, tp_delta=kd.totplnk_delta,
            tlay=tlay.T.contiguous(), tlev=tlev.T.contiguous(),
            tsfc=tsfc.to(play.dtype).contiguous(),
            sfc_emis=sfc_emis.contiguous(), cloud_tau_abs=cloud_tau_abs,
            ds=float(ds), weight=float(weight))

    def lw_fused_solve(self, play, plev, tlay, tsfc, gas_concs, **kw):
        """Gas optics + no-scattering solve in one fused kernel call.
        Returns broadband (flux_up, flux_dn), each (nlay+1, ncol)."""
        return lw_fused(self.lw_fused_inputs(play, plev, tlay, tsfc,
                                             gas_concs, **kw))

    def sw_fused_inputs(self, play, plev, tlay, gas_concs, *, mu0,
                        sfc_alb_dir, sfc_alb_dif, cloud=None
                        ) -> SWFusedInputs:
        """Descriptor prep for the fused SW kernel. mu0 (nlay, ncol);
        sfc_alb_* (ngpt, ncol); cloud optional by-band delta-scaled
        (tau, ssa, g), each (nbnd, nlay, ncol). The TOA flux is the
        k-distribution's solar source."""
        kd = self.kdist
        if not kd.source_is_external():
            raise ValueError("rrtmgp gas optics: k-distribution is LW")
        co, msc, col_gas_c, col_dry_c, idx_h2o = self._descriptors(
            play, plev, tlay, gas_concs)
        if cloud is not None:
            cloud = torch.stack(cloud)
            if cloud.shape[1] != kd.grid.nband:
                raise ValueError(f"sw cloud has {cloud.shape[1]} bands, the "
                                 f"k-distribution {kd.grid.nband}")
        ncol = play.shape[0]
        inc = kd.solar_source.to(play.dtype)[:, None].expand(kd.ngpt, ncol)
        return SWFusedInputs(
            co=co, minor_scale=msc, minors=self.minors,
            minor_meta=self.minor_meta, kmajor=kd.kmajor,
            kminor_lower=kd.kminor_lower, kminor_upper=kd.kminor_upper,
            krayl=kd.krayl, gpoint_flavor=self.gpoint_flavor,
            gpt2band=self.gpt2band,
            rayscale=(col_gas_c[idx_h2o] + col_dry_c).contiguous(),
            cloud=cloud, mu0=mu0.contiguous(),
            sfc_alb_dir=sfc_alb_dir.contiguous(),
            sfc_alb_dif=sfc_alb_dif.contiguous(), inc=inc.contiguous())

    def sw_fused_solve(self, play, plev, tlay, gas_concs, **kw):
        """Gas optics + two-stream solve in one fused kernel call. Returns
        broadband (flux_up, flux_dn total, flux_dir), each (nlay+1, ncol)."""
        return sw_fused(self.sw_fused_inputs(play, plev, tlay, gas_concs,
                                             **kw))
