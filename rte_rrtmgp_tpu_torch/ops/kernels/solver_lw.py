"""One-angle LW no-scattering solve with broadband or per-band output: the
CUDA kernel ``csrc/solver_lw.cu`` and its plain-PyTorch twin.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py::
lw_noscat_broadband_lane`` (semantics of ``ops/solver_lw.py::_oneangle``,
reference mo_rte_solver_kernels.F90:51-240): per (column, g-point) the
transmittance and linear-in-tau sources, the down sweep from the incident
flux, the surface term, the up sweep, optionally Tang rescaling (ssa, g)
and the surface Jacobian, and the broadband sum, or with ``gpt2band`` the
per-band sums, times pi * weight (the Jacobian always broadband). The TPU
kernel sums bands only when they are uniform and their width divides
128; here any band of each g-point works.

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`lw_noscat_plain`. The kernel keeps a column's layer
fields in shared memory (:func:`lw_noscat_geometry`), so on CUDA the
column height is bounded and a taller one raises ValueError naming the
limit; the twin has no limit. The kernel has no backward of its
own: on CUDA it refuses inputs that require grad; ``ops/solver_lw.py``
differentiates it (``solver_lw_bwd.lw_noscat_vjp``, or the twin's
gradient through ``autodiff.with_twin_grad``).
"""
from __future__ import annotations

import torch

from ...constants import PI
from ...fluxes import sum_bands
from ..solver_lw import _oneangle
from ._build import check_args, launch, on_cpu, query
from .autodiff import refuse_grad
from .onchip import Geometry, onchip_geometry

__all__ = ["lw_noscat", "lw_noscat_plain", "lw_noscat_geometry",
           "lw_noscat_scratch_bytes", "lw_noscat_occupancy"]


def lw_noscat_plain(tau, lay, lev, sfc_emis, sfc_src, inc_flux, *, ds,
                    weight: float, sfc_src_jac=None, ssa=None, g=None,
                    gpt2band=None, nband: int = 0):
    """tau/lay (ncol, nlay, ngpt), lev (ncol, nlay+1, ngpt), sfc_emis/
    sfc_src/inc_flux (ncol, ngpt), top at layer 0; ``ds`` a secant (a
    float or a 0-d tensor) or (ncol, ngpt) secants. With ssa and g (ncol,
    nlay, ngpt), Tang rescaling; with sfc_src_jac (ncol, ngpt), the
    Jacobian. Returns (flux_up, flux_dn, flux_up_jac or None) in W/m2:
    broadband, each (ncol, nlay+1), or with ``gpt2band`` (ngpt,) the
    fluxes' per-band sums (ncol, nlay+1, nband) and the broadband
    Jacobian."""
    up, dn, jac = _oneangle(tau, lay, lev, sfc_emis, sfc_src, inc_flux, ds,
                            weight, sfc_src_jac, ssa, g,
                            spectral=gpt2band is not None)
    if gpt2band is not None:
        up, dn = sum_bands(up, gpt2band, nband), sum_bands(dn, gpt2band, nband)
    piw = PI * weight
    return up * piw, dn * piw, None if jac is None else jac * piw


def lw_noscat_geometry(nlay: int, ngpt: int, nband: int = 0, *,
                       rescale: bool = False, jacobian: bool = False,
                       pfrac: bool = False) -> Geometry:
    """Chunk width, cluster size, threads and shared memory per block of
    the kernel (all three launchers: ``pfrac`` the in-kernel Planck
    sources of ``launch_solver_lw_pfrac``) at nlay layers, ngpt g-points
    and nband bands (0: broadband), with Tang ``rescale``-ing and the
    surface ``jacobian`` (:func:`onchip.onchip_geometry`); raises
    ValueError where a column's layer fields do not fit on chip."""
    return onchip_geometry("solver_lw", nlay, ngpt, nband, rescale=rescale,
                           jacobian=jacobian, pfrac=pfrac)


def lw_noscat_scratch_bytes(ncol: int, nlay: int, ngpt: int) -> int:
    """Device scratch of one launch of any of the three launchers, of any
    variant: none, the layer fields and the rescaled variant's radiances
    stay in shared memory."""
    return 0


def lw_noscat_occupancy(nlay: int, ngpt: int, nband: int = 0, *,
                        rescale: bool = False, jacobian: bool = False,
                        pfrac: bool = False) -> tuple:
    """(resident blocks per SM, clusters the card holds at once) of the
    variant's instantiation at these sizes, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor and
    cudaOccupancyMaxActiveClusters."""
    geo = lw_noscat_geometry(nlay, ngpt, nband, rescale=rescale,
                             jacobian=jacobian, pfrac=pfrac)
    n = query("solver_lw", "occupancy_solver_lw", nlay, geo.chunk,
              geo.nchunk, nband, int(rescale), int(jacobian), int(pfrac))
    return (n // 65536, n % 65536) if n >= 0 else (n, n)


def lw_noscat(tau, lay, lev, sfc_emis, sfc_src, inc_flux, *, ds,
              weight: float, sfc_src_jac=None, ssa=None, g=None,
              gpt2band=None, nband: int = 0):
    """:func:`lw_noscat_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``lw_noscat.launches``)."""
    if on_cpu(tau, "lw_noscat"):
        return lw_noscat_plain(tau, lay, lev, sfc_emis, sfc_src, inc_flux,
                               ds=ds, weight=weight, sfc_src_jac=sfc_src_jac,
                               ssa=ssa, g=g, gpt2band=gpt2band, nband=nband)
    refuse_grad("lw_noscat", tau, lay, lev, sfc_emis, sfc_src, inc_flux, ds,
                sfc_src_jac, ssa, g, hint="ops/solver_lw.lw_solver_noscat "
                "differentiates it (solver_lw_bwd.lw_noscat_vjp)")
    ncol, nlay, ngpt = tau.shape
    if (ssa is None) != (g is None):
        raise ValueError("lw_noscat: rescaling needs both ssa and g")
    f32 = torch.float32
    lay3, bc = (ncol, nlay, ngpt), (ncol, ngpt)
    specs = {"tau": (tau, lay3, f32), "lay": (lay, lay3, f32),
             "lev": (lev, (ncol, nlay + 1, ngpt), f32),
             "sfc_emis": (sfc_emis, bc, f32), "sfc_src": (sfc_src, bc, f32),
             "inc_flux": (inc_flux, bc, f32)}
    if ssa is not None:
        specs.update(ssa=(ssa, lay3, f32), g=(g, lay3, f32))
    if sfc_src_jac is not None:
        specs["sfc_src_jac"] = (sfc_src_jac, bc, f32)
    # a secant field is (ncol, ngpt); a 0-d tensor is one secant
    field = isinstance(ds, torch.Tensor) and ds.ndim == 2
    ds_field, ds_scalar = (ds, 0.0) if field else (None, float(ds))
    if field:
        specs["ds"] = (ds_field, bc, f32)
    if gpt2band is not None:
        if nband < 1:
            raise ValueError("lw_noscat: by-band output needs nband >= 1")
        specs["gpt2band"] = (gpt2band, (ngpt,), torch.int32)
    dev = tau.device
    check_args("lw_noscat", dev, specs)
    byband = gpt2band is not None
    # the layer fields stay in shared memory: raises past the column
    # height a block holds
    geo = lw_noscat_geometry(nlay, ngpt, int(nband) if byband else 0,
                             rescale=ssa is not None,
                             jacobian=sfc_src_jac is not None)
    lev2 = (ncol, nlay + 1)
    new = lambda shape: torch.empty(shape, dtype=f32, device=dev)
    up, dn = (None, None) if byband else (new(lev2), new(lev2))
    band_up, band_dn = ((new(lev2 + (nband,)), new(lev2 + (nband,)))
                        if byband else (None, None))
    jac = None if sfc_src_jac is None else new(lev2)
    launch("solver_lw", "launch_solver_lw", "lw_noscat",
           tau, lay, lev, ssa, g, sfc_emis, sfc_src, sfc_src_jac, inc_flux,
           ds_field, gpt2band, up, dn, jac, band_up, band_dn, ncol, nlay,
           ngpt, int(nband), ds_scalar, PI * float(weight), geo.chunk)
    lw_noscat.launches += 1
    return (band_up, band_dn, jac) if byband else (up, dn, jac)


lw_noscat.launches = 0
