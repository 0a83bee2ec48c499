#!/usr/bin/env python
"""Solver-variant flux files with the PyTorch port (reference
tests/check_variants.F90: fluxes across the LW and SW solver variants,
written for validation plots), the counterpart of
``examples/flux_variants.py``.

Variants (reference :218-475 print markers):
  LW: no-scattering 1-angle (default), no-tlev (interpolated level
      temperatures), 3-angle quadrature, optimal-angle secants, Jacobian
      carried, true two-stream; SW: default two-stream.

Runs on the CUDA device (the port's kernels) unless ``--device cpu`` is
given (their plain twins):

  python examples/flux_variants_torch.py [--ncol 24] [--nlay 48]
      [--device cpu] [--dtype float64] [--out lw_flux_variants.nc]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def variants(ncol, nlay, device, dtype):
    """The variant fields, name -> (ncol, nlay+1) tensor."""
    import torch
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import GasOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.rte import rte_lw, rte_sw
    from rte_rrtmgp_tpu_torch.utils.profiles import rcemip_profiles
    from rte_rrtmgp_tpu_torch.utils.synthetic import synthetic_kdist

    play, plev, tlay, tlev, _z, gas = rcemip_profiles(ncol, nlay)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    play, plev, tlay, tlev = t(play), t(plev), t(tlay), t(tlev)
    gas = gas.to(dtype=dtype, device=device)
    tsfc = tlay[:, -1]
    emis = t(np.full((ncol, 1), 0.98))
    kw = dict(ntemp=14, npres=59, dtype=dtype, device=device)
    gop = GasOpticsRRTMGP(synthetic_kdist(sw=False, ngpt=256, nbnd=16, **kw))
    out = {}

    def keep(suffix, f):
        out[f"lw_flux_up{suffix}"] = f.flux_up
        out[f"lw_flux_dn{suffix}"] = f.flux_dn

    props, src = gop.gas_optics_lw(play, plev, tlay, tsfc, gas, tlev=tlev,
                                   top_at_1=True)
    keep("", rte_lw(props, src, emis))
    # no-tlev: level temperatures interpolated internally
    props2, src2 = gop.gas_optics_lw(play, plev, tlay, tsfc, gas,
                                     top_at_1=True)
    keep("_notlev", rte_lw(props2, src2, emis))
    keep("_3ang", rte_lw(props, src, emis, n_gauss_angles=3))
    ds = gop.compute_optimal_angles(props)
    keep("_optang", rte_lw(props, src, emis, lw_ds=ds))
    # Jacobian carried (fluxes must be unchanged)
    f = rte_lw(props, src, emis, compute_jacobian=True)
    keep("_jaco", f)
    out["lw_jaco_up"] = f.flux_up_jac
    # true two-stream
    props_2s, src_2s = gop.gas_optics_lw(play, plev, tlay, tsfc, gas,
                                         tlev=tlev, scattering=True,
                                         top_at_1=True)
    keep("_2str", rte_lw(props_2s, src_2s, emis, use_2stream=True))

    gsw = GasOpticsRRTMGP(synthetic_kdist(sw=True, ngpt=224, nbnd=14, **kw))
    p_sw, toa = gsw.gas_optics_sw(play, plev, tlay, gas, top_at_1=True)
    alb = t(np.full((ncol, 1), 0.06))
    f = rte_sw(p_sw, t(np.full(ncol, 0.86)), toa, alb, alb)
    out["sw_flux_up"] = f.flux_up
    out["sw_flux_dn"] = f.flux_dn
    out["sw_flux_dir"] = f.flux_dn_dir
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ncol", type=int, default=24)
    ap.add_argument("--nlay", type=int, default=48)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--out", default="lw_flux_variants.nc")
    args = ap.parse_args(argv)

    import torch
    from rte_rrtmgp_tpu_torch.config import resolve_device
    fields = variants(args.ncol, args.nlay, resolve_device(args.device),
                      getattr(torch, args.dtype))

    from scipy.io import netcdf_file
    with netcdf_file(args.out, "w") as nc:
        nc.createDimension("site", args.ncol)
        nc.createDimension("level", args.nlay + 1)
        for name, arr in fields.items():
            v = nc.createVariable(name, np.float64, ("site", "level"))
            v[:] = arr.double().cpu().numpy()
    print(f"wrote {args.out} with {len(fields)} variant fields")
    for name, arr in fields.items():
        a = arr.double().cpu().numpy()
        print(f"  {name:24s} mean={a.mean():10.4f}  TOA={a[:, 0].mean():10.4f}")


if __name__ == "__main__":
    main()
