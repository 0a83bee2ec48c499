"""The outputs of the fused SW adjoint kernel (``csrc/fused_sw_bwd.cu``) at
two small cases, which ``tests/golden/fused_sw_bwd_frozen.npz`` records
bit for bit: tests/test_torch_cuda.py's DIMS["g24"] (7 columns, 12
layers, SW 40 g-points / 5 bands) and its FLAGSHIP (3 columns, 72 layers,
SW 224 g-points / 14 bands), clouds on, flux cotangents uniform in [0.5,
1.5) from numpy's default_rng(17); entry "<case>_<i>" holds the i-th
returned cotangent (None ones are left out). Used by
tests/test_torch_cuda.py::test_fused_sw_bwd_matches_frozen_record and by
scripts/freeze_fused_sw_bwd.py, which writes the record.
"""
import numpy as np

CASES = {"g24": (7, 12, 24, 3, 40, 5, 6, 11),
         "flagship": (3, 72, 256, 16, 224, 14, 14, 59)}


def record(dev):
    """{"<case>_<i>": cotangent i} of sw_fused_bwd at CASES on ``dev``."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_sw_inputs,
                                                     build_allsky)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import sw_fused_bwd
    out = {}
    for tag, dims in CASES.items():
        p = build_allsky(*dims, device=dev)
        x = allsky_sw_inputs(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
        nlay, ncol = x.mu0.shape
        rng = np.random.default_rng(17)
        gs = [torch.from_numpy(rng.uniform(0.5, 1.5, (nlay + 1, ncol))
                               .astype(np.float32)).to(dev)
              for _ in range(3)]
        for i, o in enumerate(sw_fused_bwd(x, *gs)):
            if o is not None:
                out[f"{tag}_{i}"] = o.cpu().numpy()
    return out
