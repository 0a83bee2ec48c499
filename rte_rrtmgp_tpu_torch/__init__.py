"""rte_rrtmgp_tpu_torch: the PyTorch + CUDA port of rte_rrtmgp_tpu.

The all-sky LW+SW forward step (cloud optics, RRTMGP gas optics, the LW
no-scattering or true two-stream and the SW two-stream solves, broadband
or by-band fluxes) on tensors, two ways: the fused step
(:func:`rte_rrtmgp_tpu_torch.drivers.allsky.build_allsky_step`) and the
library's public API (``GasOpticsRRTMGP.gas_optics_lw/sw``,
``CloudOpticsRRTMGP.cloud_optics``, ``optical_props.increment``,
``rte.rte_lw/rte_sw``). The hot kernels are hand-written CUDA C++
(``csrc/``) with a plain-PyTorch twin beside each (``ops/kernels/``): a
CUDA tensor goes to the kernel, a CPU tensor to the twin.

This package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
