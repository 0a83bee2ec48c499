"""rte_rrtmgp_tpu_torch: the PyTorch + CUDA port of rte_rrtmgp_tpu.

The all-sky LW+SW forward step (cloud optics, RRTMGP gas optics, LW
no-scattering and SW two-stream solves, broadband fluxes) on tensors.
Its three hot kernels are hand-written CUDA C++ (``csrc/``) with a
plain-PyTorch twin beside each (``ops/kernels/``): a CUDA tensor goes to
the kernel, a CPU tensor to the twin. Entry point:
:func:`rte_rrtmgp_tpu_torch.drivers.allsky.build_allsky_step`.

This package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
