#!/usr/bin/env python3
"""Record the outputs of the fused SW adjoint kernel (``csrc/fused_sw_bwd.cu``)
of one checkout at two small cases, on one CUDA GPU:

    python3 scripts/freeze_fused_sw_bwd.py OUT.npz [CHECKOUT]

CHECKOUT (default: the checkout holding this script) is imported, never
JAX. The cases and the record's entries are those of
``tests/fused_sw_bwd_record.py`` (this checkout's), which
``tests/test_torch_cuda.py::test_fused_sw_bwd_matches_frozen_record``
holds the kernel to bit for bit. ``tests/golden/fused_sw_bwd_frozen.npz``
is this record, taken on an H100 from the checkout before the SW solver
and its adjoint moved on chip; a new CUDA compiler or runtime may
change the kernel's bits, and then the record is written again by this
script on the card, from a checkout whose fused SW adjoint is known good.
"""
import os
import sys

import numpy as np

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def main():
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else HERE)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(os.path.abspath(HERE), "tests"))
    import torch
    from fused_sw_bwd_record import record
    if not torch.cuda.is_available():
        print("freeze_fused_sw_bwd: no CUDA device", file=sys.stderr)
        return 2
    np.savez_compressed(sys.argv[1], **record(torch.device("cuda", 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
