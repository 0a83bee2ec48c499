#!/usr/bin/env python3
"""Record the output digests of the fused LW and SW steps, the minor and
Rayleigh gathers and the fused LW adjoint of one checkout at two small
cases, on one CUDA GPU:

    python3 scripts/freeze_kernel_digests.py OUT.json [CHECKOUT]

CHECKOUT (default: the checkout holding this script) is imported, never
JAX. The cases and the record's entries are those of
``tests/kernel_digest_record.py`` (this checkout's), which
``tests/test_torch_cuda.py::test_kernels_match_frozen_digests`` holds the
kernels to. ``tests/golden/kernel_digests_frozen.json`` is this record,
taken on an H100 from the checkout before the fused LW step moved on chip
and the minor gather was rewritten; a new CUDA compiler or runtime may
change the kernels' bits, and then the record is written again by this
script on the card, from a checkout whose kernels are known good.
"""
import json
import os
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def main():
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else HERE)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(os.path.abspath(HERE), "tests"))
    import torch
    from kernel_digest_record import record
    if not torch.cuda.is_available():
        print("freeze_kernel_digests: no CUDA device", file=sys.stderr)
        return 2
    rec = record(torch.device("cuda", 0))
    with open(sys.argv[1], "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(rec, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
