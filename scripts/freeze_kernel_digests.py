#!/usr/bin/env python3
"""Record the output digests of the fused LW and SW steps, the minor and
Rayleigh gathers and the fused LW adjoint of one checkout at two small
cases, on one CUDA GPU:

    python3 scripts/freeze_kernel_digests.py OUT.json [CHECKOUT]
    python3 scripts/freeze_kernel_digests.py --outputs MATCH OUT.pt [CHECKOUT]
    python3 scripts/freeze_kernel_digests.py --compare A.pt B.pt

CHECKOUT (default: the checkout holding this script) is imported, never
JAX. The cases and the record's entries are those of
``tests/kernel_digest_record.py`` (this checkout's), which
``tests/test_torch_cuda.py::test_kernels_match_frozen_digests`` holds the
kernels to. ``tests/golden/kernel_digests_frozen.json`` is this record,
taken on an H100 from the checkout before the fused LW step moved on chip
and the minor gather was rewritten; a new CUDA compiler or runtime may
change the kernels' bits, and then the record is written again by this
script on the card, from a checkout whose kernels are known good.
``--outputs`` saves the outputs of the entries whose names hold MATCH
(``kernel_digest_record.outputs``) instead, and ``--compare`` prints, for
two such files (two checkouts' kernels on the same inputs), per entry and
output the elements that differ, the largest difference, it over the
output's largest value in A, and the largest distance in float32 units
in the last place.
"""
import json
import os
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def compare(a_path, b_path):
    """Print A against B, entry by entry and output by output."""
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    for name in sorted(a):
        for i, (x, y) in enumerate(zip(a[name], b[name])):
            d = (x.double() - y.double()).abs()
            ulp = (x.view(torch.int32).long() - y.view(torch.int32).long()
                   ).abs()
            print(json.dumps(dict(
                entry=name, output=i, shape=list(x.shape),
                differing=int((x != y).sum()), max_abs=float(d.max()),
                max_rel=float(d.max() / x.double().abs().max()),
                max_ulp=int(ulp.max()))), flush=True)
    return 0


def main():
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "--compare":
        return compare(sys.argv[2], sys.argv[3])
    match = None
    if sys.argv[1] == "--outputs":
        match = sys.argv[2]
        del sys.argv[1:3]
    root = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else HERE)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(os.path.abspath(HERE), "tests"))
    import torch
    from kernel_digest_record import outputs, record
    if not torch.cuda.is_available():
        print("freeze_kernel_digests: no CUDA device", file=sys.stderr)
        return 2
    if match is not None:
        torch.save(outputs(torch.device("cuda", 0), match), sys.argv[1])
        return 0
    rec = record(torch.device("cuda", 0))
    with open(sys.argv[1], "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(rec, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
