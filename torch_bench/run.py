#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json`` on one
CUDA card.

    python3 torch_bench/run.py --workload allsky.fused.fwd --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout. It builds the port's kernels into the
checkout (``rte_rrtmgp_tpu_torch/csrc/build/``, kept between runs), makes
the cell's tables and states on the card from the seed, warms the step
up, then runs the closed loop for ``--seconds`` and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, read under torch.profiler),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared with the plain reference beside its limit (also the last
lines of standard error). Without a CUDA card, or with fewer than the
cell asks for, it prints no result and exits with code 2. It imports the
PyTorch port and never JAX: if JAX, jaxlib, flax or the JAX package is
loaded once the check is done, it names them on standard error, prints no
result and exits with code 1.
"""
import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "torch_bench", ".cache")
# one host thread and the checkout's own cache directories, before torch
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    from torch_bench import harness
    spec = harness.cell_spec(args.workload)
    import torch
    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START, spec)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
