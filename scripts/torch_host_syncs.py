#!/usr/bin/env python3
"""Where the host waits for the card in one fused all-sky step of the
PyTorch port (the pod-scale configuration's step: cloud optics, then the
fused LW and SW kernels), on one CUDA GPU:

    python3 scripts/torch_host_syncs.py [--ncol 4096] [--nlay 72]

It runs the step once to build the kernels, then once more with the value
checks off (``config.checks_disabled``, as the pod-scale loop runs) under
``torch.cuda.set_sync_debug_mode("warn")``, and prints each call that
made the host wait, with the frames of this repository that led to it,
then one JSON line: the card and the number of such calls. It imports
``rte_rrtmgp_tpu_torch`` and never JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import traceback
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=4096)
    ap.add_argument("--nlay", type=int, default=72)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_host_syncs: no CUDA device", file=sys.stderr)
        return 1
    from rte_rrtmgp_tpu_torch.config import checks_disabled
    from rte_rrtmgp_tpu_torch.drivers.allsky import build_allsky_step
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    step, inputs = build_allsky_step(
        args.ncol, args.nlay, 256, 16, 224, 14, 14, 59,
        device=torch.device("cuda", 0))
    step(inputs)
    torch.cuda.synchronize()

    waits = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):  # the mode's notice
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(HERE)
                  and not f.filename.endswith("torch_host_syncs.py")]
        waits.append((str(message).splitlines()[0], frames))

    with warnings.catch_warnings():          # restores showwarning
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        with checks_disabled():
            step(inputs)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for i, (msg, frames) in enumerate(waits):
        print(f"wait {i + 1}: {msg}")
        for f in frames:
            print(f"    {os.path.relpath(f.filename, HERE)}:{f.lineno} "
                  f"{f.name}: {f.line}")
    print(json.dumps({"card": card, "ncol": args.ncol, "nlay": args.nlay,
                      "host_waits": len(waits)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
