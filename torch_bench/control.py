#!/usr/bin/env python3
"""The readings that set a cell's limits (not part of a benchmark run).

    python3 torch_bench/control.py --workload allsky.fused.fwd \\
        --seeds 1 2 3 ... --control-seeds 1 2 3

For each of ``--seeds`` it makes the cell's data, runs the program's step
once on a pool state drawn from the seed, and prints the numbers the
check compares (with diagnostics) against the float64 reference; for
each of ``--control-seeds`` it puts the reference computed in the next
precision below the configuration's (bfloat16 for float32: the step has
no matrix products for TF32 to round) in the program's place and prints
the same; for each of ``--f32-seeds`` it prints the same of the reference
computed in float32, the program's precision (a second witness: what
float32 itself gives, from code independent of the program). One JSON line per reading; the largest program reading over a
dozen seeds or more is a number's lower reading, the smallest control
reading its upper one. ``--device cpu`` runs the program's plain twins
(the tests' small sizes).
"""
import argparse
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(spec, seeds, control_seeds, device, f32_seeds=()):
    import torch
    from torch_bench import harness
    from torch_bench.traffic import generator
    cell, config = spec["cell"], spec["config"]
    entry_mod = harness.load("entries", cell["entry"])
    Step = harness.load("steps", cell["step"]).Step
    refmod = harness.load("reference", config["problem"])
    checker = Step(None, cell, entry_mod.OUTPUTS)
    if device.type == "cuda":
        from rte_rrtmgp_tpu_torch.ops.kernels._build import build_all
        build_all()
    for seed in sorted(set(seeds) | set(control_seeds) | set(f32_seeds)):
        data = generator.make(config, cell["traffic"], seed, device)
        k = random.Random(seed).randrange(cell["traffic"]["pool"])
        state = data["pool"][k]
        t0 = time.perf_counter()
        ref = checker.reference(refmod, data, state)
        t_ref = time.perf_counter() - t0
        if seed in seeds:
            entry = entry_mod.Entry(data, config, device)
            step = Step(entry, cell, entry_mod.OUTPUTS)
            spans = harness.Spans()
            step.run(k, spans)                       # warm-up
            out = harness._copy(step.run(k, spans))
            del step, entry
            yield dict(seed=seed, state=k, who="program", ref_s=t_ref,
                       numbers=checker.diagnostics(out, ref, state))
        if seed in control_seeds:
            ctl = checker.reference(refmod, data, state, torch.bfloat16)
            yield dict(seed=seed, state=k, who="control bfloat16",
                       numbers=checker.diagnostics(ctl, ref, state))
        if seed in f32_seeds:
            r32 = checker.reference(refmod, data, state, torch.float32)
            yield dict(seed=seed, state=k, who="reference float32",
                       numbers=checker.diagnostics(r32, ref, state))
        del data, ref
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--f32-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    from torch_bench import harness
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    for r in readings(spec, args.seeds, args.control_seeds, device,
                      args.f32_seeds):
        print(json.dumps(dict(workload=args.workload, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
