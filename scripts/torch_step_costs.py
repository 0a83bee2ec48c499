#!/usr/bin/env python3
"""The costs of the PyTorch port's fused SW and LW two-stream kernels and
of the steps that run them, for one checkout, on one CUDA GPU, at the
flagship size (4096 x 72, LW 256 g-points, SW 224):

    python3 scripts/torch_step_costs.py [CHECKOUT]

CHECKOUT is the root of a checkout of this repository (default: the one
holding this script), so that two commits are compared on one card by
running the script on both, in turns, in one session. It imports that
checkout's ``rte_rrtmgp_tpu_torch`` and ``chip_smoke.py`` (MAIN, cuda_ms,
lw2_step, train_loss) and never JAX. It prints one JSON line: the card;
the two kernels' CUDA-event median times, broadband and by band, and
their largest difference from their plain twins over the twins' largest
value; and for the fused forward step, the LW two-stream step and the
fused gradient step, the median wall time of 5 steps ending in a
synchronize, the device time per step under torch.profiler (3 steps) and
the peak device memory of one step (torch.cuda.max_memory_allocated).
"""
import json
import os
import statistics
import subprocess
import sys
import time


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_step_costs: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_sw_inputs,
                                                     build_allsky,
                                                     build_allsky_step)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (sw_fused,
                                                           sw_fused_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_2str import (
        lw_2stream, lw_2stream_plain)
    from rte_rrtmgp_tpu_torch.optical_props import increment

    dev = torch.device("cuda", 0)
    out = {"checkout": root, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    prob = build_allsky(**cs.MAIN, device=dev)
    i = prob.inputs
    x = allsky_sw_inputs(i, prob.gas_sw, cloud_optics=prob.cld_sw)
    props, src = prob.gas_lw.gas_optics_lw(
        i.play, i.plev, i.tlay, i.tsfc, i.gas_concs, tlev=i.tlev,
        scattering=True, top_at_1=True)
    props = increment(props, prob.cld_lw.cloud_optics(
        i.lwp, i.iwp, i.rel, i.dei, scattering=True))
    ncol, _, ngpt = props.tau.shape
    emis = i.sfc_emis.expand(ncol, ngpt).contiguous()
    lw = (props.tau.contiguous(), props.ssa.contiguous(),
          props.g.contiguous(), src.lay_source, src.lev_source, emis,
          src.sfc_source, torch.zeros_like(emis))
    del props, src
    bands = (prob.gas_lw.gpt2band,)
    nb = dict(nband=prob.gas_lw.grid.nband)
    xb = x._replace(byband=True)
    for name, kernel, plain in (
            ("fused_sw", lambda: sw_fused(x), lambda: sw_fused_plain(x)),
            ("fused_sw byband", lambda: sw_fused(xb),
             lambda: sw_fused_plain(xb)),
            ("solver_lw_2str", lambda: lw_2stream(*lw),
             lambda: lw_2stream_plain(*lw)),
            ("solver_lw_2str byband", lambda: lw_2stream(*lw, *bands, **nb),
             lambda: lw_2stream_plain(*lw, *bands, **nb))):
        got, ref = kernel(), plain()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        out[name] = dict(ms=cs.cuda_ms(kernel), rel_err=err / scale)
    del x, xb, lw, got, ref
    torch.cuda.empty_cache()

    step, inputs = build_allsky_step(**cs.MAIN, device=dev)
    lw2 = cs.lw2_step(prob)
    for name, fn in (("fused step", lambda: step(inputs)),
                     ("two-stream step", lambda: lw2(inputs)),
                     ("fused gradient step",
                      lambda: cs.train_loss(step, inputs))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        device = sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 3e3
        out[name] = dict(wall_ms=statistics.median(walls) * 1e3,
                         device_ms=device, peak_bytes=peak)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
