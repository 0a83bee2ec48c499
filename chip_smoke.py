#!/usr/bin/env python3
"""Run the PyTorch port's all-sky LW+SW step on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from rte_rrtmgp_tpu_torch/csrc (nvcc, one
     process per source, in parallel) and print the build time;
  3. each kernel against its plain-PyTorch twin on the device at the main
     path's shapes (4096 x 72, LW 256 g-points / 16 bands, SW 224 / 14,
     ntemp 14, npres 59), with the median CUDA-event time of both;
  4. the golden gate: the float32 kernel path at the production
     configuration (256 x 72) against tests/golden/production.npz, each
     field within 3x tests/golden/production_f32_noise.json;
  5. the main path, build_allsky_step(4096, 72, ...) then step(inputs),
     with the launch counters set to 0 just before it: every kernel must
     have launched, outputs finite and non-negative, TOA SW down equal to
     the solar source times mu0; its median step time;
  6. a ``{"kernels": [...]}`` line, then the last line
     ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with code 2 before doing anything.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN = dict(ncol=4096, nlay=72, ngpt_lw=256, nbnd_lw=16, ngpt_sw=224,
            nbnd_sw=14, ntemp=14, npres=59)
# kernel vs twin, same float32 inputs: the two differ only in summation
# order, fused multiply-adds and expf's last bit. Cloud optics is a lerp
# and two products per value; the fused steps sum 224-256 g-points over
# 72-layer recurrences. Both bounds are relative to the largest value
# (measured on an H100: 5e-8 and 2e-7).
TOL_CLOUD = 1e-6     # x max |twin|
TOL_FLUX = 2e-6      # x max |twin| (about 3e-3 W/m2 on LW fluxes)
REPS = 5


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=REPS, burst_ms=10.0):
    """Median over ``reps`` bursts of fn's device time per call, in ms.
    A burst repeats fn back to back for about ``burst_ms``, so that for a
    short kernel the host's launch overhead overlaps the device's work
    instead of being timed as idle device time."""
    import torch

    def burst(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    fn()                                                  # warm-up
    n = max(1, min(1000, int(burst_ms / burst(1))))
    return statistics.median(burst(n) for _ in range(reps))


def max_err(got, ref):
    return max(float((g - r).abs().max()) for g, r in zip(got, ref)), \
        max(float(r.abs().max()) for r in ref)


def check_kernel(name, kernel, plain, args, tol, source, replaces):
    import torch
    got = kernel(args)
    ref = plain(args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise SystemExit(f"{name}: kernel output {tuple(g.shape)} is "
                             f"not finite or not {tuple(r.shape)}")
    err, scale = max_err(got, ref)
    ms = cuda_ms(lambda: kernel(args))
    plain_ms = cuda_ms(lambda: plain(args))
    ok = err <= tol * scale
    log(f"kernel {name}: max_abs_err {err:.3e} (limit {tol * scale:.3e}), "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its twin")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     allsky_sw_inputs,
                                                     build_allsky,
                                                     build_allsky_step)
    from rte_rrtmgp_tpu_torch.ops.kernels import _build
    from rte_rrtmgp_tpu_torch.ops.kernels.cloud_props import (
        cloud_props, cloud_props_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (lw_fused,
                                                           lw_fused_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (sw_fused,
                                                           sw_fused_plain)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({len(reports)} of {len(_build.SOURCES)} sources compiled)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # ---- 3. each kernel against its twin at the main path's shapes ----
    prob = build_allsky(**MAIN, device=dev)
    inp = prob.inputs
    cld = prob.cld_lw
    idx, fint, wp = cld.lane_inputs(inp.lwp, inp.iwp, inp.rel, inp.dei)
    liq, ice = cld.tables()
    cloud_args = (idx, fint, wp, liq, ice)
    lw_args = allsky_lw_inputs(inp, prob.gas_lw, cloud_optics=prob.cld_lw)
    sw_args = allsky_sw_inputs(inp, prob.gas_sw, cloud_optics=prob.cld_sw)
    rows = [
        check_kernel("cloud_props", lambda a: cloud_props(*a),
                     lambda a: cloud_props_plain(*a), cloud_args, TOL_CLOUD,
                     "rte_rrtmgp_tpu_torch/csrc/cloud_props.cu",
                     "rte_rrtmgp_tpu/ops/pallas/minor_gather.py:227"),
        check_kernel("fused_lw", lw_fused, lw_fused_plain, lw_args, TOL_FLUX,
                     "rte_rrtmgp_tpu_torch/csrc/fused_lw.cu",
                     "rte_rrtmgp_tpu/ops/pallas/fused_lw.py:368"),
        check_kernel("fused_sw", sw_fused, sw_fused_plain, sw_args, TOL_FLUX,
                     "rte_rrtmgp_tpu_torch/csrc/fused_sw.cu",
                     "rte_rrtmgp_tpu/ops/pallas/fused_sw.py:309"),
    ]
    solar = float(prob.gas_sw.kdist.solar_source.double().sum())
    del prob, inp, lw_args, sw_args, cloud_args
    torch.cuda.empty_cache()

    # ---- 4. golden gate: float32 kernel path at the production config ----
    golden = np.load(os.path.join(HERE, "tests", "golden", "production.npz"))
    with open(os.path.join(HERE, "tests", "golden",
                           "production_f32_noise.json")) as f:
        noise = json.load(f)["f32_noise"]
    step, inputs = build_allsky_step(256, 72, 256, 16, 224, 14, 14, 59,
                                     device=dev)
    out = step(inputs)
    for key, o in zip(("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir"), out):
        d = float(np.abs(o.double().cpu().numpy() - golden[key]).max())
        log(f"golden {key}: max |f32 kernel - f64 golden| {d:.4g} "
            f"(limit {3 * noise[key]:.4g})")
        if not d <= 3 * noise[key]:
            raise SystemExit(f"golden gate failed on {key}")

    # ---- 5. the main path ----
    step, inputs = build_allsky_step(**MAIN, device=dev)
    counters = {"cloud_props": cloud_props, "fused_lw": lw_fused,
                "fused_sw": sw_fused}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = step(inputs)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"main path never launched {name}")
    nlev = MAIN["nlay"] + 1
    for o in out:
        if tuple(o.shape) != (MAIN["ncol"], nlev):
            raise SystemExit(f"output shape {tuple(o.shape)}")
        if not bool(torch.isfinite(o).all()) or bool((o < 0).any()):
            raise SystemExit("main path output not finite or negative")
    toa = solar * inputs.mu0.double()
    toa_err = float(((out[3][:, 0].double() - toa).abs() / toa).max())
    log(f"sw_dn at TOA vs sum(solar source) * mu0: rel err {toa_err:.2e}")
    if toa_err > 1e-5:
        raise SystemExit("sw_dn at TOA does not equal the incident flux")
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_step = statistics.median(times)
    log(f"main path step: {t_step * 1e3:.3f} ms median of {REPS}, "
        f"{MAIN['ncol'] / t_step:.1f} columns/s")

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
