#!/usr/bin/env python3
"""Where the host spends a benchmark cell's step, by the port's own spans
(``rte_rrtmgp_tpu_torch/trace.py``), on one CUDA card:

    python3 scripts/torch_trace_breakdown.py --workload allsky.fused.fwd \\
        --seed 7 --seconds 51 [--out breakdown.json]

From the root of a checkout. It builds the cell of ``BENCHMARK.json`` as
the benchmark does (``torch_bench``: the generator, the cell's entry and
step), warms it up, counts over 3 steps the calls that make the host wait
(``torch.cuda.set_sync_debug_mode("warn")``) and names the program's
``wait.*`` span each fell in, then runs a closed-loop window of
``--seconds`` under ``trace.collect()`` and ``torch.profiler`` (CUDA
activity, as the benchmark's traced run). It prints one JSON object (and
writes it to ``--out``):

  * per step: host ms inside ``gas.*``, ``check.*`` and ``wait.*`` spans
    (unions: nesting counted once), the ``waits`` counter, device kernels
    (copies and fills left out) launched inside ``gas.*`` spans, and
    kernels and host ms by the innermost span that launched them;
  * the device's idle seconds, each gap labelled by the innermost program
    span the host was in when the device went idle (the benchmark's own
    span where none is open), beside the benchmark's labels;
  * for the whole-grid cell, the stream's counters per sweep
    (``stream.chunks``, ``stream.sw_columns``, ``stream.bytes_up``,
    ``stream.bytes_down``) beside ``torch_bench/work/stream_copy.py``'s
    bytes for the grids swept, and the trace's copies by the span that
    launched them beside the copies the stream makes (its spans and its
    wait are among the spans and waits above);
  * the clock check: the share of the hand-written kernels' CUDA runtime
    launch events that lie inside their ``kernel.<name>`` or
    ``backward.<name>`` span once the profiler's times are mapped through
    the recorder's clock pairs, and the offset and drift of those pairs.

It imports the port and the benchmark's modules, never JAX.
"""
import argparse
import bisect
import collections
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# each hand-written kernel (its __global__ name) and the span it is
# launched in
KERNEL_SPANS = {
    "cloud_props_kernel": "kernel.cloud_props",
    "fused_lw_kernel": "kernel.lw_fused",
    "fused_sw_kernel": "kernel.sw_fused",
    "fused_lw_bwd_kernel": "backward.lw_fused",
    "fused_sw_bwd_kernel": "backward.sw_fused",
    "gas_major_kernel": "kernel.gas_major",
    "gas_minor_kernel": "kernel.gas_minor",
    "gas_rayleigh_kernel": "kernel.gas_rayleigh",
    "solver_lw_kernel": "kernel.lw_noscat",
    "solver_lw_2str_kernel": "kernel.lw_2stream",
    "solver_lw_bwd_kernel": "backward.lw_noscat",
    "solver_sw_kernel": "kernel.sw_2stream",
    "solver_sw_bwd_kernel": "backward.sw_2stream",
    "minor_scale_kernel": "kernel.minor_scale",
    "minor_scale_bwd_kernel": "backward.minor_scale",
    "gas_descriptors_kernel": "kernel.gas_descriptors",
    "gas_descriptors_bwd_kernel": "backward.gas_descriptors",
    "aerosol_props_kernel": "kernel.aerosol_props",
}
# the entry points' spans, the program's and the benchmark's
ENTRIES = ("allsky.lw", "allsky.sw", "allsky_api.lw", "allsky_api.sw",
           "rfmip.lw_sw", "stream.sweep")
BENCH_ENTRIES = ("allsky_step_lw", "allsky_step_sw", "allsky_api_lw",
                 "allsky_api_sw", "rfmip_lw_sw", "ne30pg2_stream",
                 "ne30pg2_aer_stream")
# the whole-grid stream's counters (parallel/scaling.AllSkyStream)
STREAM_COUNTERS = ("stream.chunks", "stream.sw_columns", "stream.bytes_up",
                   "stream.bytes_down")


def _kernel_of(name: str):
    """The hand-written kernel a device op's name belongs to, or None."""
    base = name[5:] if name.startswith("void ") else name
    base = base.replace("(anonymous namespace)::", "")
    for sep in "<(":
        base = base.split(sep)[0]
    return base if base in KERNEL_SPANS else None


def merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def inside(merged, t) -> bool:
    """Whether ``t`` lies in one of the sorted disjoint ``merged``."""
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def innermost(spans):
    """(times, labels): the innermost open span from each time on, over
    all threads' spans (nested or disjoint), None where none is open."""
    rows = sorted(((r[4], r[5], r[0]) for r in spans),
                  key=lambda r: (r[0], -r[1]))
    times, labels, stack = [], [], []

    def pop_until(t):
        while stack and stack[-1][0] <= t:
            end = stack.pop()[0]
            times.append(end)
            labels.append(stack[-1][1] if stack else None)

    for t0, t1, name in rows:
        pop_until(t0)
        stack.append((t1, name))
        times.append(t0)
        labels.append(name)
    pop_until(float("inf"))
    return times, labels


def label_at(timeline, t):
    times, labels = timeline
    i = bisect.bisect_right(times, t) - 1
    return labels[i] if i >= 0 else None


def sync_sites(step, npool, n=3):
    """Calls that made the host wait over ``n`` steps, each by the
    program's ``wait.*`` span it fell in or, outside one, by the frames of
    this repository that led to it; and the ``waits`` counter."""
    import torch
    from rte_rrtmgp_tpu_torch import trace
    sites = collections.Counter()

    def record(message, *args, **kw):
        if "called a synchronizing" not in str(message):
            return
        stack = getattr(trace._local, "stack", None) or []
        top = stack[-1].name if stack else ""
        if top.startswith("wait."):
            sites[top] += 1
            return
        frames = [f"{os.path.relpath(f.filename, HERE)}:{f.lineno}"
                  for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(HERE)
                  and "torch_trace_breakdown" not in f.filename]
        sites["unwrapped " + " < ".join(reversed(frames[-4:]))] += 1

    from torch_bench import harness
    with trace.collect() as rec, warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(n):
                step.run(i % npool, harness.Spans())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return ({k: v / n for k, v in sorted(sites.items())},
            sum(sites.values()) / n, rec.counters["waits"] / n)


def profile_events(prof, want):
    """Device ops (start, end, name, correlation ids) and CUDA runtime
    calls {correlation: (start, name)}, in the profiler's ns."""
    kr = prof.profiler.kineto_results
    dev, runtime = [], {}
    for e in kr.events():
        if e.device_type() == want:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name(), e.correlation_id(),
                        e.linked_correlation_id()))
        elif e.name().startswith("cuda"):
            runtime[e.correlation_id()] = (e.start_ns(), e.name())
    dev.sort()
    return dev, runtime


def stream_copies(spec, entry, steps, counters, dev, runtime, timeline,
                  to_perf) -> dict:
    """The whole-grid stream's counters per sweep beside what
    ``torch_bench/work/stream_copy.py`` gives for the grids the window
    swept (step i on grid i mod K), and the trace's copies per sweep by
    the span that launched them beside the copies the stream makes: per
    chunk one per field it sends up (the step's fields, the per-column
    gases, the day indices of a chunk with both day and night columns)
    and five down; per sweep one per scalar or profile gas. With aerosols
    (the stream given aerosol optics) the four aerosol fields of every
    column go up too, beside what ``work/stream_copy.py`` counts."""
    from rte_rrtmgp_tpu_torch.parallel.scaling import STEP_FIELDS
    from torch_bench import harness
    from torch_bench.traffic import generator
    work = harness.load("work", "stream_copy")
    shapes = generator.shapes(spec["config"])
    chunk = spec["config"]["chunk"]
    fields = entry.stream.fields
    extra = [f for f in fields if f not in STEP_FIELDS]
    grids = entry.inputs
    up, down, h2d = 0, 0, 0
    for i in range(steps):
        x = grids[i % len(grids)]
        nday = work.day_indices(x.mu0, chunk)
        u, d = work.copy_bytes(shapes, nday)
        u += sum(getattr(x, f).numel() * getattr(x, f).element_size()
                 for f in extra)
        up, down = up + u, down + d
        values = x.gas_concs.values
        nchunk = -(-x.mu0.shape[0] // chunk)
        mixed = sum(0 < int((x.mu0[c0:c0 + chunk] > 0).sum())
                    < x.mu0[c0:c0 + chunk].shape[0]
                    for c0 in range(0, x.mu0.shape[0], chunk))
        h2d += (nchunk * (len(fields) + sum(v.ndim == 2
                                                 for v in values))
                + mixed + sum(v.ndim < 2 for v in values))
    copies = collections.Counter()
    for a, b, name, corr, linked in dev[1:]:
        if not name.startswith(("Memcpy HtoD", "Memcpy DtoH")):
            continue
        call = runtime.get(corr) or runtime.get(linked)
        where = label_at(timeline, to_perf(call[0])) if call else None
        copies[f"{name.split(' (')[0]} in {where}"] += 1
    total = {k: counters.get(k, 0) for k in STREAM_COUNTERS}
    return dict(
        counters_per_sweep={k: v / steps for k, v in total.items()},
        work_bytes_per_sweep=dict(up=up / steps, down=down / steps),
        bytes_equal_work=(total["stream.bytes_up"] == up
                          and total["stream.bytes_down"] == down),
        copies_per_sweep={k: v / steps for k, v in copies.most_common()},
        expected_copies_per_sweep={
            "Memcpy HtoD in stream.upload": h2d / steps,
            "Memcpy DtoH in stream.readback":
                5 * total["stream.chunks"] / steps})


def breakdown(spec, seed: int, seconds: float, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rte_rrtmgp_tpu_torch import trace
    from torch_bench import harness
    from torch_bench.traffic import generator
    cell, config = spec["cell"], spec["config"]
    if device.type == "cuda":
        from rte_rrtmgp_tpu_torch.ops.kernels._build import build_all
        build_all()
    data = generator.make(config, cell["traffic"], seed, device)
    entry_mod = harness.load("entries", cell["entry"])
    Step = harness.load("steps", cell["step"]).Step
    entry = entry_mod.Entry(data, config, device)
    step = Step(entry, cell, entry_mod.OUTPUTS)
    npool = len(entry.inputs)
    sync = lambda: device.type == "cuda" and torch.cuda.synchronize()
    for i in range(npool + harness.WARMUP_STEPS):
        step.run(i % npool, harness.Spans())
        sync()
    out = dict(workload=spec["entry"]["name"], seed=seed)
    if device.type == "cuda":
        out["sync_sites"], out["host_syncs"], out["sync_pass_waits"] = \
            sync_sites(step, npool)

    # the window, as the benchmark's traced run, under trace.collect()
    act = (ProfilerActivity.CUDA if device.type == "cuda"
           else ProfilerActivity.CPU)
    want = (torch.autograd.DeviceType.CUDA if device.type == "cuda"
            else torch.autograd.DeviceType.CPU)
    prof = profile(activities=[act])
    prof.__enter__()
    bench = harness.Spans()
    host_s = []
    sync()
    with trace.collect() as rec:
        t_mark = time.perf_counter()
        torch.ones(1, device=device)             # the benchmark's marker
        t_win = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            step.run(i % npool, bench)
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            bench.rows.append(("synchronize", t1, t2))
            host_s.append(t1 - t0)
            i += 1
            if t2 - t_win >= seconds:
                break
    t_end = t2
    prof.__exit__(None, None, None)
    steps = i
    dev, runtime = profile_events(prof, want)
    run = harness.Run(spec, generator.shapes(config))
    run.steps = steps
    bench_breakdown = harness.read_trace(prof, device, t_mark, t_win, t_end,
                                         bench, run)
    del prof

    # the recorder's clock pairs: perf_counter_ns <-> Unix-epoch ns
    (p0, e0), (p1, e1) = rec.clock
    slope = (e1 - e0) / (p1 - p0)
    to_perf = lambda ns: p0 + (ns - e0) / slope
    out["clock"] = dict(
        offset_ns=e0 - p0, drift_ns=(e1 - p1) - (e0 - p0),
        window_s=(p1 - p0) * 1e-9,
        drift_per_s_ns=((e1 - p1) - (e0 - p0)) / ((p1 - p0) * 1e-9))

    spans = rec.spans
    names = collections.defaultdict(list)
    for r in spans:
        names[r[0]].append((r[4], r[5]))
    by_name = {n: merge(v) for n, v in names.items()}
    union = lambda pre: merge(iv for n, v in names.items()
                              if n.startswith(pre) for iv in v)
    per_step = lambda ns: ns * 1e-6 / steps
    layers = {pre: union(pre) for pre in ("gas.", "check.", "wait.")}
    out.update(
        steps=steps, window_s=t_end - t_win,
        host_ms=1e3 * sum(host_s) / steps,
        prep_ms=per_step(sum(b - a for a, b in layers["gas."])),
        checks_ms=per_step(sum(b - a for a, b in layers["check."])),
        wait_ms=per_step(sum(b - a for a, b in layers["wait."])),
        host_waits=rec.counters["waits"] / steps,
        spans_per_step=len(spans) / steps,
        launches_counters={k: v / steps for k, v in rec.counters.items()
                           if k.startswith("launches.") and v},
        span_ms={n: per_step(sum(b - a for a, b in v))
                 for n, v in sorted(names.items())},
        span_calls={n: len(v) / steps for n, v in sorted(names.items())})

    # launches: each device kernel's runtime call, by the innermost span
    timeline = innermost(spans)
    launched = collections.Counter()
    contained = collections.Counter()
    handwritten = collections.Counter()
    identity_contained = 0
    prep = 0
    matched = 0
    for a, b, name, corr, linked in dev[1:]:
        if name.startswith(("Memcpy", "Memset")):
            continue
        call = runtime.get(corr) or runtime.get(linked)
        if call is None:
            continue
        matched += 1
        h = to_perf(call[0])
        launched[label_at(timeline, h)] += 1
        prep += inside(layers["gas."], h)
        k = _kernel_of(name)
        if k is not None:
            handwritten[k] += 1
            ivs = by_name.get(KERNEL_SPANS[k], [])
            contained[k] += inside(ivs, h)
            identity_contained += inside(ivs, call[0])
    nk = sum(handwritten.values())
    out.update(
        prep_launches=prep / steps,
        launches_matched=matched / steps,
        launches_by_span={str(k): v / steps
                          for k, v in launched.most_common()},
        containment=dict(
            kernels=nk, inside=sum(contained.values()),
            share=sum(contained.values()) / nk if nk else None,
            share_if_perf_counter_clock=(identity_contained / nk
                                         if nk else None),
            by_kernel={k: [contained[k], n]
                       for k, n in handwritten.items()}))
    if any(k in rec.counters for k in STREAM_COUNTERS):
        out["stream"] = stream_copies(spec, entry, steps, rec.counters, dev,
                                      runtime, timeline, to_perf)
    # the benchmark takes the first device op for its marker, launched at
    # t_mark on an idle device: here each of the first ops' start after
    # t_mark, in us
    out["clock"]["first_ops_us"] = [
        [d[2][:48], (to_perf(d[0]) - t_mark * 1e9) * 1e-3] for d in dev[:3]]

    # idle gaps, each labelled by the innermost program span (the
    # benchmark's span where none is open) and by the benchmark's span
    if len(dev) > 1:
        w0 = max(dev[0][1], e0 + (t_win * 1e9 - p0) * slope)
        w1 = e0 + (t_end * 1e9 - p0) * slope
        busy = merge([max(a, w0), min(b, w1)] for a, b, *_ in dev[1:]
                     if b > w0 and a < w1)
        rows = sorted(bench.rows, key=lambda r: r[1])
        starts = [r[1] for r in rows]
        idle, below, entry_idle = collections.Counter(), 0.0, 0.0
        edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            h = to_perf(a)
            j = bisect.bisect_right(starts, h * 1e-9) - 1
            theirs = (rows[j][0] if j >= 0 and rows[j][2] > h * 1e-9
                      else "harness")
            ours = label_at(timeline, h)
            idle[ours or theirs] += (b - a) * 1e-9
            if theirs in BENCH_ENTRIES:
                entry_idle += (b - a) * 1e-9
                below += (b - a) * 1e-9 if ours and ours not in ENTRIES \
                    else 0.0
        out.update(
            busy_s=sum(b - a for a, b in busy) * 1e-9,
            idle_by_span=dict(idle.most_common(25)),
            entry_idle_s=entry_idle,
            entry_idle_below_share=below / entry_idle if entry_idle else None)
    out["benchmark_breakdown"] = bench_breakdown
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_trace_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from torch_bench import harness
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    result = breakdown(harness.cell_spec(args.workload), args.seed,
                       args.seconds, torch.device("cuda", 0))
    result["card"] = card
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
