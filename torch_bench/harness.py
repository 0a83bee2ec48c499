"""The benchmark's run of one cell: set-up, a closed-loop window, the
traced reading of the per-layer metrics, and the check against the plain
reference.

Everything that belongs to one configuration, cell, entry, step kind,
per-layer metric or kernel lives in a file of its own, found by the name
``BENCHMARK.json`` and the cell's file give it:

  configs/<config>.json      sizes, source, what was assumed
  workloads/<cell>.json      configuration, entry, step kind, traffic,
                             the check's limits
  entries/<entry>.py         the program's entry point for the step
  steps/<step>.py            what one step does and how it is checked
  traffic/<problem>.py       the problem's pool states, and any tables
                             and sizes of its own (``traffic/generator``
                             draws the shared tables)
  reference/<problem>.py     the configuration's plain reference
  metrics/<metric>.py        LAYER and read(run): one per-layer metric
  work/<kernel>.py           work(shapes, cell) -> (bytes, operations)

The loop is closed, with one caller: a host model that waits for its
fluxes before it advances. Step i takes pool state i mod K, and ends in
``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import random
import re
import statistics
import sys
import time
import warnings

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# steps warmed beyond one on each pool state, and steps the check samples
WARMUP_STEPS = 2
SAMPLES = 2
# the untraced stretch a traced run times after its window (step_mfu)
UNTRACED_S = 5.0
# top-level modules a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "rte_rrtmgp_tpu")


def read_json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (names may hold
    dots, so modules are loaded by path). A missing file raises
    FileNotFoundError naming it; a module whose code raises is not kept."""
    path = os.path.join(BENCH, kind, name + ".py")
    mod_name = "torch_bench_" + kind + "_" + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file torch_bench/{kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, jaxlib's, flax's
    or the JAX package's (``rte_rrtmgp_tpu``; the port's own name only
    begins with it), compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def cell_spec(workload: str) -> dict:
    """BENCHMARK.json's entry of the cell, the cell's file and its
    configuration's file."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = read_json("workloads", workload + ".json")
    config = read_json("configs", entry["config"] + ".json")
    return dict(bench=bench, entry=entry, cell=cell, config=config)


class Spans:
    """Host spans (name, start, end) on ``time.perf_counter``, kept in
    memory; one object per run."""

    def __init__(self):
        self.rows = []

    def __call__(self, name):
        return _Span(self.rows, name)


class _Span:
    __slots__ = ("rows", "name", "t0")

    def __init__(self, rows, name):
        self.rows, self.name = rows, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.rows.append((self.name, self.t0, time.perf_counter()))


def _copy(x):
    """A copy of a step's output that later steps cannot overwrite."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_copy(v) for v in x)
    return x


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """What the per-layer readers see of a traced run (``metrics/*.py``).
    Times in seconds; per-step values over the traced window's steps."""

    def __init__(self, spec, shapes):
        self.cell = spec["cell"]
        self.config = spec["config"]
        self.workload = spec["entry"]["name"]
        self.shapes = shapes
        self.steps = 0
        self.window_s = 0.0
        self.busy_s = None
        self.host_s = []
        self.kernels = {}              # device op name -> [seconds, count]
        self.launches_per_step = None
        self.syncs_per_step = None
        self.untraced_steps = 0
        self.untraced_s = 0.0

    def kernel_seconds(self, kernel: str) -> float:
        """Device seconds of the hand-written kernel ``kernel`` (its
        ``__global__`` name) over the traced window."""
        pat = re.compile(r"(^|[\s:])" + re.escape(kernel) + r"[<(]")
        return sum(s for name, (s, _) in self.kernels.items()
                   if pat.search(name) or name == kernel)

    def work(self, kernel: str):
        """(bytes, operations) of one step's launches of ``kernel`` on the
        cell's path, from its shapes (``work/<kernel>.py``)."""
        return load("work", kernel).work(self.shapes, self.cell)

    def bound_s(self, kernel: str) -> float:
        """The least time one step's launches of ``kernel`` could take:
        bytes at the card's bandwidth or operations at its float32 peak,
        whichever is larger (``peaks.py``)."""
        from torch_bench import peaks
        b, ops = self.work(kernel)
        return max(b / peaks.BYTES_PER_S, ops / peaks.F32_PER_S)

    def roofline(self, kernel: str, work: str):
        """The share, in %, of the traced window's device time of
        ``kernel`` that its bound (``work/<work>.py``) would take; None
        where the trace holds none of it."""
        t = self.kernel_seconds(kernel)
        if not t:
            return None
        return 100.0 * self.bound_s(work) * self.steps / t


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    arguments."""
    name = name[5:] if name.startswith("void ") else name
    return name.replace("(anonymous namespace)::", "").split("(")[0][:100]


def _device_events(prof, want):
    """(start, end, name) of every device op in the profile, in seconds,
    from the profiler's raw events (its parsed ``events()`` take tens of
    seconds for a window's million ops)."""
    kr = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kr is None:
        raise RuntimeError("torch.profiler gave no kineto_results: this "
                           "torch cannot be read by the benchmark")
    return [(e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9,
             e.name()) for e in kr.events() if e.device_type() == want]


def read_trace(prof, device, t_mark, t_win, t_end, spans, run):
    """Device intervals from the profiler: per-op seconds and counts,
    the busy seconds inside the window, the launches per step, and the
    idle seconds labelled by the host span the harness was in when the
    device went idle. The first device op is the marker launched at host
    time ``t_mark`` on an idle device; it maps device time to host time.
    Returns the breakdown, or None where the trace holds no device op."""
    import torch
    want = (torch.autograd.DeviceType.CUDA if device.type == "cuda"
            else torch.autograd.DeviceType.CPU)
    ev = sorted(_device_events(prof, want))
    if len(ev) < 2:
        return None
    d0 = ev[0][0]
    to_dev = lambda t: d0 + (t - t_mark)
    w0, w1 = max(ev[0][1], to_dev(t_win)), to_dev(t_end)
    ops = [(max(a, w0), min(b, w1), n) for a, b, n in ev[1:]
           if b > w0 and a < w1]
    for a, b, n in ops:
        k = run.kernels.setdefault(n, [0.0, 0])
        k[0] += b - a
        k[1] += 1
    busy = _merge([(a, b) for a, b, _ in ops])
    run.busy_s = sum(b - a for a, b in busy)
    run.launches_per_step = sum(
        c for n, (_, c) in run.kernels.items()
        if not n.startswith(("Memcpy", "Memset"))) / max(run.steps, 1)
    rows = sorted(spans.rows, key=lambda r: r[1])
    starts = [r[1] for r in rows]
    idle = {}
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        h = t_mark + (a - d0)
        i = bisect.bisect_right(starts, h) - 1
        label = rows[i][0] if i >= 0 and rows[i][2] > h else "harness"
        idle[label] = idle.get(label, 0.0) + (b - a)
    by_op = {}
    for n, (s, _) in run.kernels.items():
        by_op[_short(n)] = by_op.get(_short(n), 0.0) + s
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:10]
    return dict(device_ops=top(by_op), idle_gaps=top(idle))


def count_syncs(step, npool, device, n=3):
    """Calls per step that made the host wait for the card
    (``torch.cuda.set_sync_debug_mode``), over n steps outside the
    window; None off the card."""
    import torch
    if device.type != "cuda":
        return None
    count = 0

    def record(message, *args, **kw):
        nonlocal count
        if "called a synchronizing" in str(message):
            count += 1

    spans = Spans()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(n):
                step.run(i % npool, spans)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(device)
    return count / n


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, spec=None) -> dict:
    """One run of one cell on ``device``; returns the result line's
    object. ``spec`` (from :func:`cell_spec`) may be given to run a
    modified configuration (the tests' small sizes). Raises instead, once
    the check is done, if the process holds a module that
    :func:`forbidden_modules` names."""
    import torch
    from torch_bench.traffic import generator
    spec = spec or cell_spec(workload)
    cell, config, bench = spec["cell"], spec["config"], spec["bench"]
    device = torch.device(device)
    if device.type == "cuda":
        from rte_rrtmgp_tpu_torch.ops.kernels._build import build_all
        build_all()
    data = generator.make(config, cell["traffic"], seed, device)
    entry_mod = load("entries", cell["entry"])
    Step = load("steps", cell["step"]).Step
    entry = entry_mod.Entry(data, config, device)
    step = Step(entry, cell, entry_mod.OUTPUTS)
    npool = len(entry.inputs)
    spans = Spans()
    for i in range(npool + WARMUP_STEPS):
        step.run(i % npool, spans)
        _sync(device)
    setup_s = time.perf_counter() - t_start

    shapes = generator.shapes(config)
    run = Run(spec, shapes)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        act = (ProfilerActivity.CUDA if device.type == "cuda"
               else ProfilerActivity.CPU)
        prof = profile(activities=[act])
        prof.__enter__()
    spans = Spans()
    samples, nkeep = [], SAMPLES
    rng = random.Random(seed)
    step_s = []
    _sync(device)
    t_mark = time.perf_counter()
    if trace:
        torch.ones(1, device=device)         # the trace's clock marker
    t_win = time.perf_counter()
    i = 0
    while True:
        k = i % npool
        t0 = time.perf_counter()
        out = step.run(k, spans)
        t1 = time.perf_counter()
        _sync(device)
        t2 = time.perf_counter()
        spans.rows.append(("synchronize", t1, t2))
        step_s.append(t2 - t0)
        run.host_s.append(t1 - t0)
        i += 1
        if len(samples) < nkeep:
            samples.append((k, _copy(out)))
        elif rng.randrange(i) < nkeep:
            samples[rng.randrange(nkeep)] = (k, _copy(out))
        del out
        if t2 - t_win >= seconds:
            break
    t_end = t2
    run.steps, run.window_s = i, t_end - t_win
    breakdown = None
    if trace:
        t0 = time.perf_counter()
        prof.__exit__(None, None, None)
        t1 = time.perf_counter()
        breakdown = read_trace(prof, device, t_mark, t_win, t_end, spans,
                               run)
        log(f"trace: profiler stopped in {t1 - t0:.1f} s, read in "
            f"{time.perf_counter() - t1:.1f} s")
        del prof
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < UNTRACED_S:
            step.run(run.untraced_steps % npool, Spans())
            _sync(device)
            run.untraced_steps += 1
        run.untraced_s = time.perf_counter() - t0
        run.syncs_per_step = count_syncs(step, npool, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del step, entry
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the sampled steps against the plain reference
    t_ref = time.perf_counter()
    checker = Step(None, cell, entry_mod.OUTPUTS)
    refmod = load("reference", config["problem"])
    limits = cell["check"].get("limits") or {}
    got, failed = {}, 0
    for k, out in samples:
        ref = checker.reference(refmod, data, data["pool"][k])
        nums = checker.numbers(out, ref, data["pool"][k])
        failed += any(not nums[n] <= limits.get(n, -math.inf)
                      for n in checker.names)
        for n, v in nums.items():
            got[n] = max(got.get(n, -math.inf), v)
    ref_s = time.perf_counter() - t_ref
    correct = bool(samples) and failed == 0 and all(
        n in limits for n in checker.names)

    ncol = shapes["ncol"]
    q = statistics.quantiles([s * 1e3 for s in step_s], n=100,
                             method="inclusive") if len(step_s) > 1 else \
        [step_s[0] * 1e3] * 99
    quarters = [statistics.median(step_s[j * i // 4:(j + 1) * i // 4] or
                                  step_s) * 1e3 for j in range(4)]
    log(f"{workload}: seed {seed}, {i} steps in {run.window_s:.3f} s, "
        f"median {statistics.median(step_s) * 1e3:.3f} ms (by quarter of "
        f"the window: {', '.join(f'{x:.3f}' for x in quarters)}), p95 "
        f"{q[94]:.3f} ms; set-up {setup_s:.3f} s; check of {len(samples)} "
        f"sampled steps {ref_s:.3f} s")
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            v = load("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        e2e = dict(setup_s=setup_s, columns_per_s=i * ncol / run.window_s,
                   step_p95_ms=q[94])
        metrics = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                   for m in bench["end_to_end"]}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type),
               count=spec["entry"]["chips"], memory_peak_bytes=peak)
    if trace:
        dev.update(busy_s=run.busy_s, window_s=run.window_s)
    result = dict(correct=correct, attempted=i, failed=failed,
                  metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {n: dict(value=got.get(n), limit=limits.get(n))
                       for n in checker.names}
    for n in checker.names:
        log(f"check {n}: {got.get(n)} (limit {limits.get(n)})")
    found = forbidden_modules()
    if found:
        raise RuntimeError("the run loaded JAX or the JAX package, so it "
                           "gives no result: " + ", ".join(found))
    return result

