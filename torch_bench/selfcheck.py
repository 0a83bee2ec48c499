#!/usr/bin/env python3
"""The benchmark's own check, on the CPU, without a card:

    python3 torch_bench/selfcheck.py

  * every name in BENCHMARK.json resolves to its file (configuration,
    cell, entry, step kind, the problem's inputs and reference, per-layer
    metric with the same layer), and every name, unit and text keeps to
    the allowed characters and lengths;
  * ``work/`` reproduces the operation counts of PERF.md's kernel table
    at that table's layout (16 lower and 12 upper minor windows):
    row 2 at 1800 x 61 3.373 Gop, row 3 4.034 Gop, rows 16 and 17 at
    4096 x 72 22.574 and 38.315 Gop;
  * no file of the benchmark imports JAX or reads the JAX package's
    benchmark files;
  * the harness prints no result and exits non-zero without a CUDA card.

Prints one line per failed check and exits 1 if any failed.
"""
import json
import os
import re
import subprocess
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def check_json(errors):
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    err = errors.append
    if set(b) != KEYS:
        err(f"BENCHMARK.json keys {sorted(b)}")
    if not 1 <= len(b["paths"]) <= 16 or not all(PATH.match(p)
                                                  for p in b["paths"]):
        err("paths")
    if not (1 <= len(b["command"]) <= 32 and all(text_ok(c)
                                                 for c in b["command"])):
        err("command")
    if not (isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51):
        err("run_seconds")
    ncell = 24
    runs = 2 + 14 * ncell
    if runs * (b["run_seconds"] + 60) + ncell * 180 + 1200 > 43200:
        err("run_seconds: 24 cells would not fit a check")
    names = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[kind]:
            if not NAME.match(e["name"]) or (kind, e["name"]) in names:
                err(f"{kind} name {e['name']!r}")
            names.add((kind, e["name"]))
    for c in b["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            err(f"config {c['name']} keys")
        if not (text_ok(c["why"]) and text_ok(c["source"])):
            err(f"config {c['name']} why/source")
        if not c["file"].startswith("torch_bench/") or not os.path.exists(
                os.path.join(ROOT, c["file"])):
            err(f"config {c['name']} file {c['file']}")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        if cfg["name"] != c["name"] or cfg["source"] != c["source"] \
                or cfg["reduced"] != c["reduced"]:
            err(f"config {c['name']}: the file disagrees with BENCHMARK.json")
        if not all(NAME.match(k) for k in c["reduced"]):
            err(f"config {c['name']} reduced")
        if not any(w["config"] == c["name"] for w in b["workloads"]):
            err(f"config {c['name']} has no cell")
    configs = {c["name"] for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            err(f"cell {w['name']} keys")
        if w["config"] not in configs or w["chips"] not in (1, 4) \
                or not text_ok(w["why"]) or not NAME.match(w["traffic"]):
            err(f"cell {w['name']}")
        if w["name"] != f"{w['config']}.{w['traffic']}":
            err(f"cell {w['name']}: not <config>.<traffic>")
        path = os.path.join(BENCH, "workloads", w["name"] + ".json")
        if not os.path.exists(path):
            err(f"cell {w['name']}: no {path}")
            continue
        cell = json.load(open(path))
        if cell["config"] != w["config"]:
            err(f"cell {w['name']}: config {cell['config']}")
        cfg = json.load(open(os.path.join(BENCH, "configs",
                                          w["config"] + ".json")))
        for kind, name in (("entries", cell["entry"]),
                           ("steps", cell["step"]),
                           ("traffic", cfg["problem"]),
                           ("reference", cfg["problem"])):
            if not os.path.exists(os.path.join(BENCH, kind, name + ".py")):
                err(f"cell {w['name']}: no {kind}/{name}.py")
        limits = cell["check"].get("limits") or {}
        if not limits:
            err(f"cell {w['name']}: no limits")
    if "setup_s" not in e2e or e2e["setup_s"]["bound"] > 0.25:
        err("setup_s")
    for m in b["end_to_end"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound",
                                      "source"}:
            err(f"metric {m['name']} keys")
        if not (0.01 <= m["bound"] <= 0.25) or m["source"] not in SOURCES_E2E:
            err(f"metric {m['name']} bound/source")
    from torch_bench import harness
    for m in b["per_layer"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "source",
                                      "layer", "moves"}:
            err(f"metric {m['name']} keys")
        if m["moves"] not in e2e or m["source"] not in SOURCES \
                or not text_ok(m["layer"]):
            err(f"metric {m['name']} moves/source/layer")
        if not set(m.get("workloads", cells)) <= cells:
            err(f"metric {m['name']} workloads")
        if not os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")):
            err(f"metric {m['name']}: no metrics/{m['name']}.py")
        elif harness.load("metrics", m["name"]).LAYER != m["layer"]:
            err(f"metric {m['name']}: layer differs from its file's")
    for m in b["end_to_end"] + b["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower",
                                                            "higher"):
            err(f"metric {m['name']} unit/better")
    if len(json.dumps(b)) > 64 * 1024:
        err("BENCHMARK.json over 64 KiB")


def check_work(errors):
    from torch_bench import harness
    from torch_bench.traffic import generator
    cfg = json.load(open(os.path.join(BENCH, "configs", "allsky.json")))
    # the kernel table's layout: the port's synthetic k-distribution, 16
    # lower and 12 upper minor windows on each side
    for side in ("kdist_lw", "kdist_sw"):
        cfg[side] = dict(cfg[side], nminor_lower=16, nminor_upper=12)
    flag = generator.shapes(cfg)
    rf = generator.shapes(dict(cfg, ncol=1800, nlay=61))
    for kernel, shapes, gop in (("fused_lw", rf, 3.373),
                                ("fused_sw", rf, 4.034),
                                ("fused_lw_bwd", flag, 22.574),
                                ("fused_sw_bwd", flag, 38.315)):
        got = harness.load("work", kernel).work(shapes)[1] / 1e9
        if round(got, 3) != gop:
            errors.append(f"work/{kernel}: {got:.4f} Gop, PERF.md {gop}")


def check_imports(errors):
    bad = re.compile(r"^\s*(import jax|from jax|import rte_rrtmgp_tpu\b|"
                     r"from rte_rrtmgp_tpu\b|.*BENCH_r|.*bench\.py|"
                     r".*scripts/)", re.M)
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py") and f != "selfcheck.py":
                src = open(os.path.join(d, f)).read()
                if bad.search(src):
                    errors.append(f"{os.path.join(d, f)} reads the JAX "
                                  "package or its benchmark")


def check_refusal(errors):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "allsky.fused.fwd", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    if p.returncode == 0 or "{" in p.stdout:
        errors.append(f"run.py without a card: rc {p.returncode}, stdout "
                      f"{p.stdout[-200:]!r}")


def main() -> int:
    errors = []
    for check in (check_json, check_work, check_imports, check_refusal):
        check(errors)
    for e in errors:
        print("selfcheck:", e)
    print(f"selfcheck: {'FAILED' if errors else 'passed'}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
