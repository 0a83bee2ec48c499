"""Tolerance comparison against reference outputs (numpy only).

A copy of ``rte_rrtmgp_tpu.utils.compare`` (reference
examples/compare-to-reference.py:30-75): absolute-tolerance comparison
(rtol=0) with separate reporting and failure thresholds, both overridable
through the environment variables REPORTING_THRESHOLD and
FAILURE_THRESHOLD (the reference's names).
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["compare_fields", "default_failure_threshold"]


def default_failure_threshold(double_precision: bool = False) -> float:
    """The reference's ctest gates: 7e-4 W/m2 for double-precision builds,
    3.5e-1 for single (examples/CMakeLists.txt:1-9); the environment's
    FAILURE_THRESHOLD wins."""
    env = os.environ.get("FAILURE_THRESHOLD")
    if env is not None:
        return float(env)
    return 7.0e-4 if double_precision else 3.5e-1


def compare_fields(tst, ref, name: str = "field", *,
                   failure_threshold: float | None = None,
                   reporting_threshold: float | None = None,
                   verbose: bool = True) -> bool:
    """True if ``tst`` matches ``ref`` within the absolute threshold
    (np.allclose with rtol=0, reference compare-to-reference.py:52-60)."""
    tst = np.asarray(tst, np.float64)
    ref = np.asarray(ref, np.float64)
    if failure_threshold is None:
        failure_threshold = default_failure_threshold()
    if reporting_threshold is None:
        reporting_threshold = float(os.environ.get("REPORTING_THRESHOLD", 0.0))
    diff = np.abs(tst - ref)
    maxd = float(diff.max()) if diff.size else 0.0
    ok = bool(np.allclose(tst, ref, rtol=0.0, atol=failure_threshold))
    if verbose and maxd > reporting_threshold:
        avg = float(diff.mean()) if diff.size else 0.0
        print(f"Variable {name} differs (max abs difference: {maxd:.6e}; "
              f"mean: {avg:.6e}; threshold {failure_threshold:.1e}) "
              f"-> {'PASS' if ok else 'FAIL'}")
    return ok
