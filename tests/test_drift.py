"""f32-vs-f64 drift metric at CI scale (BASELINE.md protocol step: measure
per-step drift of the float32 trajectory against the f64 reference).

The committed at-scale numbers live in PERF.md; this tier keeps the harness
honest and catches catastrophic precision regressions (the bf16-matmul class
of bug turns 1e-6-scale per-step drift into 1e-2)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))

pytestmark = pytest.mark.slow


def test_spheres_f32_drift_bounded():
    from drift_f32 import run

    out = run("spheres", n=600, steps=20)
    # one-step local error: f32 rounding of O(10 length-unit) positions is
    # ~1e-6; a precision bug (bf16 matmul on the metric path, dropped
    # compensation term) shows up orders of magnitude above this
    assert out["per_step_drift"] < 1e-4, out
    # the 20-step window stays in the linear-ish regime at this scale
    assert out["divergence"]["20"] < 3e-2, out


def test_lcp_f32_drift_and_overlap():
    from drift_f32 import run

    out = run("lcp", n=600, steps=20)
    assert out["per_step_drift"] < 1e-4, out
    # both legs enforce the same overlap tolerance irrespective of dtype
    # (f32 solves floor near ~3e-5 at scale; 600 bodies converges to tol)
    assert out["max_overlap_f32"] < 5e-4, out
    assert out["max_overlap_f64"] < 5e-4, out
