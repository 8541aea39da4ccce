"""f32-vs-f64 drift metric (BASELINE.md protocol: per-step drift bar 1e-10).

Runs a milestone config twice from an IDENTICAL initial state — float64 on
the host CPU and float32 on the default backend (the GPU where one is
present, else the CPU) — with matched gid-keyed noise streams (brownian_velocity_keyed
is a pure function of (key, step, gid) whose draws are dtype-invariant), and
reports:

  - per-step local drift: max position deviation after ONE step from the
    shared start (the BASELINE.json 1e-10/step bar is about this number)
  - trajectory divergence at checkpoints (contact dynamics is chaotic, so
    the window divergence grows faster than linearly; both are reported)
  - for the LCP config: the constraint residual (max overlap) of each leg

Usage: python benchmarks/drift_f32.py [spheres|lcp] [N] [STEPS]

`run` enables 64-bit types only inside its own scope (jax.enable_x64), so
importing this module leaves the caller's dtype defaults alone.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

CHECKPOINTS = (1, 2, 5, 10, 20, 50, 100)


def _minimage_dev(a, b, box):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d = np.minimum(d, box - d)
    return float(d.max())


def spheres_pair(n=2000, steps=100):
    """(f64 sim+state, f32 sim+state, box) with identical starts."""
    from mundy_tpu.driver.apps.spheres import SpheresConfig, SpheresSim

    radius, phi = 0.5, 0.05
    box = (n * (4 / 3) * np.pi * radius**3 / phi) ** (1 / 3)

    def mk(dtype):
        cfg = SpheresConfig(num_spheres=n, box_size=float(box), radius=radius,
                            youngs_modulus=1000.0, diffusion_coeff=0.1,
                            dt=1e-4, skin=0.4, chunk=2048, dtype=dtype)
        return SpheresSim(cfg)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        sim64 = mk("float64")
        s64 = sim64.init()
    sim32 = mk("float32")
    s32 = sim32.init()
    # identical start: cast the f64 positions down and rebuild structures
    pos32 = jnp.asarray(np.asarray(s64.pos), jnp.float32)
    s32 = s32.replace(pos=pos32, ref_pos=pos32, key=s64.key.astype(s32.key.dtype))
    s32 = jax.jit(sim32._rebuild)(s32)
    return (sim64, s64), (sim32, s32), float(box)


def lcp_pair(n=2000, steps=100):
    from mundy_tpu.driver.apps.lcp_spheres import (LCPSpheresConfig,
                                                   LCPSpheresSim)

    radius, phi = 0.5, 0.05
    box = (n * (4 / 3) * np.pi * radius**3 / phi) ** (1 / 3)

    def mk(dtype):
        cfg = LCPSpheresConfig(num_spheres=n, box_size=float(box),
                               radius=radius, dt=1e-3, diffusion_coeff=0.1,
                               chunk=2048, dtype=dtype)
        return LCPSpheresSim(cfg)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        sim64 = mk("float64")
        s64 = sim64.init()
    sim32 = mk("float32")
    s32 = sim32.init()
    pos32 = jnp.asarray(np.asarray(s64.pos), jnp.float32)
    s32 = s32.replace(pos=pos32, ref_pos=pos32, key=s64.key.astype(s32.key.dtype))
    s32 = jax.jit(sim32._rebuild)(s32)
    return (sim64, s64), (sim32, s32), float(box)


def run(config="spheres", n=2000, steps=100):
    with jax.enable_x64(True):
        return _run(config, n, steps)


def _run(config, n, steps):
    (sim64, s64), (sim32, s32), box = (
        spheres_pair(n, steps) if config == "spheres" else lcp_pair(n, steps))
    pos_of = lambda sim, s: (sim.positions(s) if hasattr(sim, "positions")
                             else s.pos)
    cpu = jax.devices("cpu")[0]
    rows = []
    done = 0
    for k in CHECKPOINTS:
        if k > steps:
            break
        with jax.default_device(cpu):
            s64 = sim64.run_block(s64, k - done)
        s32 = sim32.run_block(s32, k - done)
        done = k
        dev = _minimage_dev(pos_of(sim64, s64), pos_of(sim32, s32), box)
        rows.append((k, dev))
        print(f"  step {k:4d}: max position deviation {dev:.3e}"
              f"  ({dev / k:.3e}/step)", flush=True)
    out = {
        "config": config,
        "n": n,
        "backend_f32": jax.default_backend(),
        "per_step_drift": rows[0][1],
        "divergence": {str(k): d for k, d in rows},
    }
    if config == "lcp":
        out["max_overlap_f64"] = float(sim64.max_overlap(s64))
        out["max_overlap_f32"] = float(sim32.max_overlap(s32))
        print(f"  max overlap: f64 {out['max_overlap_f64']:.3e}  "
              f"f32 {out['max_overlap_f32']:.3e}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    config = sys.argv[1] if len(sys.argv) > 1 else "spheres"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 2000
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    run(config, n, steps)
