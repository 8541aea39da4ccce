"""Headline benchmark: spheres config (BASELINE #1) on one GPU.

Prints a JSON line after the Hertzian leg and the full record (with the LCP
north-star leg) as the last line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Metric: pair-interactions/sec/chip for the full simulation step (broad phase
amortized via skin rebuilds + Hertzian forces + Brownian + Euler) at 1M
bodies. Every record names its device; without a GPU the script fails.
Times end in block_until_ready.
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp

from mundy_tpu.core.compile_cache import use_compile_cache
from mundy_tpu.core.device import nvidia_smi, require_gpu


def measure_lcp(n: int):
    """The north-star metric (BASELINE.json: "LCP solve ms/step"):
    steady-state 1M LCP-constrained step with Brownian drift."""
    import math as _math

    from mundy_tpu.driver.apps.lcp_spheres import (LCPSpheresConfig,
                                                   LCPSpheresSim)

    box = (n * (4.0 / 3.0) * _math.pi * 0.125 / 0.05) ** (1.0 / 3.0)
    cfg = LCPSpheresConfig(num_spheres=n, box_size=float(box), radius=0.5,
                           dt=1e-3, diffusion_coeff=0.1,
                           constraint_buffer=0.45)
    sim = LCPSpheresSim(cfg)
    state = sim.init()
    for _ in range(3):  # settle + give the active-window resize chances
        state = sim.run_block(state, 9)
    # The settle blocks may raise the sticky overflow while capacities are
    # still being right-sized; record it (the published number carries the
    # caveat) rather than silently discarding, then clear and re-verify:
    # the 2-step warm block below re-raises the flag if any capacity is
    # STILL insufficient, so `lcp_overflow` genuinely covers the timed
    # window's data structures.
    settle_overflow = bool(state.overflow)
    state = state.replace(overflow=jnp.asarray(False))
    state = jax.block_until_ready(sim.run_block(state, 2, resize=False))
    assert not bool(state.overflow), \
        "LCP capacities still overflow after the settle+resize blocks"
    rb0 = int(state.rebuild_count)
    window = 24
    t0 = time.perf_counter()
    state = jax.block_until_ready(sim.run_block(state, window, resize=False))
    dt = time.perf_counter() - t0
    return {
        "lcp_steps_per_sec": window / dt,
        "lcp_solve_ms_per_step": 1e3 * dt / window,
        "lcp_iters": int(state.lcp_iters),
        "lcp_active_pairs": int(state.act_count),
        "lcp_rebuilds_per_step": (int(state.rebuild_count) - rb0) / window,
        "lcp_overflow": bool(state.overflow),
        "lcp_settle_overflow": settle_overflow,
    }


def main():
    use_compile_cache()
    device = require_gpu()
    print(f"device: {device}  nvidia-smi: {nvidia_smi()}", flush=True)
    n = int(os.environ.get("BENCH_N", 1_000_000))
    # 150-step window: the skin-rebuild cadence at this config is ~150+
    # steps, so a much shorter window over- or under-counts rebuild
    # amortization by a coin flip
    steps = int(os.environ.get("BENCH_STEPS", 150))
    engine = os.environ.get("BENCH_ENGINE", "rows")
    from mundy_tpu.driver.apps.spheres import SpheresConfig, SpheresSim
    from mundy_tpu.driver.apps.spheres_rows import RowSpheresSim

    # volume fraction ~5%: box scaled to n
    radius = 0.5
    phi = 0.05
    vol = n * (4.0 / 3.0) * 3.141592653589793 * radius**3 / phi
    box = vol ** (1.0 / 3.0)

    cfg = SpheresConfig(
        num_spheres=n,
        box_size=box,
        radius=radius,
        youngs_modulus=1000.0,
        diffusion_coeff=0.1,
        dt=1e-4,
        skin=0.4,
        max_neighbors=32,
        cell_capacity=8,
        chunk=16384,
        dtype="float32",
    )
    sim = RowSpheresSim(cfg) if engine == "rows" else SpheresSim(cfg)
    state = sim.init()
    jax.block_until_ready(state)

    # warm up / compile
    state = jax.block_until_ready(sim.run_block(state, 3))

    t0 = time.perf_counter()
    state = jax.block_until_ready(sim.run_block(state, steps))
    elapsed = time.perf_counter() - t0

    steps_per_sec = steps / elapsed
    # directed pair interactions within the physical cutoff per step
    if engine == "rows":
        # EXACT directed in-cutoff pair count at the final state: one
        # neighbor-matrix build at the physical cutoff 2r + skin (the rows
        # engine's force kernel evaluates exactly these pairs each step).
        from mundy_tpu.neighbor import neighbor_matrix_rows
        nm = neighbor_matrix_rows(
            sim.positions(state), radius + 0.5 * cfg.skin, (box,) * 3,
            max_neighbors=cfg.max_neighbors)
        pair_evals = int(jnp.sum(nm.mask))
        if bool(nm.overflow):  # truncated count: fall back to mean-field
            dens = n / (box ** 3)
            cut = 2 * radius + cfg.skin
            pair_evals = int(n * dens * (4.0 / 3.0)
                             * 3.141592653589793 * cut**3)
    else:
        pair_evals = int(jnp.sum(state.nmat.mask))
    pairs_per_sec = steps_per_sec * pair_evals

    rec = {
        "metric": f"hertzian-contact step, {n} spheres (phi=0.05), pair interactions/sec/chip",
        "value": pairs_per_sec,
        "unit": "pair-interactions/sec/chip",
        "device": device,
        "nvidia_smi": nvidia_smi(),
        "steps_per_sec": steps_per_sec,
        "num_bodies": n,
        "pair_evals_per_step": pair_evals,
        "overflow": bool(state.overflow),
        "engine": engine,
    }
    # the headline goes out first; the full record with the LCP
    # north-star metrics follows as the last line
    print(json.dumps(rec), flush=True)
    if os.environ.get("BENCH_LCP", "1") != "0":
        rec.update(measure_lcp(n))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
