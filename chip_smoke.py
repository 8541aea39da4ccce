"""Smoke check of the main path on the GPU, in one process.

    python chip_smoke.py            # one GPU: phases a-d
    python chip_smoke.py --multi    # four GPUs: sharded runs vs one GPU only
    python chip_smoke.py --phases bd          # a subset (device check always)
    python chip_smoke.py --rehearse-cpu       # tiny sizes on the CPU; never ok

Phases (one card):
  a  device: refuse anything but a GPU; print device, versions, XLA_FLAGS
     and the card's name and power limit.
  b  kernels at the 1M-sphere LCP shapes against their plain references:
     the Triton row_extract kernel vs the XLA extraction and the cell-list
     neighbor_matrix (identical neighbor sets and counts), and the blocked
     bf16 one-hot segment sum vs jax.ops.segment_sum, both vs float64.
  c  float32 on the GPU vs float64 on the host CPU from identical starts
     (benchmarks/drift_f32.py): per-step drift, 20-step divergence, LCP
     overlap.
  d  every app through driver.main.run for a few steps: finite positions,
     no sticky overflow, bodies conserved, LCP overlap and residual within
     tolerance; prints set-up/compile seconds, smoke steps/s, the step
     program's memory_analysis() and the device's peak bytes in use.

Any failure exits nonzero. The last line of a passing run is the JSON
object {"ok": true, "device": {...}}. Steps/s figures here are smoke
figures, not benchmarks.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from mundy_tpu.core.compile_cache import use_compile_cache
from mundy_tpu.core.device import nvidia_smi, require_gpu
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresSim

ROOT = os.path.dirname(os.path.abspath(__file__))
N_1M = 1_000_000
BOX_1M = 218.8  # 1M spheres of radius 0.5 at volume fraction 0.05

# phase (c) bounds: 10x what benchmarks/drift_f32.py reports on the CPU for
# the same runs (per-step 3.7e-6 / 3.8e-6, 20-step 3.7e-5 / 3.4e-5 for
# spheres / LCP at n=2000); overlap within max_allowable_overlap (1e-5)
DRIFT_PER_STEP_MAX = 4e-5
DRIFT_20_MAX = 4e-4
OVERLAP_MAX = 1e-5

# phase (d) runs: (name, config, overrides, steps); sizes are the
# configs' own except the 1M spheres/LCP runs (bench.py's settings)
LCP_1M = ["num_spheres=1000000", f"box_size={BOX_1M}",
          "constraint_buffer=0.45", "diffusion_coeff=0.1", "dt=0.001"]
SPHERES_1M = ["num_spheres=1000000", f"box_size={BOX_1M}"]
APPS = [
    ("lcp_spheres_1m", "examples/lcp_spheres_100k.yaml", LCP_1M, 24),
    ("spheres_1m", "examples/spheres_10k.yaml", SPHERES_1M, 24),
    ("chromatin_1m_spectral", "examples/chromatin_1m_spectral.yaml", [], 8),
    ("rods_100k", "examples/rods_100k.yaml", [], 10),
    ("filaments_sperm", "examples/filaments_sperm.yaml", [], 10),
    ("granular_settling", "examples/granular_settling.yaml", [], 10),
    ("hp1_chromatin", "examples/hp1_chromatin.yaml", [], 10),
]
# rehearsal sizes (CPU): same configs, few bodies
REHEARSE = {
    "lcp_spheres_1m": ["num_spheres=3000", "box_size=31.6",
                       "constraint_buffer=0.45", "diffusion_coeff=0.1",
                       "dt=0.001"],
    "spheres_1m": ["num_spheres=3000", "box_size=31.6"],
    "chromatin_1m_spectral": ["num_chains=8", "beads_per_chain=64",
                              "num_crosslinkers=64", "box_size=20.0"],
    "rods_100k": ["num_rods=2000", "box_size=38.0"],
    "filaments_sperm": ["num_filaments=8"],
    "granular_settling": ["num_spheres=500", "box_size=10.0"],
    "hp1_chromatin": ["num_chains=2", "beads_per_chain=40",
                      "num_crosslinkers=16", "periphery_radius=8.0"],
}


def log(msg=""):
    print(msg, flush=True)


def check(ok, msg):
    """A failed check stops the run (unlike assert, not stripped by -O)."""
    if not ok:
        raise RuntimeError(msg)


def timed(fn, *args, reps=5):
    """Median wall seconds of fn(*args) ending in block_until_ready (after
    one warm-up call), and the last result."""
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


# ---------------------------------------------------------------------------
def phase_device(rehearse=False):
    if rehearse:
        devs = jax.devices()
        info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
                "count": len(devs)}
    else:
        info = require_gpu()
    log(f"[a] device: {info}")
    import jaxlib

    log(f"[a] jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    log(f"[a] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[a] nvidia-smi name, power.limit: {nvidia_smi()}")
    return info


def _neighbor_sets(idx, n):
    """(N, K) neighbor ids (n = empty) -> row-sorted (N, K) array."""
    a = np.asarray(jax.device_get(idx)).astype(np.int64)
    a = np.where(a >= n, n, a)
    return np.sort(a, axis=1)


def _boundary_only(pos, a, b, n, box, cutoff):
    """Rows where neighbor sets a, b differ: True if every differing pair
    lies within 1e-5 relative of the cutoff (f32 rounding of the cutoff
    test). Returns (ok, number of differing rows)."""
    bad = np.nonzero((a != b).any(axis=1))[0]
    p = np.asarray(jax.device_get(pos), np.float64)
    for i in bad:
        diff = set(a[i].tolist()) ^ set(b[i].tolist())
        diff.discard(n)
        for j in diff:
            d = p[j] - p[i]
            d -= box * np.round(d / box)
            if abs(np.sqrt((d * d).sum()) - cutoff) > 1e-5 * cutoff:
                return False, len(bad)
    return True, len(bad)


def phase_kernels(rehearse=False):
    from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig
    from mundy_tpu.geom import periodic
    from mundy_tpu.neighbor import build_cell_list, neighbor_matrix
    from mundy_tpu.neighbor.rows import (build_rows, extract_kernel_ok,
                                         make_row_grid, neighbor_matrix_rows,
                                         row_extract_xla)
    from mundy_tpu.ops.pallas.row_extract import row_neighbor_extract
    from mundy_tpu.ops.segments import (StridedWindows, segment_sum_strided)

    n, box = (3000, 31.6) if rehearse else (N_1M, BOX_1M)
    cfg = LCPSpheresConfig(num_spheres=n, box_size=box, radius=0.5,
                           dt=1e-3, diffusion_coeff=0.1,
                           constraint_buffer=0.45)
    sim = LCPSpheresSim(cfg)
    K, sr = sim.rows_k, float(sim.search_radius)
    cutoff = 2 * sr
    lengths, flags = (box,) * 3, (True,) * 3
    pos = jax.random.uniform(jax.random.PRNGKey(7), (n, 3), jnp.float32,
                             maxval=box)
    grid = make_row_grid([0, 0, 0], lengths, cutoff, n,
                         capacity_slack=sim.rows_slack, align=8)
    rows = jax.jit(lambda p: build_rows(
        p, jnp.arange(n, dtype=jnp.int32), grid))(pos)
    log(f"[b] row_extract at the LCP shapes: n={n} ny={grid.ny} "
        f"nz={grid.nz} R={grid.row_capacity} K={K} cutoff={cutoff}")
    if not rehearse:
        check(extract_kernel_ok(grid, K), "kernel envelope refused 1M LCP")
    kern = jax.jit(lambda st: row_neighbor_extract(
        st.pos, st.gid, st.valid, lengths, cutoff, K, interpret=rehearse))
    xla = jax.jit(lambda st: row_extract_xla(st, (lengths, flags), cutoff, K))
    t_k, (ids_k, cnt_k) = timed(kern, rows)
    t_x, (ids_x, cnt_x) = timed(xla, rows)
    valid = np.asarray(rows.valid)
    cnt_k, cnt_x = np.asarray(cnt_k), np.asarray(cnt_x)
    check(cnt_k.max() <= K, "K too small for the test positions")
    ids_k = np.sort(np.asarray(ids_k)[valid], axis=1)
    ids_x = np.sort(np.asarray(ids_x)[valid], axis=1)
    n_cnt = int((cnt_k != cnt_x).sum())
    n_set = int((ids_k != ids_x).any(axis=1).sum())
    log(f"[b] kernel vs XLA extraction: count mismatches {n_cnt}, "
        f"set mismatches {n_set} (tolerance 0; 1e-5-relative cutoff "
        "boundary pairs reported below)")
    log(f"[b] row_extract time: kernel {1e3 * t_k:.3f} ms, XLA "
        f"{1e3 * t_x:.3f} ms (median of 5, smoke timing)")

    nm_rows = jax.jit(lambda p: neighbor_matrix_rows(
        p, sr, lengths, max_neighbors=K, grid=grid))(pos)
    metric = periodic(np.asarray(lengths), dtype=jnp.float32)
    clist = build_cell_list(pos, sim.grid, cfg.cell_capacity)
    nm_cl = neighbor_matrix(pos, clist, jnp.asarray(sr, jnp.float32),
                            metric=metric, max_neighbors=K, chunk=32768)
    check(not bool(nm_rows.overflow) and not bool(nm_cl.overflow),
          "neighbor matrix overflow at the test positions")
    a = _neighbor_sets(nm_rows.idx, n)
    b = _neighbor_sets(nm_cl.idx, n)
    ok, n_diff = _boundary_only(pos, a, b, n, box, cutoff)
    log(f"[b] neighbor_matrix_rows vs cell-list neighbor_matrix: "
        f"{n_diff} rows differ, all on the cutoff boundary: {ok}")
    check(n_cnt == 0 and n_set == 0, "kernel and XLA extraction differ")
    check(ok, "rows and cell-list neighbor sets differ off the boundary")

    # blocked one-hot segment sum at the 1M Delassus shapes
    B, W = 1024, 512
    nb = -(-n // B)
    rng = np.random.default_rng(3)
    counts = np.minimum(rng.poisson(0.45, n), 8)
    ids = np.full((nb * W,), n, np.int64)
    for blk in range(nb):
        seg = np.repeat(np.arange(blk * B, min((blk + 1) * B, n)),
                        counts[blk * B:(blk + 1) * B])[:W]
        ids[blk * W:blk * W + seg.size] = seg
    vals = rng.normal(size=(nb * W, 3)).astype(np.float32)
    vals[ids >= n] = 0.0
    ids_j, vals_j = jnp.asarray(ids, jnp.int32), jnp.asarray(vals)
    win = StridedWindows(block_bodies=B, window=W, nb=nb,
                         overflow=jnp.asarray(False))
    blocked = jax.jit(lambda v, i: segment_sum_strided(v, i, n, win))
    plain = jax.jit(lambda v, i: jax.ops.segment_sum(
        v, i, num_segments=n + 1, indices_are_sorted=True)[:n])
    t_b, out_b = timed(blocked, vals_j, ids_j)
    t_p, out_p = timed(plain, vals_j, ids_j)
    ref = np.zeros((n + 1, 3))
    np.add.at(ref, ids, vals.astype(np.float64))
    mag = np.zeros((n + 1, 3))
    np.add.at(mag, ids, np.abs(vals.astype(np.float64)))
    # a few f32 ulp of each segment's summed magnitude
    tol = 4 * np.finfo(np.float32).eps * mag[:n]
    err_b = np.abs(np.asarray(out_b) - ref[:n])
    err_p = np.abs(np.asarray(out_p) - ref[:n])
    log(f"[b] segment sum ({nb * W} slots, B={B}, W={W}): blocked bf16 "
        f"one-hot max |err| {err_b.max():.3e}, segment_sum max |err| "
        f"{err_p.max():.3e}; tolerance 4 ulp of each summed magnitude "
        f"(max {tol.max():.3e})")
    log(f"[b] segment sum time: blocked {1e3 * t_b:.3f} ms, "
        f"jax.ops.segment_sum {1e3 * t_p:.3f} ms (median of 5, smoke)")
    check((err_b <= tol).all() and (err_p <= tol).all(), "segment sum")


def phase_drift(rehearse=False):
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from drift_f32 import run as drift_run

    n = 400 if rehearse else 2000
    sph = drift_run("spheres", n=n, steps=20)
    lcp = drift_run("lcp", n=n, steps=20)
    for name, out in (("spheres", sph), ("lcp", lcp)):
        log(f"[c] {name}: per-step drift {out['per_step_drift']:.3e} "
            f"(bound {DRIFT_PER_STEP_MAX}), 20-step divergence "
            f"{out['divergence']['20']:.3e} (bound {DRIFT_20_MAX})")
        check(out["per_step_drift"] <= DRIFT_PER_STEP_MAX, out)
        check(out["divergence"]["20"] <= DRIFT_20_MAX, out)
    log(f"[c] lcp max overlap: f32 {lcp['max_overlap_f32']:.3e}, f64 "
        f"{lcp['max_overlap_f64']:.3e} (bound {OVERLAP_MAX})")
    check(lcp["max_overlap_f32"] <= OVERLAP_MAX, lcp)
    check(lcp["max_overlap_f64"] <= OVERLAP_MAX, lcp)


def _positions(sim, state):
    fn = getattr(sim, "positions", None)
    return np.asarray(jax.device_get(
        fn(state) if fn is not None else state.pos))


def _body_count(sim, state):
    rows = getattr(state, "rows", None)
    if rows is not None:
        return int(jnp.sum(rows.valid))
    return int(np.isfinite(_positions(sim, state)).all(axis=-1).sum())


def _expected_bodies(cfg):
    for attr in ("num_spheres", "num_rods"):
        if hasattr(cfg, attr):
            return getattr(cfg, attr)
    if hasattr(cfg, "num_filaments"):
        return cfg.num_filaments * cfg.nodes_per_filament
    return cfg.num_chains * cfg.beads_per_chain


def run_app(name, yaml_path, overrides, steps, clock, devices=0):
    """One app through driver.main.run; checks and prints its figures.
    Returns (sim, state)."""
    from mundy_tpu.driver.main import run as driver_run

    argv = [os.path.join(ROOT, yaml_path), "--set", *overrides,
            f"num_steps={steps}", "log_every=1000000"]
    if devices:
        argv += ["--devices", str(devices)]
    c0 = clock.total
    t0 = time.perf_counter()
    sim, state = driver_run(argv)
    state = jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    compile_s = clock.total - c0
    cfg = sim.config
    pos = _positions(sim, state)
    n_exp = _expected_bodies(cfg)
    n_got = _body_count(sim, state)
    ovf = bool(np.asarray(jax.device_get(state.overflow)).any())
    log(f"[d] {name}: {steps} steps, wall {wall:.2f} s, of which trace + "
        f"lower + compile {compile_s:.2f} s (set-up)")
    check(np.isfinite(pos).all(), f"{name}: non-finite positions")
    check(not ovf, f"{name}: sticky overflow after the driver's regrows")
    check(n_got == n_exp, f"{name}: {n_got} bodies, expected {n_exp}")
    if hasattr(state, "lcp_residual"):
        inner = getattr(sim, "sim", sim)
        overlap = inner.max_overlap(state)
        resid = float(state.lcp_residual)
        tol = cfg.max_allowable_overlap
        # the solve enforces tol on the predicted separations; the overlap
        # re-measured from stored positions also carries their rounding:
        # 2 ulp of the box length in the position dtype
        eps = np.finfo(np.dtype(cfg.dtype)).eps
        ulp_box = eps * 2.0 ** np.floor(np.log2(cfg.box_size))
        bound = tol + 2 * ulp_box
        log(f"[d] {name}: max overlap {overlap:.3e} (bound {bound:.3e} = "
            f"tolerance {tol:.1e} + 2 ulp of the box {ulp_box:.3e}), final "
            f"BBPGD residual {resid:.3e} (tolerance {tol:.1e}), iterations "
            f"{int(state.lcp_iters)}")
        check(overlap <= bound, f"{name}: overlap {overlap} > {bound}")
        check(resid <= tol, f"{name}: residual {resid} > {tol}")
    return sim, state


def smoke_window(sim, state, steps):
    """(state, steps/s) over `steps` more steps, after one untimed step
    that absorbs any recompile a second call still triggers (the LCP app's
    between-block capacity refit, which recompiles, is skipped)."""
    kw = {"resize": False} if isinstance(sim, LCPSpheresSim) else {}
    state = jax.block_until_ready(sim.run_block(state, 1, **kw))
    t0 = time.perf_counter()
    state = jax.block_until_ready(sim.run_block(state, steps, **kw))
    return state, steps / (time.perf_counter() - t0)


def memory_report(name, sim, state):
    fn = getattr(sim, "_burst_jit", None) or getattr(sim, "_run_jit", None)
    if fn is not None:
        compiled = fn.lower(state, jnp.asarray(1, jnp.int32)).compile()
        log(f"[d] {name}: step program memory_analysis: "
            f"{compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[d] {name}: device peak_bytes_in_use (process so far) "
        f"{stats.get('peak_bytes_in_use')}")


def phase_apps(clock, rehearse=False):
    for name, yaml_path, overrides, steps in APPS:
        if rehearse:
            overrides = REHEARSE[name]
            steps = 3
        sim, state = run_app(name, yaml_path, overrides, steps, clock)
        state, sps = smoke_window(sim, state, steps)
        log(f"[d] {name}: smoke figure, not a benchmark: {sps:.3f} "
            f"steps/s over {steps} warm steps")
        check(np.isfinite(_positions(sim, state)).all(),
              f"{name}: non-finite positions after the warm window")
        memory_report(name, sim, state)


def phase_multi(clock, rehearse=False):
    """1M LCP (balanced_lcp) and 1M spheres (slab_rows) on 4 devices and on
    1 device: same body count, no overflow, LCP overlap bound, positions
    after the same steps within POS_TOL."""
    pos_tol = 1e-3  # box-relative ~5e-6: f32 sums in another order
    d = 4
    runs = [("lcp_spheres_1m", "examples/lcp_spheres_100k.yaml", LCP_1M, 12),
            ("spheres_1m", "examples/spheres_10k.yaml", SPHERES_1M, 24)]
    for name, yaml_path, overrides, steps in runs:
        if rehearse:
            overrides = REHEARSE[name]
        res = {}
        for devices in (d, 1):
            t0 = time.perf_counter()
            sim, state = run_app(f"{name} x{devices}", yaml_path, overrides,
                                 steps, clock, devices=devices)
            wall = time.perf_counter() - t0
            state, sps = smoke_window(sim, state, steps)
            log(f"[multi] {name} on {devices} device(s): {sps:.3f} steps/s "
                f"over {steps} warm steps (smoke figure; first run incl. "
                f"compile {wall:.1f} s)")
            res[devices] = (_positions(sim, state), _body_count(sim, state))
        (p4, n4), (p1, n1) = res[d], res[1]
        box = float(overrides[1].split("=")[1])
        dev = p4 - p1
        dev -= box * np.round(dev / box)
        worst = float(np.abs(dev).max())
        log(f"[multi] {name}: bodies {n4} vs {n1}; max position deviation "
            f"{worst:.3e} after {2 * steps + 1} steps (tolerance {pos_tol})")
        check(n4 == n1, f"{name}: body counts differ")
        check(worst <= pos_tol, f"{name}: 4-device vs 1-device {worst}")


def phases_for(args) -> list:
    """Phase names a run executes, in order."""
    if args.multi:
        return ["device", "multi"]
    names = {"a": "device", "b": "kernels", "c": "drift", "d": "apps"}
    return ["device"] + [names[p] for p in "bcd" if p in args.phases]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: sharded 1M LCP and spheres vs one GPU")
    ap.add_argument("--phases", default="abcd",
                    help="subset of phases b, c, d (a always runs)")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="tiny sizes on any backend; never reports ok")
    args = ap.parse_args(argv)
    use_compile_cache()
    clock = CompileClock()
    info = None
    for phase in phases_for(args):
        t0 = time.perf_counter()
        if phase == "device":
            info = phase_device(args.rehearse_cpu)
            if args.multi and info["count"] < 4 and not args.rehearse_cpu:
                raise SystemExit(f"--multi needs 4 GPUs, found {info['count']}")
        elif phase == "kernels":
            phase_kernels(args.rehearse_cpu)
        elif phase == "drift":
            phase_drift(args.rehearse_cpu)
        elif phase == "apps":
            phase_apps(clock, args.rehearse_cpu)
        elif phase == "multi":
            phase_multi(clock, args.rehearse_cpu)
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    if args.rehearse_cpu:
        log("rehearsal finished: no accelerator result")
        return 3
    log(f"nvidia-smi name, power.limit: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
