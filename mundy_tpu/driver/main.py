"""CLI driver: `python -m mundy_tpu.driver.main config.yaml [--set k=v ...]`.

The `main()` entry of the reference app drivers (CommandLineProcessor +
getParametersFromYamlFile, `HP1...neigh_linker.cpp:1021-1062`), with
checkpoint/continuation handled the way the reference's
`enable_continuation_if_available` does (`:897-899`).
"""

from __future__ import annotations

import argparse
import json
import sys

import jax

from mundy_tpu.core.compile_cache import use_compile_cache
from mundy_tpu.driver.configurator import available_apps, build_simulation_from_yaml
from mundy_tpu.io import latest_checkpoint, load_checkpoint, save_checkpoint


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got '{p}'")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def run(argv=None):
    """Parse the CLI, build the app and run it to num_steps.

    Returns (sim, state) at the end of the run, for callers that inspect
    the final state (`main` is the CLI wrapper)."""
    ap = argparse.ArgumentParser(
        description=f"mundy_tpu driver. Apps: {', '.join(available_apps())}"
    )
    ap.add_argument("config", help="YAML config with 'app' and 'params'")
    ap.add_argument("--set", nargs="*", metavar="KEY=VALUE", dest="overrides",
                    help="parameter overrides (JSON-parsed values)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for periodic checkpoints + continuation")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="steps between checkpoints (0 = only at end)")
    ap.add_argument("--continue", dest="resume", action="store_true",
                    help="resume from the latest checkpoint if present")
    ap.add_argument("--output-dir", default=None,
                    help="directory for trajectory frames + final VTK "
                         "(the IOBroker results role)")
    ap.add_argument("--output-every", type=int, default=0,
                    help="steps between trajectory frames (0 = final only)")
    ap.add_argument("--platform", default=None,
                    help="jax platform override: cpu or cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="run sharded over N devices (the reference's "
                         "`mpirun -n N` role); 0/1 = single device")
    args = ap.parse_args(argv)

    use_compile_cache()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    # enable x64 before building the sim if the config requests float64
    # (otherwise jnp silently truncates and warns on every call)
    from mundy_tpu.core.config import load_yaml

    overrides = _parse_overrides(args.overrides)
    spec = load_yaml(args.config)
    dtype = (overrides.get("dtype") or (spec.get("params") or {}).get("dtype"))
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    config, sim = build_simulation_from_yaml(args.config, overrides)
    print(f"app config: {config}")

    if args.devices and args.devices > 1:
        from mundy_tpu.driver.sharded import ShardedSim

        sim = ShardedSim(spec["app"], sim, args.devices)
        print(f"sharded over {args.devices} devices "
              f"(mesh axis '{sim.axis}')")

    if not hasattr(sim, "run_block"):
        raise SystemExit(
            f"app {type(sim).__name__} does not expose run_block(state, "
            "n_steps) — every driver app must")

    state = sim.init()
    start_step = 0
    if args.resume and args.checkpoint_dir:
        ck = latest_checkpoint(args.checkpoint_dir)
        if ck is not None:
            state = load_checkpoint(ck, state)
            start_step = int(getattr(state, "step", 0))
            print(f"resumed from {ck} at step {start_step}")

    total = config.num_steps
    broker = None
    if args.output_dir:
        from mundy_tpu.io.broker import ResultsBroker

        broker = ResultsBroker(args.output_dir, 0, args.output_every,
                               dt=float(getattr(config, "dt", 0.0)),
                               append=start_step > 0)
        if start_step == 0:
            broker.write_frame(0, sim, state)  # initial configuration

    # block size = the finest positive cadence among checkpointing and
    # results output (the reference's io_frequency / PeriodicTrigger role)
    cadences = [v for v in (args.checkpoint_every, args.output_every) if v > 0]
    block = min(cadences) if cadences else total
    done = start_step
    regrows = 0
    while done < total:
        n = min(block, total - done)
        new_state = sim.run_block(state, n)
        jax.block_until_ready(new_state)
        if (bool(getattr(new_state, "overflow", False))
                and hasattr(sim, "regrow")):
            if regrows >= 8:
                raise SystemExit("capacity overflow persists after regrows")
            regrows += 1
            print(f"capacity overflow: regrow #{regrows}, retrying block")
            state = sim.regrow(state)
            continue
        state = new_state
        done += n
        print(f"step {done}/{total}")
        if broker is not None:
            broker.maybe_write(done, sim, state)
        if args.checkpoint_dir and (
                done >= total
                or (args.checkpoint_every > 0
                    and done % args.checkpoint_every == 0)):
            save_checkpoint(args.checkpoint_dir, done, state)
    if broker is not None:
        vtk = broker.finalize(done, sim, state)
        print(f"wrote {broker.frames_written} trajectory frames to "
              f"{broker.trajectory_path}; final snapshot {vtk}")
    print("done")
    return sim, state


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
