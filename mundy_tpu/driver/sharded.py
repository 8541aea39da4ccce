"""Multi-chip execution from the production CLI: `--devices N`.

The reference's drivers run at any rank count with zero app changes
(`mpirun -n N`; `stk::parallel_machine_init`,
`mundy/tests/unit_tests/DefaultUnitTestMain.cpp:11`). The
JAX form: `ShardedSim` wraps a single-device app sim and routes its steps
onto the app's sharded engine over a `jax.sharding.Mesh` — shard at the
first block, step via the engine's fused `step_block_fn`, gather back into
the ordinary app state for IO/checkpoints. The wrapper duck-types the sim
interface `driver.main` consumes (`run_block`, `regrow`, `positions`,
`config`), so checkpointing, the results broker, and the regrow loop work
unchanged; states passed in and out are ordinary app states (what
`save_checkpoint` writes), while the authoritative sharded arrays live
inside the wrapper between blocks.

App -> engine routing (every production app has a sharded story):

| app         | engine                                   | decomposition |
|-------------|------------------------------------------|---------------|
| spheres     | parallel/slab_rows.py                    | z-slab rows   |
| lcp_spheres | parallel/balanced_lcp.py                 | balanced z-slabs (count-allocated; THE sharded LCP engine) |
| rods        | parallel/slab_segments.py                | z-slab rows   |
| filaments   | parallel/filaments_shard.py              | whole-filament blocks |
| chromatin   | parallel/chromatin_shard.py              | whole-chain blocks |
| granular    | parallel/granular_shard.py               | balanced z-slabs + migrating history |
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh


def _mesh_of(n_devices: int, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if len(devs) < n_devices:
        raise SystemExit(
            f"--devices {n_devices}: only {len(devs)} devices visible "
            f"(set XLA_FLAGS=--xla_force_host_platform_device_count=N "
            f"JAX_PLATFORMS=cpu for a virtual mesh)")
    return Mesh(np.array(devs[:n_devices]), (axis,))


def _rep(x, d):
    """Replicate a host scalar/array across the d-sharded leading axis."""
    a = np.asarray(jax.device_get(x))
    return np.broadcast_to(a, (d,) + a.shape).copy()


class ShardedSim:
    """Wraps `sim` so run_block steps over `n_devices` devices.

    States in/out are ordinary app states; the sharded dict is held
    internally between blocks (re-sharding every block would drop engine-
    internal history such as granular tangential displacements)."""

    def __init__(self, app: str, sim, n_devices: int, axis: str = "shard"):
        self.app = app
        self.sim = sim
        self.config = sim.config
        self.d = int(n_devices)
        self.axis = axis
        self.mesh = _mesh_of(self.d, axis)
        self._dict = None
        self._build()

    # delegate the sim surface main/broker use
    def positions(self, state):
        fn = getattr(self.sim, "positions", None)
        return fn(state) if fn is not None else state.pos

    def init(self, key=None):
        return self.sim.init(key) if key is not None else self.sim.init()

    # ------------------------------------------------------------------
    def _build(self):
        app, c, mesh, axis = self.app, self.config, self.mesh, self.axis
        dtype = jnp.dtype(getattr(c, "dtype", "float32"))
        if app == "spheres":
            if getattr(c, "polydispersity", 0.0):
                raise SystemExit("--devices: sharded spheres engine needs "
                                 "equal radii (polydispersity=0)")
            from mundy_tpu.parallel.slab_rows import (
                make_slab_rows_spheres_step)
            self._init_fn, self._step_fn, _grid = \
                make_slab_rows_spheres_step(
                    mesh, axis, n_total=c.num_spheres, box_size=c.box_size,
                    radius=c.radius, youngs=c.youngs_modulus,
                    poisson=c.poissons_ratio, viscosity=c.viscosity,
                    diffusion=c.diffusion_coeff, dt=c.dt, skin=c.skin,
                    dtype=dtype)
        elif app == "lcp_spheres":
            # the count-allocated balanced engine IS the sharded LCP path
            if c.hydro != "none" or getattr(c, "polydispersity", 0.0):
                raise SystemExit("--devices: sharded LCP covers the dry "
                                 "equal-radius pipeline (hydro='none')")
            from mundy_tpu.parallel.balanced_lcp import make_balanced_lcp_step
            self._init_fn, self._step_fn = make_balanced_lcp_step(
                mesh, axis, n_total=c.num_spheres, box_size=c.box_size,
                radius=c.radius, dt=c.dt, viscosity=c.viscosity,
                diffusion_coeff=c.diffusion_coeff,
                constraint_buffer=c.constraint_buffer,
                max_allowable_overlap=c.max_allowable_overlap,
                max_col_iterations=min(c.max_col_iterations, 1000),
                max_neighbors=c.max_neighbors,
                cell_capacity=c.cell_capacity, dtype=dtype)
        elif app == "rods":
            if c.shape != "spherocylinder":
                raise SystemExit("--devices: sharded rods engine covers "
                                 "the spherocylinder narrow phase")
            from mundy_tpu.parallel.slab_segments import make_slab_rods_step
            self._init_fn, self._step_fn, _grid = make_slab_rods_step(
                mesh, axis, n_total=c.num_rods, box_size=c.box_size,
                length=c.length, radius=c.radius, youngs=c.youngs_modulus,
                poisson=c.poissons_ratio, viscosity=c.viscosity,
                diffusion=c.diffusion_coeff,
                rot_diffusion=c.rot_diffusion_coeff, dt=c.dt, skin=c.skin,
                dtype=dtype)
        elif app == "filaments":
            from mundy_tpu.parallel.filaments_shard import (
                make_sharded_filaments_step)
            self._shard_fn, self._step_fn, self._gather_fn = \
                make_sharded_filaments_step(mesh, axis, self.sim)
        elif app == "chromatin":
            from mundy_tpu.parallel.chromatin_shard import (
                make_sharded_chromatin_step)
            self._shard_fn, self._step_fn, self._gather_fn = \
                make_sharded_chromatin_step(mesh, axis, self.sim)
        elif app == "granular":
            from mundy_tpu.parallel.granular_shard import (
                make_granular_slab_step)
            self._init_fn, self._step_fn, self._gather_fn = \
                make_granular_slab_step(
                    mesh, axis, n_total=c.num_spheres, box_size=c.box_size,
                    radius=c.radius, density=c.density, gravity=c.gravity,
                    friction_coeff=c.friction_coeff,
                    normal_spring=c.normal_spring,
                    normal_damping=c.normal_damping,
                    tang_spring=c.tang_spring, tang_damping=c.tang_damping,
                    wall_spring=c.wall_spring, dt=c.dt, skin=c.skin,
                    max_neighbors=c.max_neighbors,
                    cell_capacity=c.cell_capacity, dtype=dtype)
        else:
            raise SystemExit(f"--devices: no sharded engine for app "
                             f"'{app}'")

    # ------------------------------------------------------------------
    def _shard(self, state):
        app, d = self.app, self.d
        if app in ("filaments", "chromatin"):
            return self._shard_fn(state)
        if app == "spheres":
            dd = self._init_fn(jax.random.PRNGKey(0),
                               pos=np.asarray(jax.device_get(state.pos)))
            # the stream key/step come from the STATE (parity with the
            # single-device trajectory, resume mid-stream)
            dd["key"] = jnp.asarray(jax.device_get(state.key))
            dd["step"] = jnp.asarray(int(state.step), jnp.int32)
            return dd
        if app == "rods":
            if hasattr(state, "rows"):  # RowRodsState: de-permute by gid
                pos = np.asarray(jax.device_get(
                    self.sim.positions(state)))
                quat = np.asarray(jax.device_get(
                    self.sim.quaternions(state)))
            else:
                pos = np.asarray(jax.device_get(state.pos))
                quat = np.asarray(jax.device_get(state.quat))
            dd = self._init_fn(jax.random.PRNGKey(0), pos=pos, quat=quat)
            dd["key"] = jnp.asarray(jax.device_get(state.key))
            dd["step"] = jnp.asarray(int(state.step), jnp.int32)
            return dd
        if app == "lcp_spheres":
            dd = self._init_fn(jax.random.PRNGKey(0),
                               pos=np.asarray(jax.device_get(state.pos)))
            from jax.sharding import NamedSharding, PartitionSpec as P
            sh = NamedSharding(self.mesh, P(self.axis))
            dd["key"] = jax.device_put(
                jnp.asarray(_rep(state.key, d)), sh)
            dd["step"] = jax.device_put(
                jnp.asarray(np.full((d,), int(state.step), np.int32)), sh)
            return dd
        if app == "granular":
            return self._init_fn(np.asarray(jax.device_get(state.pos)),
                                 np.asarray(jax.device_get(state.vel)))
        raise AssertionError(app)

    # ------------------------------------------------------------------
    def _gather(self, dd, state, n_done: int):
        """Sharded dict -> updated app state (pos/step/overflow + per-app
        evolving fields); engine-internal fields stay in the dict."""
        app = self.app
        n_ovf = lambda: bool(np.any(np.asarray(  # noqa: E731
            jax.device_get(dd["overflow"]))))
        if app == "spheres":
            n = self.config.num_spheres
            gid = np.asarray(jax.device_get(dd["gid"])).reshape(-1)
            val = (np.asarray(jax.device_get(dd["valid"])).reshape(-1)
                   & (gid < n))
            pos = np.zeros((n, 3),
                           np.asarray(jax.device_get(dd["pos"])).dtype)
            pos[gid[val]] = np.asarray(
                jax.device_get(dd["pos"])).reshape(-1, 3)[val]
            pos = jnp.asarray(pos)
            return state.replace(
                pos=pos, ref_pos=pos, step=jnp.asarray(dd["step"]),
                overflow=jnp.asarray(n_ovf()))
        if app == "rods":
            n = self.config.num_rods
            gid = np.asarray(jax.device_get(dd["gid"])).reshape(-1)
            val = (np.asarray(jax.device_get(dd["valid"])).reshape(-1)
                   & (gid < n))
            pdt = np.asarray(jax.device_get(dd["pos"])).dtype
            pos = np.zeros((n, 3), pdt)
            quat = np.zeros((n, 4), pdt)
            quat[:, 0] = 1.0
            pos[gid[val]] = np.asarray(
                jax.device_get(dd["pos"])).reshape(-1, 3)[val]
            quat[gid[val]] = np.asarray(
                jax.device_get(dd["quat"])).reshape(-1, 4)[val]
            if hasattr(state, "rows"):
                # rebuild the wrapped sim's row layout from the flat state
                from mundy_tpu.neighbor.rows import build_rows
                rows = build_rows(jnp.asarray(pos, self.sim.dtype),
                                  jnp.arange(n, dtype=jnp.int32),
                                  self.sim.grid)
                quat_rows = self.sim._payload_to_rows(
                    jnp.asarray(quat, self.sim.dtype), rows)
                return state.replace(
                    rows=rows, quat=quat_rows,
                    step=jnp.asarray(dd["step"]),
                    overflow=jnp.asarray(n_ovf()
                                         | np.asarray(jax.device_get(
                                             rows.overflow)).any()))
            return state.replace(
                pos=jnp.asarray(pos), quat=jnp.asarray(quat),
                step=jnp.asarray(dd["step"]),
                overflow=jnp.asarray(n_ovf()))
        if app == "lcp_spheres":
            n = self.config.num_spheres
            gid = np.asarray(jax.device_get(dd["gid"])).reshape(-1)
            val = np.asarray(jax.device_get(dd["valid"])).reshape(-1)
            pos = np.zeros((n, 3),
                           np.asarray(jax.device_get(dd["pos"])).dtype)
            pos[gid[val]] = np.asarray(
                jax.device_get(dd["pos"])).reshape(-1, 3)[val]
            pos = jnp.asarray(pos)
            return state.replace(
                pos=pos, ref_pos=pos,
                step=jnp.asarray(int(np.max(np.asarray(
                    jax.device_get(dd["step"])))), jnp.int32),
                lcp_iters=jnp.asarray(int(np.max(np.asarray(
                    jax.device_get(dd["lcp_iters"])))), jnp.int32),
                overflow=jnp.asarray(n_ovf()))
        if app == "granular":
            pos, vel, ovf = self._gather_fn(dd)
            return state.replace(
                pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                ref_pos=jnp.asarray(pos),
                step=state.step + n_done, overflow=jnp.asarray(ovf))
        if app == "filaments":
            F, M = self.sim.F, self.sim.M
            pos = np.asarray(jax.device_get(dd["pos"])).reshape(F, M, 3)
            rod = state.rod.replace(
                edge_q=jnp.asarray(np.asarray(
                    jax.device_get(dd["rod_q"])).reshape(
                        state.rod.edge_q.shape)),
                tangent=jnp.asarray(np.asarray(
                    jax.device_get(dd["rod_t"])).reshape(
                        state.rod.tangent.shape)),
                length=jnp.asarray(np.asarray(
                    jax.device_get(dd["rod_l"])).reshape(
                        state.rod.length.shape)))
            return state.replace(
                pos=jnp.asarray(pos), rod=rod,
                step=jnp.asarray(int(np.max(np.asarray(
                    jax.device_get(dd["step"])))), jnp.int32),
                overflow=jnp.asarray(n_ovf()))
        if app == "chromatin":
            pos, xs, bt = self._gather_fn(dd)
            st = state.replace(
                pos=jnp.asarray(pos),
                step=jnp.asarray(int(np.max(np.asarray(
                    jax.device_get(dd["step"])))), jnp.int32),
                overflow=jnp.asarray(n_ovf()))
            if xs.size:
                xl = state.xl
                active = jnp.asarray(bt >= 0)
                indices = xl.indices.at[:, 1].set(
                    jnp.asarray(np.where(bt >= 0, bt, 0), xl.indices.dtype))
                fields = dict(xl.fields)
                fields["state"] = jnp.asarray(xs, xl.fields["state"].dtype)
                st = st.replace(xl=xl.replace(indices=indices,
                                              active=active,
                                              fields=fields))
            return st
        raise AssertionError(app)

    # ------------------------------------------------------------------
    def run_block(self, state, n_steps: int):
        if self._dict is None:
            self._dict = self._shard(state)
        self._dict = self._step_fn(self._dict, n_steps)
        out = self._gather(self._dict, state, n_steps)
        if bool(np.asarray(jax.device_get(out.overflow)).any()):
            # drop the sharded arrays; regrow re-shards from the gathered
            # state (engine-internal history restarts, as on a single-
            # device regrow rebuild)
            self._dict = None
        return out

    def regrow(self, state):
        """Grow the engine's static capacities and re-shard."""
        self._grow_attempts = getattr(self, "_grow_attempts", 0) + 1
        for attr, align in (("max_neighbors", 8), ("cell_capacity", 8)):
            if hasattr(self.config, attr):
                setattr(self.config, attr,
                        int(getattr(self.config, attr) * 1.5 + align - 1)
                        // align * align)
        self._dict = None
        self._build()
        return state.replace(overflow=jnp.asarray(False))
