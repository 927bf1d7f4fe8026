"""Device-mesh parallelism: shard the env batch over chips and hosts.

The reference is strictly single-process Python with no parallelism of any kind
(SURVEY.md §2.6); this module is the framework's scaling layer: a
``jax.sharding.Mesh`` over all devices, the env batch sharded along a
``"data"`` axis via ``NamedSharding``/``shard_map``, and metrics reduced with
XLA collectives (``psum``; NCCL over NVLink on GPUs). Multi-host launches use
``jax.distributed.initialize`` (multi-controller): each host drives its local
shard of the global batch.

The engine itself is purely elementwise over the batch, so sharding is
embarrassingly parallel — the value of this layer is (a) correct placement
(state born sharded, no host round-trips), (b) per-shard RNG decorrelation,
and (c) the collective plumbing that the DQN learner's gradient all-reduce
rides on (train/dqn.py).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import EnvConfig
from ..core import engine as E
from ..core.state import EnvState, init_state
from ..api.env import (build_observation, build_rollout, make_info, step_fn,
                       reset_fn)

DATA_AXIS = "data"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-controller init for multi-host pods (no-op on a single host when
    no coordinator is given). Call before any other JAX operation."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def make_data_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices: batch dim -> DATA_AXIS.
    Over several hosts it spans them; routing collectives is XLA's job."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (DATA_AXIS,))


def state_sharding(mesh: Mesh, cfg: EnvConfig = None) -> EnvState:
    """NamedSharding pytree matching EnvState's batch-minor layout: batch is the
    last axis of rows/shape_counts (rows carry a word axis for wide boards),
    the only axis of per-env scalars; the engine key is replicated."""
    def ns(spec):
        return NamedSharding(mesh, spec)
    nw = 1 if cfg is None else cfg.num_words
    rows_spec = ns(P(None, DATA_AXIS) if nw == 1 else P(None, None, DATA_AXIS))
    batch_last = ns(P(None, DATA_AXIS))
    vec = ns(P(DATA_AXIS))
    rep = ns(P())
    return EnvState(
        rows=rows_spec, piece=vec, rot=vec, ax=vec, ay=vec, lock=vec,
        time=vec, score=vec, holes=vec, lines_cleared=vec, piece_height=vec,
        deaths=vec, shape_counts=batch_last, key=rep)


def obs_sharding(mesh: Mesh, cfg: EnvConfig) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))  # obs is batch-major


class ShardedTetrisEnv:
    """TetrisVectorEnv with the batch sharded over a device mesh.

    Uses jit + NamedSharding constraints (the idiomatic pjit path): XLA keeps
    every per-env computation local to the shard; nothing communicates except
    user-requested metric reductions. ``global_batch`` must divide by the mesh
    size.

    >>> mesh = make_data_mesh()
    >>> env = ShardedTetrisEnv(EnvConfig(auto_reset=True), 4096 * len(jax.devices()), mesh)
    >>> obs, state = env.reset(jax.random.PRNGKey(0))
    >>> obs, state, rew, done, info = env.step(state, actions)
    """

    def __init__(self, config: EnvConfig, global_batch: int, mesh: Mesh = None):
        self.config = config
        self.mesh = mesh if mesh is not None else make_data_mesh()
        n = self.mesh.size
        if global_batch % n:
            raise ValueError(f"global_batch {global_batch} % mesh size {n} != 0")
        self.global_batch = global_batch
        cfg = config
        sh_state = state_sharding(self.mesh, cfg)
        sh_obs = obs_sharding(self.mesh, cfg)
        sh_vec = NamedSharding(self.mesh, P(DATA_AXIS))

        self._reset = jax.jit(
            lambda key: reset_fn(cfg, global_batch, key),
            out_shardings=(sh_obs, sh_state))
        self._step = jax.jit(
            lambda s, a: step_fn(cfg, s, a),
            in_shardings=(sh_state, sh_vec),
            out_shardings=(sh_obs, sh_state, sh_vec, sh_vec, None),
            donate_argnums=(0,))

        self._rollout = jax.jit(
            build_rollout(cfg, global_batch, self.obs_shape),
            in_shardings=(sh_state, NamedSharding(self.mesh, P(None, DATA_AXIS))),
            donate_argnums=(0,))

    @property
    def obs_shape(self) -> Tuple[int, ...]:
        from ..api import spaces
        return spaces.observation_space(self.config).shape

    def reset(self, key):
        return self._reset(key)

    def step(self, state, action):
        return self._step(state, action)

    def rollout(self, state, actions):
        return self._rollout(state, actions)


def shard_map_step(cfg: EnvConfig, mesh: Mesh):
    """Explicit shard_map variant of the batched step, for users who want
    manual SPMD control (and the pattern the learner's psum rides on).

    Per-shard RNG decorrelation: the engine key is replicated, so each shard
    folds its DATA_AXIS index into the key before stepping — without this every
    shard would draw identical piece streams.
    """
    from jax import shard_map

    def local_step(state: EnvState, action: jnp.ndarray):
        idx = jax.lax.axis_index(DATA_AXIS)
        local = state.replace(
            key=jax.random.key_data(
                jax.random.fold_in(jax.random.wrap_key_data(state.key), idx)
            ).astype(jnp.uint32))
        out = E.engine_step(cfg, local, action)
        # keep the carried key replicated: every shard advanced identically
        # from the pre-fold key, so re-derive from the original
        new_key = jax.random.key_data(
            jax.random.split(jax.random.wrap_key_data(state.key))[0]
        ).astype(jnp.uint32)
        st = out.state.replace(key=new_key)
        obs = build_observation(cfg, out.emitted_rows)
        # example cross-shard collective: global episode metrics
        finished = jax.lax.psum(out.done.sum(), DATA_AXIS)
        return obs, st, out.reward, out.done, finished

    batch_last = P(None, DATA_AXIS)
    rows_spec = (batch_last if cfg.num_words == 1
                 else P(None, None, DATA_AXIS))
    vec = P(DATA_AXIS)
    state_spec = EnvState(
        rows=rows_spec, piece=vec, rot=vec, ax=vec, ay=vec, lock=vec,
        time=vec, score=vec, holes=vec, lines_cleared=vec, piece_height=vec,
        deaths=vec, shape_counts=batch_last, key=P())
    return shard_map(
        local_step, mesh=mesh,
        in_specs=(state_spec, vec),
        out_specs=(vec, state_spec, vec, vec, P()),
        check_vma=False)


def _aggregate_metrics_fn(s: EnvState):
    return {
        "total_deaths": s.deaths.sum(),
        "total_lines": s.lines_cleared.sum(),
        "mean_score": s.score.mean(),
        "mean_holes": s.holes.mean(),
        "env_steps": s.time.sum(),
    }


_aggregate_metrics = jax.jit(_aggregate_metrics_fn)
_aggregate_by_mesh = {}


def global_metrics(state: EnvState, mesh: Mesh = None) -> dict:
    """Cross-host/chip aggregate episode metrics via one jitted reduction.
    With ``mesh``, the outputs are pinned replicated on it (the reductions
    then run as collectives over the sharded state); without, jit
    infers the same from the state's shardings. One executable per mesh."""
    if mesh is not None:
        fn = _aggregate_by_mesh.get(mesh)
        if fn is None:
            fn = jax.jit(_aggregate_metrics_fn,
                         out_shardings=NamedSharding(mesh, P()))
            _aggregate_by_mesh[mesh] = fn
        return dict(fn(state))
    return dict(_aggregate_metrics(state))
