"""Functional batched environment API (the framework's main entry point).

Design follows the functional-RL-env idiom (gymnax-style) rather than the
reference's mutable ``gym.Env`` object (tetris_env.py:338-467): state is an
explicit pytree, ``reset``/``step`` are pure jitted functions, and the batch
dimension is first-class (shardable over a device mesh — see ``parallel/``).

Semantics per step/reset match the reference exactly (see core/engine.py);
observation conversion matches ``TetrisEnv._observation`` (tetris_env.py:413-433)
including the float32 cast (:400) and the empty-board reset observation (:405-411).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.config import EnvConfig
from ..core import engine as E
from ..core.pieces import PIECE_NAMES
from ..core.state import EnvState, init_state
from ..ops.bitops import unpack_rows, unpack_board
from ..ops.raster import rasterize, grayscale_to_rgb
from . import spaces


def storage_obs_shape(cfg: EnvConfig) -> tuple:
    """Per-env shape of the canonical storage observation (see below)."""
    if cfg.obs_type == "ram":
        return (cfg.width, cfg.height)
    return (84, 84)


def build_observation_storage(cfg: EnvConfig,
                              emitted_rows: jnp.ndarray) -> jnp.ndarray:
    """Packed board rows uint32[H, B] (piece burned in) -> canonical storage
    observation, always uint8:

    ram:            [B, W, H] 0/1 (board[x, y] orientation, tetris_env.py:421)
    grayscale/rgb:  [B, 84, 84] values {0, 128, 190} (:426-431)

    This is the only tensor the per-step pipeline materializes; the delivered
    observation (``obs_from_storage``) is an exact elementwise view of it
    (dtype cast, rgb channel broadcast, extend_dims axis) that XLA fuses into
    whatever consumes the observation — a replay-buffer write, a conv stem, or
    the bench accumulator. Producing uint8 and casting at the consumer (rather
    than materializing a float32 image, 4x the bytes, or a channel-tripled rgb
    tensor, 3x) keeps the image observation's memory traffic at one byte per
    pixel.
    """
    if cfg.obs_type == "ram":
        return unpack_board(cfg, emitted_rows, dtype=jnp.uint8)   # [B, W, H]
    cells = unpack_rows(cfg, emitted_rows, dtype=jnp.uint8)       # [B, H, W]
    return rasterize(cells, cfg.height, cfg.width, 84,
                     impl=cfg.resolved_raster_impl)


def obs_from_storage(cfg: EnvConfig, storage: jnp.ndarray) -> jnp.ndarray:
    """Storage observation -> the observation the API delivers.

    Exact, lazy elementwise ops only: the float32 cast (reference parity,
    tetris_env.py:400; {0,1} and {0,128,190} are exact in f32), the rgb
    channel triple as a broadcast (``convert_grayscale_rgb``, :117-122 — a
    repeat of identical values, so a broadcast view is value-identical without
    3x the HBM traffic), and the extend_dims trailing axis (:424, :431).
    """
    dt = jnp.float32 if cfg.obs_dtype == "float32" else jnp.uint8
    obs = storage.astype(dt)
    if cfg.obs_type == "rgb":
        return jnp.broadcast_to(obs[..., None], obs.shape + (3,))
    return obs[..., None] if cfg.extend_dims else obs


def build_observation(cfg: EnvConfig, emitted_rows: jnp.ndarray) -> jnp.ndarray:
    """Packed board rows uint32[H, B] -> delivered obs per cfg.obs_type
    (``TetrisEnv._observation``, tetris_env.py:413-433). Composition of
    ``build_observation_storage`` and ``obs_from_storage``."""
    return obs_from_storage(cfg, build_observation_storage(cfg, emitted_rows))


def _select_done(done: jnp.ndarray, new: EnvState, old: EnvState) -> EnvState:
    """Per-env select over the state pytree (batch-minor aware): batch is the
    last axis of rows/shape_counts (rows may carry a word axis for wide
    boards), the only axis of per-env scalars, and the engine key is global
    (the advanced key is kept unconditionally)."""
    last = lambda n, o: jnp.where(
        done.reshape((1,) * (n.ndim - 1) + (-1,)), n, o)
    vec = lambda n, o: jnp.where(done, n, o)
    return old.replace(
        rows=last(new.rows, old.rows),
        piece=vec(new.piece, old.piece),
        rot=vec(new.rot, old.rot),
        ax=vec(new.ax, old.ax),
        ay=vec(new.ay, old.ay),
        lock=vec(new.lock, old.lock),
        time=vec(new.time, old.time),
        score=vec(new.score, old.score),
        holes=vec(new.holes, old.holes),
        lines_cleared=vec(new.lines_cleared, old.lines_cleared),
        piece_height=vec(new.piece_height, old.piece_height),
        deaths=vec(new.deaths, old.deaths),
        shape_counts=last(new.shape_counts, old.shape_counts),
        key=new.key,
    )


def apply_reset_mask(cfg: EnvConfig, state: EnvState, emitted: jnp.ndarray,
                     mask: jnp.ndarray):
    """Episode-reset the envs selected by ``mask`` (bool[B]): their state is
    clear()ed (carry-over semantics) and their emitted board becomes the empty
    reset board. Shared by auto_reset (mask = done) and the gymnasium
    next-step-autoreset adapter (mask = pending-from-last-step)."""
    cleared_state, cleared_rows = E.engine_clear(cfg, state)
    new_state = _select_done(mask, cleared_state, state)
    mask_r = mask.reshape((1,) * (emitted.ndim - 1) + (-1,))
    return new_state, jnp.where(mask_r, cleared_rows, emitted)


def reset_fn(cfg: EnvConfig, batch_size: int, key,
             injected_r: Optional[jnp.ndarray] = None
             ) -> Tuple[jnp.ndarray, EnvState]:
    """Fresh engine + episode reset. The observation is the *empty* board —
    the reference's reset returns the board before the spawned piece is burned
    in (tetris_env.py:313-315, :405-411)."""
    state = init_state(cfg, batch_size, key)
    state, emitted = E.engine_clear(cfg, state, injected_r=injected_r)
    return build_observation(cfg, emitted), state


def soft_reset_fn(cfg: EnvConfig, state: EnvState,
                  injected_r: Optional[jnp.ndarray] = None):
    """Episode reset that carries over lock counter / deaths / shape counts,
    exactly like ``TetrisEngine.clear`` (tetris_env.py:306-315)."""
    state, emitted = E.engine_clear(cfg, state, injected_r=injected_r)
    return build_observation(cfg, emitted), state


def step_fn(cfg: EnvConfig, state: EnvState, action: jnp.ndarray,
            injected_r: Optional[jnp.ndarray] = None):
    """One batched transition. Returns (obs, state, reward, done, info).

    With ``cfg.auto_reset``, envs that died are re-cleared in the same call and
    their observation is the reset observation (empty board); reward/done still
    report the terminal transition.
    """
    out = E.engine_step(cfg, state, action, injected_r=injected_r)
    new_state, emitted = out.state, out.emitted_rows
    if cfg.auto_reset:
        new_state, emitted = apply_reset_mask(cfg, new_state, emitted,
                                              out.done)
    obs = build_observation(cfg, emitted)
    info = make_info(new_state)
    # lines cleared THIS step, computed before the auto-reset mask zeroes the
    # per-episode counter (tetris_env.py:307-311): without it, lines cleared
    # on a death step — and any episode's final count under auto_reset — are
    # unrecoverable from the reset-masked ``info["lines_cleared"]``. Additive
    # key (the reference's get_info has no per-step delta, tetris_env.py:232).
    info["lines_delta"] = out.state.lines_cleared - state.lines_cleared
    return obs, new_state, out.reward, out.done, info


def make_info(state: EnvState) -> dict:
    """Batched analog of ``get_info`` (tetris_env.py:232-241): same keys, arrays
    over the batch; ``current_piece`` is an int id into PIECE_NAMES; the
    ``statistics`` live-dict aliasing quirk becomes a plain int32[B, 7] copy."""
    return {
        "time": state.time,
        "current_piece": state.piece,
        "score": state.score,
        "lines_cleared": state.lines_cleared,
        "holes": state.holes,
        "deaths": state.deaths,
        "statistics": state.shape_counts.T,  # [B, 7], batch-major for consumers
    }


def build_rollout(cfg: EnvConfig, batch_size: int, obs_shape=None,
                  with_obs: bool = True, acc_mode: str = "storage",
                  unroll: int = 4):
    """Scan-fused multi-step rollout builder shared by the local and sharded
    envs. Returns a function (state, actions[T, B]) ->
    (final_state, obs_acc, reward[T, B], done[T, B]).

    ``with_obs=True`` renders the observation every step and folds it into an
    accumulator, keeping the full observation pipeline live under XLA's DCE
    (an accumulator is updated in place across loop iterations; a
    carry-replace buffer would copy every step).

    ``acc_mode`` selects what is accumulated:
      "storage"   (default, the deployment shape): the canonical uint8 storage
                  observation — exactly what a replay buffer stores or a conv
                  stem reads; the delivered-dtype cast / rgb broadcast are
                  fused into the consumer and never hit HBM.
      "delivered": the full delivered observation in cfg.obs_dtype, rgb
                  channels materialized (bench.py --acc delivered).

    ``with_obs=False`` runs the bare engine. ``obs_shape`` is only used for
    acc_mode="delivered" (defaults to the delivered space shape). ``unroll``
    is forwarded to ``lax.scan`` (several steps per loop iteration, so the
    loop's own bookkeeping runs less often).
    """

    def rollout(s, acts):
        def body(carry, a):
            st, acc = carry
            if acc_mode == "storage":
                out = E.engine_step(cfg, st, a)
                st, emitted = out.state, out.emitted_rows
                if cfg.auto_reset:
                    st, emitted = apply_reset_mask(cfg, st, emitted, out.done)
                if with_obs:
                    acc = acc + build_observation_storage(cfg, emitted)
                return (st, acc), (out.reward, out.done)
            obs, st, r, d, _ = step_fn(cfg, st, a)
            if with_obs:
                acc = acc + obs
            return (st, acc), (r, d)

        if acc_mode == "storage":
            obs0 = jnp.zeros((batch_size,) + storage_obs_shape(cfg),
                             dtype=jnp.uint8)
        else:
            acc_dtype = jnp.float32 if cfg.obs_dtype == "float32" else jnp.uint8
            shape = obs_shape
            if shape is None:
                shape = spaces.observation_space(cfg).shape
            obs0 = jnp.zeros((batch_size,) + tuple(shape), dtype=acc_dtype)
        (final, acc), (rew, done) = jax.lax.scan(body, (s, obs0), acts,
                                                 unroll=unroll)
        return final, acc, rew, done

    return rollout


class TetrisVectorEnv:
    """Batched device-native SimpleTetris. All methods are jit-compiled per
    (config, batch_size); state is explicit and device-resident.

    >>> env = TetrisVectorEnv(EnvConfig(obs_type="ram"), batch_size=4096)
    >>> obs, state = env.reset(jax.random.PRNGKey(0))
    >>> obs, state, reward, done, info = env.step(state, actions)
    """

    PIECE_NAMES = PIECE_NAMES

    def __init__(self, config: EnvConfig = EnvConfig(), batch_size: int = 1):
        self.config = config
        self.batch_size = batch_size
        self.observation_space = spaces.observation_space(config)
        self.action_space = spaces.action_space()
        cfg = config
        self._reset = jax.jit(lambda key: reset_fn(cfg, batch_size, key))
        self._reset_inj = jax.jit(
            lambda key, r: reset_fn(cfg, batch_size, key, injected_r=r))
        self._step = jax.jit(lambda s, a: step_fn(cfg, s, a))
        self._step_inj = jax.jit(lambda s, a, r: step_fn(cfg, s, a, injected_r=r))
        self._soft_reset = jax.jit(lambda s: soft_reset_fn(cfg, s))
        self._soft_reset_inj = jax.jit(lambda s, r: soft_reset_fn(cfg, s, r))
        self._render = jax.jit(lambda s: E.render_rows(cfg, s))
        self._vac = jax.jit(lambda s: E.valid_action_count(cfg, s))
        self._rollout_jit = {}

    # -- core API ---------------------------------------------------------------
    def reset(self, key, injected_r=None):
        if injected_r is None:
            return self._reset(key)
        return self._reset_inj(key, jnp.asarray(injected_r))

    def step(self, state: EnvState, action, injected_r=None):
        if injected_r is None:
            return self._step(state, jnp.asarray(action))
        return self._step_inj(state, jnp.asarray(action), jnp.asarray(injected_r))

    def soft_reset(self, state: EnvState, injected_r=None):
        if injected_r is None:
            return self._soft_reset(state)
        return self._soft_reset_inj(state, jnp.asarray(injected_r))

    # -- aux --------------------------------------------------------------------
    def render_rows(self, state: EnvState) -> jnp.ndarray:
        """Packed board with active piece burned in (TetrisEngine.render)."""
        return self._render(state)

    def valid_action_count(self, state: EnvState) -> jnp.ndarray:
        return self._vac(state)

    def rollout(self, state: EnvState, actions: jnp.ndarray,
                with_obs: bool = True, acc_mode: str = "storage"):
        """Scan ``T`` pre-chosen action batches: actions int32[T, B].

        Returns (final_state, obs_acc, reward[T, B], done[T, B]).

        ``with_obs=True`` renders the observation every step and folds it into
        an accumulator, keeping the full observation pipeline live under XLA's
        DCE — this is what the throughput bench measures. ``acc_mode`` picks
        the accumulated tensor: "storage" (canonical uint8 obs, the deployment
        shape) or "delivered" (cfg.obs_dtype, rgb materialized) — see
        ``build_rollout``. ``with_obs=False`` benches the bare engine.
        Use cfg.auto_reset for horizons past episode ends.
        """
        cfg = self.config

        fn = self._rollout_jit.get((with_obs, acc_mode))
        if fn is None:
            fn = jax.jit(build_rollout(cfg, self.batch_size,
                                       self.observation_space.shape, with_obs,
                                       acc_mode=acc_mode))
            self._rollout_jit[(with_obs, acc_mode)] = fn
        return fn(state, jnp.asarray(actions))
