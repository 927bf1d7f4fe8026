"""Functional wrappers over the batched env: frame stacking and episode stats.

The reference ships no wrappers (agents stacked frames externally); these are
the standard RL conveniences, kept functional/jittable like the env itself.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass
from .env import TetrisVectorEnv


@pytree_dataclass
class FrameStackState:
    env_state: object
    frames: jnp.ndarray   # [B, *obs, K]


class FrameStack:
    """Stack the last K observations on a trailing axis (channel-last, the
    layout NatureDQN consumes). Works for any obs_type; reset repeats the
    first observation K times."""

    def __init__(self, env: TetrisVectorEnv, k: int = 4):
        self.env = env
        self.k = k

    def reset(self, key):
        obs, state = self.env.reset(key)
        frames = jnp.repeat(obs[..., None], self.k, axis=-1)
        return frames, FrameStackState(state, frames)

    def step(self, fs_state: FrameStackState, action):
        obs, state, reward, done, info = self.env.step(fs_state.env_state,
                                                       action)
        frames = jnp.concatenate(
            [fs_state.frames[..., 1:], obs[..., None]], axis=-1)
        # on auto-reset boundaries, restart the stack from the reset obs
        if self.env.config.auto_reset:
            d = done.reshape(done.shape + (1,) * (frames.ndim - 1))
            frames = jnp.where(
                d, jnp.repeat(obs[..., None], self.k, axis=-1), frames)
        return frames, FrameStackState(state, frames), reward, done, info


@pytree_dataclass
class EpisodeStatsState:
    env_state: object
    ep_return: jnp.ndarray     # float32[B] running return
    ep_length: jnp.ndarray     # int32[B]
    last_return: jnp.ndarray   # float32[B] return of last finished episode
    last_length: jnp.ndarray   # int32[B]
    episodes: jnp.ndarray      # int32[B]
    ep_lines: jnp.ndarray      # int32[B] lines cleared this episode
    last_lines: jnp.ndarray    # int32[B] lines of last finished episode
    total_lines: jnp.ndarray   # int32[B] lines cleared across ALL episodes
    #   (accumulated from info["lines_delta"], so lines cleared on a death
    #   step and past auto-resets are counted — the raw env_state counter
    #   only covers the in-progress episode)


class EpisodeStats:
    """Track per-env episode returns/lengths (requires auto_reset)."""

    def __init__(self, env: TetrisVectorEnv):
        if not env.config.auto_reset:
            raise ValueError("EpisodeStats requires auto_reset=True")
        self.env = env

    def reset(self, key):
        obs, state = self.env.reset(key)
        b = self.env.batch_size
        z = jnp.zeros((b,), jnp.float32)
        zi = jnp.zeros((b,), jnp.int32)
        return obs, EpisodeStatsState(state, z, zi, z, zi, zi, zi, zi, zi)

    def step(self, es: EpisodeStatsState, action):
        obs, state, reward, done, info = self.env.step(es.env_state, action)
        ret = es.ep_return + reward
        length = es.ep_length + 1
        lines = es.ep_lines + info["lines_delta"]
        new = EpisodeStatsState(
            env_state=state,
            ep_return=jnp.where(done, 0.0, ret),
            ep_length=jnp.where(done, 0, length),
            last_return=jnp.where(done, ret, es.last_return),
            last_length=jnp.where(done, length, es.last_length),
            episodes=es.episodes + done.astype(jnp.int32),
            ep_lines=jnp.where(done, 0, lines),
            last_lines=jnp.where(done, lines, es.last_lines),
            total_lines=es.total_lines + info["lines_delta"])
        info = dict(info, episode_return=new.last_return,
                    episode_length=new.last_length, episodes=new.episodes,
                    episode_lines=new.last_lines)
        return obs, new, reward, done, info
