"""Lockstep check of the JAX engine against the native C++ oracle.

The oracle plays ``B`` games of ``T`` steps with its own RNG and records every
draw it made (:func:`drive_oracle`); the JAX engine replays the same actions
with those draws injected, on whatever device JAX runs on
(:func:`replay_engine`); :func:`assert_lockstep` then requires boards,
rewards, dones and the cross-episode carry-over state to agree bitwise.
``tools/soak_fuzz.py``, the render fuzz test and ``chip_smoke.py`` all drive
the oracle through these functions, so every engine flag reaches both sides.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..api.env import _select_done
from ..core import engine as E
from ..core.config import EnvConfig
from ..core.state import init_state
from ..ops.bitops import unpack_board
from . import drive_many

# every EnvConfig field the oracle takes besides width/height
FLAG_KEYS = ("lock_delay", "step_reset", "reward_step", "penalise_height",
             "penalise_height_increase", "advanced_clears", "high_scoring",
             "penalise_holes", "penalise_holes_increase")


def drive_oracle(cfg: EnvConfig, actions: np.ndarray, seeds) -> dict:
    """Play ``actions`` int[T, B] in the oracle, one game per column."""
    return drive_many(np.asarray(actions).T, np.asarray(seeds, np.uint64),
                      width=cfg.width, height=cfg.height,
                      **{k: getattr(cfg, k) for k in FLAG_KEYS})


def replay_engine(cfg: EnvConfig, actions, oracle: dict, key):
    """Replay the oracle's games in the JAX engine (one jitted scan; a death
    re-clears the env with the oracle's recorded clear() draw).

    Returns (final_state, emitted_rows[T, ...], reward[T, B], done[T, B])."""
    b = np.asarray(actions).shape[1]
    state = init_state(cfg, b, key)
    state, _ = jax.jit(lambda s, r: E.engine_clear(cfg, s, injected_r=r))(
        state, jnp.asarray(oracle["r0"]))

    def body(st, xs):
        a, r_step, r_clear = xs
        o = E.engine_step(cfg, st, a, injected_r=r_step)
        cleared, _ = E.engine_clear(cfg, o.state, injected_r=r_clear)
        return (_select_done(o.done, cleared, o.state),
                (o.emitted_rows, o.reward, o.done))

    xs = (jnp.asarray(actions, jnp.int32), jnp.asarray(oracle["r_step"].T),
          jnp.asarray(oracle["r_clear"].T))
    final, (emitted, reward, done) = jax.jit(
        lambda s, x: jax.lax.scan(body, s, x))(state, xs)
    return final, emitted, reward, done


def assert_lockstep(cfg: EnvConfig, oracle: dict, final, emitted, reward,
                    done) -> None:
    """Bitwise agreement of a :func:`replay_engine` run with the oracle."""
    boards = np.asarray(jax.vmap(
        lambda e: unpack_board(cfg, e, dtype=jnp.uint8))(emitted))
    np.testing.assert_array_equal(
        boards, np.transpose(oracle["boards"], (1, 0, 2, 3)),
        err_msg=f"boards cfg={cfg}")
    np.testing.assert_array_equal(np.asarray(reward), oracle["rewards"].T,
                                  err_msg=f"rewards cfg={cfg}")
    np.testing.assert_array_equal(np.asarray(done).astype(np.uint8),
                                  oracle["dones"].T, err_msg=f"dones cfg={cfg}")
    np.testing.assert_array_equal(np.asarray(final.deaths), oracle["deaths"],
                                  err_msg=f"deaths cfg={cfg}")
    np.testing.assert_array_equal(np.asarray(final.shape_counts).T,
                                  oracle["counts"], err_msg=f"counts cfg={cfg}")
