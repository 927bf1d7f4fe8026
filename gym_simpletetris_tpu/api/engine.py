"""Standalone ``TetrisEngine`` + the public raster conversion functions.

The reference exposes three module-level entry points that user code imports
directly (not through the gym env):

- ``TetrisEngine(width, height, ...)`` — the tetrisRL-style engine class
  (tetris_env.py:125-335): construct, ``clear()``, ``step(action)`` ->
  (board_copy, reward, done), read ``.board``/``.anchor``/``.shape``/counters.
- ``convert_grayscale(board, size)`` (tetris_env.py:76-114) and
  ``convert_grayscale_rgb(array)`` (:117-122) — pure host functions over
  arbitrary arrays.

This module provides the same three names with identical observable behavior.
``TetrisEngine`` is backed by the batched JAX engine at B=1 (every transition
is the jitted ``core.engine.engine_step``), so its trajectories are bitwise
those of the vectorized framework; the conversion functions are pure numpy
over the same precomputed static geometry as the device raster
(``ops.raster.build_raster_maps``), so pixel-exactness is shared with the
device paths.

Documented differences from the reference (same policy as api/gym_compat.py):
- RNG: a keyword-only ``seed`` drives per-engine threefry instead of the
  global Python Mersenne Twister (the reference has no seeding API; callers
  had to use ``random.seed()``); ``injected_r`` hooks support oracle-parity
  replay of recorded reference draws.
- ``.board`` is a property returning a fresh (W, H) float copy of the packed
  device state (piece erased, like the reference's persistent board between
  steps). In-place element writes to the returned array don't write through;
  assign a whole array to ``.board`` instead (the setter re-packs it).
- ``.anchor`` reads back the int-coerced anchor (the reference stores the
  spawn x as the *float* width/2 until ``step`` coerces it at :244; every
  observable behavior uses the coerced value).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax

from ..core.config import EnvConfig
from ..core.pieces import PIECE_NAMES, OFFSETS
from ..ops.bitops import pack_board, unpack_board
from ..ops.raster import (BACKGROUND_SHADE, PIECE_SHADE, build_raster_maps)
from .env import TetrisVectorEnv
from .primitives import VALUE_ACTION_MAP

__all__ = ["TetrisEngine", "convert_grayscale", "convert_grayscale_rgb"]


def convert_grayscale(board, size: int) -> np.ndarray:
    """Rasterize a 2-D array into a ``size``x``size`` uint8 grayscale image —
    the reference's ``convert_grayscale`` (tetris_env.py:76-114), exactly:

    - the input is uint8-cast then transposed (:81-82), so image axis 0
      indexes the input's *second* axis (for (W, H) boards: image rows = y);
    - value semantics incl. the pass-through quirk (:96-97): 0 -> 128
      (background), 1 -> 190 (piece), any OTHER value becomes that pixel's
      shade verbatim (only 0 and 1 are remapped);
    - integer block/gap/padding geometry: gap = size//100 + 1, block =
      (size - 2*gap)//max(d0,d1) - gap, centering pad floor-halved (:87-94);
    - gaps render background (128), outer padding renders border (0).

    Raises ValueError where the reference's ``np.repeat``/``np.insert`` chain
    would produce malformed output (block size < 1 — board too large for
    ``size``).
    """
    arr = np.asarray(np.array(board, dtype=np.uint8).T)
    d0, d1 = arr.shape
    shades = np.where(arr == 0, np.uint8(BACKGROUND_SHADE),
                      np.where(arr == 1, np.uint8(PIECE_SHADE), arr))
    base, cellmap = build_raster_maps(d0, d1, size)
    flat = np.append(shades.astype(np.uint8).reshape(-1), np.uint8(0))
    img = np.where(cellmap < 0, base,
                   flat[np.where(cellmap < 0, d0 * d1, cellmap)])
    return img.astype(np.uint8)


def convert_grayscale_rgb(array) -> np.ndarray:
    """HxW -> HxWx3 channel triple (``convert_grayscale_rgb``,
    tetris_env.py:117-122), including its exact reshape semantics (the
    target shape is always ``(shape[0], shape[1], 1)``)."""
    array = np.asarray(array)
    shape = (array.shape[0], array.shape[1])
    grayscale = np.reshape(array, newshape=(*shape, 1))
    return np.repeat(grayscale, 3, axis=2)


class TetrisEngine:
    """Drop-in standalone engine with the reference ``TetrisEngine`` surface
    (tetris_env.py:125-335), backed by the batched JAX engine at B=1.

    Constructor signature and defaults match the reference positionally
    (:126-137). Before the first ``clear()`` the engine mirrors the
    reference's post-``__init__`` state: empty board, ``time == score == -1``,
    no piece (``anchor``/``shape``/``shape_name`` are None) and ``step()``
    raises (:165-172).
    """

    def __init__(self,
                 width,
                 height,
                 lock_delay=0,
                 step_reset=False,
                 reward_step=False,
                 penalise_height=False,
                 penalise_height_increase=False,
                 advanced_clears=False,
                 high_scoring=False,
                 penalise_holes=False,
                 penalise_holes_increase=False,
                 *,
                 seed: int = 0):
        self.width, self.height = width, height
        self.config = EnvConfig(
            width=width, height=height, obs_type="ram",
            reward_step=reward_step, penalise_height=penalise_height,
            penalise_height_increase=penalise_height_increase,
            advanced_clears=advanced_clears, high_scoring=high_scoring,
            penalise_holes=penalise_holes,
            penalise_holes_increase=penalise_holes_increase,
            lock_delay=lock_delay, step_reset=step_reset)
        # the reference's introspectable attributes (:141-162, :175-177)
        self._scoring = self.config.scoring_dict()
        self.value_action_map = dict(VALUE_ACTION_MAP)
        self.action_value_map = {v: k for k, v in self.value_action_map.items()}
        self.nb_actions = len(self.value_action_map)
        self._step_reset = step_reset

        self._venv = TetrisVectorEnv(self.config, batch_size=1)
        self._key = jax.random.PRNGKey(seed)
        self._state = None

    # -- engine API (tetris_env.py:243-335) -----------------------------------
    def step(self, action, injected_r: Optional[int] = None):
        """One transition: returns ``(board_copy, reward, done)`` where
        ``board_copy`` is the (W, H) float board with the active piece burned
        in (tetris_env.py:301-304)."""
        if self._state is None:
            # the reference dies coercing the None anchor (:244)
            raise TypeError("step() before clear(): no piece spawned yet "
                            "(the reference raises here too)")
        inj = None if injected_r is None else np.array([injected_r], np.int32)
        obs, self._state, reward, done, _ = self._venv.step(
            self._state, np.array([int(action)], np.int32), injected_r=inj)
        state = np.asarray(obs[0], dtype=float)
        return state, float(reward[0]), bool(done[0])

    def clear(self, injected_r: Optional[int] = None) -> np.ndarray:
        """Episode reset (tetris_env.py:306-315): zero the board and
        per-episode counters, spawn a piece; carries over the lock counter,
        ``n_deaths`` and ``shape_counts`` exactly like the reference.
        Returns the (empty) board."""
        inj = None if injected_r is None else np.array([injected_r], np.int32)
        if self._state is None:
            _, self._state = self._venv.reset(self._key, injected_r=inj)
        else:
            _, self._state = self._venv.soft_reset(self._state, injected_r=inj)
        return self.board

    def render(self) -> np.ndarray:
        """Board copy with the active piece burned in (tetris_env.py:317-321)."""
        if self._state is None:
            return self.board
        rows = self._venv.render_rows(self._state)
        return np.asarray(unpack_board(self.config, rows), dtype=float)[0]

    def get_info(self) -> dict:
        """The reference info dict (tetris_env.py:232-241); ``statistics`` is
        a fresh dict per call, not the live mutated object (:240-241 quirk)."""
        return {
            "time": self.time,
            "current_piece": self.shape_name,
            "score": self.score,
            "lines_cleared": self.lines_cleared,
            "holes": self.holes,
            "deaths": self.n_deaths,
            "statistics": self.shape_counts,
        }

    def valid_action_count(self) -> int:
        """Count of actions that would change (shape, anchor)
        (tetris_env.py:222-230)."""
        if self._state is None:
            raise TypeError("valid_action_count() before clear()")
        return int(self._venv.valid_action_count(self._state)[0])

    def seed(self, seed: int) -> None:
        """Reseed the engine RNG (fresh-engine semantics: the next ``clear()``
        behaves like a newly constructed engine with this seed). No reference
        counterpart — it had no seeding API at all (tetris_env.py:2,187)."""
        self._key = jax.random.PRNGKey(seed)
        self._state = None

    # -- reference attributes as properties over the packed state -------------
    @property
    def board(self) -> np.ndarray:
        """(W, H) float board indexed ``board[x, y]``, active piece erased —
        the persistent board between steps (tetris_env.py:140). A fresh copy;
        assign a whole array to write (the setter re-packs it)."""
        if self._state is None:
            return np.zeros((self.width, self.height), dtype=float)
        return np.asarray(
            unpack_board(self.config, self._state.rows), dtype=float)[0]

    @board.setter
    def board(self, value) -> None:
        if self._state is None:
            raise RuntimeError("cannot assign board before clear()")
        value = np.asarray(value)
        if value.shape != (self.width, self.height):
            raise ValueError(f"board shape {value.shape} != "
                             f"{(self.width, self.height)}")
        rows = pack_board(self.config, (value != 0)[None])  # [H,(NW,)1]
        self._state = self._state.replace(
            rows=jax.numpy.asarray(rows, dtype=jax.numpy.uint32))

    @property
    def anchor(self):
        if self._state is None:
            return None
        return (int(self._state.ax[0]), int(self._state.ay[0]))

    @property
    def shape(self):
        """Current piece offsets [(dx, dy), ...] at its current rotation
        (the reference mutates ``self.shape`` on rotation, :171,:245)."""
        if self._state is None:
            return None
        s = self._state
        return [tuple(c) for c in
                OFFSETS[int(s.piece[0]), int(s.rot[0])].tolist()]

    @property
    def shape_name(self):
        if self._state is None:
            return None
        return PIECE_NAMES[int(self._state.piece[0])]

    @property
    def shape_counts(self) -> dict:
        """Per-piece spawn counts as the reference's name-keyed dict (:181)."""
        if self._state is None:
            return {n: 0 for n in PIECE_NAMES}
        counts = np.asarray(self._state.shape_counts[:, 0])
        return {n: int(c) for n, c in zip(PIECE_NAMES, counts)}

    @property
    def time(self) -> int:
        return -1 if self._state is None else int(self._state.time[0])

    @property
    def score(self) -> int:
        return -1 if self._state is None else int(self._state.score[0])

    @property
    def holes(self) -> int:
        return 0 if self._state is None else int(self._state.holes[0])

    @property
    def lines_cleared(self) -> int:
        return 0 if self._state is None else int(self._state.lines_cleared[0])

    @property
    def piece_height(self) -> int:
        return 0 if self._state is None else int(self._state.piece_height[0])

    @property
    def n_deaths(self) -> int:
        return 0 if self._state is None else int(self._state.deaths[0])

    @property
    def _lock_delay(self) -> int:
        """The live lock-delay counter (reference attribute ``_lock_delay``,
        tetris_env.py:176) — read-only introspection."""
        return 0 if self._state is None else int(self._state.lock[0])

    def __repr__(self) -> str:
        """ASCII board with the piece burned in (tetris_env.py:329-335)."""
        b = self.render()
        s = "o" + "-" * self.width + "o\n"
        s += "\n".join(
            "|" + "".join("X" if b[x, y] else " "
                          for x in range(self.width)) + "|"
            for y in range(self.height))
        return s + "\no" + "-" * self.width + "o"
