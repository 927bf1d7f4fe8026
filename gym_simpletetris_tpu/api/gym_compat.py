"""Single-env, old-gym-API compatibility shim.

Mirrors the reference ``TetrisEnv`` surface exactly (tetris_env.py:338-467):
4-tuple ``step`` -> (obs, reward, done, info), ``reset(return_info=False)``,
``render(mode='human'|'rgb_array')`` (pygame window at 512px / 8fps cap, or a
(160,160,3) array), ``close()``, and the same constructor kwargs — but backed by
the batched JAX engine at B=1 with numpy I/O, so a user of the reference can
switch imports and keep their agent loop unchanged.

Differences (documented, not silent):
- RNG: a ``seed`` kwarg drives per-env threefry instead of the global Python
  Mersenne Twister (the reference has no seeding API at all — callers had to
  call ``random.seed()``); an ``injected_r`` hook supports oracle-parity replay.
- ``info['statistics']`` is a fresh dict per call, not the engine's live,
  mutated dict object (reference quirk, tetris_env.py:240-241).
- Out-of-range actions act as no-ops instead of raising KeyError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import EnvConfig
from ..core.pieces import PIECE_NAMES
from ..ops.bitops import unpack_board
from ..ops.raster import rasterize, grayscale_to_rgb
from .env import TetrisVectorEnv
from . import spaces


class _EngineView:
    """Read-only adapter exposing reference-TetrisEngine attribute names
    (tetris_env.py:125-181) over the packed batched state."""

    def __init__(self, env: "TetrisEnv"):
        self._env = env

    def _s(self):
        if self._env._state is None:
            raise RuntimeError("engine state unavailable before reset()")
        return self._env._state

    @property
    def board(self) -> np.ndarray:
        """(W, H) float board, piece erased — the persistent board between
        steps, exactly like the reference's ``engine.board``."""
        return np.asarray(
            unpack_board(self._env.config, self._s().rows)[0], dtype=float)

    @property
    def anchor(self):
        s = self._s()
        return (int(s.ax[0]), int(s.ay[0]))

    @property
    def shape_name(self) -> str:
        return PIECE_NAMES[int(self._s().piece[0])]

    @property
    def shape(self):
        """Current piece offsets [(dx, dy), ...] at its current rotation."""
        from ..core.pieces import OFFSETS
        s = self._s()
        return [tuple(c) for c in
                OFFSETS[int(s.piece[0]), int(s.rot[0])].tolist()]

    @property
    def shape_counts(self) -> dict:
        counts = np.asarray(self._s().shape_counts[:, 0])
        return {n: int(c) for n, c in zip(PIECE_NAMES, counts)}

    @property
    def time(self) -> int:
        return int(self._s().time[0])

    @property
    def score(self) -> int:
        return int(self._s().score[0])

    @property
    def holes(self) -> int:
        return int(self._s().holes[0])

    @property
    def lines_cleared(self) -> int:
        return int(self._s().lines_cleared[0])

    @property
    def n_deaths(self) -> int:
        return int(self._s().deaths[0])

    @property
    def width(self) -> int:
        return self._env.width

    @property
    def height(self) -> int:
        return self._env.height

    def valid_action_count(self) -> int:
        return self._env.valid_action_count()

    def render(self) -> np.ndarray:
        """Board copy with the piece burned in (tetris_env.py:317-321)."""
        return self._env._board().astype(float)

    def get_info(self) -> dict:
        return self._env._get_info()


class TetrisEnv:
    """Drop-in, old-gym-API SimpleTetris backed by the batched JAX engine."""

    metadata = {"render.modes": ["human", "rgb_array"], "render_fps": 8}

    def __init__(self,
                 width=10,
                 height=20,
                 obs_type="ram",
                 extend_dims=False,
                 render_mode="rgb_array",
                 reward_step=False,
                 penalise_height=False,
                 penalise_height_increase=False,
                 advanced_clears=False,
                 high_scoring=False,
                 penalise_holes=False,
                 penalise_holes_increase=False,
                 lock_delay=0,
                 step_reset=False,
                 seed: int = 0):
        self.config = EnvConfig(
            width=width, height=height, obs_type=obs_type,
            extend_dims=extend_dims, render_mode=render_mode,
            reward_step=reward_step, penalise_height=penalise_height,
            penalise_height_increase=penalise_height_increase,
            advanced_clears=advanced_clears, high_scoring=high_scoring,
            penalise_holes=penalise_holes,
            penalise_holes_increase=penalise_holes_increase,
            lock_delay=lock_delay, step_reset=step_reset)
        self.width, self.height = width, height
        self.obs_type, self.extend_dims = obs_type, extend_dims
        self.render_mode = render_mode
        self.window_size = 512

        self._venv = TetrisVectorEnv(self.config, batch_size=1)
        self._key = jax.random.PRNGKey(seed)
        self._state = None
        self.action_space = spaces.action_space()
        self.observation_space = spaces.observation_space(self.config)
        self.window = None
        self.clock = None
        # engine attribute parity (tetris_env.py:152-162): the maps hold the
        # movement-primitive FUNCTION OBJECTS like the reference's (user code
        # calls them / inverts the map); see api/primitives.py
        from .primitives import VALUE_ACTION_MAP
        self.value_action_map = dict(VALUE_ACTION_MAP)
        self.action_value_map = {v: k for k, v in self.value_action_map.items()}
        self.nb_actions = len(self.value_action_map)

    # -- gym API ----------------------------------------------------------------
    def reset(self, return_info: bool = False, injected_r: Optional[int] = None):
        inj = None if injected_r is None else np.array([injected_r], np.int32)
        if self._state is None:
            obs, self._state = self._venv.reset(self._key, injected_r=inj)
        else:
            # episode reset on a live engine: carry-over semantics (clear())
            obs, self._state = self._venv.soft_reset(self._state, injected_r=inj)
        obs = np.asarray(obs[0], dtype=np.float32)
        return (obs, self._get_info()) if return_info else obs

    def step(self, action, injected_r: Optional[int] = None):
        if self._state is None:
            raise RuntimeError("step() before reset()")
        inj = None if injected_r is None else np.array([injected_r], np.int32)
        obs, self._state, reward, done, _ = self._venv.step(
            self._state, np.array([int(action)], np.int32), injected_r=inj)
        obs = np.asarray(obs[0], dtype=np.float32)
        return obs, float(reward[0]), bool(done[0]), self._get_info()

    def _get_info(self):
        s = self._state
        counts = np.asarray(s.shape_counts[:, 0])
        return {
            "time": int(s.time[0]),
            "current_piece": PIECE_NAMES[int(s.piece[0])],
            "score": int(s.score[0]),
            "lines_cleared": int(s.lines_cleared[0]),
            "holes": int(s.holes[0]),
            "deaths": int(s.deaths[0]),
            "statistics": {n: int(c) for n, c in zip(PIECE_NAMES, counts)},
        }

    def seed(self, seed: int) -> None:
        """Reseed the env RNG in place (fresh-engine semantics: the next
        ``reset()`` behaves like a newly constructed env with this seed).
        Does NOT rebuild the env, so jitted executables are reused — no
        recompilation (the reference has no seeding API at all; callers had
        to use ``random.seed()``, tetris_env.py:2,187)."""
        self._key = jax.random.PRNGKey(seed)
        self._state = None

    def _observation(self, mode=None, state=None, extend_dims=None):
        """Observation conversion hook, mirroring the reference's de-facto
        "render the board as a different obs type" API
        (``TetrisEnv._observation``, tetris_env.py:413-433): ``state`` is a
        (W, H) board (defaults to the live board with the active piece burned
        in, like ``engine.render()``); ``mode``/``extend_dims`` default to the
        env's own. Returns the raw converted array (float board for ram,
        uint8 {0,128,190} image for grayscale/rgb) exactly like the
        reference — the float32 cast there happens in step/reset, not here.
        """
        from .engine import convert_grayscale, convert_grayscale_rgb
        obs = state
        if obs is None:
            obs = self._board().astype(float)
        obs = np.asarray(obs)
        new_mode = self.obs_type if mode is None else mode
        if new_mode == "ram":
            extend = self.extend_dims if extend_dims is None else extend_dims
            return (np.reshape(obs, (self.width, self.height, 1))
                    if extend else obs)
        # the public convert_grayscale carries the value pass-through quirk
        # (tetris_env.py:81, 96-97: only 0 and 1 are remapped; any other value
        # becomes that pixel shade verbatim) — it matters for user-supplied
        # ``state=`` arrays only, engine boards are 0/1.
        img = convert_grayscale(obs, 84)
        if new_mode == "grayscale":
            extend = self.extend_dims if extend_dims is None else extend_dims
            return np.reshape(img, (84, 84, 1)) if extend else img
        return convert_grayscale_rgb(img)

    @property
    def engine(self):
        """Read-only view with the reference TetrisEngine's public attribute
        names (board/anchor/shape_name/... — tetris_env.py:125-181), for user
        code that pokes ``env.engine`` directly."""
        return _EngineView(self)

    def valid_action_count(self) -> int:
        """Count of actions that would change (shape, anchor)
        (``TetrisEngine.valid_action_count``, tetris_env.py:222-230)."""
        if self._state is None:
            raise RuntimeError("valid_action_count() before reset()")
        return int(self._venv.valid_action_count(self._state)[0])

    def _board(self) -> np.ndarray:
        """(W, H) float board with the active piece burned in."""
        rows = self._venv.render_rows(self._state)
        return np.asarray(unpack_board(self.config, rows))[0]

    def render(self, mode: str = "human"):
        if mode == "rgb_array":
            # (160,160,3) image of the (internally transposed) board
            # (tetris_env.py:458-462)
            cells = jnp.asarray(self._board().T[None])     # [1, H, W]
            img = rasterize(cells, self.height, self.width, 160)
            return np.asarray(grayscale_to_rgb(img[0]))
        if mode == "human":
            # pygame window path (tetris_env.py:436-457): the board is
            # transposed *before* convert_grayscale, i.e. rasterized as (W, H)
            import pygame
            if self.window is None:
                pygame.init()
                pygame.display.init()
                self.window = pygame.display.set_mode(
                    (self.window_size, self.window_size))
            if self.clock is None:
                self.clock = pygame.time.Clock()
            cells = jnp.asarray(self._board()[None])       # [1, W, H]
            img = rasterize(cells, self.width, self.height, self.window_size)
            rgb = np.asarray(grayscale_to_rgb(img[0]))
            pygame.pixelcopy.array_to_surface(self.window, rgb)
            canvas = pygame.surfarray.make_surface(rgb)
            self.window.blit(canvas, canvas.get_rect())
            pygame.event.pump()
            pygame.display.update()
            self.clock.tick(self.metadata["render_fps"])
            return None
        # unknown mode: the reference falls through to gym.Env.render
        # (tetris_env.py:463-464), which in the old gym API raises
        # NotImplementedError itself — delegate when gym is importable,
        # reproduce its behavior when it isn't.
        try:
            import gym
        except ImportError:
            raise NotImplementedError(mode)
        try:
            return gym.Env.render(self, mode=mode)
        except TypeError:      # newer gym dropped the mode parameter
            return gym.Env.render(self)

    def close(self):
        # the reference just `del self.engine` and leaks the window (:466-467);
        # we do close the window.
        self._state = None
        if self.window is not None:
            import pygame
            pygame.display.quit()
            self.window = None

    def __repr__(self):
        """ASCII board like TetrisEngine.__repr__ (tetris_env.py:329-335)."""
        if self._state is None:
            return f"TetrisEnv({self.width}x{self.height}, unreset)"
        b = self._board()
        s = "o" + "-" * self.width + "o\n"
        s += "\n".join(
            "|" + "".join("X" if b[x, y] else " " for x in range(self.width)) + "|"
            for y in range(self.height))
        return s + "\no" + "-" * self.width + "o"
