"""Frozen, hashable environment configuration.

The reference exposes its configuration as 14 constructor kwargs on ``TetrisEnv``
(``tetris_env.py:343-357``) forwarded to 11 on ``TetrisEngine`` (``:126-137``).
Here the same surface is a frozen dataclass used as a *static* jit argument, so one
compiled executable exists per configuration and no flag is ever a traced value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

OBS_TYPES = ("ram", "grayscale", "rgb")

# Bit layout of a packed board row: column x lives at global bit (x + XSHIFT).
# XSHIFT guard bits below bit 0 and 4 above bit (width-1 + XSHIFT) absorb piece
# offsets (|dx| <= 3, candidate anchors reach x = width) so anchor-shifted masks
# never wrap; see core/engine.py. Widths up to MAX_WIDTH_1W pack into a single
# uint32 per row ([H, B], the fast path); wider boards (the reference has no
# width limit, tetris_env.py:126-140) split each row over
# num_words = ceil((width + XSHIFT + 4) / 32) words ([H, NW, B]).
XSHIFT = 4
MAX_WIDTH_1W = 32 - XSHIFT - 4
MAX_WIDTH = 1024          # sanity bound only (board memory, raster geometry)
RASTER_IMPLS = ("sep", "sepb", "bcast", "matmul", "gather")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """All reference knobs (1:1) plus vectorization knobs.

    Reference kwargs (TetrisEnv.__init__, tetris_env.py:343-357):
      width, height, obs_type, extend_dims, render_mode(unused there too),
      reward_step, penalise_height, penalise_height_increase, advanced_clears,
      high_scoring, penalise_holes, penalise_holes_increase, lock_delay, step_reset.

    New knobs: auto_reset (batched training convenience; the reference resets only
    by caller, tetris_env.py:405) and raster_impl (obs kernel selection).
    """

    width: int = 10
    height: int = 20
    obs_type: str = "ram"
    extend_dims: bool = False
    render_mode: str = "rgb_array"  # stored-but-unused, like tetris_env.py:348,362
    reward_step: bool = False
    penalise_height: bool = False
    penalise_height_increase: bool = False
    advanced_clears: bool = False
    high_scoring: bool = False
    penalise_holes: bool = False
    penalise_holes_increase: bool = False
    lock_delay: int = 0
    step_reset: bool = False
    # --- vectorization knobs (not in the reference) ---
    auto_reset: bool = False
    raster_impl: str = "auto"    # "auto" | "sep" (two separable matmuls) |
                                 # "sepb" | "bcast" (pure elementwise) |
                                 # "matmul" | "gather"; all pixel-exact.
                                 # auto = sep (resolved_raster_impl)
    obs_dtype: str = "float32"   # "float32" (reference parity, :400) | "uint8"
                                 # (native palette, 4x fewer bytes)

    def __post_init__(self):
        if not (2 <= self.width <= MAX_WIDTH):
            raise ValueError(
                f"width={self.width} unsupported: requires 2 <= width <= "
                f"{MAX_WIDTH}")
        if self.height < 2:
            raise ValueError(f"height={self.height} must be >= 2")
        if self.obs_type not in OBS_TYPES:
            raise ValueError(f"obs_type={self.obs_type!r} not in {OBS_TYPES}")
        if self.raster_impl not in ("auto",) + RASTER_IMPLS:
            raise ValueError(f"raster_impl={self.raster_impl!r}")
        if self.obs_dtype not in ("float32", "uint8"):
            raise ValueError(f"obs_dtype={self.obs_dtype!r}")

    # -- derived, static helpers ------------------------------------------------
    @property
    def num_words(self) -> int:
        """uint32 words per packed board row: bits XSHIFT..width-1+XSHIFT+4
        (guard for candidate anchors at x = width, |dx| <= 3) must fit."""
        return (self.width + XSHIFT + 4 + 31) // 32

    @property
    def resolved_raster_impl(self) -> str:
        """Resolve raster_impl="auto" to the separable two-matmul raster
        ("sep", ops/raster.py). Which variant is fastest on a given device is
        a measurement that bench.py's --impl sweep makes."""
        if self.raster_impl != "auto":
            return self.raster_impl
        return "sep"

    @property
    def valid_mask(self) -> int:
        """uint32 mask of in-board column bits: [XSHIFT, XSHIFT + width)."""
        return ((1 << self.width) - 1) << XSHIFT

    @property
    def spawn_x(self) -> int:
        """Reference spawns at float width/2 (tetris_env.py:196); every observable
        use truncates per-cell via int() (``:244`` and ``:327``), which for the
        positions a piece can occupy equals using floor(width/2) directly."""
        return self.width // 2

    @property
    def lock_modulus(self) -> int:
        # _lock_delay_fn = (x+1) % (max(lock_delay,0)+1)  (tetris_env.py:175)
        return max(self.lock_delay, 0) + 1

    def scoring_dict(self) -> dict:
        """The reference's _scoring dict (tetris_env.py:141-149), for introspection."""
        return {
            "reward_step": self.reward_step,
            "penalise_height": self.penalise_height,
            "penalise_height_increase": self.penalise_height_increase,
            "advanced_clears": self.advanced_clears,
            "high_scoring": self.high_scoring,
            "penalise_holes": self.penalise_holes,
            "penalise_holes_increase": self.penalise_holes_increase,
        }

    def replace(self, **kw) -> "EnvConfig":
        return dataclasses.replace(self, **kw)
