"""Batched environment state as a single pytree.

The reference keeps all game state as mutable attributes on ``TetrisEngine``
(``tetris_env.py:126-181``): a float board indexed ``board[x, y]``, the active
piece as a mutable offset list + float anchor, and an assortment of counters.
Here the whole engine state is one immutable pytree dataclass of batched
arrays (``core/pytree.py``), so it can be jitted over, vmapped, donated,
sharded over a device mesh, and checkpointed with orbax as-is.

Board representation: **bit-packed rows in batch-minor layout** — ``uint32[H, B]``
with column ``x`` at bit ``x + XSHIFT``. Batch-minor keeps the large batch
dimension innermost, so every elementwise op over the state runs over long
contiguous vectors instead of the tiny H axis, and bit-packing makes collision
an AND, line-clear detection a row compare, and hole counting a popcount over
a prefix-OR.
"""

from __future__ import annotations

import jax.numpy as jnp

from .config import EnvConfig
from .pytree import pytree_dataclass


@pytree_dataclass
class EnvState:
    """One array per reference attribute; B is the env batch (minor axis).

    Reference attribute mapping (tetris_env.py):
      rows          <- self.board (:140), piece erased (the board between steps
                       always has the active piece cleared; the final
                       _set_piece(False) of the emit sequence :301-303
                       unconditionally zeroes piece cells, which produces the
                       spawn-overlap / death erase quirks)
      piece, rot    <- self.shape / self.shape_name (:171-172) as (id, rotation)
      ax, ay        <- self.anchor (:170), already int-coerced (:244)
      lock          <- self._lock_delay (:176)
      time          <- self.time (:165)
      score         <- self.score (:166)
      holes         <- self.holes (:167), only recomputed at lock (:278,:284)
      lines_cleared <- self.lines_cleared (:168)
      piece_height  <- self.piece_height (:169)
      deaths        <- self.n_deaths (:173)
      shape_counts  <- self.shape_counts (:181), int32[7, B] (batch-minor)
      key           <- (new) engine PRNG key data uint32[2]; the reference's
                       only RNG is the global Python Mersenne Twister (:2,:187).
                       A single counter-based threefry key yields independent
                       per-env draws in one vectorized call.
    """

    rows: jnp.ndarray          # uint32[H, B] (width <= 24), else [H, NW, B]
    piece: jnp.ndarray         # int32[B] in [0, 7)
    rot: jnp.ndarray           # int32[B] in [0, 4)
    ax: jnp.ndarray            # int32[B]
    ay: jnp.ndarray            # int32[B]
    lock: jnp.ndarray          # int32[B]
    time: jnp.ndarray          # int32[B]
    score: jnp.ndarray         # int32[B]
    holes: jnp.ndarray         # int32[B]
    lines_cleared: jnp.ndarray # int32[B]
    piece_height: jnp.ndarray  # int32[B]
    deaths: jnp.ndarray        # int32[B]
    shape_counts: jnp.ndarray  # int32[7, B]
    key: jnp.ndarray           # uint32[2] threefry key data

    @property
    def batch_size(self) -> int:
        return self.rows.shape[-1]


def init_state(config: EnvConfig, batch_size: int, key) -> EnvState:
    """Fresh-engine state, mirroring TetrisEngine.__init__ (tetris_env.py:163-181):
    time/score start at -1, everything else zero, no piece spawned yet (anchor/
    shape are None there; stepping before reset is undefined, as in the
    reference where it raises)."""
    import jax

    b = batch_size
    i32 = jnp.int32
    nw = config.num_words
    rows_shape = (config.height, b) if nw == 1 else (config.height, nw, b)
    return EnvState(
        rows=jnp.zeros(rows_shape, dtype=jnp.uint32),
        piece=jnp.zeros((b,), i32),
        rot=jnp.zeros((b,), i32),
        ax=jnp.zeros((b,), i32),
        ay=jnp.zeros((b,), i32),
        lock=jnp.zeros((b,), i32),
        time=jnp.full((b,), -1, i32),
        score=jnp.full((b,), -1, i32),
        holes=jnp.zeros((b,), i32),
        lines_cleared=jnp.zeros((b,), i32),
        piece_height=jnp.zeros((b,), i32),
        deaths=jnp.zeros((b,), i32),
        shape_counts=jnp.zeros((7, b), i32),
        key=jax.random.key_data(key).astype(jnp.uint32).reshape(2),
    )
