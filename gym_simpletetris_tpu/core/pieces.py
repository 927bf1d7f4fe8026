"""Tetromino piece tables as constant lookup tensors.

The reference (``/root/reference/gym_simpletetris/envs/tetris_env.py:10-26``) stores
each of the 7 tetrominoes as a *mutable Python list* of 4 ``(dx, dy)`` offsets relative
to an anchor cell (negative ``dy`` points up, because board row 0 is the top), and
rotates by mapping ``(i, j) -> (-j, i)`` (clockwise, ``rotated(cclk=True)``, used by
``rotate_right`` at ``tetris_env.py:67-69``) or ``(i, j) -> (j, -i)`` (counter-clockwise,
``rotate_left`` at ``tetris_env.py:62-64``).

Redesign: rotation state is an integer ``rot in [0, 4)`` counting clockwise
applications, and every ``(piece, rot)`` pair is pre-expanded at import time into
constant numpy tables that the jitted engine consumes as gather/shift operands:

- ``OFFSETS[piece, rot, cell, 2]``: the raw (dx, dy) offsets (property tests / parity).
- ``ROWMASKS[piece, rot, NROWS]``: per-relative-row bitmasks. Row ``k`` covers
  ``dy = k - DY_OFF``; bit ``dx + DX_OFF`` is set for each cell in that row. The engine
  shifts these left by the anchor x to obtain absolute board-row masks (see
  ``core/engine.py``). Applying ``rotated`` four times is the identity, so a 4-entry
  rotation ring is exact — verified by ``tests/test_pieces.py``.
"""

from __future__ import annotations

import numpy as np

# Piece cell offsets, anchor-relative, (dx, dy); dy < 0 is above the anchor.
# Semantics match the reference table (tetris_env.py:10-18); order of
# PIECE_NAMES matches shape_names (tetris_env.py:19) because the count-balanced
# sampler walks pieces in that order.
PIECE_NAMES = ("T", "J", "L", "Z", "S", "I", "O")

_BASE_OFFSETS = {
    "T": ((0, 0), (-1, 0), (1, 0), (0, -1)),
    "J": ((0, 0), (-1, 0), (0, -1), (0, -2)),
    "L": ((0, 0), (1, 0), (0, -1), (0, -2)),
    "Z": ((0, 0), (-1, 0), (0, -1), (1, -1)),
    "S": ((0, 0), (-1, -1), (0, -1), (1, 0)),
    "I": ((0, 0), (0, -1), (0, -2), (0, -3)),
    "O": ((0, 0), (0, -1), (-1, 0), (-1, -1)),
}

NUM_PIECES = 7
NUM_ROTS = 4
NUM_CELLS = 4

# Offsets fit in [-3, 3] for every rotation (base dy in [-3, 0], dx in [-1, 1];
# the rotation maps permute/negate coordinates).
DX_OFF = 3  # stored bit for a cell = dx + DX_OFF, in [0, 6]
DY_OFF = 3  # relative row k covers dy = k - DY_OFF, k in [0, 6]
NROWS = 7   # relative rows spanned by any piece: dy in [-3, 3]


def rotate_cw(cells):
    """One clockwise rotation step: (i, j) -> (-j, i).

    Mirrors ``rotated(shape, cclk=True)`` (tetris_env.py:22-26). ``rotate_left``
    applies the inverse map, so rot index arithmetic is rot+1 (right) / rot-1 (left)
    mod 4.
    """
    return tuple((-j, i) for (i, j) in cells)


def _build_offsets() -> np.ndarray:
    out = np.zeros((NUM_PIECES, NUM_ROTS, NUM_CELLS, 2), dtype=np.int8)
    for p, name in enumerate(PIECE_NAMES):
        cells = _BASE_OFFSETS[name]
        for r in range(NUM_ROTS):
            for c, (dx, dy) in enumerate(cells):
                out[p, r, c, 0] = dx
                out[p, r, c, 1] = dy
            cells = rotate_cw(cells)
    return out


def _build_rowmasks(offsets: np.ndarray) -> np.ndarray:
    masks = np.zeros((NUM_PIECES, NUM_ROTS, NROWS), dtype=np.uint32)
    for p in range(NUM_PIECES):
        for r in range(NUM_ROTS):
            for c in range(NUM_CELLS):
                dx = int(offsets[p, r, c, 0])
                dy = int(offsets[p, r, c, 1])
                masks[p, r, dy + DY_OFF] |= np.uint32(1) << np.uint32(dx + DX_OFF)
    return masks


OFFSETS = _build_offsets()
OFFSETS.setflags(write=False)

ROWMASKS = _build_rowmasks(OFFSETS)
ROWMASKS.setflags(write=False)

# Flat [NUM_PIECES * NUM_ROTS, NROWS] view for single-gather lookup by p*4+r.
ROWMASKS_FLAT = np.ascontiguousarray(ROWMASKS.reshape(NUM_PIECES * NUM_ROTS, NROWS))
ROWMASKS_FLAT.setflags(write=False)
