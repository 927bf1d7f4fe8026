"""Observation rasterization: board -> size×size grayscale/rgb images.

The reference renders observations with numpy ``repeat``/``insert`` chains
(``convert_grayscale``, tetris_env.py:76-114) — its dominant per-step cost
(BASELINE.md: 22.5k steps/s ram vs 4.6k grayscale). The geometry is pure integer
arithmetic over ``(d0, d1, size)``, so here it is precomputed **once per config on
the host** into static lookup structures, and the per-step device work is either:

- ``matmul``: one ``[B, d0*d1] @ [d0*d1, size*size]`` bf16 matmul against a
  constant 0/1 pixel-membership matrix (exact, since all values are small
  integers), or
- ``gather``: one static-index gather per pixel.

Pixel semantics replicated exactly (verified pixel-for-pixel against the
reference in tests/test_raster.py):

- border_shade=0, background_shade=128, piece_shade=190 (tetris_env.py:77-79)
- the input board is transposed first (:82), so axis0 of the image indexes the
  board's second axis (for (W,H) boards: rows of the image = y)
- gap = size//100 + 1; block = (size - 2*gap)//max(d0,d1) - gap (:87-88)
- inner extent per axis = gap + (block+gap)*d (:90-91); centering padding is
  floor((size-inner)/2) before, remainder after (:93-94, :109-112)
- grid: [gap, block]* pattern starting with a gap; gaps/background share 128
- border rows/cols (value 0) are inserted last and span the full image
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

BORDER_SHADE = 0
BACKGROUND_SHADE = 128
PIECE_SHADE = 190


def raster_geometry(d0: int, d1: int, size: int):
    """Static geometry for an image of a (d0, d1) array at ``size`` pixels.
    Returns (gap, block, inner0, inner1, pad0, pad1)."""
    limiting = max(d0, d1)
    gap = (size // 100) + 1
    block = ((size - 2 * gap) // limiting) - gap
    if block < 1:
        raise ValueError(
            f"board {d0}x{d1} too large to rasterize at {size}px "
            f"(block={block}); the reference would crash in np.repeat too")
    inner0 = gap + (block + gap) * d0
    inner1 = gap + (block + gap) * d1
    pad0 = (size - inner0) // 2
    pad1 = (size - inner1) // 2
    if pad0 < 0 or pad1 < 0:
        raise ValueError(f"board {d0}x{d1} does not fit at {size}px")
    return gap, block, inner0, inner1, pad0, pad1


def _axis_cells(d: int, size: int, gap: int, block: int, inner: int, pad: int):
    """Per-pixel classification along one axis: cell index or -1 (gap), -2 (border)."""
    idx = np.full(size, -2, dtype=np.int32)
    for p in range(pad, pad + inner):
        t = (p - pad) - gap
        if t < 0:
            idx[p] = -1
            continue
        i, rem = divmod(t, block + gap)
        idx[p] = i if rem < block else -1
    return idx


@lru_cache(maxsize=64)
def build_raster_maps(d0: int, d1: int, size: int):
    """Host-side static maps: (base uint8[size,size], cell int32[size,size]).

    ``base`` is the image of an all-empty board; ``cell[p0,p1]`` is the flat cell
    index ``i0*d1 + i1`` whose occupancy bumps that pixel from 128 to 190, or -1
    for pixels that never depend on the board (border and gaps).
    """
    gap, block, inner0, inner1, pad0, pad1 = raster_geometry(d0, d1, size)
    a0 = _axis_cells(d0, size, gap, block, inner0, pad0)
    a1 = _axis_cells(d1, size, gap, block, inner1, pad1)
    border0 = a0 == -2
    border1 = a1 == -2
    border = border0[:, None] | border1[None, :]
    base = np.where(border, BORDER_SHADE, BACKGROUND_SHADE).astype(np.uint8)
    is_cell = (a0[:, None] >= 0) & (a1[None, :] >= 0)
    cell = np.where(is_cell, a0[:, None] * d1 + np.maximum(a1, 0)[None, :], -1)
    return base, cell.astype(np.int32)


@lru_cache(maxsize=64)
def _matmul_operands(d0: int, d1: int, size: int):
    base, cell = build_raster_maps(d0, d1, size)
    ncell = d0 * d1
    flat = cell.reshape(-1)
    # A[cell, pixel] = 1 where the pixel belongs to the cell's block
    a = np.zeros((ncell, size * size), dtype=np.float32)
    sel = flat >= 0
    a[flat[sel], np.nonzero(sel)[0]] = 1.0
    return base, a


def rasterize_matmul(cells: jnp.ndarray, d0: int, d1: int, size: int) -> jnp.ndarray:
    """cells: [B, d0, d1] (0/1, any numeric dtype) -> uint8 [B, size, size].

    One matmul: shade delta = (190-128) * (cells @ A). bf16 is exact here (values
    are 0/1 with one term per pixel; 62*1+128=190 < 256 is exactly representable).
    """
    base, a = _matmul_operands(d0, d1, size)
    b = cells.shape[0]
    x = cells.reshape(b, d0 * d1).astype(jnp.bfloat16)
    hit = jnp.dot(x, jnp.asarray(a, dtype=jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    img = jnp.asarray(base, dtype=jnp.float32).reshape(1, -1) + \
        (PIECE_SHADE - BACKGROUND_SHADE) * hit
    return img.astype(jnp.uint8).reshape(b, size, size)


def rasterize_bcast(cells: jnp.ndarray, d0: int, d1: int, size: int) -> jnp.ndarray:
    """cells: [B, d0, d1] (0/1) -> uint8 [B, size, size], pure elementwise.

    The pixel grid is a regular tiling: each board cell owns a
    (block+gap)x(block+gap) tile whose first ``block`` rows/cols are the cell
    and the rest gap, the whole grid sits at offset pad+gap, and everything
    else is the constant ``base`` map. That makes the raster expressible as
    broadcast * tile-mask -> reshape -> pad -> affine — **no dot, no gather**,
    so XLA fuses the entire chain (from packed board rows through to the
    consumer) into one elementwise kernel. Unlike the matmul path there is no
    materialized [B, size*size] f32 dot output.
    """
    gap, block, inner0, inner1, pad0, pad1 = raster_geometry(d0, d1, size)
    bg = block + gap
    b = cells.shape[0]
    # fold the shade delta (62) into the axis-0 tile mask so the expansion
    # product directly yields the pixel delta — one fewer full-size multiply
    m0 = jnp.asarray(np.where(np.arange(bg) < block,
                              PIECE_SHADE - BACKGROUND_SHADE, 0).astype(np.uint8))
    m1 = jnp.asarray((np.arange(bg) < block).astype(np.uint8))
    x = cells.astype(jnp.uint8)
    # X[b, i, u, j, v] = cells[b, i, j] * m0[u] * m1[v]
    x = (x[:, :, None, :, None] * m0[None, None, :, None, None]
         * m1[None, None, None, None, :])
    x = x.reshape(b, d0 * bg, d1 * bg)
    x = jnp.pad(x, ((0, 0),
                    (pad0 + gap, size - pad0 - gap - d0 * bg),
                    (pad1 + gap, size - pad1 - gap - d1 * bg)))
    base, _ = build_raster_maps(d0, d1, size)
    return jnp.asarray(base)[None] + x


@lru_cache(maxsize=64)
def _sep_operands(d0: int, d1: int, size: int):
    """Separable raster operands, with the shade arithmetic folded in.

    The whole image is separable: ``img[p,q] = 62*cellsexp[p,q] +
    128*inb0[p]*inb1[q]`` (cell pixels add 62 on the 128 background; border
    pixels — where either axis is outside the inner grid — are 0). Augmenting
    the cell matrix with one constant row/column folds the background term
    into the same two matmuls:

      E1p[d1+1, size]: rows 0..d1-1 = 0/1 column expansion; row d1 = 128*inb1
      E0p[size, d0+1]: cols 0..d0-1 = 62 * row expansion;   col d0 = inb0

    so ``img = (E0p @ (cellsp @ E1p)).astype(uint8)`` exactly (all values are
    integers <= 190, exact in bf16).
    """
    gap, block, inner0, inner1, pad0, pad1 = raster_geometry(d0, d1, size)
    a0 = _axis_cells(d0, size, gap, block, inner0, pad0)
    a1 = _axis_cells(d1, size, gap, block, inner1, pad1)
    e1p = np.zeros((d1 + 1, size), np.float32)
    e1p[:d1] = (a1[None, :] == np.arange(d1)[:, None])
    e1p[d1] = BACKGROUND_SHADE * (a1 != -2)
    e0p = np.zeros((size, d0 + 1), np.float32)
    e0p[:, :d0] = (PIECE_SHADE - BACKGROUND_SHADE) * \
        (a0[:, None] == np.arange(d0)[None, :])
    e0p[:, d0] = (a0 != -2)
    return e0p, e1p


def rasterize_sep(cells: jnp.ndarray, d0: int, d1: int, size: int) -> jnp.ndarray:
    """cells: [B, d0, d1] (0/1) -> uint8 [B, size, size], separable matmuls.

    The pixel->cell map factorizes per axis, so the block expansion is two
    rank-reducing matmuls over tiny constant operands (``_sep_operands``) that
    also carry the shade arithmetic, followed by one fused elementwise pass
    (bf16->u8 convert + consumer). Unlike the single big matmul
    (``rasterize_matmul``: a [d0*d1, size*size] operand and an f32 dot output)
    nothing large is read per step. Exact: all pixel values are integers
    <= 190, exact in bf16.
    """
    e0p, e1p = _sep_operands(d0, d1, size)
    b = cells.shape[0]
    c = cells.astype(jnp.bfloat16)
    cp = jnp.concatenate([
        jnp.concatenate([c, jnp.zeros((b, d0, 1), jnp.bfloat16)], axis=2),
        jnp.broadcast_to(
            jnp.concatenate([jnp.zeros((d1,), jnp.bfloat16),
                             jnp.ones((1,), jnp.bfloat16)])[None, None, :],
            (b, 1, d1 + 1)),
    ], axis=1)                                               # [B, d0+1, d1+1]
    t = jnp.einsum("bhw,wq->bhq", cp, jnp.asarray(e1p, jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16)      # [B, d0+1, size]
    u = jnp.einsum("ph,bhq->bpq", jnp.asarray(e0p, jnp.bfloat16), t,
                   preferred_element_type=jnp.bfloat16)      # [B, size, size]
    return u.astype(jnp.uint8)


@lru_cache(maxsize=64)
def _sepb_operands(d0: int, d1: int, size: int):
    """Column-expansion operand with the shade affine folded in:
    ``A1[d1+1, size]`` where rows 0..d1-1 carry 62 * the 0/1 column expansion
    and row d1 carries the background term 128*inb1 — so for an augmented
    cell row ``[cells_i, 1]``, ``[cells_i, 1] @ A1`` is exactly the finished
    image row of cell row i (bg 128 inside the inner grid, +62 on occupied
    cell pixels, border 0 outside). Also returns that background ("gap") row
    itself — the image row at every inner gap position."""
    gap, block, inner0, inner1, pad0, pad1 = raster_geometry(d0, d1, size)
    a1 = _axis_cells(d1, size, gap, block, inner1, pad1)
    op = np.zeros((d1 + 1, size), np.float32)
    op[:d1] = (PIECE_SHADE - BACKGROUND_SHADE) * \
        (a1[None, :] == np.arange(d1)[:, None])
    op[d1] = BACKGROUND_SHADE * (a1 != -2)
    return op, op[d1].copy()


def rasterize_sepb(cells: jnp.ndarray, d0: int, d1: int, size: int) -> jnp.ndarray:
    """cells: [B, d0, d1] (0/1) -> uint8 [B, size, size]: separable columns /
    broadcast rows.

    The row expansion of the separable raster is a 0/1 selection — every pixel
    row of cell row i is the SAME vector ``t_i`` (and every gap row the same
    constant) — so the second matmul of ``rasterize_sep`` is replaced by pure
    broadcasts: one tiny dot ``[B, d0, d1+1] @ [d1+1, size]`` produces the
    d0 distinct image rows, and broadcast/concat/pad assemble the image. This
    removes the [B, size, size] bf16 dot *output* of the sep path; only
    [B, d0, size] comes out of a matmul. Exact: all values are integers <= 190,
    exact in bf16.
    """
    gap, block, inner0, inner1, pad0, pad1 = raster_geometry(d0, d1, size)
    op, gap_row = _sepb_operands(d0, d1, size)
    b = cells.shape[0]
    cp = jnp.concatenate([cells.astype(jnp.bfloat16),
                          jnp.ones((b, d0, 1), jnp.bfloat16)], axis=2)
    t = jnp.einsum("bhw,wq->bhq", cp, jnp.asarray(op, jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16)    # [B, d0, size]
    grow = jnp.asarray(gap_row, jnp.bfloat16)
    blk = jnp.broadcast_to(t[:, :, None, :], (b, d0, block, size))
    gaps = jnp.broadcast_to(grow, (b, d0, gap, size))
    x = jnp.concatenate([blk, gaps], axis=2).reshape(b, d0 * (block + gap),
                                                     size)
    lead = jnp.broadcast_to(grow, (b, gap, size))
    x = jnp.concatenate([lead, x], axis=1)                 # [B, inner0, size]
    x = jnp.pad(x, ((0, 0), (pad0, size - pad0 - inner0), (0, 0)))
    return x.astype(jnp.uint8)


def rasterize_gather(cells: jnp.ndarray, d0: int, d1: int, size: int) -> jnp.ndarray:
    """cells: [B, d0, d1] -> uint8 [B, size, size] via one static-index gather."""
    base, cell = build_raster_maps(d0, d1, size)
    b = cells.shape[0]
    ncell = d0 * d1
    flat = jnp.concatenate(
        [cells.reshape(b, ncell).astype(jnp.uint8),
         jnp.zeros((b, 1), dtype=jnp.uint8)], axis=1)
    idx = jnp.asarray(np.where(cell < 0, ncell, cell).reshape(-1))
    hit = jnp.take(flat, idx, axis=1)                       # [B, size*size]
    img = jnp.asarray(base, dtype=jnp.uint8).reshape(1, -1) + \
        jnp.uint8(PIECE_SHADE - BACKGROUND_SHADE) * hit
    return img.reshape(b, size, size)


def rasterize(cells: jnp.ndarray, d0: int, d1: int, size: int,
              impl: str = "matmul") -> jnp.ndarray:
    if impl == "matmul":
        return rasterize_matmul(cells, d0, d1, size)
    if impl == "gather":
        return rasterize_gather(cells, d0, d1, size)
    if impl == "bcast":
        return rasterize_bcast(cells, d0, d1, size)
    if impl == "sep":
        return rasterize_sep(cells, d0, d1, size)
    if impl == "sepb":
        return rasterize_sepb(cells, d0, d1, size)
    raise ValueError(f"unknown raster impl {impl!r}")


def rasterize_host(cells: np.ndarray, d0: int, d1: int, size: int) -> np.ndarray:
    """Pure-numpy host raster (used by the native CPU env, api/native_env.py):
    (d0, d1) 0/1 cells -> uint8 (size, size). Same static maps as the device
    paths, so pixel-exactness is shared."""
    base, cell = build_raster_maps(d0, d1, size)
    flat = np.append(np.asarray(cells, dtype=np.uint8).reshape(-1), np.uint8(0))
    idx = np.where(cell < 0, d0 * d1, cell)
    return base + np.uint8(PIECE_SHADE - BACKGROUND_SHADE) * flat[idx]


def rasterize_host_batch(cells: np.ndarray, d0: int, d1: int,
                         size: int) -> np.ndarray:
    """Pure-numpy batched host raster: [N, d0, d1] 0/1 -> uint8 [N, size, size]
    (one fancy-index gather per batch; used by the native vector env)."""
    base, cell = build_raster_maps(d0, d1, size)
    n = cells.shape[0]
    flat = np.concatenate(
        [np.asarray(cells, np.uint8).reshape(n, d0 * d1),
         np.zeros((n, 1), np.uint8)], axis=1)
    idx = np.where(cell < 0, d0 * d1, cell).reshape(-1)
    hit = flat[:, idx]
    return (base.reshape(1, -1)
            + np.uint8(PIECE_SHADE - BACKGROUND_SHADE) * hit
            ).reshape(n, size, size)


def grayscale_to_rgb(img: jnp.ndarray) -> jnp.ndarray:
    """HxW -> HxWx3 channel triple (``convert_grayscale_rgb``, tetris_env.py:117-122)."""
    return jnp.repeat(img[..., None], 3, axis=-1)
