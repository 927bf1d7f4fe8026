"""Pure, jittable, batched Tetris transition engine (batch-minor layout).

This is a ground-up array-program redesign of the reference engine
(``gym_simpletetris/envs/tetris_env.py:125-335``), not a translation. Design
decisions:

- **Batch-minor layout**: every per-row array is ``[H, B]`` (board rows,
  collision profiles, piece masks, shape counts), so the innermost dimension
  is the large env batch, not the tiny H/W dimension: every elementwise op
  runs over long contiguous vectors.
- **Bit-packed rows**: ``uint32[H, B]``, column ``x`` at bit ``x + XSHIFT``.
  Collision is AND, a full row is a compare, holes are popcount of a prefix-OR.
  Boards wider than 24 columns (the reference has no width limit,
  tetris_env.py:126-140) use a **multi-word generalization**:
  ``uint32[H, NW, B]`` with global bit ``x + XSHIFT`` in word ``(x+XSHIFT)//32``
  — every bit op extends element-wise over the word axis, and the only
  cross-word operation is the piece-mask placement shift (a two-word
  funnel shift, ``piece_masks``). NW == 1 keeps the flat ``[H, B]`` layout.
- **No gathers, no scatters, no sorts.** Per-env row lookups are one-hot
  compare+reduce contractions; the per-(piece,rot) mask table lookup is a tiny
  one-hot matmul; line compaction is a compare-reduce permutation. Every op
  of the step is elementwise or a small static contraction over the batch.
- **No data-dependent control flow**: candidates are evaluated branchlessly and
  selected; ``hard_drop`` (a Python ``while True`` loop in the reference,
  tetris_env.py:54-59) is an argmin over a dense collide-at-every-height
  profile computed with 7 static slices.

Exact behavioral parity with the reference ``step`` (tetris_env.py:243-304) is
the contract, including its quirks (verified by tests/test_parity_engine.py):

- cells with ``y < 0`` skip *all* collision checks including x-bounds
  (tetris_env.py:29-36);
- gravity applies one extra soft-drop after every action (:247);
- the lock-delay counter wraps modulo ``lock_delay+1`` and goes stale across
  ledge slides unless ``step_reset`` is set (:175, :248-249, :260);
- on lock: burn piece, stable downward line compaction (:205-216), scoring
  (:266-275), death = any cell in row 0 after clearing (:277) with the whole
  step reward overwritten to -100 (:281), no spawn on death (:283-299);
- holes recomputed only at lock (:278, :284);
- the end-of-step emit sequence ``set_piece(True); copy; set_piece(False)``
  (:301-303) force-clears piece cells from the persistent board (the
  spawn-overlap-erase and death-erase quirks) — reproduced by keeping the
  persistent board piece-erased (``rows_next = rows_after & ~piece_bits``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import EnvConfig, XSHIFT
from .pieces import ROWMASKS_FLAT, NROWS, DY_OFF
from .state import EnvState

_U32 = jnp.uint32
_I32 = jnp.int32
_F32 = jnp.float32

# NES line-clear score table (tetris_env.py:267).
_SCORES_TAB = np.array([0, 40, 100, 300, 1200], dtype=np.int32)

# Action ids (value_action_map, tetris_env.py:152-160).
A_LEFT, A_RIGHT, A_HARD, A_SOFT, A_ROTL, A_ROTR, A_IDLE = range(7)
NUM_ACTIONS = 7


class StepOut(NamedTuple):
    state: EnvState
    emitted_rows: jnp.ndarray  # board copy with active piece burned in
                               # (uint32[H, B], or [H, NW, B] for wide boards)
    reward: jnp.ndarray        # float32[B]
    done: jnp.ndarray          # bool[B]


# ------------------------------------------------------------- word-axis helpers
#
# Internal currency: word-form arrays with an explicit NW axis just before the
# batch axis — board rows uint32[H, NW, B], piece masks uint32[NROWS, NW, B].
# The public/state layout drops the axis when NW == 1 (the flat [H, B] fast
# path; a size-1 axis is layout-free in XLA, so the word-generic code compiles
# to the identical single-word kernels).

def _to_words(cfg: EnvConfig, rows: jnp.ndarray) -> jnp.ndarray:
    """State-layout board rows -> word form uint32[H, NW, B]."""
    return rows[:, None, :] if rows.ndim == 2 else rows


def _from_words(cfg: EnvConfig, rows_w: jnp.ndarray) -> jnp.ndarray:
    """Word form -> state layout ([H, B] when NW == 1)."""
    return rows_w[:, 0, :] if cfg.num_words == 1 else rows_w


def _valid_words(cfg: EnvConfig) -> np.ndarray:
    """uint32[NW]: per-word in-board column bits of cfg.valid_mask."""
    return np.array([(cfg.valid_mask >> (32 * w)) & 0xFFFFFFFF
                     for w in range(cfg.num_words)], dtype=np.uint32)


def _invalid_words(cfg: EnvConfig) -> np.ndarray:
    """uint32[NW]: per-word complement (guard bits + out-of-board columns)."""
    return np.array([~v & 0xFFFFFFFF for v in _valid_words(cfg)],
                    dtype=np.uint32)


# ------------------------------------------------------------------ piece masks

def piece_masks(cfg: EnvConfig, piece: jnp.ndarray, rot: jnp.ndarray,
                ax: jnp.ndarray, rot_delta: int = 0) -> jnp.ndarray:
    """Absolute per-relative-row bitmasks: uint32[NROWS, NW, B].

    Relative row k covers board row ``ay + k - DY_OFF``; global bit
    ``x + XSHIFT`` is column x. Table lookup is a one-hot f32 matmul (entries
    <= 127, exact); the anchor shift is ``s = ax + (XSHIFT - 3)`` (stored bits
    are ``dx + 3``), which is >= 0 for every reachable and candidate position
    (each piece contains its anchor cell, pinning ax to [0, W); candidates
    reach ax-1 >= -1). Word w receives the funnel-shifted slice
    ``(m << (s - 32w)) | (m >> (32w - s))`` with out-of-range shifts masked.
    """
    pr = piece * 4 + (rot + rot_delta) % 4                       # [B]
    oh = (jnp.arange(28, dtype=_I32)[:, None] == pr[None, :])    # [28, B]
    tab = jnp.asarray(ROWMASKS_FLAT.astype(np.float32).T)        # [NROWS, 28]
    m = jnp.dot(tab, oh.astype(jnp.float32),
                preferred_element_type=jnp.float32).astype(_U32)  # [NROWS, B]
    s = ax + (XSHIFT - 3)                                        # int32[B], >= 0
    nw = cfg.num_words
    if nw == 1:
        return (m << s.astype(_U32)[None, :])[:, None, :]
    words = []
    for w in range(nw):
        d = s - 32 * w                                           # int32[B]
        lsh = jnp.clip(d, 0, 31).astype(_U32)[None, :]
        rsh = jnp.clip(-d, 0, 31).astype(_U32)[None, :]
        lv = jnp.where(((d >= 0) & (d < 32))[None, :], m << lsh, _U32(0))
        rv = jnp.where(((d < 0) & (d > -32))[None, :], m >> rsh, _U32(0))
        words.append(lv | rv)
    return jnp.stack(words, axis=1)                              # [NROWS, NW, B]


def pad_rows(rows: jnp.ndarray) -> jnp.ndarray:
    """Zero-pad the H axis: DY_OFF rows above the board, NROWS-DY_OFF below.
    Out-of-board rows read as empty; y-bounds are handled arithmetically."""
    return jnp.pad(rows, ((DY_OFF, NROWS - DY_OFF),)
                   + ((0, 0),) * (rows.ndim - 1))


# ------------------------------------------------------------------- collision

def extract_window(cfg: EnvConfig, rows: jnp.ndarray,
                   ay: jnp.ndarray) -> jnp.ndarray:
    """Board rows at y = ay-3 .. ay+3 per env, zeros outside:
    uint32[NROWS, NW, B]. One-hot compare+reduce — no gather."""
    H = cfg.height
    rows_w = _to_words(cfg, rows)
    rel = (jnp.arange(H, dtype=_I32)[:, None, None] - ay[None, None, :]) \
        + DY_OFF                                              # [H, 1, B]
    return jnp.stack(
        [jnp.sum(jnp.where(rel == k, rows_w, _U32(0)), axis=0)
         for k in range(NROWS)], axis=0)                      # [NROWS, NW, B]


def collide_window(cfg: EnvConfig, window: jnp.ndarray, masks: jnp.ndarray,
                   ay: jnp.ndarray) -> jnp.ndarray:
    """Collision for C candidate mask sets sharing one anchor row: bool[C, B].

    window: uint32[NROWS, NW, B]; masks: uint32[C, NROWS, NW, B]; ay: int32[B].
    Replicates ``is_occupied`` (tetris_env.py:29-36) per cell-row: skip if
    y < 0 (before any x check!), else collide on x out-of-board, y >= H (if the
    row has cells), or board-bit overlap.
    """
    H = cfg.height
    nv = jnp.asarray(_invalid_words(cfg))[None, None, :, None]
    k = jnp.arange(NROWS, dtype=_I32)[None, :, None]          # [1, NROWS, 1]
    y = ay[None, None, :] + (k - DY_OFF)                      # [1, NROWS, B]
    nonempty = (masks != 0).any(axis=2)                       # [C, NROWS, B]
    xo = ((masks & nv) != 0).any(axis=2)
    hit = ((window[None] & masks) != 0).any(axis=2)
    coll = (y >= 0) & (xo | ((y >= H) & nonempty) | hit)
    return coll.any(axis=1)                                   # [C, B]


def collide_profile(cfg: EnvConfig, rows_pad: jnp.ndarray,
                    masks: jnp.ndarray) -> jnp.ndarray:
    """Collision of one mask set at *every* anchor row 0..H: bool[H+1, B].

    rows_pad: padded board rows (state layout or word form);
    masks: uint32[NROWS, NW, B]. One dense pass of 7 static slices subsumes
    soft-drop, gravity, hard-drop landing and the resting check. ``profile[H]``
    is always True (the anchor cell at y=H is out of bounds), so drop distances
    are well defined.
    """
    H = cfg.height
    B = masks.shape[-1]
    rp = _to_words(cfg, rows_pad)                             # [H+NROWS, NW, B]
    nv = jnp.asarray(_invalid_words(cfg))[:, None]            # [NW, 1]
    coll = jnp.zeros((H + 1, B), dtype=bool)
    for k in range(NROWS):
        mk = masks[k]                                         # [NW, B]
        # static activity range along the profile axis: row y'+k-3 must be >= 0
        lo = max(0, DY_OFF - k)                               # y' >= 3-k
        hit = ((rp[k:k + H + 1] & mk[None]) != 0).any(axis=1)  # [H+1, B]
        xo = ((mk & nv) != 0).any(axis=0)                     # [B]
        term = hit | xo[None, :]
        # y' + k - 3 >= H  (static row range), counts only if the row has cells
        yo_lo = H + DY_OFF - k                                # y' >= H+3-k
        if yo_lo <= H:
            yo = jnp.zeros((H + 1, 1), dtype=bool).at[yo_lo:].set(True)
            term = term | (yo & (mk != 0).any(axis=0)[None, :])
        if lo > 0:
            active = jnp.zeros((H + 1, 1), dtype=bool).at[lo:].set(True)
            term = term & active
        coll = coll | term
    return coll


def profile_at(prof: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """prof[idx[b], b] -> bool[B], via one-hot reduce (no gather)."""
    hp1 = prof.shape[0]
    oh = jnp.arange(hp1, dtype=_I32)[:, None] == idx[None, :]
    return jnp.any(oh & prof, axis=0)


def _place_bits_w(cfg: EnvConfig, masks: jnp.ndarray,
                  ay: jnp.ndarray) -> jnp.ndarray:
    """Burn a piece into an empty board: word form uint32[H, NW, B]. Cells
    outside the board are silently dropped, matching the per-cell bounds check
    of ``_set_piece`` (tetris_env.py:323-327)."""
    H = cfg.height
    valid = jnp.asarray(_valid_words(cfg))[None, :, None]     # [1, NW, 1]
    rel = (jnp.arange(H, dtype=_I32)[:, None, None] - ay[None, None, :]) \
        + DY_OFF                                              # [H, 1, B]
    pb = jnp.zeros((H, cfg.num_words, masks.shape[-1]), dtype=_U32)
    for k in range(NROWS):
        pb = pb | jnp.where(rel == k, masks[k][None] & valid, _U32(0))
    return pb


def place_bits(cfg: EnvConfig, masks: jnp.ndarray, ay: jnp.ndarray) -> jnp.ndarray:
    """``_place_bits_w`` in the state layout ([H, B] when NW == 1)."""
    return _from_words(cfg, _place_bits_w(cfg, masks, ay))


# ----------------------------------------------------------------- board queries

def count_holes(cfg: EnvConfig, rows: jnp.ndarray) -> jnp.ndarray:
    """Empty cells with any filled cell above, as in
    ``count_nonzero(board.cumsum(y) * ~board)`` (tetris_env.py:218-220):
    popcount of ``~rows & prefixOR(rows)`` (the self-term cancels)."""
    rw = _to_words(cfg, rows)
    above = jax.lax.associative_scan(jnp.bitwise_or, rw, axis=0)
    valid = jnp.asarray(_valid_words(cfg))[None, :, None]
    bits = jnp.bitwise_not(rw) & above & valid
    return jax.lax.population_count(bits).sum(axis=(0, 1)).astype(_I32)


def nonempty_rows(cfg: EnvConfig, rows: jnp.ndarray) -> jnp.ndarray:
    """Count of rows with any filled cell — the reference's "height"
    (``sum(np.any(board, axis=0))``, tetris_env.py:287); with overhangs this is
    *not* the max column height. Code is the spec."""
    rw = _to_words(cfg, rows)
    valid = jnp.asarray(_valid_words(cfg))[None, :, None]
    return ((rw & valid) != 0).any(axis=1).sum(axis=0).astype(_I32)


def _clear_lines_w(cfg: EnvConfig, rows_w: jnp.ndarray):
    """Full-row removal with stable downward compaction (tetris_env.py:205-216).

    Each kept row i lands at ``i + (#full rows below i)``; the permutation is a
    compare-reduce contraction over [H_out, H_in, B] — sort/gather/scatter-free.
    """
    H = cfg.height
    valid = jnp.asarray(_valid_words(cfg))[None, :, None]     # [1, NW, 1]
    full = ((rows_w & valid) == valid).all(axis=1)            # [H, B]
    n_full = full.sum(axis=0).astype(_I32)                    # [B]
    below = n_full[None, :] - jnp.cumsum(full.astype(_I32), axis=0)  # [H, B]
    dest = jnp.arange(H, dtype=_I32)[:, None] + below         # [H, B]
    keep = ~full
    out_rows = jnp.arange(H, dtype=_I32)[:, None, None]       # [H_out, 1, 1]
    route = (dest[None] == out_rows) & keep[None]             # [H_out, H_in, B]
    new_rows = jnp.sum(jnp.where(route[:, :, None, :], rows_w[None], _U32(0)),
                       axis=1)                                # [H, NW, B]
    return new_rows, n_full


def clear_lines(cfg: EnvConfig, rows: jnp.ndarray):
    """``_clear_lines_w`` in the state layout."""
    new_rows, n_full = _clear_lines_w(cfg, _to_words(cfg, rows))
    return _from_words(cfg, new_rows), n_full


# ------------------------------------------------------------------------ sampler

def sample_piece(counts: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Count-balanced piece choice (``_choose_shape``, tetris_env.py:183-191).

    counts: int32[7, B]; r: int32[B] in [1, sum(m)]. The reference draws
    r = randint(1, sum(m)) with weights m[i] = 5 + max(counts) - counts[i] and
    walks linearly; equivalently piece = #{i : cumsum(m)[i] < r}.
    """
    maxm = counts.max(axis=0, keepdims=True)
    m = 5 + maxm - counts                                     # [7, B]
    c = jnp.cumsum(m, axis=0)
    return (c < r[None, :]).sum(axis=0).astype(_I32)


def piece_weight_sum(counts: jnp.ndarray) -> jnp.ndarray:
    maxm = counts.max(axis=0, keepdims=True)
    return (5 + maxm - counts).sum(axis=0).astype(_I32)


def _advance_key(key_data: jnp.ndarray):
    """Split the single engine key: returns (carry uint32[2], draw key)."""
    k = jax.random.wrap_key_data(key_data, impl="threefry2x32")
    k1, k2 = jax.random.split(k)
    return jax.random.key_data(k1), k2


def draw_spawn_r(draw_key, counts: jnp.ndarray) -> jnp.ndarray:
    """Pure-JAX analog of the reference's only RNG draw, randint(1, sum(m))
    (tetris_env.py:187): counter-based threefry bits, one batched call.
    r = 1 + bits mod sum(m) (the tiny modulo bias is irrelevant — this mode
    defines its own stream; parity mode injects recorded reference draws).
    """
    s = piece_weight_sum(counts)                              # [B]
    bits = jax.random.bits(draw_key, (s.shape[0],), dtype=_U32)
    return (1 + (bits % s.astype(_U32))).astype(_I32)


# --------------------------------------------------------------------------- step

def candidate_collisions(cfg: EnvConfig, rows, piece, rot, ax, ay):
    """Collision of the four in-place move candidates — left, right,
    rotate-left, rotate-right — at the current anchor row (the shared
    contract of ``engine_step``'s action selection and
    ``valid_action_count``). Returns (c_left, c_right, c_rotl, c_rotr)."""
    win = extract_window(cfg, rows, ay)
    cand = jnp.stack([
        piece_masks(cfg, piece, rot, ax - 1),
        piece_masks(cfg, piece, rot, ax + 1),
        piece_masks(cfg, piece, rot, ax, rot_delta=-1),
        piece_masks(cfg, piece, rot, ax, rot_delta=+1),
    ], axis=0)                                                # [4, NROWS, NW, B]
    c4 = collide_window(cfg, win, cand, ay)                   # [4, B]
    return c4[0], c4[1], c4[2], c4[3]


def engine_step(cfg: EnvConfig, state: EnvState, action: jnp.ndarray,
                injected_r: Optional[jnp.ndarray] = None) -> StepOut:
    """One batched transition; operation order tracks tetris_env.py:243-304.

    ``injected_r``: optional int32[B] of raw ``randint(1, sum(m))`` draws
    recorded from the reference, for bitwise trajectory parity. Ignored on
    steps where no spawn occurs.
    """
    H, W = cfg.height, cfg.width
    piece, rot = state.piece, state.rot
    ax, ay, lock = state.ax, state.ay, state.lock
    rows_w = _to_words(cfg, state.rows)                       # [H, NW, B]
    valid_w = jnp.asarray(_valid_words(cfg))[:, None]         # [NW, 1]

    # -- action: left/right/rotate candidates at the current anchor row ---------
    # (anchor int-coercion at :244 is implicit: anchors are int32)
    c_left, c_right, c_rotl, c_rotr = candidate_collisions(
        cfg, rows_w, piece, rot, ax, ay)

    is_l = action == A_LEFT
    is_r = action == A_RIGHT
    is_h = action == A_HARD
    is_s = action == A_SOFT
    is_rl = action == A_ROTL
    is_rr = action == A_ROTR

    ax1 = ax + jnp.where(is_l & ~c_left, -1, 0) + jnp.where(is_r & ~c_right, 1, 0)
    rot1 = (rot + jnp.where(is_rl & ~c_rotl, -1, 0)
            + jnp.where(is_rr & ~c_rotr, 1, 0)) % 4

    # -- one dense collision profile at the post-action configuration -----------
    # (soft/hard/idle don't change rot/ax, so the profile serves them too)
    masks1 = piece_masks(cfg, piece, rot1, ax1)               # [NROWS, NW, B]
    rows_pad = pad_rows(rows_w)
    coll = collide_profile(cfg, rows_pad, masks1)             # [H+1, B]

    c_soft = profile_at(coll, ay + 1)
    idxs = jnp.arange(H + 1, dtype=_I32)[:, None]
    blocked = jnp.where((idxs > ay[None, :]) & coll, idxs, H + 2)
    ay_hard = blocked.min(axis=0) - 1                         # hard-drop landing

    ay1 = jnp.where(is_h, ay_hard,
                    jnp.where(is_s & ~c_soft, ay + 1, ay))

    # -- gravity: one extra soft drop every step (:247) --------------------------
    g_coll = profile_at(coll, ay1 + 1)
    ay2 = ay1 + jnp.where(g_coll, 0, 1)
    if cfg.step_reset:                                        # :248-249
        lock0 = jnp.where(ay2 != ay1, 0, lock)
    else:
        lock0 = lock
    time_next = state.time + 1                                # :253

    reward = jnp.full(ay.shape, 1.0 if cfg.reward_step else 0.0, _F32)  # :256

    # -- lock-delay FSM (:259-262) ----------------------------------------------
    resting = profile_at(coll, ay2 + 1)                       # _has_dropped (:202)
    lock1 = jnp.where(resting, (lock0 + 1) % cfg.lock_modulus, lock0)
    locked = resting & (lock1 == 0)

    # -- lock: burn piece, clear lines, score, death, penalties, spawn ----------
    pb_lock = _place_bits_w(cfg, masks1, ay2)
    rows_locked = rows_w | jnp.where(locked[None, None, :], pb_lock, _U32(0))
    rows_cleared, n_clear = _clear_lines_w(cfg, rows_locked)
    n_clear = jnp.where(locked, n_clear, 0)
    rows_after = jnp.where(locked[None, None, :], rows_cleared, rows_w)
    lines_next = state.lines_cleared + n_clear

    if cfg.advanced_clears:                                   # :266-269
        sc = jnp.sum(jnp.where(
            jnp.arange(5, dtype=_I32)[:, None] == n_clear[None, :],
            jnp.asarray(_SCORES_TAB)[:, None], 0), axis=0)
        reward = reward + 2.5 * sc.astype(_F32)
        score_inc = sc
    elif cfg.high_scoring:                                    # :270-272
        reward = reward + 1000.0 * n_clear.astype(_F32)
        score_inc = n_clear
    else:                                                     # :273-275
        reward = reward + 100.0 * n_clear.astype(_F32)
        score_inc = n_clear
    score_next = state.score + jnp.where(locked, score_inc, 0)

    death = locked & ((rows_after[0] & valid_w) != 0).any(axis=0)   # :277
    alive_lock = locked & ~death

    old_holes = state.holes
    holes_new = count_holes(cfg, rows_after)
    holes_next = jnp.where(locked, holes_new, old_holes)      # only at lock

    piece_height_next = state.piece_height
    if cfg.penalise_height:                                   # :286-287
        reward = reward - jnp.where(alive_lock,
                                    nonempty_rows(cfg, rows_after), 0).astype(_F32)
    elif cfg.penalise_height_increase:                        # :288-292
        nh = nonempty_rows(cfg, rows_after)
        inc = nh - state.piece_height
        reward = reward - jnp.where(alive_lock & (inc > 0), 10 * inc, 0).astype(_F32)
        piece_height_next = jnp.where(alive_lock, nh, state.piece_height)
    if cfg.penalise_holes:                                    # :294-295
        reward = reward - jnp.where(alive_lock, 5 * holes_new, 0).astype(_F32)
    elif cfg.penalise_holes_increase:                         # :296-297
        reward = reward - jnp.where(alive_lock,
                                    5 * (holes_new - old_holes), 0).astype(_F32)

    # death overwrites everything accumulated this step (:281)
    reward = jnp.where(death, _F32(-100.0), reward)
    deaths_next = state.deaths + death.astype(_I32)

    # -- spawn (only on alive lock; no spawn on death, :283-299) ----------------
    carry_key, draw_key = _advance_key(state.key)
    if injected_r is None:
        r_draw = draw_spawn_r(draw_key, state.shape_counts)
    else:
        r_draw = injected_r.astype(_I32)
    piece_new = sample_piece(state.shape_counts, r_draw)
    piece_next = jnp.where(alive_lock, piece_new, piece)
    rot_next = jnp.where(alive_lock, 0, rot1)
    ax_next = jnp.where(alive_lock, cfg.spawn_x, ax1)
    ay_next = jnp.where(alive_lock, 0, ay2)
    spawn_oh = (jnp.arange(7, dtype=_I32)[:, None] == piece_new[None, :])
    counts_next = state.shape_counts + jnp.where(
        alive_lock[None, :] & spawn_oh, 1, 0)

    # -- emit: burn piece, copy, erase (:301-303) — including the erase quirks --
    m_emit = piece_masks(cfg, piece_next, rot_next, ax_next)
    pb_emit = _place_bits_w(cfg, m_emit, ay_next)
    emitted = _from_words(cfg, rows_after | pb_emit)
    rows_next = _from_words(cfg, rows_after & jnp.bitwise_not(pb_emit))

    new_state = state.replace(
        rows=rows_next, piece=piece_next, rot=rot_next,
        ax=ax_next, ay=ay_next, lock=lock1,
        time=time_next, score=score_next, holes=holes_next,
        lines_cleared=lines_next, piece_height=piece_height_next,
        deaths=deaths_next, shape_counts=counts_next, key=carry_key,
    )
    return StepOut(new_state, emitted, reward, death)


def engine_clear(cfg: EnvConfig, state: EnvState,
                 injected_r: Optional[jnp.ndarray] = None):
    """Episode reset (``TetrisEngine.clear``, tetris_env.py:306-315): zero the
    board and per-episode counters, spawn a piece — but carry over
    ``_lock_delay``, ``n_deaths`` and ``shape_counts`` (deliberately not reset
    there). Returns (state, emitted_rows): the reference's reset observation is
    the zeroed board *without* the spawned piece burned in (:313-315).
    """
    zeros_i = jnp.zeros_like(state.time)
    carry_key, draw_key = _advance_key(state.key)
    if injected_r is None:
        r_draw = draw_spawn_r(draw_key, state.shape_counts)
    else:
        r_draw = injected_r.astype(_I32)
    piece_new = sample_piece(state.shape_counts, r_draw)
    spawn_oh = (jnp.arange(7, dtype=_I32)[:, None] == piece_new[None, :])
    counts_next = state.shape_counts + spawn_oh.astype(_I32)
    rows0 = jnp.zeros_like(state.rows)
    new_state = state.replace(
        rows=rows0, piece=piece_new,
        rot=zeros_i, ax=jnp.full_like(state.ax, cfg.spawn_x), ay=zeros_i,
        time=zeros_i, score=zeros_i, holes=zeros_i,
        lines_cleared=zeros_i, piece_height=zeros_i,
        shape_counts=counts_next, key=carry_key,
        # lock, deaths intentionally carried over
    )
    return new_state, rows0


def render_rows(cfg: EnvConfig, state: EnvState) -> jnp.ndarray:
    """Board copy with the active piece burned in (``TetrisEngine.render``,
    tetris_env.py:317-321), state layout. ``rows`` is invariantly
    piece-erased, so this is a pure OR."""
    m = piece_masks(cfg, state.piece, state.rot, state.ax)
    return state.rows | place_bits(cfg, m, state.ay)


def valid_action_count(cfg: EnvConfig, state: EnvState) -> jnp.ndarray:
    """Number of actions that would change (shape, anchor)
    (``valid_action_count``, tetris_env.py:222-230): idle never counts; a
    rotated offset-list never compares equal to the original, so rotations
    count iff unobstructed; soft_drop and hard_drop each count iff one soft
    drop is possible."""
    c4 = jnp.stack(candidate_collisions(
        cfg, state.rows, state.piece, state.rot, state.ax, state.ay), axis=0)
    win_dn = extract_window(cfg, state.rows, state.ay + 1)
    m_cur = piece_masks(cfg, state.piece, state.rot, state.ax)
    c_soft = collide_window(cfg, win_dn, m_cur[None], state.ay + 1)[0]
    return ((~c4).sum(axis=0) + 2 * (~c_soft).astype(_I32)).astype(_I32)
