"""Unit/property tests for engine primitives and the §2.2 quirk table — these are
reference-free (the rules they encode cite tetris_env.py; parity tests provide the
oracle cross-check)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_simpletetris_tpu.core import engine as E
from gym_simpletetris_tpu.core.config import EnvConfig
from gym_simpletetris_tpu.core.pieces import PIECE_NAMES
from gym_simpletetris_tpu.core.state import init_state
from gym_simpletetris_tpu.ops.bitops import pack_board, unpack_board

CFG = EnvConfig()


def _collide_single(cfg, board_wh, piece, rot, ax, ay):
    rows = jnp.asarray(pack_board(cfg, board_wh))[:, None]       # [H, 1]
    masks = E.piece_masks(cfg, jnp.array([piece]), jnp.array([rot]), jnp.array([ax]))
    coll = E.collide_profile(cfg, E.pad_rows(rows), masks)       # [H+1, 1]
    return bool(coll[ay, 0])


def _brute_collide(cfg, board_wh, offsets, ax, ay):
    """Direct transcription of the is_occupied rules (tetris_env.py:29-36)."""
    for dx, dy in offsets:
        x, y = ax + dx, ay + dy
        if y < 0:
            continue
        if x < 0 or x >= cfg.width or y >= cfg.height or board_wh[x, y]:
            return True
    return False


def test_y_negative_skips_x_bounds():
    """S piece at anchor (0,0) has a cell at (-1,-1): above-board cells skip ALL
    checks including x-bounds (tetris_env.py:31-34) — so this is NOT occupied."""
    cfg = CFG
    board = np.zeros((cfg.width, cfg.height))
    s = PIECE_NAMES.index("S")
    assert not _collide_single(cfg, board, s, 0, 0, 0)


def test_collision_matches_brute_force_random():
    from gym_simpletetris_tpu.core.pieces import OFFSETS
    rng = np.random.RandomState(0)
    cfg = EnvConfig(width=7, height=9)
    for trial in range(200):
        board = (rng.rand(cfg.width, cfg.height) < 0.3).astype(float)
        p = rng.randint(7)
        r = rng.randint(4)
        ax = rng.randint(0, cfg.width)
        ay = rng.randint(0, cfg.height)
        got = _collide_single(cfg, board, p, r, ax, ay)
        want = _brute_collide(cfg, board, OFFSETS[p, r].tolist(), ax, ay)
        assert got == want, (trial, p, r, ax, ay)


def test_hard_drop_equals_iterated_soft_drop():
    """Profile-argmin landing must equal the reference's soft-drop fixpoint loop
    (tetris_env.py:54-59), via brute force."""
    from gym_simpletetris_tpu.core.pieces import OFFSETS
    rng = np.random.RandomState(1)
    cfg = EnvConfig(width=8, height=10)
    for trial in range(200):
        board = (rng.rand(cfg.width, cfg.height) < 0.25).astype(float)
        p, r = rng.randint(7), rng.randint(4)
        ax = rng.randint(0, cfg.width)
        ay = rng.randint(0, cfg.height)
        offs = OFFSETS[p, r].tolist()
        if _brute_collide(cfg, board, offs, ax, ay):
            continue  # unreachable start
        # brute force: drop until next would collide
        y = ay
        while not _brute_collide(cfg, board, offs, ax, y + 1):
            y += 1
        rows = jnp.asarray(pack_board(cfg, board))[:, None]
        masks = E.piece_masks(cfg, jnp.array([p]), jnp.array([r]), jnp.array([ax]))
        coll = E.collide_profile(cfg, E.pad_rows(rows), masks)   # [H+1, 1]
        idxs = jnp.arange(cfg.height + 1)[:, None]
        blocked = jnp.where((idxs > ay) & coll, idxs, cfg.height + 2)
        got = int(blocked.min(axis=0)[0]) - 1
        assert got == y, (trial, p, r, ax, ay, got, y)


def test_clear_lines_stable_compaction():
    cfg = EnvConfig(width=4, height=6)
    b = np.zeros((4, 6))
    b[:, 1] = 1          # full row at y=1
    b[0, 0] = 1          # partial above
    b[1, 3] = 1          # partial below
    b[:, 5] = 1          # full bottom row
    rows = jnp.asarray(pack_board(cfg, b))[:, None]
    cleared, n = E.clear_lines(cfg, rows)
    assert int(n[0]) == 2
    out = np.asarray(unpack_board(cfg, cleared))[0]
    want = np.zeros((4, 6))
    want[0, 2] = 1       # y=0 row: two cleared rows below it -> shifts down 2
    want[1, 4] = 1       # y=3 row: one cleared row below it (y=5) -> shifts down 1
    np.testing.assert_array_equal(out, want)


def test_count_holes_matches_reference_formula():
    cfg = EnvConfig(width=6, height=8)
    rng = np.random.RandomState(2)
    for _ in range(100):
        board = (rng.rand(cfg.width, cfg.height) < 0.4).astype(float)
        rows = jnp.asarray(pack_board(cfg, board))[:, None]
        got = int(E.count_holes(cfg, rows)[0])
        want = int(np.count_nonzero(board.cumsum(axis=1) * ~board.astype(bool)))
        assert got == want


def test_nonempty_rows_counts_rows_not_max_height():
    cfg = EnvConfig(width=4, height=6)
    b = np.zeros((4, 6))
    b[0, 0] = 1  # one cell at the very top, nothing below: "height" is 1, not 6
    rows = jnp.asarray(pack_board(cfg, b))[:, None]
    assert int(E.nonempty_rows(cfg, rows)[0]) == 1


def test_sampler_matches_linear_walk():
    rng = np.random.RandomState(3)
    for _ in range(200):
        counts = rng.randint(0, 20, size=(1, 7)).astype(np.int32)
        m = 5 + counts.max() - counts[0]
        s = int(m.sum())
        r = rng.randint(1, s + 1)
        # reference linear walk (tetris_env.py:188-191)
        rr = r
        for i, w in enumerate(m):
            rr -= int(w)
            if rr <= 0:
                want = i
                break
        got = int(E.sample_piece(jnp.asarray(counts).T, jnp.array([r]))[0])
        assert got == want


def _ledge_state(cfg):
    """O piece resting at (ax=1, ay=2) on a 2-cell ledge at y=3, x in {0,1}."""
    board = np.zeros((cfg.width, cfg.height))
    board[0, 3] = board[1, 3] = 1
    state = init_state(cfg, 1, jax.random.PRNGKey(0))
    state, _ = E.engine_clear(cfg, state, injected_r=jnp.array([31], jnp.int32))
    assert PIECE_NAMES[int(state.piece[0])] == "O"
    return state.replace(
        rows=jnp.asarray(pack_board(cfg, board))[:, None],
        ax=jnp.array([1], jnp.int32), ay=jnp.array([2], jnp.int32),
        lock=jnp.array([0], jnp.int32))


def _lock_step_index(cfg, actions):
    """Step the crafted ledge scenario; return the step at which the piece
    locks (detected by the post-lock respawn at ay == 0)."""
    state = _ledge_state(cfg)
    for i, a in enumerate(actions):
        out = E.engine_step(cfg, state, jnp.array([a], jnp.int32),
                            injected_r=jnp.array([1], jnp.int32))
        state = out.state
        if int(state.ay[0]) == 0:
            return i
    return None


def test_stale_lock_counter_across_ledge_slide():
    """§2.2 [verified] quirk (tetris_env.py:175,:248-249,:260): without
    step_reset the lock counter goes stale across a ledge slide — the O piece
    rests twice (counter -> 2 of modulus 3), slides off, falls to the floor,
    and locks on its *first* new resting step (2 -> 0). With step_reset the
    gravity move clears the counter, so it locks two steps later."""
    actions = [6, 1, 1, 6, 6, 6, 6, 6, 6]  # idle, right, right, idle...
    no_reset = _lock_step_index(
        EnvConfig(width=6, height=6, lock_delay=2, step_reset=False), actions)
    with_reset = _lock_step_index(
        EnvConfig(width=6, height=6, lock_delay=2, step_reset=True), actions)
    assert no_reset == 4   # rest(c1), rest(c2), fall, fall, rest -> c wraps: lock
    assert with_reset == 6  # counter cleared by the fall: 3 fresh resting steps


def test_batch_independence():
    """Envs in a batch must never interact: stepping [a,b] equals stepping each."""
    cfg = EnvConfig()
    key = jax.random.PRNGKey(0)
    s2 = init_state(cfg, 2, key)
    s2, _ = E.engine_clear(cfg, s2, injected_r=jnp.array([3, 17], jnp.int32))
    actions = np.random.RandomState(5).randint(0, 7, size=(50, 2))
    rs = np.random.RandomState(6).randint(1, 30, size=(50, 2))
    def bslice(s, lo, hi):
        return s.replace(
            rows=s.rows[:, lo:hi], piece=s.piece[lo:hi], rot=s.rot[lo:hi],
            ax=s.ax[lo:hi], ay=s.ay[lo:hi], lock=s.lock[lo:hi],
            time=s.time[lo:hi], score=s.score[lo:hi], holes=s.holes[lo:hi],
            lines_cleared=s.lines_cleared[lo:hi],
            piece_height=s.piece_height[lo:hi], deaths=s.deaths[lo:hi],
            shape_counts=s.shape_counts[:, lo:hi], key=s.key)
    sA = bslice(s2, 0, 1)
    sB = bslice(s2, 1, 2)
    for t in range(50):
        out2 = E.engine_step(cfg, s2, jnp.asarray(actions[t]),
                             injected_r=jnp.asarray(rs[t]))
        outA = E.engine_step(cfg, sA, jnp.asarray(actions[t, 0:1]),
                             injected_r=jnp.asarray(rs[t, 0:1]))
        outB = E.engine_step(cfg, sB, jnp.asarray(actions[t, 1:2]),
                             injected_r=jnp.asarray(rs[t, 1:2]))
        s2, sA, sB = out2.state, outA.state, outB.state
        np.testing.assert_array_equal(np.asarray(out2.emitted_rows[:, 0]),
                                      np.asarray(outA.emitted_rows[:, 0]))
        np.testing.assert_array_equal(np.asarray(out2.emitted_rows[:, 1]),
                                      np.asarray(outB.emitted_rows[:, 0]))
        assert float(out2.reward[0]) == float(outA.reward[0])
        assert float(out2.reward[1]) == float(outB.reward[0])


def test_config_validation():
    with pytest.raises(ValueError):
        EnvConfig(width=1)
    with pytest.raises(ValueError):
        EnvConfig(width=2000)
    with pytest.raises(ValueError):
        EnvConfig(obs_type="nope")
    with pytest.raises(ValueError):
        EnvConfig(raster_impl="nope")
    with pytest.raises(ValueError):
        EnvConfig(obs_dtype="float16")
    # wide boards use multi-word rows under every raster
    assert EnvConfig(width=30, raster_impl="sep").num_words == 2
    assert EnvConfig(width=24).num_words == 1
    assert EnvConfig(width=30).num_words == 2
    assert EnvConfig(width=56).num_words == 2
    assert EnvConfig(width=57).num_words == 3


def test_tall_board_h64():
    """H is unbounded (rows are packed along W only): a 10x64 board plays."""
    cfg = EnvConfig(width=10, height=64)
    state = init_state(cfg, 2, jax.random.PRNGKey(0))
    state, _ = E.engine_clear(cfg, state, injected_r=jnp.array([1, 9], jnp.int32))
    for t in range(80):
        out = E.engine_step(cfg, state, jnp.full((2,), 2, jnp.int32),
                            injected_r=jnp.array([t % 30 + 1] * 2, jnp.int32))
        state = out.state
    assert int(state.lines_cleared.sum()) >= 0
    assert int(state.ay.max()) < 64 and int(state.time[0]) == 80
