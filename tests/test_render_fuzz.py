"""CI-size render-geometry fuzz: every step's rendered image at the 160px
(rgb_array) and 512px (human window) sizes vs the host raster of the C++
oracle's boards.

This is the in-suite twin of ``tools/soak_fuzz.py --pixels --pixel-size
160/512`` (test_raster.py checks the non-84 render paths against the
reference only at fixed boards; this fuzzes them soak style against the
oracle). Geometry per reference
``tetris_env.py:446`` (rgb_array 160) and ``:460`` (human 512); the 84px
observation path has its own CI fuzz via the --pixels soak families and
test_parity_obs.py.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gym_simpletetris_tpu import EnvConfig
from gym_simpletetris_tpu.native.lockstep import drive_oracle, replay_engine
from gym_simpletetris_tpu.ops.bitops import unpack_rows
from gym_simpletetris_tpu.ops.raster import rasterize, rasterize_host_batch

# (config, pixel size, B, T): one standard board per size, plus a
# multi-word wide board (W>24) at each size — the soak tool's two
# previously-uncovered families, CI-sized.
CASES = [
    (EnvConfig(width=10, height=20, lock_delay=2, step_reset=True), 160, 16, 96),
    (EnvConfig(width=33, height=14, advanced_clears=True), 160, 16, 96),
    (EnvConfig(width=10, height=20, high_scoring=True), 512, 8, 48),
    (EnvConfig(width=40, height=26, lock_delay=1), 512, 8, 48),
]


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_render_fuzz_vs_oracle(ci):
    cfg, size, B, T = CASES[ci]
    rng = np.random.RandomState(9000 + ci)
    # drop-heavy script: a lock every ~2 steps maximizes board churn
    actions = np.asarray([0, 1, 2, 2, 2, 4, 5], np.int32)[
        rng.randint(0, 7, size=(T, B))]
    out = drive_oracle(cfg, actions,
                       rng.randint(1, 1 << 31, B).astype(np.uint64))
    _, em, _, _ = replay_engine(cfg, actions, out, jax.random.PRNGKey(ci))

    # em: [T, ...packed rows (batch-minor)...]; unpack_rows -> [B, H, W],
    # rasterize is batched over its leading axis -> imgs [T, B, size, size]
    imgs = np.asarray(jax.jit(jax.vmap(
        lambda e: rasterize(unpack_rows(cfg, e, dtype=jnp.uint8),
                            cfg.height, cfg.width, size)))(em))
    want = rasterize_host_batch(
        np.transpose(out["boards"], (1, 0, 3, 2)).reshape(
            -1, cfg.height, cfg.width),
        cfg.height, cfg.width, size).reshape(imgs.shape)
    np.testing.assert_array_equal(imgs, want, err_msg=f"cfg={cfg} size={size}")
