"""Spawn-sampler statistics (SURVEY.md §4.5).

Throughput is measured on the card by ``bench.py``, never in the CPU suite.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gym_simpletetris_tpu.core import engine as E


def test_piece_sampler_is_count_balancing():
    """The threefry sampler must reproduce the reference's count-balanced
    distribution: weights 5 + max(counts) - counts (tetris_env.py:183-191).
    With skewed counts, the starved piece must be drawn ~max_weight/sum more
    often than the saturated one."""
    counts = jnp.asarray(
        np.array([[20, 0, 10, 10, 10, 10, 10]], np.int32).T)  # [7, 1]
    counts = jnp.tile(counts, (1, 20000))                     # [7, B]
    key = jax.random.wrap_key_data(jnp.array([1, 2], jnp.uint32))
    r = E.draw_spawn_r(key, counts)
    pieces = np.asarray(E.sample_piece(counts, r))
    freq = np.bincount(pieces, minlength=7) / pieces.size
    m = np.array([5, 25, 15, 15, 15, 15, 15], float)
    expect = m / m.sum()
    np.testing.assert_allclose(freq, expect, atol=0.01)
