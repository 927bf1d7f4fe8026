"""CPU-side performance canaries: compiled-cost regression guards.

Throughput needs the card (bench.py); these canaries instead pin the
*compiled cost profile* of the hot paths via
``compiled.cost_analysis()`` on the CPU backend, so CI catches gross
regressions — a materialized float32 image (4x bytes), a materialized rgb
triple (3x), a replay ring that copies its buffers every insert (10x+) —
without any hardware. Budgets are ~2x the measured values
(see git history for calibration), loose enough to survive compiler-version
drift, tight enough that the known failure modes blow through them.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import pytest

from gym_simpletetris_tpu import EnvConfig
from gym_simpletetris_tpu.api.env import build_rollout
from gym_simpletetris_tpu.core.state import init_state

B, T = 256, 8


def _cost(fn, *args):
    comp = jax.jit(fn).lower(*args).compile()
    ca = comp.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return ca


def _rollout_cost(obs_type, **cfg_kw):
    # unroll=1: cost_analysis counts each unrolled body instance's
    # intermediates separately (~3.7x at the default unroll=4), which would
    # drown the materialization signal these budgets exist to catch.
    cfg = EnvConfig(obs_type=obs_type, auto_reset=True, **cfg_kw)
    fn = build_rollout(cfg, B, None, True, acc_mode="storage", unroll=1)
    st = init_state(cfg, B, jax.random.PRNGKey(0))
    acts = jnp.zeros((T, B), jnp.int32)
    return _cost(fn, st, acts)


def test_rollout_bytes_budget():
    """Absolute bytes-accessed budgets (measured 1.85 / 29.3 MB)."""
    assert _rollout_cost("ram")["bytes accessed"] < 4e6
    assert _rollout_cost("grayscale")["bytes accessed"] < 60e6


def test_rgb_costs_no_more_than_grayscale():
    """The rgb channel triple must stay a lazy broadcast: its compiled
    storage-obs pipeline may not touch more bytes than grayscale's."""
    g = _rollout_cost("grayscale")["bytes accessed"]
    r = _rollout_cost("rgb")["bytes accessed"]
    assert r <= g * 1.02, (r, g)


def test_f32_delivery_costs_no_more_than_uint8():
    """float32 delivery is a fused cast of the uint8 storage pipeline — the
    obs_dtype knob may not change the compiled cost of storage production."""
    a = _rollout_cost("grayscale", obs_dtype="float32")["bytes accessed"]
    b = _rollout_cost("grayscale", obs_dtype="uint8")["bytes accessed"]
    assert a <= b * 1.02, (a, b)


def test_train_chunk_bytes_budget():
    """Full DQN train chunk (insert + sample + TD learner) over a 65536-row
    ring: a ring that copies its buffers per insert (~54 MB/step here) blows
    this budget by >3x (measured 128 MB for the 8-step chunk)."""
    from gym_simpletetris_tpu.train.dqn import DQNConfig, make_train
    cfg = DQNConfig(
        env=EnvConfig(obs_type="ram", auto_reset=True, reward_step=True),
        num_envs=64, buffer_capacity=65536, learn_batch=64, learn_starts=128)
    init_fn, _, chunk_fn, _ = make_train(cfg)
    st = init_fn(jax.random.PRNGKey(0))
    ca = _cost(partial(chunk_fn, n=8), st)
    assert ca["bytes accessed"] < 300e6, ca["bytes accessed"]


def test_obs_ring_chunk_cheaper_than_legacy_at_frame_stack():
    """The obs-ring layout exists because the legacy layout's per-step
    stacked-obs plumbing (shift + window push + obs/next insert) moves tens
    of MB per flagship actor step. Pin the structural
    advantage: with frame stacking + n-step, the obs-ring train chunk must
    touch well under the legacy chunk's bytes."""
    from gym_simpletetris_tpu.train.dqn import DQNConfig, make_train

    def chunk_bytes(**kw):
        cfg = DQNConfig(
            env=EnvConfig(obs_type="grayscale", auto_reset=True,
                          reward_step=True),
            num_envs=64, buffer_capacity=8192, learn_batch=64,
            learn_starts=128, frame_stack=4, n_step=3, learn_every=4, **kw)
        init_fn, _, chunk_fn, _ = make_train(cfg)
        st = init_fn(jax.random.PRNGKey(0))
        return _cost(partial(chunk_fn, n=8), st)["bytes accessed"]

    legacy = chunk_bytes()
    obs_ring = chunk_bytes(frame_ring=True, ring_stacks=True)
    assert obs_ring < 0.75 * legacy, (obs_ring, legacy)
