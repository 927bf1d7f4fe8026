"""The pytree-dataclass helper (core/pytree.py) on every state type that uses
it: flatten/unflatten round trip, ``.replace``, immutability, and static
fields kept out of the leaves and inside jit's cache key."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_simpletetris_tpu import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu.core.pytree import pytree_dataclass, static_field

_ENV = EnvConfig(width=6, height=8, auto_reset=True, reward_step=True)


def _env_state():
    from gym_simpletetris_tpu.core.state import init_state
    return init_state(_ENV, 4, jax.random.PRNGKey(0))


def _replay_state():
    from gym_simpletetris_tpu.train.replay import replay_init
    return replay_init(16, (3, 2), 4)


def _frame_ring_state():
    from gym_simpletetris_tpu.train.replay import frame_ring_init
    return frame_ring_init(32, (3, 2), 4, frame_stack=2, n_step=2,
                           stacked=True)


def _dqn_state():
    from gym_simpletetris_tpu.train.dqn import DQNConfig, make_train
    cfg = DQNConfig(env=_ENV, num_envs=4, buffer_capacity=32, learn_batch=8,
                    learn_starts=8)
    return make_train(cfg)[0](jax.random.PRNGKey(0))


def _ppo_state():
    from gym_simpletetris_tpu.train.ppo import PPOConfig, make_ppo
    cfg = PPOConfig(env=_ENV, num_envs=4, rollout_len=4, num_minibatches=2)
    return make_ppo(cfg)[0](jax.random.PRNGKey(0))


def _es_state():
    from gym_simpletetris_tpu.train.es import ESConfig, make_es
    cfg = ESConfig(env=_ENV, pop_size=4, envs_per_member=1, horizon=4,
                   hidden=(8,))
    return make_es(cfg)[0](jax.random.PRNGKey(0))


def _frame_stack_state():
    from gym_simpletetris_tpu.api.wrappers import FrameStack
    return FrameStack(TetrisVectorEnv(_ENV, 4), 2).reset(
        jax.random.PRNGKey(0))[1]


def _episode_stats_state():
    from gym_simpletetris_tpu.api.wrappers import EpisodeStats
    return EpisodeStats(TetrisVectorEnv(_ENV, 4)).reset(
        jax.random.PRNGKey(0))[1]


STATES = {
    "EnvState": _env_state, "ReplayState": _replay_state,
    "FrameRingState": _frame_ring_state, "DQNState": _dqn_state,
    "PPOState": _ppo_state, "ESState": _es_state,
    "FrameStackState": _frame_stack_state,
    "EpisodeStatsState": _episode_stats_state,
}


@pytest.mark.parametrize("name", sorted(STATES))
def test_state_is_a_frozen_pytree_dataclass(name):
    st = STATES[name]()
    assert type(st).__name__ == name and dataclasses.is_dataclass(st)
    leaves, treedef = jax.tree_util.tree_flatten(st)
    assert leaves and all(hasattr(x, "shape") for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(st)
    assert jax.tree_util.tree_structure(back) == treedef
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # leaves are addressed by field name (GetAttrKey), as checkpoints and
    # train/sharding.py's path rules expect
    paths = jax.tree_util.tree_flatten_with_path(st)[0]
    fields = {f.name for f in dataclasses.fields(st)}
    assert {p[0].name for p, _ in paths} <= fields
    # .replace swaps one field and leaves the original untouched (frozen)
    first = dataclasses.fields(st)[0].name
    marker = jnp.zeros((1,))
    new = st.replace(**{first: marker})
    assert getattr(new, first) is marker and getattr(st, first) is not marker
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(st, first, marker)


@pytest.mark.parametrize("name,static", [
    ("ReplayState", {"obs_shape": (3, 2)}),
    ("FrameRingState", {"base_shape": (3, 2), "frame_stack": 2,
                        "n_step": 2, "gamma": 0.99, "stacked": True}),
])
def test_static_fields_live_in_the_treedef(name, static):
    st = STATES[name]()
    for field, value in static.items():
        assert getattr(st, field) == value
    leaves = jax.tree_util.tree_leaves(st)
    assert all(hasattr(x, "shape") for x in leaves)   # no static in leaves
    traces = []

    @jax.jit
    def f(s):
        traces.append(1)
        return jax.tree_util.tree_leaves(s)[0]

    f(st)
    f(st)
    assert len(traces) == 1                            # same statics: cached
    field, value = next(iter(static.items()))
    changed = value + (1,) if isinstance(value, tuple) else not value \
        if isinstance(value, bool) else value + 1
    f(st.replace(**{field: changed}))
    assert len(traces) == 2                            # new static: retrace


def test_decorator_on_a_fresh_class():
    @pytree_dataclass
    class Pair:
        a: jnp.ndarray
        tag: str = static_field(default="x")

    p = Pair(jnp.ones(3))
    assert jax.tree_util.tree_leaves(p)[0].shape == (3,)
    q = jax.tree.map(lambda x: x * 2, p)
    assert q.tag == "x" and float(q.a.sum()) == 6.0
    assert p.replace(tag="y").tag == "y"
