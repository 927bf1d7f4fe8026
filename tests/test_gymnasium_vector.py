"""gymnasium.vector.VectorEnv adapters: v1 next-step-autoreset convention on
both backends (jitted JAX engine and host C++ engine)."""

from __future__ import annotations

import numpy as np
import pytest

gymnasium = pytest.importorskip("gymnasium")

from gym_simpletetris_tpu.api.registry import make_gymnasium_vector_env
from gym_simpletetris_tpu.native import native_available

BACKENDS = ["tpu"] + (["native"] if native_available() else [])


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_env_api_and_autoreset_convention(backend):
    n = 8
    env = make_gymnasium_vector_env(n, backend=backend, obs_type="ram",
                                    reward_step=True, seed=3)
    assert isinstance(env, gymnasium.vector.VectorEnv)
    assert env.observation_space.shape == (n, 10, 20)
    obs, info = env.reset()
    assert obs.shape == (n, 10, 20) and not obs.any()  # reset obs = empty board
    assert info["_time"].all() and (info["time"] == 0).all()

    rng = np.random.RandomState(0)
    prev_term = np.zeros(n, dtype=bool)
    seen_reset_after_term = 0
    seen_term = 0
    for t in range(400):
        a = rng.randint(0, 7, n)
        obs, reward, term, trunc, info = env.step(a)
        assert not trunc.any()  # reference has no TimeLimit
        # next-step convention: envs that terminated last step are reset now —
        # empty-board obs, reward 0, terminated False
        for i in np.nonzero(prev_term)[0]:
            assert not term[i]
            assert reward[i] == 0.0
            assert not obs[i].any(), f"t={t} env{i}: reset obs must be empty"
            seen_reset_after_term += 1
        # terminal steps return the TERMINAL observation (locked board burnt
        # in -> non-empty) and the death reward
        for i in np.nonzero(term)[0]:
            assert reward[i] == -100.0
            assert obs[i].any(), f"t={t} env{i}: terminal obs must show board"
            seen_term += 1
        prev_term = term
    assert seen_term > 0 and seen_reset_after_term > 0
    env.close()


def test_standard_wrappers_accept_adapter():
    """gymnasium's own vector wrappers assert on the AutoresetMode enum —
    regression for the string-metadata bug."""
    from gymnasium.wrappers.vector import RecordEpisodeStatistics
    env = make_gymnasium_vector_env(4, backend="tpu", obs_type="ram",
                                    reward_step=True, seed=4)
    wrapped = RecordEpisodeStatistics(env)
    wrapped.reset()
    rng = np.random.RandomState(0)
    finished = 0
    for _ in range(200):
        obs, rew, term, trunc, info = wrapped.step(rng.randint(0, 7, 4))
        if "episode" in info:
            finished += int(np.asarray(info["_episode"]).sum())
    assert finished > 0


def test_reset_without_seed_gives_fresh_episodes():
    env = make_gymnasium_vector_env(4, backend="tpu", obs_type="ram", seed=1)
    env.reset()
    tr1 = [env.step(np.full(4, 2))[0].copy() for _ in range(8)]
    env.reset()
    tr2 = [env.step(np.full(4, 2))[0].copy() for _ in range(8)]
    assert any(not np.array_equal(a, b) for a, b in zip(tr1, tr2))


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_env_grayscale_spaces(backend):
    env = make_gymnasium_vector_env(4, backend=backend, obs_type="grayscale")
    obs, _ = env.reset()
    assert obs.shape == (4, 84, 84)
    obs, r, term, trunc, info = env.step(np.zeros(4, np.int64))
    assert set(np.unique(obs)) <= {0.0, 128.0, 190.0}
    assert info["statistics"].shape == (4, 7)
    env.close()
