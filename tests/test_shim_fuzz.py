"""Random-config shim-surface lockstep fuzz: the
fixed-config shim parity tests leave the config space unexplored at the
user-facing surfaces. Here random (geometry x flags x obs) configurations
drive all three single-env surfaces — ``gym_compat.TetrisEnv``, the
standalone ``TetrisEngine`` class, and ``NativeTetrisEnv`` — against the
in-place-loaded reference (tetris_env.py:397-433), comparing obs + reward +
done + the full info dict (or board + reward + done + info at the engine
surface) at every step.

Deeper soaks of the same families: tools/soak_shim.py.
"""

import numpy as np
import pytest

from reference_oracle import reference_available

pytestmark = pytest.mark.skipif(
    not reference_available(), reason="reference repo not mounted")


def random_env_kwargs(rng, with_obs=True):
    kw = dict(
        width=int(rng.randint(4, 17)),
        height=int(rng.randint(5, 25)),
        lock_delay=int(rng.choice([0, 0, 1, 2, 4])),
        step_reset=bool(rng.randint(2)),
        reward_step=bool(rng.randint(2)),
        penalise_height=bool(rng.randint(2)),
        penalise_height_increase=bool(rng.randint(2)),
        advanced_clears=bool(rng.randint(2)),
        high_scoring=bool(rng.randint(2)),
        penalise_holes=bool(rng.randint(2)),
        penalise_holes_increase=bool(rng.randint(2)),
    )
    if with_obs:
        kw["obs_type"] = str(rng.choice(["ram", "grayscale", "rgb"]))
        kw["extend_dims"] = bool(rng.randint(2))
    return kw


@pytest.mark.parametrize("case", range(8))
def test_gym_compat_random_config_lockstep(case):
    from test_env_parity import run_env_lockstep
    rng = np.random.RandomState(1000 + case)
    kw = random_env_kwargs(rng)
    # image obs on very tall/wide boards is slow on CPU; cap steps there
    steps = 150 if kw["obs_type"] == "ram" else 60
    run_env_lockstep(n_steps=steps, policy_seed=case, seed=2000 + case, **kw)


@pytest.mark.parametrize("case", range(5))
def test_standalone_engine_random_config_lockstep(case):
    from test_engine_standalone import run_lockstep
    rng = np.random.RandomState(3000 + case)
    kw = random_env_kwargs(rng, with_obs=False)
    run_lockstep(200, seed=4000 + case, policy_seed=case, **kw)


@pytest.mark.parametrize("case", range(5))
def test_native_env_random_config_lockstep(case):
    from reference_oracle import OracleEnv
    from gym_simpletetris_tpu.api.native_env import NativeTetrisEnv

    rng = np.random.RandomState(5000 + case)
    kw = random_env_kwargs(rng)
    ref = OracleEnv(seed=6000 + case, **kw)
    nat = NativeTetrisEnv(**kw)
    robs, draws = ref.reset()
    nobs = nat.reset(injected_r=draws[0])
    np.testing.assert_array_equal(robs, nobs)
    for t in range(120):
        a = int(rng.randint(0, 7))
        (robs, rrew, rdone, rinfo), draws = ref.step(a)
        no, nr, nd, ni = nat.step(a, injected_r=draws[0] if draws else 0)
        np.testing.assert_array_equal(robs, no,
                                      err_msg=f"obs t={t} kw={kw}")
        assert float(rrew) == nr and bool(rdone) == nd, f"t={t} kw={kw}"
        assert rinfo == ni, f"info t={t}: {rinfo} vs {ni}"
        if rdone:
            robs, draws = ref.reset()
            nobs = nat.reset(injected_r=draws[0])
            np.testing.assert_array_equal(robs, nobs)
