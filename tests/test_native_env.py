"""Host-native single-env (api/native_env.NativeTetrisEnv): obs-level parity
vs the reference TetrisEnv, engine attribute view, and registry wiring."""

from __future__ import annotations

import numpy as np
import pytest

from reference_oracle import OracleEnv, reference_available
from gym_simpletetris_tpu.native import native_available

if native_available():
    from gym_simpletetris_tpu.api.native_env import NativeTetrisEnv

pytestmark = pytest.mark.skipif(
    not native_available(), reason="g++ toolchain unavailable")


CASES = [
    dict(obs_type="ram"),
    dict(obs_type="ram", extend_dims=True, width=9, height=12),
    dict(obs_type="grayscale", reward_step=True),
    dict(obs_type="grayscale", extend_dims=True),
    dict(obs_type="rgb", advanced_clears=True, lock_delay=1),
]


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
@pytest.mark.parametrize("kw", CASES, ids=lambda k: "-".join(
    f"{a}={v}" for a, v in k.items()))
def test_native_env_obs_parity(kw):
    """Byte-identical observations/rewards/done/info vs the reference TetrisEnv
    under an identical injected draw stream, through full episodes."""
    ref = OracleEnv(seed=11, **kw)
    nat = NativeTetrisEnv(**kw)

    robs, draws = ref.reset()
    nobs = nat.reset(injected_r=draws[0])
    assert robs.dtype == nobs.dtype == np.float32
    np.testing.assert_array_equal(robs, nobs)

    rng = np.random.RandomState(3)
    for t in range(150):
        a = int(rng.randint(0, 7))
        (ro, rr, rd, ri), draws = ref.step(a)
        no, nr, nd, ni = nat.step(a, injected_r=draws[0] if draws else 0)
        np.testing.assert_array_equal(ro, no, err_msg=f"t={t} kw={kw}")
        assert float(rr) == nr and bool(rd) == nd
        assert ri == ni, (t, ri, ni)
        if rd:
            robs, draws = ref.reset()
            nobs = nat.reset(injected_r=draws[0])
            np.testing.assert_array_equal(robs, nobs)


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_native_env_rgb_array_render_parity():
    ref = OracleEnv(seed=4, obs_type="ram")
    nat = NativeTetrisEnv(obs_type="ram")
    _, draws = ref.reset()
    nat.reset(injected_r=draws[0])
    rng = np.random.RandomState(0)
    for t in range(40):
        a = int(rng.randint(0, 7))
        (_, _, rd, _), draws = ref.step(a)
        nat.step(a, injected_r=draws[0] if draws else 0)
        if t % 10 == 0:
            np.testing.assert_array_equal(
                ref.env.render("rgb_array"), nat.render("rgb_array"))
        if rd:
            _, draws = ref.reset()
            nat.reset(injected_r=draws[0])


def test_engine_attribute_view():
    env = NativeTetrisEnv(obs_type="ram", seed=9)
    env.reset()
    eng = env.engine
    assert eng.shape_name in "TJLZSIO"
    assert isinstance(eng.anchor, tuple) and eng.anchor[1] == 0
    assert len(eng.shape) == 4 and all(len(c) == 2 for c in eng.shape)
    assert eng.time == 0 and eng.score == 0 and eng.n_deaths == 0
    assert sum(eng.shape_counts.values()) == 1
    assert eng.board.shape == (10, 20) and not eng.board.any()
    assert 0 <= env.valid_action_count() <= 6
    assert env.__repr__().count("\n") == 21  # H rows + 2 borders


def test_wide_board_beyond_packed_limit():
    """The native env supports widths past the packed engine's one-word 24."""
    env = NativeTetrisEnv(width=40, height=8, obs_type="ram", seed=2)
    obs = env.reset()
    assert obs.shape == (40, 8)
    done_seen = False
    for t in range(200):
        _, _, d, info = env.step(2)  # hard-drop spam
        if d:
            done_seen = True
            env.reset()
    assert done_seen and info["deaths"] >= 1


def test_native_vector_env_matches_single_games():
    """NativeVectorEnv == B independent NativeTetrisEnv with clear-on-done."""
    from gym_simpletetris_tpu.api.native_env import NativeVectorEnv
    B, T = 12, 250
    venv = NativeVectorEnv(B, obs_type="ram", auto_reset=True, seed=100,
                           reward_step=True, with_info=True)
    singles = [NativeTetrisEnv(obs_type="ram", seed=100 + i, reward_step=True)
               for i in range(B)]
    vobs = venv.reset()
    sobs = np.stack([e.reset() for e in singles])
    np.testing.assert_array_equal(vobs, sobs)
    rng = np.random.RandomState(0)
    deaths = 0
    for t in range(T):
        a = rng.randint(0, 7, B)
        vobs, vrew, vdone, vinfo = venv.step(a)
        for i, e in enumerate(singles):
            so, sr, sd, si = e.step(int(a[i]))
            assert vrew[i] == np.float32(sr) and vdone[i] == sd, (t, i)
            if sd:
                deaths += 1
                so = e.reset()  # auto-reset obs = reset obs
                si = e._get_info()
            np.testing.assert_array_equal(vobs[i], so, err_msg=f"t={t} i={i}")
            assert vinfo["score"][i] == si["score"]
            assert vinfo["deaths"][i] == si["deaths"]
            assert list(vinfo["statistics"][i]) == \
                list(si["statistics"].values())
    assert deaths > 0  # the fuzz actually exercised auto-reset


def test_native_vector_env_grayscale_obs():
    from gym_simpletetris_tpu.api.native_env import NativeVectorEnv
    venv = NativeVectorEnv(4, obs_type="grayscale", seed=5)
    obs = venv.reset()
    assert obs.shape == (4, 84, 84) and obs.dtype == np.float32
    single = NativeTetrisEnv(obs_type="grayscale", seed=5)
    sobs = single.reset()
    np.testing.assert_array_equal(obs[0], sobs)
    obs, r, d, _ = venv.step(np.full(4, 2))
    so, sr, sd, _ = single.step(2)
    assert not sd  # one hard drop on an empty board can never kill
    np.testing.assert_array_equal(obs[0], so)


@pytest.mark.parametrize("w,h", [(9, 12), (4, 5), (24, 20), (16, 5)])
def test_vector_env_cpp_raster_matches_numpy(w, h):
    """The sparse rect-fill C++ raster must equal the gather-map numpy raster
    for odd geometries (asymmetric padding, non-square boards)."""
    from gym_simpletetris_tpu.api.native_env import NativeVectorEnv
    from gym_simpletetris_tpu.ops.raster import rasterize_host_batch
    venv = NativeVectorEnv(8, obs_type="grayscale", width=w, height=h, seed=2)
    venv.reset()
    rng = np.random.RandomState(1)
    for _ in range(50):
        venv.step(rng.randint(0, 7, 8))
    boards = np.stack([e.render() for e in venv.engines])
    want = rasterize_host_batch(boards.transpose(0, 2, 1), h, w, 84)
    got = venv._observation(boards)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_registry_native_backend():
    from gym_simpletetris_tpu.api.registry import make
    env = make("SimpleTetris-v0", backend="native", obs_type="grayscale")
    assert isinstance(env, NativeTetrisEnv)
    obs = env.reset()
    assert obs.shape == (84, 84)
    obs, r, d, info = env.step(6)
    assert set(np.unique(obs)) <= {0.0, 128.0, 190.0}
    from gym_simpletetris_tpu.api.native_env import NativeVectorEnv
    venv = make("SimpleTetris-v0", backend="native", batch_size=4,
                obs_type="ram", reward_step=True)
    assert isinstance(venv, NativeVectorEnv)
    venv.reset()
    obs, rew, done, _ = venv.step(np.full(4, 3))
    assert obs.shape == (4, 10, 20) and rew.shape == (4,)
    with pytest.raises(ValueError):
        make("SimpleTetris-v0", backend="cuda")
