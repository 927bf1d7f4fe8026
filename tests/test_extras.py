"""Tests: training CLI, video export, scaling bench, headless human render,
uint8 obs mode."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_simpletetris_tpu import EnvConfig, TetrisVectorEnv, make


def test_run_dqn_cli(tmp_path):
    from gym_simpletetris_tpu.train.run_dqn import main
    log = tmp_path / "log.jsonl"
    state = main([
        "--obs", "ram", "--width", "6", "--height", "8",
        "--num-envs", "8", "--total-steps", "8", "--chunk", "4",
        "--buffer", "64", "--learn-batch", "16", "--log-jsonl", str(log)])
    assert int(state.step) == 8
    lines = [json.loads(l) for l in log.read_text().splitlines()]
    assert len(lines) == 2 and "loss" in lines[0] and "sps" in lines[0]


def test_video_gif(tmp_path):
    pytest.importorskip("PIL")
    from gym_simpletetris_tpu.utils.video import record_episode, write_gif
    env = TetrisVectorEnv(EnvConfig(width=6, height=8), batch_size=1)
    frames = record_episode(env, max_steps=30, size=84)
    assert frames.ndim == 4 and frames.shape[-1] == 3
    assert set(np.unique(frames)) <= {0, 128, 190}
    path = write_gif(frames, str(tmp_path / "ep.gif"))
    assert os.path.getsize(path) > 0


def test_scaling_bench_fake_mesh():
    from gym_simpletetris_tpu.parallel.scaling_bench import bench_mesh
    cfg = EnvConfig(auto_reset=True)
    r = bench_mesh(cfg, n_devices=8, per_device=4, steps=16, chunk=8)
    assert r["devices"] == 8 and r["global_batch"] == 32
    assert r["env_steps_per_sec"] > 0


def test_human_render_headless():
    os.environ["SDL_VIDEODRIVER"] = "dummy"
    pytest.importorskip("pygame")
    env = make("SimpleTetris-v0")
    env.reset()
    env.step(2)
    env.render(mode="human")   # must not raise under the dummy driver
    env.close()


def test_uint8_obs_mode():
    env = TetrisVectorEnv(EnvConfig(obs_type="grayscale", obs_dtype="uint8"),
                          batch_size=2)
    obs, state = env.reset(jax.random.PRNGKey(0))
    obs, *_ = env.step(state, jnp.zeros(2, jnp.int32))
    assert obs.dtype == jnp.uint8
    assert set(np.unique(np.asarray(obs))) <= {0, 128, 190}
    assert env.observation_space.dtype == np.uint8


def test_evaluate_cli():
    from gym_simpletetris_tpu.train.evaluate import main
    r = main(["--policies", "random", "heuristic", "--num-envs", "8",
              "--steps", "80", "--width", "6", "--height", "8"])
    assert set(r) == {"random", "heuristic"}
    assert r["random"]["episodes"] > 0


def test_run_ppo_cli_and_ppo_eval(tmp_path):
    """Train PPO via the CLI (tiny), checkpoint, evaluate the checkpoint."""
    from gym_simpletetris_tpu.train.run_ppo import main as train_main
    from gym_simpletetris_tpu.train.evaluate import main as eval_main
    ckpt = str(tmp_path / "ppo_ckpt")
    log = str(tmp_path / "ppo.jsonl")
    train_main(["--num-envs", "8", "--rollout-len", "8", "--updates", "3",
                "--minibatches", "2", "--width", "6", "--height", "8",
                "--ckpt", ckpt, "--log-jsonl", log])
    assert len(open(log).readlines()) == 3
    r = eval_main(["--policies", "ppo", "--num-envs", "8", "--steps", "60",
                   "--width", "6", "--height", "8", "--ckpt", ckpt])
    assert r["ppo"]["episodes"] > 0


def test_long_horizon_parity_with_resets():
    """1000-step lockstep incl. many episode resets (cross-episode carry-over
    exercised at length)."""
    import pytest
    from reference_oracle import reference_available
    if not reference_available():
        pytest.skip("reference not mounted")
    from test_parity_engine import run_lockstep
    from gym_simpletetris_tpu.core.config import EnvConfig
    run_lockstep(EnvConfig(reward_step=True, advanced_clears=True),
                 seed=99, n_steps=1000, policy_seed=99)
