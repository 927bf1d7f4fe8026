"""Cross-topology checkpoint restore.

A DQNState saved from one mesh shape must restore onto a *different* mesh
shape and onto the unsharded host, and training must continue identically —
sharding is a layout decision, never part of the checkpoint's meaning. The
reference never serializes env state at all (SURVEY.md §5); this pins the
orbax path the suite previously only exercised same-topology (the
"sharding info not provided" warning in test_utils' roundtrip).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from gym_simpletetris_tpu import EnvConfig
from gym_simpletetris_tpu.train.dqn import DQNConfig, make_train
from gym_simpletetris_tpu.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)


def _cfg():
    return DQNConfig(
        env=EnvConfig(obs_type="ram", auto_reset=True, reward_step=True,
                      width=6, height=8),
        num_envs=16, buffer_capacity=256, learn_batch=16, learn_starts=16,
        target_update_period=5,
        prioritized=True, n_step=2, dueling=True, noisy=True)


def _mesh(data, model):
    devs = np.asarray(jax.devices()[:data * model]).reshape(data, model)
    return Mesh(devs, ("data", "model"))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dst", ["mesh_8x1", "mesh_2x4", "unsharded"])
def test_cross_topology_restore_continues_identically(tmp_path, dst):
    cfg = _cfg()
    mesh_a = _mesh(4, 2)
    init_a, step_a, chunk_a, _ = make_train(cfg, mesh=mesh_a)
    state = init_a(jax.random.PRNGKey(3))
    # step past learn_starts so the learner half is live in the checkpoint
    state, _ = chunk_a(state, 24)
    path = save_checkpoint(str(tmp_path / "ckpt"), state)
    # host snapshots before the golden step (the sharded step donates its
    # input state, deleting the device buffers)
    saved = {"step": np.asarray(state.step),
             "ptr": np.asarray(state.replay.ptr),
             "rows": np.asarray(state.env_state.rows),
             "params": _host(state.params)}

    # golden continuation on the source topology
    _, golden_metrics = step_a(state)
    golden = _host(golden_metrics)

    if dst == "unsharded":
        init_d, step_d, _, _ = make_train(cfg)
        target = jax.jit(init_d)(jax.random.PRNGKey(0))  # structure donor only
        step_d = jax.jit(step_d)
    else:
        shape = {"mesh_8x1": (8, 1), "mesh_2x4": (2, 4)}[dst]
        init_d, step_d, _, _ = make_train(cfg, mesh=_mesh(*shape))
        target = init_d(jax.random.PRNGKey(0))
    restored = restore_checkpoint(path, target=target)

    # restored values match the saved state exactly, wherever they now live
    np.testing.assert_array_equal(np.asarray(restored.step), saved["step"])
    np.testing.assert_array_equal(np.asarray(restored.replay.ptr),
                                  saved["ptr"])
    np.testing.assert_array_equal(np.asarray(restored.env_state.rows),
                                  saved["rows"])
    for (pa, la), (pb, lb) in zip(
            jax.tree_util.tree_leaves_with_path(saved["params"]),
            jax.tree_util.tree_leaves_with_path(_host(restored.params))):
        np.testing.assert_array_equal(la, lb, err_msg=str(pa))

    # training continues with the same metrics as the source-topology golden
    _, metrics = step_d(restored)
    metrics = _host(metrics)
    assert set(metrics) == set(golden)
    for k in golden:
        np.testing.assert_allclose(
            metrics[k], golden[k], rtol=1e-6, atol=1e-7,
            err_msg=f"metric {k} diverged after restore onto {dst}")
