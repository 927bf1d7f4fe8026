"""The plain-JAX networks (models/nn.py, models/dqn.py,
models/actor_critic.py): output shapes and dtypes, parameter-tree names, and
the checked-in PPO checkpoint, which must restore into them and evaluate."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_simpletetris_tpu.models.actor_critic import ActorCritic
from gym_simpletetris_tpu.models.dqn import build_q_network

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "ppo_lineclear_ckpt")
PARAMS_NPZ = os.path.join(ROOT, "artifacts", "ppo_lineclear_params.npz")

OBS = {"ram": (10, 20), "grayscale": (84, 84, 4)}
HEADS = {
    "plain": (dict(), (7,), {"q"}),
    "dueling": (dict(dueling=True), (7,), {"DuelingHead_0"}),
    "c51": (dict(num_atoms=11), (7, 11), {"C51Head_0"}),
    "noisy": (dict(noisy=True, dueling=True, num_atoms=11), (7, 11),
              {"C51Head_0"}),
}
TRUNK = {"ram": {"dense0", "dense1"},
         "grayscale": {"conv1", "conv2", "conv3", "dense"}}


def _paths(tree):
    return {jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("obs", sorted(OBS))
@pytest.mark.parametrize("head", sorted(HEADS))
def test_q_network_shapes_dtypes_and_names(obs, head):
    kw, out_shape, head_names = HEADS[head]
    net = build_q_network(obs, OBS[obs], **kw)
    x = jnp.zeros((1,) + OBS[obs])
    variables = net.init(jax.random.PRNGKey(0), x)
    params = variables["params"]
    assert set(params) == TRUNK[obs] | head_names
    leaves = jax.tree_util.tree_leaves(params)
    assert all(l.dtype == jnp.float32 for l in leaves)
    noisy = kw.get("noisy", False)
    names = {p.rsplit("[", 1)[-1].strip("']") for p in _paths(params)}
    assert names == ({"kernel_mu", "kernel_sigma", "bias_mu", "bias_sigma",
                      "kernel", "bias"} if noisy and obs == "grayscale"
                     else {"kernel_mu", "kernel_sigma", "bias_mu",
                           "bias_sigma"} if noisy else {"kernel", "bias"})
    batch = jnp.asarray(np.random.RandomState(0).randint(
        0, 2, (3,) + OBS[obs]) * 128, jnp.float32)
    out = net.apply(variables, batch)
    assert out.shape == (3,) + out_shape and out.dtype == jnp.float32
    assert np.isfinite(np.asarray(out)).all()
    if noisy:
        k = jax.random.PRNGKey(4)
        a = net.apply(variables, batch, rngs={"noise": k})
        b = net.apply(variables, batch, rngs={"noise": k})
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.abs(np.asarray(a) - np.asarray(out)).max() > 0


@pytest.mark.parametrize("obs,expect", [
    ("ram", {"['MlpTrunk_0']['dense0']['kernel']", "['pi']['kernel']",
             "['v']['bias']"}),
    ("grayscale", {"['ConvTrunk_0']['conv1']['kernel']", "['fc']['kernel']",
                   "['pi']['bias']"}),
])
def test_actor_critic_shapes_and_names(obs, expect):
    shape = OBS[obs][:2] if obs == "grayscale" else OBS[obs]
    net = ActorCritic(obs_type=obs)
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1,) + shape))
    assert expect <= _paths(variables["params"])
    logits, value = net.apply(variables, jnp.zeros((5,) + shape))
    assert logits.shape == (5, 7) and value.shape == (5,)
    assert logits.dtype == value.dtype == jnp.float32


def test_ppo_checkpoint_restores_and_evaluates():
    """The checked-in orbax checkpoint restores into ActorCritic (same tree,
    key path for key path) and the evaluate CLI plays it."""
    pytest.importorskip("orbax.checkpoint")
    from gym_simpletetris_tpu.train.evaluate import main
    from gym_simpletetris_tpu.utils.checkpoint import restore_checkpoint

    tree = restore_checkpoint(CKPT)
    fresh = ActorCritic().init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 20)))
    assert _paths(tree) == _paths(fresh)
    r = main(["--policies", "ppo", "--ckpt", CKPT, "--num-envs", "16",
              "--steps", "200", "--seed", "1"])
    # the trained policy clears lines (a random one clears ~none in 200 steps)
    assert r["ppo"]["total_lines"] > 0


def test_ppo_params_npz_matches_the_checkpoint():
    """artifacts/ppo_lineclear_params.npz (read with numpy only, e.g. by
    chip_smoke.py) holds exactly the orbax checkpoint's parameters."""
    pytest.importorskip("orbax.checkpoint")
    from gym_simpletetris_tpu.utils.checkpoint import (load_params_npz,
                                                       restore_checkpoint)

    want = restore_checkpoint(CKPT)
    got = load_params_npz(PARAMS_NPZ)
    assert _paths(got) == _paths(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_params_npz_round_trip(tmp_path):
    from gym_simpletetris_tpu.utils.checkpoint import (load_params_npz,
                                                       save_params_npz)

    v = build_q_network("ram", (6, 8), dueling=True).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 6, 8)))
    path = str(tmp_path / "p.npz")
    save_params_npz(path, v)
    back = load_params_npz(path)
    assert _paths(back) == _paths(v)
    x = jnp.ones((2, 6, 8))
    net = build_q_network("ram", (6, 8), dueling=True)
    np.testing.assert_array_equal(np.asarray(net.apply(back, x)),
                                  np.asarray(net.apply(v, x)))
