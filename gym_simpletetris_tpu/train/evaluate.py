"""Policy evaluation CLI: random / heuristic / trained checkpoints, one table.

    python -m gym_simpletetris_tpu.train.evaluate --policies random heuristic \
        --steps 1000 --num-envs 256
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import EnvConfig
from ..api.env import TetrisVectorEnv
from ..api.wrappers import EpisodeStats


def evaluate_policy(env: TetrisVectorEnv, action_fn, steps: int, seed: int) -> dict:
    """Roll ``steps`` with ``action_fn(obs, state) -> actions``; aggregate
    episode stats over the batch."""
    es = EpisodeStats(env)
    obs, state = es.reset(jax.random.PRNGKey(seed))
    step = jax.jit(es.step)
    for t in range(steps):
        obs, state, r, d, info = step(state, action_fn(obs, state.env_state))
    eps = np.asarray(state.episodes)
    rets = np.asarray(state.last_return)
    lens = np.asarray(state.last_length)
    mask = eps > 0
    # total_lines spans ALL episodes (EpisodeStats accumulates the per-step
    # info["lines_delta"], which survives auto-reset and death-step clears —
    # the raw env_state counter only covers in-progress episodes)
    total_lines = int(np.asarray(state.total_lines).sum())
    n_eps = int(eps.sum())
    return {
        "episodes": n_eps,
        "mean_return": round(float(rets[mask].mean()), 2) if mask.any() else None,
        "mean_length": round(float(lens[mask].mean()), 2) if mask.any() else None,
        "total_lines": total_lines,
        "lines_per_episode": round(total_lines / n_eps, 3) if n_eps else None,
        "total_deaths": int(np.asarray(state.env_state.deaths).sum()),
    }


def _unwrap_params(tree):
    """Accept a checkpoint holding either a full train state or bare
    params and return the ``{"params": layers}`` variables dict apply()
    expects."""
    params = tree["params"] if isinstance(tree, dict) and "params" in tree \
        else tree.params
    if isinstance(params, dict) and "params" not in params:
        params = {"params": params}   # ckpt held bare params: re-wrap
    return params


def make_action_fn(name: str, cfg: EnvConfig, batch: int, ckpt: str = None,
                   seed: int = 0, atoms: int = 0, noisy: bool = False,
                   es_hidden=(64, 64)):
    if name == "random":
        rng = np.random.RandomState(seed)
        return lambda obs, st: jnp.asarray(rng.randint(0, 7, batch))
    if name == "heuristic":
        from ..models.heuristic import make_heuristic_policy
        pol = make_heuristic_policy(cfg)
        return lambda obs, st: pol(st)
    if name == "ppo":
        if ckpt is None:
            raise ValueError("--ckpt required for the ppo policy")
        from ..models.actor_critic import ActorCritic
        from ..utils.checkpoint import restore_checkpoint
        net = ActorCritic(obs_type=cfg.obs_type)
        tree = restore_checkpoint(ckpt)
        params = _unwrap_params(tree)

        @jax.jit
        def act_ppo(obs):
            logits, _ = net.apply(params, jnp.asarray(obs, jnp.float32))
            return jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return lambda obs, st: act_ppo(obs)
    if name == "es":
        if ckpt is None:
            raise ValueError("--ckpt required for the es policy")
        from ..train.es import ESConfig, _build_policy, greedy_params
        from ..utils.checkpoint import restore_checkpoint
        escfg = ESConfig(env=cfg, hidden=tuple(es_hidden))
        tree = restore_checkpoint(ckpt)
        theta = tree["theta"] if isinstance(tree, dict) else tree.theta
        params = greedy_params(escfg, theta)
        net = _build_policy(escfg)[0]

        @jax.jit
        def act_es(obs):
            scores = net.apply(params, jnp.asarray(obs, jnp.float32))
            if scores.ndim == 3:
                scores = scores.mean(axis=-1)
            return jnp.argmax(scores, axis=-1).astype(jnp.int32)
        return lambda obs, st: act_es(obs)
    if name == "dqn":
        if ckpt is None:
            raise ValueError("--ckpt required for the dqn policy")
        from ..models.dqn import build_q_network
        from ..utils.checkpoint import restore_checkpoint
        from ..api import spaces
        # noisy only shapes the param tree; applying without a "noise" rng
        # below is the deterministic mu-only policy net
        net = build_q_network(cfg.obs_type, spaces.observation_space(cfg).shape,
                              num_atoms=atoms, noisy=noisy)
        tree = restore_checkpoint(ckpt)
        params = _unwrap_params(tree)

        @jax.jit
        def act(obs):
            out = net.apply(params, obs)
            if atoms:
                # greedy over E[Z] — invariant to the (linear) support's
                # affine placement, so an atom-index surrogate support works
                # without knowing the training v_min/v_max
                idx = jnp.arange(atoms, dtype=jnp.float32)
                out = (jax.nn.softmax(out, axis=-1) * idx).sum(axis=-1)
            return jnp.argmax(out, axis=1).astype(jnp.int32)
        return lambda obs, st: act(obs)
    raise ValueError(f"unknown policy {name!r}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--policies", nargs="+", default=["random", "heuristic"])
    p.add_argument("--obs", default="ram", choices=["ram", "grayscale", "rgb"])
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--height", type=int, default=20)
    p.add_argument("--reward-step", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--atoms", type=int, default=0,
                   help="num_atoms of a distributional (C51) dqn checkpoint")
    p.add_argument("--noisy", action="store_true",
                   help="the dqn checkpoint has NoisyNet layers (evaluated "
                        "deterministically with the mu weights)")
    p.add_argument("--es-hidden", type=int, nargs="+", default=[64, 64],
                   help="hidden widths of an es checkpoint's policy MLP")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    cfg = EnvConfig(width=args.width, height=args.height, obs_type=args.obs,
                    auto_reset=True, reward_step=args.reward_step)
    env = TetrisVectorEnv(cfg, args.num_envs)
    results = {}
    for name in args.policies:
        fn = make_action_fn(name, cfg, args.num_envs, args.ckpt, args.seed,
                            atoms=args.atoms, noisy=args.noisy,
                            es_hidden=tuple(args.es_hidden))
        results[name] = evaluate_policy(env, fn, args.steps, args.seed)
        print(json.dumps({name: results[name]}), flush=True)
    return results


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
