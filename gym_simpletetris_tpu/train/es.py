"""Evolution Strategies trainer (Salimans et al. 2017, OpenAI-ES).

The reference has no training infrastructure (SURVEY.md §3.5); this is the
framework's third trainer family next to DQN/Rainbow and PPO, and the most
accelerator-shaped of the three: no backprop, no replay — one generation is a
single jitted program that evaluates ``pop_size`` antithetic parameter
perturbations by rolling each through its own slice of a
``pop_size * envs_per_member`` vectorized env batch, then updates the mean
parameters with the rank-shaped score gradient

    g = 1/(pop * sigma) * sum_i shape(F_i) * eps_i .

Everything stays on device; the only host sync is the per-generation metrics
fetch. Under a mesh the env batch and the population axis shard over ``data``
(the perturbation matrix is drawn replicated and sliced, so the sharded run
computes the same generation as the unsharded one up to reduction order).

Design notes:
- Antithetic pairs (+eps, -eps) halve the RNG/bandwidth cost and reduce
  variance; ``pop_size`` must be even.
- Centered-rank fitness shaping (argsort-of-argsort) runs once per
  generation on a [pop] vector — sorts are banned in the env step path
  (core/engine.py), not in a per-generation learner.
- Policies act greedily (argmax over the net's action scores); exploration
  comes entirely from parameter-space noise.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from ..core.config import EnvConfig
from ..core.pytree import pytree_dataclass
from ..api.env import reset_fn, step_fn
from ..models.dqn import build_q_network


@dataclasses.dataclass(frozen=True)
class ESConfig:
    env: EnvConfig = EnvConfig(obs_type="ram", auto_reset=True,
                               reward_step=True, penalise_holes=True)
    pop_size: int = 256          # perturbed members per generation (even)
    envs_per_member: int = 4     # fitness = mean return over this many envs
    horizon: int = 256           # env steps per evaluation
    sigma: float = 0.05          # perturbation scale
    lr: float = 0.02
    weight_decay: float = 0.005  # L2 pull toward 0 (Salimans et al. §2.1)
    rank_shaping: bool = True    # centered ranks instead of raw returns
    hidden: tuple = (64, 64)     # policy MLP width (ram obs)

    def __post_init__(self):
        if self.pop_size % 2:
            raise ValueError("pop_size must be even (antithetic pairs)")
        if not self.env.auto_reset:
            raise ValueError("ES training requires env auto_reset=True")


@pytree_dataclass
class ESState:
    theta: jnp.ndarray        # float32[dim] — flat mean parameters
    key: jnp.ndarray
    generation: jnp.ndarray   # int32[]


def centered_ranks(f):
    """Map fitness values to centered ranks in [-0.5, 0.5] (Salimans et al.
    2017 §2; ties broken by position like the reference implementation)."""
    n = f.shape[0]
    ranks = jnp.argsort(jnp.argsort(f))
    return ranks.astype(jnp.float32) / (n - 1) - 0.5


def es_update(theta, eps, fitness, *, sigma: float, lr: float,
              weight_decay: float, rank_shaping: bool = True):
    """One ES parameter update from a generation's perturbations + fitness.

    theta [dim], eps [pop, dim], fitness [pop] -> (theta', grad) with
    grad = shape(F) @ eps / (pop * sigma) and an L2 pull toward 0.
    Pure function, factored out of ``gen_step_fn`` so the math is testable
    independently of the (bf16, fusion-dependent) rollout."""
    pop = eps.shape[0]
    shaped = centered_ranks(fitness) if rank_shaping else \
        (fitness - fitness.mean()) / (fitness.std() + 1e-8)
    grad = (shaped @ eps) / (pop * sigma)
    return (1.0 - lr * weight_decay) * theta + lr * grad, grad


def _build_policy(cfg: ESConfig):
    """(network, unravel, obs_shape, dim) for the ES policy net."""
    ecfg = cfg.env
    if ecfg.obs_type == "ram":
        from ..models.dqn import RamDQN
        network = RamDQN(hidden=tuple(cfg.hidden))
    else:
        network = build_q_network(ecfg.obs_type, None)
    from ..api import spaces
    obs_shape = spaces.observation_space(ecfg).shape
    sample_params = network.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1,) + obs_shape, jnp.float32))
    theta0, unravel = ravel_pytree(sample_params)
    return network, unravel, obs_shape, theta0.shape[0]


def make_es(cfg: ESConfig, mesh=None):
    """Returns (init_fn, gen_step_fn, network).

    init_fn(key) -> ESState; gen_step_fn(state) -> (state, metrics) runs ONE
    generation (perturb -> rollout -> rank -> update) as a single jitted
    program. With ``mesh`` the env batch (and therefore the population axis)
    shards over ``data``.
    """
    ecfg = cfg.env
    network, unravel, obs_shape, dim = _build_policy(cfg)
    pop, k_env = cfg.pop_size, cfg.envs_per_member
    num_envs = pop * k_env

    def init_fn(key) -> ESState:
        k_net, k_state = jax.random.split(key)
        params = network.init(k_net, jnp.zeros((1,) + obs_shape, jnp.float32))
        return ESState(theta=ravel_pytree(params)[0], key=k_state,
                       generation=jnp.zeros((), jnp.int32))

    def _member_actions(member_thetas, obs):
        """obs [pop, k_env, ...] -> greedy actions [pop, k_env]."""
        def one(theta_i, obs_i):
            scores = network.apply(unravel(theta_i), obs_i)
            if scores.ndim == 3:          # distributional head: E over atoms
                scores = scores.mean(axis=-1)
            return jnp.argmax(scores, axis=-1).astype(jnp.int32)
        return jax.vmap(one)(member_thetas, obs)

    def gen_step_fn(state: ESState):
        k_eps, k_reset, key = jax.random.split(state.key, 3)
        eps_half = jax.random.normal(k_eps, (pop // 2, dim), jnp.float32)
        eps = jnp.concatenate([eps_half, -eps_half])           # [pop, dim]
        members = state.theta[None, :] + cfg.sigma * eps       # [pop, dim]

        obs, env_state = reset_fn(ecfg, num_envs, k_reset)

        def roll(carry, _):
            obs, env_state, ret = carry
            a = _member_actions(
                members, obs.reshape((pop, k_env) + obs.shape[1:]))
            obs, env_state, reward, done, _ = step_fn(ecfg, env_state,
                                                      a.reshape(-1))
            return (obs, env_state, ret + reward), None

        (_, _, returns), _ = jax.lax.scan(
            roll, (obs, env_state, jnp.zeros((num_envs,), jnp.float32)),
            None, length=cfg.horizon)
        fitness = returns.reshape(pop, k_env).mean(axis=1)     # [pop]

        theta, grad = es_update(state.theta, eps, fitness, sigma=cfg.sigma,
                                lr=cfg.lr, weight_decay=cfg.weight_decay,
                                rank_shaping=cfg.rank_shaping)

        metrics = {
            "fitness_mean": fitness.mean(),
            "fitness_max": fitness.max(),
            "fitness_std": fitness.std(),
            "theta_norm": jnp.linalg.norm(theta),
            "grad_norm": jnp.linalg.norm(grad),
        }
        new_state = ESState(theta=theta, key=key,
                            generation=state.generation + 1)
        return new_state, metrics

    if mesh is None:
        return init_fn, gen_step_fn, network

    # Mesh-aware: theta/key replicate; jit pins them and lets XLA shard the
    # [num_envs] rollout internals along the population-major env batch.
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    sh = ESState(theta=rep, key=rep, generation=rep)
    init_j = jax.jit(init_fn, out_shardings=sh)
    step_j = jax.jit(gen_step_fn, in_shardings=(sh,), out_shardings=(sh, rep))
    return init_j, step_j, network


def train(cfg: ESConfig, generations: int, key=None, log_fn=print):
    """Host driver: run ``generations`` ES generations, logging metrics."""
    key = key if key is not None else jax.random.PRNGKey(0)
    init_fn, gen_fn, _ = make_es(cfg)
    state = init_fn(key)
    gen_jit = jax.jit(gen_fn)
    for g in range(generations):
        state, metrics = gen_jit(state)
        if log_fn is not None:
            host = {k: float(v) for k, v in metrics.items()}
            host["generation"] = g + 1
            host["env_steps"] = ((g + 1) * cfg.pop_size * cfg.envs_per_member
                                 * cfg.horizon)
            log_fn(host)
    return state


def greedy_params(cfg: ESConfig, theta):
    """Unravel a flat mean-parameter vector (ESState.theta) into the policy
    network's param pytree (for evaluation / checkpoint loading)."""
    _, unravel, _, _ = _build_policy(cfg)
    return unravel(jnp.asarray(theta))
