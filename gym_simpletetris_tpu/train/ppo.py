"""On-device PPO actor-learner (second bundled trainer family).

Fully jitted: a scan collects a T-step on-policy rollout from the batched env,
GAE computes advantages, and minibatched clipped-objective epochs update the
shared actor-critic — no host round-trips inside an update. Same scaling story
as DQN: env batch and minibatches shard along the data axis; replicated params
get their gradient all-reduce from jit.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import optax

from ..core.config import EnvConfig
from ..core.pytree import pytree_dataclass
from ..api.env import reset_fn, step_fn
from ..models.actor_critic import ActorCritic


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    env: EnvConfig = EnvConfig(obs_type="ram", auto_reset=True,
                               reward_step=True, penalise_holes=True)
    num_envs: int = 1024
    rollout_len: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    lr: float = 3e-4
    epochs: int = 2
    num_minibatches: int = 8
    max_grad_norm: float = 0.5
    reward_scale: float = 0.01  # tame the -100 death spikes for value learning
    shuffle_block: int = 1  # epoch-shuffle granularity: 1 = exact per-row
    # permutation; >1 permutes contiguous row BLOCKS instead. The flat
    # rollout is [T, B]-major, so a block of K <= num_envs rows is K
    # *different envs at the same timestep* — block-shuffled minibatches
    # still mix random timesteps x random env groups, while the shuffle
    # gather drops from n rows to n/K rows of K times the width.

    def __post_init__(self):
        if (self.num_envs * self.rollout_len) % self.num_minibatches:
            raise ValueError(
                "num_envs*rollout_len must be divisible by num_minibatches")
        n = self.num_envs * self.rollout_len
        if self.shuffle_block < 1 or n % self.shuffle_block:
            raise ValueError("shuffle_block must divide num_envs*rollout_len")
        if (n // self.num_minibatches) % self.shuffle_block:
            raise ValueError("shuffle_block must divide the minibatch size")
        if self.num_envs % self.shuffle_block:
            # blocks that straddle timestep boundaries would break the
            # same-timestep mixing argument the block shuffle's learning
            # equivalence rests on (see the shuffle_block field comment)
            raise ValueError("shuffle_block must divide num_envs")


@pytree_dataclass
class PPOState:
    params: Any
    opt_state: Any
    env_state: Any
    obs: jnp.ndarray
    key: jnp.ndarray
    update: jnp.ndarray   # int32[]


def make_ppo(cfg: PPOConfig, mesh=None, model_axis: str = "model"):
    """Returns (init_fn, update_fn, network): update_fn runs one full PPO
    iteration (rollout + GAE + epochs) and returns (state, metrics).

    With ``mesh``, the returned functions are jit-compiled against the
    path-assigned PPOState sharding (train/sharding.py — the same rules as
    the DQN family): env batch and rollout along ``data``, dense/conv kernels
    (and their Adam mirrors) along ``model_axis`` when present; ``init_fn``
    constructs the state born sharded.
    """
    from ..api import spaces

    ecfg = cfg.env
    if not ecfg.auto_reset:
        raise ValueError("PPO requires env auto_reset=True")
    obs_shape = spaces.observation_space(ecfg).shape
    network = ActorCritic(obs_type=ecfg.obs_type)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.lr))

    def init_fn(key) -> PPOState:
        k_env, k_net, k_state = jax.random.split(key, 3)
        obs, env_state = reset_fn(ecfg, cfg.num_envs, k_env)
        params = network.init(k_net, jnp.zeros((1,) + obs_shape, jnp.float32))
        return PPOState(params=params, opt_state=tx.init(params),
                        env_state=env_state, obs=obs, key=k_state,
                        update=jnp.zeros((), jnp.int32))

    def collect(state: PPOState):
        """T-step on-policy rollout under scan."""
        def body(carry, key_t):
            env_state, obs = carry
            logits, value = network.apply(state.params, obs)
            action = jax.random.categorical(key_t, logits).astype(jnp.int32)
            logp = jax.nn.log_softmax(logits)[
                jnp.arange(obs.shape[0]), action]
            nobs, nstate, reward, done, info = step_fn(ecfg, env_state, action)
            # store obs flattened uint8 (exact: env values fit the palette):
            # one contiguous F-byte row per transition, 1/4 the bytes of f32,
            # so the epoch shuffle gathers whole rows (same layout as the
            # DQN replay ring)
            out = dict(obs=obs.reshape(obs.shape[0], -1).astype(jnp.uint8),
                       action=action, logp=logp, value=value,
                       reward=reward * cfg.reward_scale,
                       done=done.astype(jnp.float32),
                       # per-step line clears (info["lines_delta"] survives
                       # auto-reset) — metrics only, not a learner input
                       lines=info["lines_delta"].astype(jnp.float32))
            return (nstate, nobs), out

        keys = jax.random.split(jax.random.fold_in(
            jax.random.wrap_key_data(jax.random.key_data(state.key)),
            state.update), cfg.rollout_len)
        (env_state, obs), traj = jax.lax.scan(
            body, (state.env_state, state.obs), keys)
        _, last_value = network.apply(state.params, obs)
        return env_state, obs, traj, last_value

    def gae(traj, last_value):
        def body(carry, x):
            adv_next, v_next = carry
            delta = x["reward"] + cfg.gamma * v_next * (1 - x["done"]) - x["value"]
            adv = delta + cfg.gamma * cfg.gae_lambda * (1 - x["done"]) * adv_next
            return (adv, x["value"]), adv
        (_, _), advs = jax.lax.scan(
            body, (jnp.zeros_like(last_value), last_value), traj, reverse=True)
        returns = advs + traj["value"]
        return advs, returns

    def loss_fn(params, batch):
        x = batch["obs"].astype(jnp.float32).reshape(
            (batch["obs"].shape[0],) + obs_shape)    # exact u8 -> f32 cast
        logits, value = network.apply(params, x)
        logp_all = jax.nn.log_softmax(logits)
        logp = logp_all[jnp.arange(batch["obs"].shape[0]), batch["action"]]
        ratio = jnp.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg = -jnp.minimum(
            ratio * adv,
            jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
        v_loss = 0.5 * jnp.square(value - batch["ret"]).mean()
        entropy = -(jnp.exp(logp_all) * logp_all).sum(axis=1).mean()
        loss = pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
        return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy,
                      "clip_frac": (jnp.abs(ratio - 1) > cfg.clip_eps).mean()}

    def update_fn(state: PPOState):
        env_state, obs, traj, last_value = collect(state)
        advs, returns = gae(traj, last_value)
        n = cfg.rollout_len * cfg.num_envs
        flat = {
            "obs": traj["obs"].reshape((n, -1)),     # flat u8 rows
            "action": traj["action"].reshape(n),
            "logp": traj["logp"].reshape(n),
            "adv": advs.reshape(n),
            "ret": returns.reshape(n),
        }
        mb = n // cfg.num_minibatches

        def epoch(carry, key_e):
            params, opt_state = carry
            blk = cfg.shuffle_block
            if blk > 1:
                nb = n // blk
                perm = jax.random.permutation(key_e, nb)
                shuf = jax.tree.map(
                    lambda x: x.reshape((nb, blk) + x.shape[1:])[perm]
                    .reshape(x.shape), flat)
            else:
                perm = jax.random.permutation(key_e, n)
                shuf = jax.tree.map(lambda x: x[perm], flat)

            def minibatch(c, i):
                p, o = c
                batch = jax.tree.map(
                    lambda x: jax.lax.dynamic_slice_in_dim(x, i * mb, mb), shuf)
                (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    p, batch)
                updates, o = tx.update(grads, o, p)
                return (optax.apply_updates(p, updates), o), aux

            (params, opt_state), auxs = jax.lax.scan(
                minibatch, (params, opt_state),
                jnp.arange(cfg.num_minibatches))
            return (params, opt_state), auxs

        k_up = jax.random.fold_in(
            jax.random.wrap_key_data(jax.random.key_data(state.key)),
            state.update + 7777)
        ekeys = jax.random.split(k_up, cfg.epochs)
        (params, opt_state), auxs = jax.lax.scan(
            epoch, (state.params, state.opt_state), ekeys)
        metrics = jax.tree.map(lambda x: x.mean(), auxs)
        metrics["mean_reward"] = traj["reward"].mean() / cfg.reward_scale
        metrics["episodes_done"] = traj["done"].sum()
        metrics["lines_cleared"] = traj["lines"].sum()
        new_state = PPOState(params=params, opt_state=opt_state,
                             env_state=env_state, obs=obs, key=state.key,
                             update=state.update + 1)
        return new_state, metrics

    if mesh is None:
        return init_fn, update_fn, network

    from jax.sharding import NamedSharding, PartitionSpec as P
    from .sharding import train_state_sharding

    abstract = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    sh = train_state_sharding(cfg, mesh, abstract, model_axis=model_axis)
    rep = NamedSharding(mesh, P())
    init_sharded = jax.jit(init_fn, out_shardings=sh)
    update_sharded = jax.jit(update_fn, in_shardings=(sh,),
                             out_shardings=(sh, rep), donate_argnums=(0,))
    return init_sharded, update_sharded, network
