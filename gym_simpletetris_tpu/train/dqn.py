"""On-device DQN actor-learner over the batched env (BASELINE.json config 5).

Everything — env stepping, observation rendering, epsilon-greedy acting, the
replay ring, TD learning, target sync — lives on device inside one jitted
``train_step`` (scannable into multi-step chunks). Host sync happens only at
logging boundaries. Under a data mesh the env batch, replay and learner batch
shard along ``parallel.mesh.DATA_AXIS``; with replicated params jit inserts the
gradient all-reduce (psum) automatically.

Double DQN + optional dueling heads + optional distributional (C51) targets;
epsilon is linearly annealed on device.

Replay layouts (replay.py): the legacy ring stores matured stacked
transitions (obs+next per slot, rolling n-step window — fastest for tiny
ram observations); ``frame_ring=True`` stores per-step rows with sample-time
n-step folding and no window — with ``ring_stacks=True`` (the "obs ring",
the flagship image layout) each row is the whole observation stack, with
``ring_stacks=False`` a single raw frame (2k-x leaner memory, gather-heavier
sampling).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..core.config import EnvConfig
from ..core.pytree import pytree_dataclass
from ..core.engine import NUM_ACTIONS
from ..api.env import build_observation, reset_fn, step_fn
from ..models.dqn import build_q_network
from .replay import (ReplayState, frame_ring_init, frame_ring_insert_frame,
                     frame_ring_insert_step, frame_ring_sample,
                     frame_ring_sample_prioritized, frame_ring_sample_slots,
                     frame_ring_sample_slots_prioritized,
                     frame_ring_stack_newest, replay_init, replay_insert,
                     replay_sample, replay_sample_prioritized,
                     replay_sample_slots, replay_sample_slots_prioritized,
                     replay_update_priority, replay_update_priority_slots)


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    env: EnvConfig = EnvConfig(obs_type="ram", auto_reset=True,
                               reward_step=True, penalise_holes=True)
    num_envs: int = 1024
    buffer_capacity: int = 262144
    learn_batch: int = 1024
    gamma: float = 0.99
    lr: float = 3e-4
    target_update_period: int = 500    # learner steps between target syncs
    learn_starts: int = 4096           # transitions before learning begins
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 100_000
    double_dqn: bool = True
    dueling: bool = False
    max_grad_norm: float = 10.0
    frame_stack: int = 1   # >1 stacks the last K obs on a trailing channel axis
    n_step: int = 1        # >1 inserts n-step returns (rolling window, exact
                           # truncation at episode bounds; TD target becomes
                           # reward_n + gamma^n * Q(s_{t+n}))
    prioritized: bool = False  # PER: two-level inverse-CDF sampling
                               # proportional to priority (replay.py)
    per_alpha: float = 0.6
    per_beta0: float = 0.4
    per_beta_steps: int = 100_000
    per_eps: float = 1e-3
    distributional: bool = False  # C51 (Bellemare et al. 2017): categorical
    num_atoms: int = 51           # return distributions on a fixed support,
    v_min: float = -110.0         # projected cross-entropy loss. Default
    v_max: float = 110.0          # support covers the -100 death overwrite.
    noisy: bool = False   # NoisyNet FC layers (Fortunato et al. 2018):
                          # exploration by parameter noise resampled every
                          # actor step and learner forward; epsilon-greedy is
                          # disabled (Rainbow's convention).
    noisy_shared_selection: bool = False  # share ONE noise draw between the
                          # online loss forward and the double-DQN
                          # action-selection forward (the target net keeps
                          # its own): XLA then materializes the online noisy
                          # weights once instead of twice per learner step —
                          # the generation is a batch-independent flat cost.
                          # Algorithm delta: a* is picked by the same
                          # perturbed net being trained that step (several
                          # public Rainbow implementations do exactly this).
    learn_every: int = 1  # actor steps per learner update (Rainbow uses 4;
                          # with a batched actor each "actor step" is already
                          # num_envs transitions, so the default stays 1 —
                          # raise it to trade sample reuse for throughput on
                          # conv models where the learner dominates).
    frame_ring: bool = False  # store single frames in the replay and rebuild
                          # stacks / n-step returns at consume time
                          # (replay.FrameRingState): deletes the per-step
                          # stacked-obs shift, the n-step window and the 2k x
                          # frame duplication in the ring. Same transition
                          # semantics (tested equivalent in
                          # tests/test_frame_ring.py).
    ring_stacks: bool = False  # with frame_ring: store the WHOLE stack per
                          # slot (the "obs ring") instead of single frames —
                          # k x the frame memory (still no next_obs buffer,
                          # no window: 2x leaner than legacy) but sampling
                          # reads one contiguous row per stack instead of k
                          # row-gathers.

    sample_slots: bool = False  # learner batches are WHOLE replay slot rows
                          # (learn_batch // num_envs of them) instead of
                          # per-transition gathers: a slot row is num_envs
                          # different envs at the same ring age (the replay
                          # twin of PPO's shuffle_block), so mixing stays
                          # random-age x all-envs while the obs reads become
                          # a few contiguous row-gathers and the PER
                          # write-back a row write. With prioritized replay the
                          # distribution coarsens to slot-level PER
                          # (stratified: slots ~ summed priority, uniform
                          # within the row, slot-level importance weights).
                          # Requires learn_batch % num_envs == 0 and (on the
                          # frame ring) ring_stacks=True or frame_stack=1.

    def __post_init__(self):
        if self.buffer_capacity % self.num_envs:
            raise ValueError("buffer_capacity must be a multiple of num_envs")
        if self.learn_every < 1:
            raise ValueError("learn_every must be >= 1")
        if self.ring_stacks and not self.frame_ring:
            raise ValueError("ring_stacks requires frame_ring=True")
        if self.sample_slots:
            if self.learn_batch % self.num_envs:
                raise ValueError("sample_slots needs learn_batch to be a "
                                 "multiple of num_envs (whole slot rows)")
            if self.frame_ring and self.frame_stack > 1 and \
                    not self.ring_stacks:
                raise ValueError("sample_slots on the frame ring needs "
                                 "ring_stacks=True or frame_stack == 1 "
                                 "(per-env stack clamping would reintroduce "
                                 "the gathers it removes)")


@pytree_dataclass
class DQNState:
    params: Any
    target_params: Any
    opt_state: Any
    replay: ReplayState
    env_state: Any
    obs: jnp.ndarray          # current observation [num_envs, ...]
    key: jnp.ndarray          # PRNG key
    step: jnp.ndarray         # int32[] — actor steps taken
    learn_steps: jnp.ndarray  # int32[]
    window: Any = None        # n-step pending transitions (n_step > 1):
                              # dict of [n-1, B, ...] arrays


def project_distribution(probs, tz, v_min: float, v_max: float,
                         num_atoms: int):
    """Project a categorical distribution onto the fixed support (C51).

    ``probs``: [B, num_atoms] target-atom masses; ``tz``: [B, num_atoms]
    Bellman-shifted atom positions (reward + discount * z). Each shifted atom
    splits its mass linearly between the two support neighbours it lands
    between (Bellemare et al. 2017, algorithm 1) — vectorized as two one-hot
    expansions summed over source atoms, no scatter in the compiled program.
    """
    dz = (v_max - v_min) / (num_atoms - 1)
    b = (jnp.clip(tz, v_min, v_max) - v_min) / dz      # [B, n] in [0, n-1]
    low = jnp.floor(b)
    up = jnp.minimum(low + 1.0, num_atoms - 1.0)
    w_up = b - low                                      # 0 when b integral
    low_oh = jax.nn.one_hot(low.astype(jnp.int32), num_atoms)  # [B, n, n]
    up_oh = jax.nn.one_hot(up.astype(jnp.int32), num_atoms)
    return ((probs * (1.0 - w_up))[..., None] * low_oh
            + (probs * w_up)[..., None] * up_oh).sum(axis=1)   # [B, n]


def make_train(cfg: DQNConfig, mesh=None, model_axis: str = "model"):
    """Returns (init_fn, train_step_fn, train_chunk_fn, network).

    init_fn(key) -> DQNState
    train_step_fn(state) -> (state, metrics)          # one actor+learner step
    train_chunk_fn(state, n) -> (state, metrics_mean) # n steps under lax.scan

    With ``mesh`` (a ``jax.sharding.Mesh`` with a ``data`` axis and optionally
    a ``model_axis``), the returned functions are jit-compiled against the
    path-assigned DQNState sharding (train/sharding.py): ``init_fn``
    *constructs* the state sharded (``out_shardings`` — born on the mesh, no
    resharding pass), and the step/chunk functions pin matching in/out
    shardings with state donation. Env batch, replay ring and learner batch
    shard along ``data``; dense/conv kernels shard their output axis along
    ``model_axis`` when present (DP + TP). Without ``mesh`` the functions are
    returned unjitted, exactly as before.
    """
    from ..api import spaces

    ecfg = cfg.env
    if not ecfg.auto_reset:
        raise ValueError("DQN training requires env auto_reset=True")
    base_shape = spaces.observation_space(ecfg).shape
    k = cfg.frame_stack
    obs_shape = base_shape + (k,) if k > 1 else base_shape
    atoms = cfg.num_atoms if cfg.distributional else 0
    network = build_q_network(ecfg.obs_type, obs_shape, dueling=cfg.dueling,
                              num_atoms=atoms, noisy=cfg.noisy)
    support = jnp.linspace(cfg.v_min, cfg.v_max, cfg.num_atoms)

    def apply_net(params, obs, nk=None):
        """Forward pass; with NoisyNets each call draws fresh factorized
        noise from ``nk`` (independent noise per forward, as in Rainbow)."""
        if cfg.noisy:
            return network.apply(params, obs, rngs={"noise": nk})
        return network.apply(params, obs)

    def q_values(params, obs, nk=None):
        """Scalar Q [B, A]: direct net output, or E[Z] under the C51 head."""
        out = apply_net(params, obs, nk)
        if not cfg.distributional:
            return out
        return (jax.nn.softmax(out, axis=-1) * support).sum(axis=-1)

    def _stack_reset(obs):
        return jnp.repeat(obs[..., None], k, axis=-1) if k > 1 else obs

    def _stack_next(frames, obs, done):
        """Shift the stack; restart it from the reset obs where done."""
        if k == 1:
            return obs
        nxt = jnp.concatenate([frames[..., 1:], obs[..., None]], axis=-1)
        d = done.reshape(done.shape + (1,) * (nxt.ndim - 1))
        return jnp.where(d, _stack_reset(obs), nxt)
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(cfg.lr))

    def epsilon(step):
        frac = jnp.clip(step.astype(jnp.float32) / cfg.eps_decay_steps, 0, 1)
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    def init_fn(key) -> DQNState:
        k_env, k_net, k_state = jax.random.split(key, 3)
        obs, env_state = reset_fn(ecfg, cfg.num_envs, k_env)
        params = network.init(k_net, jnp.zeros((1,) + obs_shape, jnp.float32))
        if cfg.frame_ring:
            # the state holds the newest frame (single-frame layout) or the
            # maintained stack (obs-ring layout), uint8 — the palette is
            # integer-exact; n-step maturation lives in the ring either way
            replay = frame_ring_init(cfg.buffer_capacity, base_shape,
                                     cfg.num_envs, k, cfg.n_step, cfg.gamma,
                                     stacked=cfg.ring_stacks)
            obs = obs.astype(jnp.uint8)
            if cfg.ring_stacks:
                obs = _stack_reset(obs)
        else:
            replay = replay_init(cfg.buffer_capacity, obs_shape, cfg.num_envs)
            obs = _stack_reset(obs)
        state = DQNState(
            params=params,
            target_params=jax.tree.map(jnp.copy, params),
            opt_state=tx.init(params),
            replay=replay,
            env_state=env_state,
            obs=obs,
            key=k_state,
            step=jnp.zeros((), jnp.int32),
            learn_steps=jnp.zeros((), jnp.int32),
        )
        if cfg.n_step > 1 and not cfg.frame_ring:
            # prefill the pending window with n-1 random-policy transitions so
            # every train_step matures exactly one insertable transition
            # (the frame ring needs no window: maturation is intrinsic — a
            # slot becomes sampleable once its n successors exist)
            state = state.replace(window=_empty_window())
            prefill = jax.jit(_prefill_step)
            for _ in range(cfg.n_step - 1):
                state = prefill(state)
        return state

    def _empty_window():
        n1 = cfg.n_step - 1
        b = cfg.num_envs
        return {
            "obs": jnp.zeros((n1, b) + obs_shape, jnp.uint8),
            "action": jnp.zeros((n1, b), jnp.int8),
            "reward": jnp.zeros((n1, b), jnp.float32),
            "done": jnp.ones((n1, b), jnp.bool_),   # mark slots invalid: a
            # True done truncates any return crossing an unfilled slot, and
            # prefill overwrites all of them before training starts
        }

    def _prefill_step(state: DQNState) -> DQNState:
        k_act, key = jax.random.split(state.key)
        action = jax.random.randint(k_act, (cfg.num_envs,), 0, NUM_ACTIONS)
        raw_next, env_state, reward, done, _ = step_fn(ecfg, state.env_state,
                                                       action)
        next_obs = _stack_next(state.obs, raw_next, done)
        window = _push_window(state.window, state.obs, action, reward, done)
        return state.replace(env_state=env_state, obs=next_obs, key=key,
                             window=window)

    def _push_window(window, obs, action, reward, done):
        """Drop the oldest pending transition, append the newest."""
        return {
            "obs": jnp.concatenate(
                [window["obs"][1:], obs.astype(jnp.uint8)[None]]),
            "action": jnp.concatenate(
                [window["action"][1:], action.astype(jnp.int8)[None]]),
            "reward": jnp.concatenate(
                [window["reward"][1:], reward.astype(jnp.float32)[None]]),
            "done": jnp.concatenate([window["done"][1:], done[None]]),
        }

    def _mature_nstep(window, obs_t, action_t, reward_t, done_t, next_obs_t):
        """Fold the window + current transition into the matured n-step
        transition: (obs_0, a_0, R_n, next_obs_t, discount, done_any) with
        exact truncation at the first episode end inside the horizon."""
        rew_seq = jnp.concatenate(
            [window["reward"], reward_t.astype(jnp.float32)[None]])  # [n, B]
        done_seq = jnp.concatenate([window["done"], done_t[None]])   # [n, B]
        alive = jnp.ones_like(rew_seq[0])
        ret = jnp.zeros_like(rew_seq[0])
        for j in range(cfg.n_step):     # static unroll, n is small
            ret = ret + (cfg.gamma ** j) * alive * rew_seq[j]
            alive = alive * (1.0 - done_seq[j].astype(jnp.float32))
        discount = (cfg.gamma ** cfg.n_step) * alive
        done_any = done_seq.any(axis=0)
        return (window["obs"][0], window["action"][0],
                ret, next_obs_t, discount, done_any)

    # The two ONLINE forwards (loss obs + double-DQN selection) stay
    # separate applies: concatenating them into one 2B-batch apply would
    # materialize a [2B, 84, 84, 4] copy between the replay gather and the
    # conv stem. ``noisy_shared_selection`` shares only the noise KEY (XLA
    # then computes the noisy weights once).

    def td_loss(params, target_params, batch, weights, nkey):
        k1, k2, k3 = jax.random.split(nkey, 3)
        if cfg.noisy_shared_selection:
            k3 = k1   # one online noise draw: XLA CSEs the two weight gens
        q = apply_net(params, batch["obs"], k1)                       # [B, A]
        q_sel = jnp.take_along_axis(q, batch["action"][:, None], 1)[:, 0]
        q_next_t = apply_net(target_params, batch["next_obs"], k2)    # [B, A]
        if cfg.double_dqn:
            q_next_online = apply_net(params, batch["next_obs"], k3)
            a_star = jnp.argmax(q_next_online, axis=1)
            q_next = jnp.take_along_axis(q_next_t, a_star[:, None], 1)[:, 0]
        else:
            q_next = q_next_t.max(axis=1)
        # unified 1-step/n-step target: discount = gamma^m * (1 - done)
        target = batch["reward"] + batch["discount"] * q_next
        err = q_sel - jax.lax.stop_gradient(target)
        # Huber loss (standard DQN choice; robust to the -100 death spikes)
        loss = jnp.where(jnp.abs(err) <= 1.0, 0.5 * err * err,
                         jnp.abs(err) - 0.5)
        return (loss * weights).mean(), (err, q_sel)

    def c51_loss(params, target_params, batch, weights, nkey):
        """Projected categorical cross-entropy (C51). The replay ``discount``
        (= gamma^m * (1 - done), shared with the scalar TD target) collapses
        the shifted support to the pure reward at episode ends, so the
        projection needs no separate done handling. The per-sample
        cross-entropy doubles as the PER priority signal (Rainbow's choice)."""
        k1, k2, k3 = jax.random.split(nkey, 3)
        if cfg.noisy_shared_selection:
            k3 = k1   # one online noise draw: XLA CSEs the two weight gens
        logits = apply_net(params, batch["obs"], k1)          # [B, A, n]
        logp = jax.nn.log_softmax(logits, axis=-1)
        logp_a = jnp.take_along_axis(
            logp, batch["action"][:, None, None], axis=1)[:, 0]  # [B, n]
        q_sel = (jnp.exp(logp_a) * support).sum(axis=-1)

        logits_t = apply_net(target_params, batch["next_obs"], k2)
        p_t = jax.nn.softmax(logits_t, axis=-1)               # [B, A, n]
        if cfg.double_dqn:
            a_star = jnp.argmax(
                q_values(params, batch["next_obs"], k3), axis=1)
        else:
            a_star = jnp.argmax((p_t * support).sum(axis=-1), axis=1)
        p_next = jnp.take_along_axis(
            p_t, a_star[:, None, None], axis=1)[:, 0]         # [B, n]
        tz = batch["reward"][:, None] + batch["discount"][:, None] * support
        m = project_distribution(p_next, tz, cfg.v_min, cfg.v_max,
                                 cfg.num_atoms)
        ce = -(jax.lax.stop_gradient(m) * logp_a).sum(axis=-1)  # [B]
        return (ce * weights).mean(), (ce, q_sel)

    loss_fn = c51_loss if cfg.distributional else td_loss

    def _actor_half(state: DQNState):
        """One env interaction + replay insert; no learner. Returns the
        advanced state, the learner half's keys, and the per-step actor
        metrics (emitted every step, unlike learner metrics — see
        ``train_chunk_fn``)."""
        k_eps, k_act, k_sample, k_nact, k_nlearn, key = jax.random.split(
            state.key, 6)
        eps_metric = (jnp.zeros(()) if cfg.noisy else epsilon(state.step))

        if cfg.frame_ring:
            # write this step's observation row (raw frame, or the
            # maintained stack in obs-ring mode); single-frame mode reads
            # the stack back out of the ring
            replay0 = frame_ring_insert_frame(state.replay, state.obs)
            cur_obs = (state.obs if cfg.ring_stacks
                       else frame_ring_stack_newest(replay0))
        else:
            cur_obs = state.obs

        # -- actor: epsilon-greedy (or noisy-greedy) on the current obs ---------
        q = q_values(state.params, cur_obs, k_nact)
        greedy = jnp.argmax(q, axis=1).astype(jnp.int32)
        if cfg.noisy:
            # NoisyNet exploration: fresh parameter noise each step, no
            # epsilon-greedy (Rainbow). k_eps/k_act stay drawn so the RNG
            # stream is identical across the noisy/eps-greedy variants.
            action = greedy
        else:
            rand_a = jax.random.randint(k_act, (cfg.num_envs,), 0, NUM_ACTIONS)
            explore = (jax.random.uniform(k_eps, (cfg.num_envs,))
                       < epsilon(state.step))
            action = jnp.where(explore, rand_a, greedy)

        raw_next, env_state, reward, done, info = step_fn(ecfg, state.env_state,
                                                          action)
        if cfg.frame_ring:
            replay = frame_ring_insert_step(replay0, action, reward, done)
            raw_u8 = raw_next.astype(jnp.uint8)
            next_obs = (_stack_next(state.obs, raw_u8, done)
                        if cfg.ring_stacks else raw_u8)
            window = state.window
        elif cfg.n_step > 1:
            next_obs = _stack_next(state.obs, raw_next, done)
            m_obs, m_act, m_ret, m_next, m_disc, m_done = _mature_nstep(
                state.window, state.obs, action, reward, done, next_obs)
            replay = replay_insert(state.replay, m_obs, m_next, m_act, m_ret,
                                   m_done, discount=m_disc)
            window = _push_window(state.window, state.obs, action, reward,
                                  done)
        else:
            next_obs = _stack_next(state.obs, raw_next, done)
            replay = replay_insert(state.replay, state.obs, next_obs, action,
                                   reward, done, gamma=cfg.gamma)
            window = state.window
        state = state.replace(replay=replay, env_state=env_state,
                              obs=next_obs, key=key, step=state.step + 1,
                              window=window)
        actor_metrics = {
            "mean_reward": reward.mean(),
            "episodes_done": done.sum().astype(jnp.float32),
            "lines_cleared": info["lines_delta"].sum().astype(jnp.float32),
            "epsilon": eps_metric,
        }
        return state, (k_sample, k_nlearn, actor_metrics)

    _LEARNER_ZEROS = {"loss": jnp.zeros(()), "mean_q": jnp.zeros(()),
                      "td_abs_err": jnp.zeros(())}

    def _learner_half(state: DQNState, k_sample, k_nlearn):
        """One TD step once the buffer has warmed up. The warm-up gate is a
        ``lax.cond``: before learn_starts the whole learner — sampling,
        forwards, backward, optimizer — is skipped at runtime, and after
        warm-up the update writes params/opt_state/replay directly instead of
        through per-leaf masked ``jnp.where`` passes over the param/Adam
        state (the target sync is likewise a nested cond, costing its param
        copy only on the 1-in-target_update_period step)."""
        can_learn = state.replay.filled >= cfg.learn_starts
        if cfg.frame_ring:
            # a frame-ring slot is sampleable only once its k-1 predecessors
            # and n successors exist
            can_learn &= state.replay.valid_slots > 0

        def do_learn(state):
            replay = state.replay
            if cfg.prioritized:
                frac = jnp.clip(
                    state.learn_steps.astype(jnp.float32) / cfg.per_beta_steps,
                    0, 1)
                beta = cfg.per_beta0 + (1.0 - cfg.per_beta0) * frac
                if cfg.sample_slots:
                    sample_p = (frame_ring_sample_slots_prioritized
                                if cfg.frame_ring
                                else replay_sample_slots_prioritized)
                else:
                    sample_p = (frame_ring_sample_prioritized if cfg.frame_ring
                                else replay_sample_prioritized)
                batch, per_idx, weights = sample_p(
                    replay, k_sample, cfg.learn_batch, beta)
            else:
                if cfg.sample_slots:
                    sample_u = (frame_ring_sample_slots if cfg.frame_ring
                                else replay_sample_slots)
                    batch, _ = sample_u(replay, k_sample, cfg.learn_batch)
                else:
                    sample_u = (frame_ring_sample if cfg.frame_ring
                                else replay_sample)
                    batch = sample_u(replay, k_sample, cfg.learn_batch)
                weights = jnp.ones((cfg.learn_batch,), jnp.float32)
            (loss, (err, q_sel)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params, state.target_params,
                                       batch, weights, k_nlearn)
            if cfg.prioritized:
                if cfg.sample_slots:
                    replay = replay_update_priority_slots(
                        replay, per_idx, err, cfg.per_alpha, cfg.per_eps)
                else:
                    replay = replay_update_priority(replay, per_idx, err,
                                                    cfg.per_alpha, cfg.per_eps)
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            params = optax.apply_updates(state.params, updates)
            learn_steps = state.learn_steps + 1

            # -- periodic target sync (cond: copy only when it fires) -------
            sync = learn_steps % cfg.target_update_period == 0
            target_params = jax.lax.cond(
                sync, lambda p, t: p, lambda p, t: t,
                params, state.target_params)

            metrics = {
                "loss": loss,
                "mean_q": q_sel.mean(),
                "td_abs_err": jnp.abs(err).mean(),
            }
            new_state = state.replace(
                params=params, target_params=target_params,
                opt_state=opt_state, replay=replay, learn_steps=learn_steps)
            return new_state, metrics

        def no_learn(state):
            return state, _LEARNER_ZEROS

        return jax.lax.cond(can_learn, do_learn, no_learn, state)

    def train_step_fn(state: DQNState):
        state, (k_sample, k_nlearn, actor_m) = _actor_half(state)
        state, learner_m = _learner_half(state, k_sample, k_nlearn)
        return state, {**actor_m, **learner_m}

    def train_chunk_fn(state: DQNState, n: int, unroll: int = 1):
        """``n`` actor steps; one learner update per ``cfg.learn_every`` of
        them. The scan body is one actor step followed by the learner half
        under ``lax.cond`` — a single flat scan whose compiled footprint is
        learn_every-independent, with skipped learner updates never executed
        at runtime. ``unroll`` forwards to lax.scan (opt-in: it multiplies
        compile time, unlike the env rollout's default)."""
        le = cfg.learn_every
        if n % le:
            raise ValueError(f"chunk length {n} must be a multiple of "
                             f"learn_every={le}")

        def body(s, do_learn):
            s, (k_sample, k_nlearn, actor_m) = _actor_half(s)
            if le == 1:
                s, learner_m = _learner_half(s, k_sample, k_nlearn)
            else:
                s, learner_m = jax.lax.cond(
                    do_learn, _learner_half,
                    lambda st, *_: (st, _LEARNER_ZEROS),
                    s, k_sample, k_nlearn)
            return s, {**actor_m, **learner_m}

        flags = (jnp.arange(n, dtype=jnp.int32) % le) == (le - 1)
        state, ms = jax.lax.scan(body, state, flags, unroll=unroll)
        # actor metrics are emitted every step (mean over n; episode/line
        # counts stay per-step rates); learner metrics only on learner steps
        # (mean over the n//le of them)
        denom = {k: (n // le if k in _LEARNER_ZEROS else n) for k in ms}
        metrics = {k: v.sum(axis=0) / denom[k] for k, v in ms.items()}
        return state, metrics

    if mesh is None:
        return init_fn, train_step_fn, train_chunk_fn, network

    # ---- mesh-aware compilation: state born sharded, steps pinned ----------
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .sharding import dqn_state_sharding

    abstract = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    sh = dqn_state_sharding(cfg, mesh, abstract, model_axis=model_axis)
    rep = NamedSharding(mesh, P())

    init_sharded = jax.jit(init_fn, out_shardings=sh)
    step_sharded = jax.jit(train_step_fn, in_shardings=(sh,),
                           out_shardings=(sh, rep), donate_argnums=(0,))

    _chunk_cache = {}

    def chunk_sharded(state, n: int):
        fn = _chunk_cache.get(n)
        if fn is None:
            fn = jax.jit(partial(train_chunk_fn, n=n), in_shardings=(sh,),
                         out_shardings=(sh, rep), donate_argnums=(0,))
            _chunk_cache[n] = fn
        return fn(state)

    return init_sharded, step_sharded, chunk_sharded, network


def train(cfg: DQNConfig, total_steps: int, key=None, chunk: int = 128,
          log_fn=print):
    """Host driver: init, scan chunks, log aggregated metrics. Returns DQNState."""
    key = key if key is not None else jax.random.PRNGKey(0)
    init_fn, _, chunk_fn, _ = make_train(cfg)
    state = init_fn(key)
    chunk_jit = jax.jit(partial(chunk_fn, n=chunk))
    steps = 0
    while steps < total_steps:
        state, metrics = chunk_jit(state)
        steps += chunk
        if log_fn is not None:
            host = {k: float(v) for k, v in metrics.items()}
            host["env_steps"] = steps * cfg.num_envs
            log_fn(host)
    return state
