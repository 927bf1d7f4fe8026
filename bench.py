#!/usr/bin/env python
"""Throughput benchmark: env-steps/s at B=4096 on one GPU.

Prints exactly ONE JSON line to stdout (the ram headline):
  {"metric": ..., "value": N, "unit": "env_steps/s", "vs_baseline": N,
   "device": {...}}
and, by default, one JSON line per obs type (ram, grayscale, rgb), the ram
B=16384 config, the two delivered-f32 materialization configs, and one line
per trainer family — the flagship Rainbow conv at its canonical le=4 point
(exact and slots variant), PPO ram at 2048x64 with shuffle_block=64, and ES at
1024x8 — to stderr. Every line carries ``device``: JAX's platform,
``device_kind`` and device count, and the card's name and power limit from
nvidia-smi. Without a GPU the benchmark refuses to run.

vs_baseline compares against the reference implementation measured in
BASELINE.md (single-process Python on CPU): 22,500 steps/s for obs_type=ram,
4,600 for grayscale, 3,700 for rgb (TetrisEnv.step, tetris_env.py:397-403).

The timed region is the full env pipeline: random actions, batched transition,
observation rendering, auto-reset. Stepping is fused over scan chunks to
amortize dispatch; that is the intended deployment shape (actor loops live on
device). Every timed region ends in ``jax.block_until_ready``. The observation
pipeline is kept live under XLA's DCE by folding each step's observation into
an accumulator. ``--acc`` picks what is accumulated:

  storage   (default) the canonical uint8 observation — exactly what a replay
            buffer stores or a conv stem reads; the delivered-dtype cast and
            the rgb channel broadcast are exact elementwise views that XLA
            fuses into the consumer, so this is the deployment-shaped number.
  delivered the fully materialized delivered observation (cfg.obs_dtype, rgb
            channels expanded).

Usage: python bench.py [--obs ram|grayscale|rgb] [--batch 4096] [--steps 16384]
                       [--chunk 1024] [--impl auto|sep|sepb|bcast|matmul|gather]
                       [--acc storage|delivered] [--profile-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from gym_simpletetris_tpu import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu.core.config import RASTER_IMPLS
from gym_simpletetris_tpu.utils.compile_cache import enable_compile_cache

REF_BASELINE = {"ram": 22_500.0, "grayscale": 4_600.0, "rgb": 3_700.0}


def device_stamp() -> dict:
    """What every result line names its device by. Exits when JAX's default
    device is not a GPU: a CPU number is never reported as a device rate."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"bench.py: no GPU (default device: {d.platform}); "
                 f"refusing to report a device rate")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card}


def bench_flagship_trainer(stamp: dict, variant: str = "") -> dict:
    """The flagship TRAINER line (the env lines cover the environment only):
    full Rainbow conv DQN — gray-u8 + 4-frame stack + PER + 3-step + dueling
    + C51 + noisy — at the canonical 256-env / learn_every=4 point on the
    obs-ring replay layout. ``variant="slots"`` additionally enables slot-row
    sampling + a shared online noise draw."""
    from gym_simpletetris_tpu.train.dqn import DQNConfig, make_train

    cfg = DQNConfig(
        env=EnvConfig(obs_type="grayscale", auto_reset=True,
                      reward_step=True, penalise_height=True),
        num_envs=256, buffer_capacity=65536, learn_batch=512,
        learn_every=4, frame_stack=4, prioritized=True, n_step=3,
        dueling=True, distributional=True, noisy=True,
        frame_ring=True, ring_stacks=True,
        sample_slots=variant == "slots",
        noisy_shared_selection=variant == "slots")
    init_fn, _, chunk_fn, _ = make_train(cfg)
    state = init_fn(jax.random.PRNGKey(0))
    chunk = jax.jit(lambda s: chunk_fn(s, 512))
    state, m = chunk(state)              # compile + warm
    state, m = jax.block_until_ready(chunk(state))
    n_chunks = 6
    sps = 0.0
    for _pass in range(2):               # best-of-2
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            state, m = chunk(state)
        jax.block_until_ready((state, m))
        sps = max(sps, n_chunks * 512 * cfg.num_envs
                  / (time.perf_counter() - t0))
    return {
        "metric": "train_env_steps_per_sec_flagship_le4" + (
            "_slots" if variant == "slots" else ""),
        "value": sps, "unit": "env_steps/s",
        "vs_baseline": sps / REF_BASELINE["grayscale"],
        "device": stamp,
        "_detail": {"num_envs": 256, "learn_every": 4,
                    "replay_layout": "obs-ring",
                    "features": "PER+3step+dueling+C51+noisy+stack4" + (
                        "+slot_sampling+shared_noise" if variant == "slots"
                        else ""),
                    "loss": float(m["loss"])},
    }


def bench_ppo_trainer(stamp: dict) -> dict:
    """The PPO line: 2048 envs x 64 rollout, 2 epochs x 8 minibatches,
    ``shuffle_block=64``."""
    from gym_simpletetris_tpu.train.ppo import PPOConfig, make_ppo

    cfg = PPOConfig(
        env=EnvConfig(obs_type="ram", auto_reset=True,
                      reward_step=True, penalise_holes=True),
        num_envs=2048, rollout_len=64, epochs=2, num_minibatches=8,
        shuffle_block=64)
    init_fn, update_fn, _ = make_ppo(cfg)
    state = init_fn(jax.random.PRNGKey(0))
    upd = jax.jit(update_fn)
    state, m = upd(state)                # compile + warm
    state, m = jax.block_until_ready(upd(state))
    n_upd = 20
    sps = 0.0
    for _pass in range(2):               # best-of-2
        t0 = time.perf_counter()
        for _ in range(n_upd):
            state, m = upd(state)
        jax.block_until_ready((state, m))
        sps = max(sps, n_upd * cfg.num_envs * cfg.rollout_len
                  / (time.perf_counter() - t0))
    return {
        "metric": "train_env_steps_per_sec_ppo_ram_block64",
        "value": sps, "unit": "env_steps/s",
        "vs_baseline": sps / REF_BASELINE["ram"],
        "device": stamp,
        "_detail": {"num_envs": 2048, "rollout_len": 64,
                    "epochs_x_minibatches": "2x8", "shuffle_block": 64,
                    "pg_loss": float(m["pg_loss"])},
    }


def bench_es_trainer(stamp: dict) -> dict:
    """The ES line: pop 1024 x 8 envs/member, horizon 256, one generation
    (population rollout + update) per call."""
    from gym_simpletetris_tpu.train.es import ESConfig, make_es

    cfg = ESConfig(pop_size=1024, envs_per_member=8, horizon=256)
    init_fn, gen_fn, _ = make_es(cfg)
    state = init_fn(jax.random.PRNGKey(0))
    gen = jax.jit(gen_fn)
    state, m = gen(state)                # compile + warm
    state, m = jax.block_until_ready(gen(state))
    n_gen = 3
    steps_per_gen = cfg.pop_size * cfg.envs_per_member * cfg.horizon
    sps = 0.0
    for _pass in range(2):
        t0 = time.perf_counter()
        for _ in range(n_gen):
            state, m = gen(state)
        jax.block_until_ready((state, m))
        sps = max(sps, n_gen * steps_per_gen / (time.perf_counter() - t0))
    return {
        "metric": "train_env_steps_per_sec_es_1024x8",
        "value": sps, "unit": "env_steps/s",
        "vs_baseline": sps / REF_BASELINE["ram"],
        "device": stamp,
        "_detail": {"pop_size": 1024, "envs_per_member": 8, "horizon": 256,
                    "fitness_mean": float(m["fitness_mean"])},
    }


def bench_one(stamp: dict, obs_type: str, batch: int, steps: int, chunk: int,
              impl: str, acc_mode: str, profile_dir: str | None = None) -> dict:
    cfg = EnvConfig(obs_type=obs_type, auto_reset=True, raster_impl=impl)
    env = TetrisVectorEnv(cfg, batch_size=batch)
    key = jax.random.PRNGKey(0)
    obs, state = env.reset(key)

    n_chunks = max(1, steps // chunk)
    akey = jax.random.PRNGKey(1)
    actions = jax.random.randint(akey, (chunk, batch), 0, 7, dtype=jnp.int32)

    # warmup: the first call compiles; the next absorb first-dispatch costs
    # that would otherwise pollute a short timed region
    for _ in range(3):
        out = env.rollout(state, actions, acc_mode=acc_mode)
    jax.block_until_ready(out)

    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    # best-of-3 passes
    n_steps = n_chunks * chunk * batch
    sps, best = 0.0, None
    for _pass in range(3):
        t0 = time.perf_counter()
        total_done = jnp.zeros((), jnp.int32)
        for i in range(n_chunks):
            state, acc, rew, done = env.rollout(state, actions,
                                                acc_mode=acc_mode)
            total_done = total_done + done.sum()
        jax.block_until_ready((state, acc, total_done))
        dt = time.perf_counter() - t0
        if n_steps / dt > sps:
            sps = n_steps / dt
            best = (dt, int(total_done))   # keep _detail consistent w/ value
    dt, total_done_host = best

    if profile_dir:
        jax.profiler.stop_trace()
    return {
        "metric": f"env_steps_per_sec_{obs_type}_b{batch}",
        "value": sps,
        "unit": "env_steps/s",
        "vs_baseline": sps / REF_BASELINE[obs_type],
        "device": stamp,
        "_detail": {
            "obs_type": obs_type, "batch": batch,
            "timed_env_steps": int(n_steps), "wall_s": dt,
            "episodes_finished": total_done_host,
            "raster_impl": impl, "acc_mode": acc_mode,
        },
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--obs", default=None, choices=["ram", "grayscale", "rgb"],
                    help="bench a single obs type (default: all three; "
                         "headline = ram)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=16384)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--impl", default="auto", choices=("auto",) + RASTER_IMPLS)
    ap.add_argument("--acc", default="storage",
                    choices=["storage", "delivered"])
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--no-delivered", action="store_true",
                    help="skip the two delivered-f32 materialization lines")
    ap.add_argument("--no-train", action="store_true",
                    help="skip the trainer lines")
    args = ap.parse_args()
    stamp = device_stamp()
    enable_compile_cache()

    def emit(r):
        print(json.dumps(r), file=sys.stderr, flush=True)
        return r

    if args.obs is None:
        results = {}
        for obs_type in ("ram", "grayscale", "rgb"):
            results[obs_type] = emit(bench_one(
                stamp, obs_type, args.batch, args.steps, args.chunk,
                args.impl, args.acc))
        if args.batch == 4096:
            emit(bench_one(stamp, "ram", 16384, args.steps, args.chunk,
                           args.impl, args.acc))
        if not args.no_delivered:
            # the fully-materialized float32 image observations: what a user
            # who pulls f32 images out of the env pays
            for obs_type in ("grayscale", "rgb"):
                r = bench_one(stamp, obs_type, args.batch,
                              max(args.chunk, args.steps // 4), args.chunk,
                              args.impl, "delivered")
                r["metric"] += "_delivered_f32"
                emit(r)
        if not args.no_train:
            for fn in (bench_flagship_trainer,
                       lambda st: bench_flagship_trainer(st, "slots"),
                       bench_ppo_trainer, bench_es_trainer):
                emit(fn(stamp))
        headline = results["ram"]
    else:
        headline = bench_one(stamp, args.obs, args.batch, args.steps,
                             args.chunk, args.impl, args.acc,
                             args.profile_dir)
        print(json.dumps(headline["_detail"]), file=sys.stderr)

    headline.pop("_detail", None)
    print(json.dumps(headline), flush=True)


if __name__ == "__main__":
    main()
