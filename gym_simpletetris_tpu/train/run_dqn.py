"""DQN training CLI.

The reference's de-facto train loop is its README random-policy example
(README.md:36-54); this is the framework's real one. Thin argparse layer over
``DQNConfig`` (SURVEY.md §5 config plan) with JSONL/stdout metric sinks and
orbax checkpointing.

    python -m gym_simpletetris_tpu.train.run_dqn --obs ram --num-envs 1024 \
        --total-steps 100000 --log-jsonl runs/dqn.jsonl --ckpt runs/ckpt
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax

from ..core.config import EnvConfig
from .dqn import DQNConfig, make_train


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obs", default="ram", choices=["ram", "grayscale", "rgb"])
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--height", type=int, default=20)
    p.add_argument("--reward-step", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--penalise-holes", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--advanced-clears", action="store_true")
    p.add_argument("--lock-delay", type=int, default=0)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--total-steps", type=int, default=100_000)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--buffer", type=int, default=262_144)
    p.add_argument("--learn-batch", type=int, default=1024)
    p.add_argument("--learn-starts", type=int, default=4096)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--dueling", action="store_true")
    p.add_argument("--no-double", action="store_true")
    p.add_argument("--frame-stack", type=int, default=1)
    p.add_argument("--n-step", type=int, default=1,
                   help="n-step returns (rolling window, exact truncation)")
    p.add_argument("--prioritized", action="store_true",
                   help="prioritized replay (on-device Gumbel-top-k)")
    p.add_argument("--per-alpha", type=float, default=0.6)
    p.add_argument("--per-beta0", type=float, default=0.4)
    p.add_argument("--distributional", action="store_true",
                   help="C51 categorical value distributions")
    p.add_argument("--num-atoms", type=int, default=51)
    p.add_argument("--v-min", type=float, default=-110.0)
    p.add_argument("--v-max", type=float, default=110.0)
    p.add_argument("--noisy", action="store_true",
                   help="NoisyNet layers (exploration by parameter noise; "
                        "disables epsilon-greedy)")
    p.add_argument("--learn-every", type=int, default=1,
                   help="actor steps per learner update (Rainbow uses 4; "
                        "must divide --chunk)")
    p.add_argument("--replay-layout", default="legacy",
                   choices=["legacy", "frame-ring", "obs-ring"],
                   help="replay storage layout: legacy (stacked obs+next "
                        "per transition — fastest for ram), obs-ring (one "
                        "stacked row per step, window-free, no next buffer "
                        "— the fastest image/frame-stack layout: flagship "
                        "+35%% at learn_every=4), frame-ring (single raw "
                        "frames, 2k-x leaner memory, gather-heavier "
                        "sampling)")
    p.add_argument("--sample-slots", action="store_true",
                   help="learner batches are whole replay slot rows "
                        "(learn_batch/num_envs of them) — contiguous row "
                        "reads instead of per-transition gathers; with "
                        "--prioritized the distribution coarsens to "
                        "slot-level PER (see DQNConfig.sample_slots)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-jsonl", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--ckpt-every", type=int, default=50_000,
                   help="checkpoint every N actor steps (needs --ckpt)")
    p.add_argument("--resume", action="store_true",
                   help="restore --ckpt if it exists and continue from its "
                        "actor-step count; training then proceeds exactly as "
                        "if never interrupted (the checkpoint is the entire "
                        "DQNState: params, optimizer, replay ring, env "
                        "batch, RNG key, counters)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    env = EnvConfig(
        width=args.width, height=args.height, obs_type=args.obs,
        auto_reset=True, reward_step=args.reward_step,
        penalise_holes=args.penalise_holes,
        advanced_clears=args.advanced_clears, lock_delay=args.lock_delay)
    cfg = DQNConfig(
        env=env, num_envs=args.num_envs, buffer_capacity=args.buffer,
        learn_batch=args.learn_batch, learn_starts=args.learn_starts,
        lr=args.lr, gamma=args.gamma,
        dueling=args.dueling, double_dqn=not args.no_double,
        frame_stack=args.frame_stack, n_step=args.n_step,
        prioritized=args.prioritized, per_alpha=args.per_alpha,
        per_beta0=args.per_beta0, distributional=args.distributional,
        num_atoms=args.num_atoms, v_min=args.v_min, v_max=args.v_max,
        noisy=args.noisy, learn_every=args.learn_every,
        frame_ring=args.replay_layout != "legacy",
        ring_stacks=args.replay_layout == "obs-ring",
        sample_slots=args.sample_slots)

    init_fn, _, chunk_fn, _ = make_train(cfg)
    state = init_fn(jax.random.PRNGKey(args.seed))
    import os
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        from ..utils.checkpoint import restore_checkpoint
        try:
            state = restore_checkpoint(args.ckpt, target=state)
        except (ValueError, KeyError, TypeError) as e:
            # the replay ring's pytree structure differs per layout, so a
            # layout mismatch surfaces as an opaque orbax structure error —
            # translate it (the checkpoint itself doesn't record the layout)
            raise SystemExit(
                f"--resume failed restoring {args.ckpt!r} into a "
                f"'{args.replay_layout}' replay layout: the checkpoint was "
                f"likely saved under a different --replay-layout "
                f"(legacy / frame-ring / obs-ring). Re-run with the layout "
                f"it was trained with. Underlying error: {e}")
        print(json.dumps({"resumed_from": args.ckpt,
                          "actor_steps": int(state.step)}), flush=True)
    chunk_jit = jax.jit(lambda s: chunk_fn(s, args.chunk))

    sink = open(args.log_jsonl, "a") if args.log_jsonl else None
    try:
        steps, t0 = int(state.step), time.time()
        start_steps = steps
        last_ckpt = steps
        while steps < args.total_steps:
            state, metrics = chunk_jit(state)
            steps += args.chunk
            rec = {k: float(v) for k, v in metrics.items()}
            now = time.time()
            rec.update(actor_steps=steps, env_steps=steps * cfg.num_envs,
                       wall_s=round(now - t0, 2),
                       sps=round((steps - start_steps) * cfg.num_envs
                                 / (now - t0), 1))
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            if args.ckpt and steps - last_ckpt >= args.ckpt_every:
                from ..utils.checkpoint import save_checkpoint
                save_checkpoint(args.ckpt, state)
                last_ckpt = steps
        if args.ckpt:
            from ..utils.checkpoint import save_checkpoint
            save_checkpoint(args.ckpt, state)
    finally:
        if sink:
            sink.close()
    return state


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
