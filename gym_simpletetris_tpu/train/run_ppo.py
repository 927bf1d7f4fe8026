"""PPO training CLI (mirrors run_dqn.py for the second trainer family).

    python -m gym_simpletetris_tpu.train.run_ppo --num-envs 1024 \
        --updates 200 --ckpt /tmp/ppo_ckpt --log-jsonl ppo.jsonl
"""

from __future__ import annotations

import argparse
import json
import time

import jax

from ..core.config import EnvConfig
from .ppo import PPOConfig, make_ppo


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obs", default="ram", choices=["ram", "grayscale", "rgb"])
    p.add_argument("--obs-dtype", default="float32",
                   choices=["float32", "uint8"])
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--height", type=int, default=20)
    p.add_argument("--reward-step", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--penalise-holes", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--advanced-clears", action="store_true",
                   help="NES-table clear rewards (100/250/750/3000 x 0.01 "
                        "reward_scale — the line-clear-seeking shaping)")
    p.add_argument("--penalise-height", action="store_true")
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--rollout-len", type=int, default=64)
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--reward-scale", type=float, default=0.01)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--minibatches", type=int, default=8)
    p.add_argument("--entropy-coef", type=float, default=0.01)
    p.add_argument("--shuffle-block", type=int, default=1,
                   help="epoch-shuffle granularity: 1 = exact row "
                        "permutation; K > 1 permutes blocks of K "
                        "same-timestep envs (fewer, larger gather rows)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-jsonl", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="checkpoint every N updates (0 = only at the end)")
    p.add_argument("--resume", action="store_true",
                   help="restore --ckpt if it exists and continue from its "
                        "update count (the checkpoint is the entire PPOState)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    env = EnvConfig(width=args.width, height=args.height, obs_type=args.obs,
                    obs_dtype=args.obs_dtype, auto_reset=True,
                    reward_step=args.reward_step,
                    penalise_holes=args.penalise_holes,
                    advanced_clears=args.advanced_clears,
                    penalise_height=args.penalise_height)
    cfg = PPOConfig(env=env, num_envs=args.num_envs,
                    rollout_len=args.rollout_len, lr=args.lr,
                    gamma=args.gamma, reward_scale=args.reward_scale,
                    epochs=args.epochs, num_minibatches=args.minibatches,
                    entropy_coef=args.entropy_coef,
                    shuffle_block=args.shuffle_block)
    init_fn, update_fn, _ = make_ppo(cfg)
    state = init_fn(jax.random.PRNGKey(args.seed))
    import os
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        from ..utils.checkpoint import restore_checkpoint
        state = restore_checkpoint(args.ckpt, target=state)
        print(json.dumps({"resumed_from": args.ckpt,
                          "update": int(state.update)}), flush=True)
    upd = jax.jit(update_fn)

    sink = open(args.log_jsonl, "a") if args.log_jsonl else None
    try:
        t0 = time.time()
        u0 = int(state.update)
        for u in range(u0, args.updates):
            state, metrics = upd(state)
            rec = {k: float(v) for k, v in metrics.items()}
            env_steps = (u + 1) * cfg.num_envs * cfg.rollout_len
            now = time.time()
            rec.update(update=u + 1, env_steps=env_steps,
                       wall_s=round(now - t0, 2),
                       sps=round((u + 1 - u0) * cfg.num_envs * cfg.rollout_len
                                 / (now - t0), 1))
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            if (args.ckpt and args.ckpt_every
                    and (u + 1 - u0) % args.ckpt_every == 0):
                from ..utils.checkpoint import save_checkpoint
                save_checkpoint(args.ckpt, state)
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
