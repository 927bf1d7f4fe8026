"""Evolution Strategies training CLI (third trainer family).

    python -m gym_simpletetris_tpu.train.run_es --pop 256 --generations 100 \
        --horizon 256 --log-jsonl runs/es.jsonl
"""

from __future__ import annotations

import argparse
import json

import jax

from ..core.config import EnvConfig
from .es import ESConfig, train


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obs", default="ram", choices=["ram", "grayscale", "rgb"])
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--height", type=int, default=20)
    p.add_argument("--reward-step", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--penalise-holes", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--pop", type=int, default=256)
    p.add_argument("--envs-per-member", type=int, default=4)
    p.add_argument("--horizon", type=int, default=256)
    p.add_argument("--generations", type=int, default=100)
    p.add_argument("--sigma", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--weight-decay", type=float, default=0.005)
    p.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-jsonl", default=None)
    p.add_argument("--ckpt", default=None,
                   help="save the final ESState here (orbax); evaluate with "
                        "`evaluate --policies es --ckpt ... --es-hidden ...`")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = ESConfig(
        env=EnvConfig(width=args.width, height=args.height, obs_type=args.obs,
                      auto_reset=True, reward_step=args.reward_step,
                      penalise_holes=args.penalise_holes),
        pop_size=args.pop, envs_per_member=args.envs_per_member,
        horizon=args.horizon, sigma=args.sigma, lr=args.lr,
        weight_decay=args.weight_decay, hidden=tuple(args.hidden))

    sink = open(args.log_jsonl, "a") if args.log_jsonl else None

    def log(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        state = train(cfg, args.generations, key=jax.random.PRNGKey(args.seed),
                      log_fn=log)
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
