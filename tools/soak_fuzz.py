#!/usr/bin/env python
"""Randomized soak fuzz: JAX engine vs native C++ oracle over random configs.

Samples random (width, height, lock_delay, step_reset, scoring-flag-subset)
configurations — including multi-word wide boards (width up to 56), deep
boards (height up to 64) and long lock delays (up to 8) — and lockstep-fuzzes
B envs x T steps per config with injected draw streams, asserting bitwise
boards/rewards/dones/carry-over. Per config, one of four **action scripts**
is drawn; three are adversarial, chosen to maximize lock/clear/death events
per step (where parity bugs live — the lock FSM, compaction, death-erase and
carry-over paths):

  uniform     all 7 actions equally
  drop-heavy  ~43% hard drops: a lock every ~2 steps, constant respawn churn
  rotate-drop rotate/hard-drop mix: exercises rotated masks at lock time
  stack-clear soft-drop + laterals: builds dense rows, maximizes line clears
  ledge-slide rest/slide/rest sequences under FORCED lock_delay 1..8 (the
              config's lock_delay/step_reset are overridden): stale-lock-
              counter wraps when a rested piece slides off a ledge and falls
  spawn-overlap drop-heavy on FORCED 4..5-wide boards: the spawn-overlap
              erase quirk fires constantly (piece spawns inside the stack)

``--pixels`` also compares the rendered 84x84 grayscale
observation of EVERY step (uint8, pixel-exact) against the host raster of the
oracle's boards — an obs-level soak on top of the engine-state one (widths/
heights capped at 40 so the boards fit the 84px geometry).

The CI fuzz (tests/test_native_oracle.py) covers a fixed 10-config matrix;
this tool covers the combinatorial space at soak depth.

Usage: python tools/soak_fuzz.py [--configs 30] [--batch 64] [--steps 1024]
                                 [--seed 0] [--cpu] [--max-width 56]
                                 [--max-height 64] [--max-lock-delay 8]
                                 [--pixels]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: whatever JAX picks)")
    ap.add_argument("--max-width", type=int, default=56,
                    help="widths 4..N; >24 exercises multi-word packed rows")
    ap.add_argument("--max-height", type=int, default=64)
    ap.add_argument("--max-lock-delay", type=int, default=8)
    ap.add_argument("--pixels", action="store_true",
                    help="also compare the grayscale image of every step "
                         "(uint8, pixel-exact); caps width/height so blocks "
                         "stay >= 1 px at the chosen --pixel-size")
    ap.add_argument("--pixel-size", type=int, default=84,
                    choices=[84, 160, 512],
                    help="image size for --pixels: 84 soaks the observation "
                         "path (build_observation_storage); 160/512 soak the "
                         "render paths (rgb_array / human window geometry, "
                         "tetris_env.py:446,460) through ops.raster.rasterize")
    ap.add_argument("--chunk-bytes", type=int, default=1 << 24,
                    help="--pixels fetch-chunk budget in image bytes (each "
                         "chunk is one device-to-host copy)")
    args = ap.parse_args()
    if args.pixels:
        # block = (size - 2*gap)//max(w,h) - gap must stay >= 1
        cap = {84: 40, 160: 50, 512: 56}[args.pixel_size]
        args.max_width = min(args.max_width, cap)
        args.max_height = min(args.max_height, cap)

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from gym_simpletetris_tpu import EnvConfig
    from gym_simpletetris_tpu.native.lockstep import (
        FLAG_KEYS, assert_lockstep, drive_oracle, replay_engine)

    # L, R, HARD, SOFT, ROTL, ROTR, IDLE = 0..6
    SCRIPTS = {
        "uniform": None,                      # plain randint
        "drop-heavy": [0, 1, 2, 2, 2, 4, 5],
        "rotate-drop": [2, 4, 5, 4, 5, 2, 3],
        "stack-clear": [3, 3, 3, 0, 1, 2, 6],
        # rest (idle/soft) -> lateral slide -> rest again: wraps stale lock
        # counters when the piece slides off a ledge (tetris_env.py:248-260,
        # the step_reset=False stale-counter quirk); needs lock_delay >= 1
        "ledge-slide": [6, 6, 3, 0, 0, 1, 1, 6, 3, 2],
        # constant hard drops on a 4-5-wide board: the new piece spawns inside
        # the stack almost every lock -> spawn-overlap erase quirk (:303)
        "spawn-overlap": [2, 2, 2, 2, 0, 1, 4],
    }

    rng = np.random.RandomState(args.seed)
    B, T = args.batch, args.steps
    total = 0
    t0 = time.time()
    for ci in range(args.configs):
        cfg = EnvConfig(
            width=int(rng.randint(4, args.max_width + 1)),
            height=int(rng.randint(4, args.max_height + 1)),
            lock_delay=int(rng.choice(
                [0, 0, 1, 2, 5] + list(range(args.max_lock_delay + 1)))),
            step_reset=bool(rng.randint(2)),
            reward_step=bool(rng.randint(2)),
            penalise_height=bool(rng.randint(2)),
            penalise_height_increase=bool(rng.randint(2)),
            advanced_clears=bool(rng.randint(2)),
            high_scoring=bool(rng.randint(2)),
            penalise_holes=bool(rng.randint(2)),
            penalise_holes_increase=bool(rng.randint(2)),
        )
        script = list(SCRIPTS)[int(rng.randint(len(SCRIPTS)))]
        if script == "ledge-slide":
            # the stale-counter path only exists with a nonzero lock delay
            cfg = cfg.replace(
                lock_delay=int(rng.randint(1, args.max_lock_delay + 1)),
                step_reset=bool(rng.randint(2)))
        elif script == "spawn-overlap":
            cfg = cfg.replace(width=int(rng.randint(4, 6)),
                              height=int(rng.randint(5, 10)))
        menu = SCRIPTS[script]
        if menu is None:
            actions = rng.randint(0, 7, size=(T, B)).astype(np.int32)
        else:
            actions = np.asarray(menu, np.int32)[
                rng.randint(0, len(menu), size=(T, B))]
        out = drive_oracle(cfg, actions,
                           rng.randint(1, 1 << 31, B).astype(np.uint64))
        fs, em, rew, done = replay_engine(cfg, actions, out,
                                          jax.random.PRNGKey(ci))
        assert_lockstep(cfg, out, fs, em, rew, done)
        if args.pixels:
            # obs-level: the rendered grayscale uint8 image of EVERY step,
            # via the device raster vs the host raster of the oracle's
            # boards — chunked over T for memory. Size 84 runs the actual
            # observation path; 160/512 run the render-path geometry
            # (rgb_array / human window) through ops.raster.rasterize.
            from gym_simpletetris_tpu.api.env import (
                build_observation_storage, obs_from_storage)
            from gym_simpletetris_tpu.ops.raster import rasterize_host_batch
            psize = args.pixel_size
            if psize == 84:
                img_fn = jax.jit(jax.vmap(
                    lambda e: build_observation_storage(
                        cfg.replace(obs_type="grayscale"), e)))
            else:
                from gym_simpletetris_tpu.ops.bitops import unpack_rows
                from gym_simpletetris_tpu.ops.raster import rasterize
                img_fn = jax.jit(jax.vmap(
                    lambda e: rasterize(
                        unpack_rows(cfg, e, dtype=jnp.uint8),
                        cfg.height, cfg.width, psize)))
            rgb_cfg = cfg.replace(obs_type="rgb")
            rgb_fn = jax.jit(jax.vmap(
                lambda e: obs_from_storage(
                    rgb_cfg, build_observation_storage(rgb_cfg, e))))
            oboards = np.transpose(out["boards"], (1, 0, 3, 2))  # [T,B,H,W]
            ck = max(1, args.chunk_bytes // (B * psize * psize))
            for t0c in range(0, T, ck):
                imgs = np.asarray(img_fn(em[t0c:t0c + ck]))
                want = rasterize_host_batch(
                    oboards[t0c:t0c + ck].reshape(-1, cfg.height, cfg.width),
                    cfg.height, cfg.width, psize).reshape(imgs.shape)
                np.testing.assert_array_equal(imgs, want,
                                              err_msg=f"pixels cfg={cfg}")
                if t0c == 0 and psize == 84:
                    # rgb delivered surface (the channel-triple + f32 cast,
                    # tetris_env.py:117-122,:433): every channel of every
                    # pixel on the first chunk — the rgb OBSERVATION is
                    # 84px only, so this check is skipped for the 160/512
                    # render-geometry soaks (whose boards may exceed the
                    # 84px block>=1 limit)
                    rgb = np.asarray(rgb_fn(em[t0c:t0c + ck]))
                    np.testing.assert_array_equal(
                        rgb, np.repeat(
                            want.astype(rgb.dtype)[..., None], 3, axis=-1),
                        err_msg=f"rgb pixels cfg={cfg}")
        total += B * T
        print(f"[{ci+1}/{args.configs}] w{cfg.width} h{cfg.height} "
              f"ld{cfg.lock_delay} {script:11s} flags="
              f"{''.join(str(int(getattr(cfg, k))) for k in FLAG_KEYS[1:])} "
              f"deaths={int(out['deaths'].sum())} "
              f"OK ({total/1e6:.2f}M steps, {time.time()-t0:.0f}s)",
              flush=True)
    print(f"SOAK PASS: {total/1e6:.2f}M steps bitwise across "
          f"{args.configs} random configs")


if __name__ == "__main__":
    main()
