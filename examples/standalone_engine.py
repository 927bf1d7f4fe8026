"""tetrisRL-style standalone engine usage (no gym env): construct a
``TetrisEngine`` directly, drive it, read its attributes — the reference's
original interface (tetris_env.py:125-335), backed here by the batched JAX
batched engine at B=1.

Run: python examples/standalone_engine.py
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # run from anywhere

import random

from gym_simpletetris_tpu import (TetrisEngine, convert_grayscale,
                                  convert_grayscale_rgb)


def main():
    eng = TetrisEngine(10, 20, reward_step=True, seed=7)
    eng.clear()
    total = 0.0
    for t in range(200):
        action = random.randint(0, 6)
        board, reward, done = eng.step(action)     # (W, H) float board copy
        total += reward
        if done:
            eng.clear()                            # carries deaths/statistics
    print(eng)                                     # ASCII board, like the ref
    info = eng.get_info()
    print(f"steps={info['time']} score={info['score']} deaths={info['deaths']} "
          f"lines={info['lines_cleared']} total_reward={total}")
    print(f"piece={eng.shape_name} at {eng.anchor}, offsets {eng.shape}")
    print(f"spawn statistics: {eng.shape_counts}")

    # the module-level raster functions work on any array:
    img = convert_grayscale(eng.render(), 84)      # (84, 84) uint8
    rgb = convert_grayscale_rgb(img)               # (84, 84, 3)
    print(f"raster: {img.shape} {img.dtype}, rgb {rgb.shape}, "
          f"shades {sorted(set(img.reshape(-1).tolist()))[:4]}")


if __name__ == "__main__":
    main()
