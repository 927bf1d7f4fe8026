"""Native batched API: 4096 boards in lockstep, scan-fused rollout on the default device."""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # run from anywhere

import jax
import numpy as np

from gym_simpletetris_tpu import EnvConfig, TetrisVectorEnv

# GST_EXAMPLE_SMOKE=1 shrinks the run for the test suite
SMOKE = bool(_os.environ.get("GST_EXAMPLE_SMOKE"))
B, T = (256, 64) if SMOKE else (4096, 512)

env = TetrisVectorEnv(EnvConfig(obs_type="ram", auto_reset=True), B)
obs, state = env.reset(jax.random.PRNGKey(0))
actions = jax.random.randint(jax.random.PRNGKey(1), (T, B), 0, 7)

import time
final, acc, rew, done = env.rollout(state, actions)   # compile + warmup
np.asarray(rew[-1, :1])
t0 = time.time()
final, acc, rew, done = env.rollout(final, actions)
np.asarray(rew[-1, :1])
dt = time.time() - t0
print(f"{T * B / dt / 1e6:.1f}M env-steps/s; "
      f"{int(done.sum())} episodes finished in this rollout")
