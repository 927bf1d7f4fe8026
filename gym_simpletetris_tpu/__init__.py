"""gym_simpletetris_tpu — vectorized SimpleTetris on accelerators, in JAX.

A ground-up JAX/XLA re-design of the capabilities of GIJaws/gym-simpletetris
(the reference): the complete SimpleTetris-v0 environment
— 7-piece count-balanced spawning, exact collision/lock-delay/line-clear
semantics, the full reward-shaping flag matrix, ram/grayscale/rgb(84x84)
observations — rebuilt as pure jittable array programs over bit-packed batched
board state, stepping thousands of boards in lockstep, sharded across device
meshes, and feeding an on-device DQN actor-learner.

Quick start (batched):
    >>> import jax
    >>> from gym_simpletetris_tpu import EnvConfig, TetrisVectorEnv
    >>> env = TetrisVectorEnv(EnvConfig(obs_type="ram", auto_reset=True), 4096)
    >>> obs, state = env.reset(jax.random.PRNGKey(0))
    >>> obs, state, reward, done, info = env.step(state, actions)

Quick start (reference-compatible, single env):
    >>> from gym_simpletetris_tpu import make
    >>> env = make("SimpleTetris-v0", obs_type="grayscale")
    >>> obs = env.reset()
    >>> obs, reward, done, info = env.step(env.action_space.sample())
"""

from .core.config import EnvConfig
from .core.state import EnvState, init_state
from .core.pieces import PIECE_NAMES
from .api.env import TetrisVectorEnv, step_fn, reset_fn, build_observation
from .api.gym_compat import TetrisEnv
from .api.engine import TetrisEngine, convert_grayscale, convert_grayscale_rgb
from .api.registry import make, register, register_gym, register_gymnasium

__version__ = "0.3.0"

__all__ = [
    "EnvConfig", "EnvState", "init_state", "PIECE_NAMES",
    "TetrisVectorEnv", "TetrisEnv", "TetrisEngine", "step_fn", "reset_fn",
    "build_observation", "convert_grayscale", "convert_grayscale_rgb",
    "make", "register", "register_gym", "register_gymnasium",
    "NativeTetrisEnv", "NativeVectorEnv", "NativeTetrisEngine",
    "__version__",
]

# Mirror the reference's import-time legacy-gym registration
# (gym_simpletetris/__init__.py:3-6); a no-op when old gym isn't importable.
register_gym()


def __getattr__(name):
    # Lazy: first touch compiles the C++ engine (native/__init__.py).
    if name == "NativeTetrisEnv":
        from .api.native_env import NativeTetrisEnv
        return NativeTetrisEnv
    if name == "NativeVectorEnv":
        from .api.native_env import NativeVectorEnv
        return NativeVectorEnv
    if name == "NativeTetrisEngine":
        from .native import NativeTetrisEngine
        return NativeTetrisEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
