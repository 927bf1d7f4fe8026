"""Execute every examples/*.py end-to-end, so example bitrot cannot go
unnoticed.

Each example runs in a subprocess on the CPU backend (the wrapper applies the
same ``jax.config.update("jax_platforms", "cpu")`` override conftest uses)
with ``GST_EXAMPLE_SMOKE=1``, which the heavy examples honor by shrinking
their workloads.
"""

import os
import subprocess
import sys

import pytest

EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), "..", "examples")

_WRAPPER = """
import jax
jax.config.update("jax_platforms", "cpu")
import runpy, sys
runpy.run_path(sys.argv[1], run_name="__main__")
"""

_EXPECT = {
    "random_agent.py": "episode 9:",
    "vectorized_rollout.py": "env-steps/s",
    "standalone_engine.py": "spawn statistics:",
    "native_cpu.py": "drive():",
    "train_and_watch.py": "wrote dqn_episode.gif",
}


@pytest.mark.parametrize("name", sorted(_EXPECT))
def test_example_runs(name, tmp_path):
    path = os.path.abspath(os.path.join(EXAMPLES_DIR, name))
    env = dict(os.environ, GST_EXAMPLE_SMOKE="1",
               JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=os.path.abspath(
                   os.path.join(EXAMPLES_DIR, "..", ".jax_cache")))
    proc = subprocess.run(
        [sys.executable, "-c", _WRAPPER, path],
        cwd=tmp_path,             # artifacts (gifs) land in the tmp dir
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (
        f"{name} failed:\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    assert _EXPECT[name] in proc.stdout, (
        f"{name} missing expected output {_EXPECT[name]!r}:\n{proc.stdout}")
