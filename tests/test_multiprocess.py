"""REAL multi-process (multi-controller) execution: 2 OS processes x 4 fake
CPU devices each, connected via jax.distributed (Gloo collectives) — the same
code path a multi-host GPU cluster uses, minus the hardware
(SURVEY.md §2.6 / §4.4; parallel/mesh.init_distributed).

Each worker builds the global 8-device data mesh, resets a ShardedTetrisEnv
with the SAME global key, scans a rollout, psums a global metric, and dumps
its (addressable-shard) rewards. The parent asserts:
  - both processes agree on the psum'd global metric,
  - the concatenated per-process shards equal a single-process 8-device run
    of the identical program, bitwise.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
pid, nproc, port, outdir = (sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4])
ndev_local = 8 // int(nproc)   # 8 global devices split across the controllers
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=%%d" %% ndev_local)
# NOTE: deliberately NO JAX_COMPILATION_CACHE_DIR here — sharing the
# persistent compile cache between concurrent multi-controller workers was
# measured to stall them past the subprocess timeout (cache-write
# coordination), where the uncached run takes ~20 s.
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
from gym_simpletetris_tpu.parallel.mesh import (init_distributed,
                                                make_data_mesh,
                                                ShardedTetrisEnv)
init_distributed(f"localhost:{port}", int(nproc), int(pid))
assert jax.device_count() == 8 and jax.local_device_count() == ndev_local
import numpy as np
import jax.numpy as jnp
from gym_simpletetris_tpu import EnvConfig

mesh = make_data_mesh()
env = ShardedTetrisEnv(EnvConfig(auto_reset=True, reward_step=True),
                       global_batch=64, mesh=mesh)
obs, state = env.reset(jax.random.PRNGKey(0))
acts = jax.random.randint(jax.random.PRNGKey(1), (32, 64), 0, 7,
                          dtype=jnp.int32)
fs, acc, rew, done = env.rollout(state, acts)
total = float(jax.jit(lambda r: r.sum())(rew))  # global psum-equivalent sum

# addressable shard of the [T, B] rewards, with its global batch offset
shards = [(s.index, np.asarray(s.data)) for s in rew.addressable_shards]
cols = sorted((idx[1].start if idx[1].start else 0, d) for idx, d in shards)
local = np.concatenate([d for _, d in cols], axis=1)
start = cols[0][0]
np.save(f"{outdir}/rew_{pid}.npy", local)
np.save(f"{outdir}/meta_{pid}.npy", np.array([start, total]))
print(f"worker {pid} ok", flush=True)
""" % {"repo": REPO}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_worker_pair(script_path, tmp_path, timeout: float,
                     attempts: int = 3, n_workers: int = 2,
                     extra_args: tuple = ()) -> list:
    """Launch ``n_workers`` controllers; retry on a *hang* (workers alive but
    stuck past the deadline with rc unset).

    The hang is a reproduced upstream race in XLA:CPU's Gloo collectives: with
    per-step dispatches it strikes ~1 run in 6 on this 2-vCPU host (both
    processes futex-parked inside a dispatched collective, zero CPU), it is
    wildly load-sensitive, and it is not a property of this repo's code — the
    identical program completes in ~25 s when the dispatch wins the race.
    Mitigations here: (a) the learner workers issue ONE scan-fused chunk
    dispatch instead of 40 step dispatches (0 hangs in 10 cold-cache pair runs
    vs ~1/6 before), (b) a genuine worker *error* still fails immediately —
    only clean timeouts retry, (c) fresh port per attempt.
    """
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                        "JAX_COMPILATION_CACHE_DIR")}
    last_outs = None
    for attempt in range(attempts):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(script_path), str(pid), str(n_workers),
             str(port), str(tmp_path), *extra_args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for pid in range(n_workers)]
        outs, timed_out = [], False
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                timed_out = True
            outs.append(out)
        if not timed_out:
            for pid, (p, out) in enumerate(zip(procs, outs)):
                assert p.returncode == 0, \
                    f"worker {pid} failed:\n{out[-3000:]}"
            return outs
        last_outs = outs
    tails = "\n".join(o[-1500:] for o in last_outs)
    raise AssertionError(
        f"{n_workers} workers hung {attempts} consecutive times (deadline "
        f"{timeout:.0f}s each; upstream Gloo dispatch race should not "
        f"survive retries):\n{tails}")


def _check_rollout_workers(tmp_path, n_workers: int):
    """Assemble the n controllers' reward shards and compare against the
    single-process 8-device golden of the identical program, bitwise."""
    metas = [np.load(tmp_path / f"meta_{pid}.npy") for pid in range(n_workers)]
    # every controller computed the same global reward sum
    for m in metas[1:]:
        assert m[1] == metas[0][1]

    # reassemble the global [T, B] rewards from the processes' shards
    parts = sorted(
        (int(metas[pid][0]), np.load(tmp_path / f"rew_{pid}.npy"))
        for pid in range(n_workers))
    global_rew = np.concatenate([d for _, d in parts], axis=1)
    assert global_rew.shape == (32, 64)

    # golden: the identical program on this process's own 8-device mesh
    import jax
    import jax.numpy as jnp
    from gym_simpletetris_tpu import EnvConfig
    from gym_simpletetris_tpu.parallel.mesh import (make_data_mesh,
                                                    ShardedTetrisEnv)
    mesh = make_data_mesh()
    senv = ShardedTetrisEnv(EnvConfig(auto_reset=True, reward_step=True),
                            global_batch=64, mesh=mesh)
    obs, state = senv.reset(jax.random.PRNGKey(0))
    acts = jax.random.randint(jax.random.PRNGKey(1), (32, 64), 0, 7,
                              dtype=jnp.int32)
    fs, acc, rew, done = senv.rollout(state, acts)
    np.testing.assert_array_equal(global_rew, np.asarray(rew))
    assert float(np.asarray(rew).sum()) == metas[0][1]


def test_two_process_sharded_rollout_bitwise(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    _run_worker_pair(script, tmp_path, timeout=240)
    _check_rollout_workers(tmp_path, 2)


def test_four_process_sharded_rollout_bitwise(tmp_path):
    """4 controllers x 2 fake devices each (controller-count evidence beyond
    the single 2-process shape). Same global
    8-device mesh and program; the deadline is generous because four
    concurrent uncached controllers timeslice this host's 2 vCPUs."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    _run_worker_pair(script, tmp_path, timeout=480, n_workers=4)
    _check_rollout_workers(tmp_path, 4)


LEARNER_WORKER = r"""
import os, sys
pid, nproc, port, outdir = (sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4])
ndev_local = 8 // int(nproc)   # 8 global devices split across the controllers
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=%%d" %% ndev_local)
# NOTE: deliberately NO JAX_COMPILATION_CACHE_DIR here — sharing the
# persistent compile cache between concurrent multi-controller workers was
# measured to stall them past the subprocess timeout (cache-write
# coordination), where the uncached run takes ~20 s.
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
from gym_simpletetris_tpu.parallel.mesh import init_distributed, DATA_AXIS
init_distributed(f"localhost:{port}", int(nproc), int(pid))
assert jax.device_count() == 8 and jax.local_device_count() == ndev_local
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh
from gym_simpletetris_tpu import EnvConfig
from gym_simpletetris_tpu.train.dqn import DQNConfig, make_train

mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), (DATA_AXIS, "model"))
layout = sys.argv[5] if len(sys.argv) > 5 else "legacy"
cfg = DQNConfig(
    env=EnvConfig(obs_type="ram", auto_reset=True, reward_step=True,
                  width=6, height=8),
    num_envs=16, buffer_capacity=256, learn_batch=16, learn_starts=32,
    target_update_period=5,
    frame_stack=2 if layout != "legacy" else 1,
    frame_ring=layout != "legacy", ring_stacks=layout == "obs-ring")
init_fn, _, chunk_fn, _ = make_train(cfg, mesh=mesh)
state = init_fn(jax.random.PRNGKey(7))
# ONE scan-fused 40-step chunk dispatch (the deployment shape), not 40 step
# dispatches: each dispatch of a collective-bearing program is a chance to
# hit the upstream XLA:CPU Gloo race (see _run_worker_pair)
state, metrics = chunk_fn(state, 40)
# fully-addressable (replicated across the mesh) learner params: dump leaves
leaves = jax.tree_util.tree_leaves_with_path(state.params)
flat = np.concatenate(
    [np.asarray(jax.jit(lambda x: x,
                        out_shardings=jax.sharding.NamedSharding(
                            mesh, jax.sharding.PartitionSpec()))(l)).ravel()
     for _, l in leaves])
np.save(f"{outdir}/params_{pid}.npy", flat)
np.save(f"{outdir}/lsteps_{pid}.npy",
        np.array([int(state.learn_steps),
                  float(np.asarray(metrics["loss"]))]))
print(f"learner worker {pid} ok", flush=True)
""" % {"repo": REPO}


@pytest.mark.parametrize("layout", ["legacy", "obs-ring"])
def test_two_process_dqn_train_step(tmp_path, layout):
    """The full actor-learner (BASELINE config 5 shape): 2 controller
    processes x 4 fake devices run a 40-step mesh-aware DQN train chunk
    (DP x TP via make_train(cfg, mesh=...)); both controllers' final params
    must agree bitwise with each other and match a single-process run of the
    identical program to float-reduction tolerance (rtol=1e-5). Runs for
    both the legacy replay layout and the round-4 obs-ring flagship layout
    (with frame stacking).

    The single-process golden runs FIRST and its wall time calibrates the
    worker deadline for this host's current speed/load (the workers run the
    same program twice concurrently on half the cores each, plus process
    startup and Gloo rendezvous)."""
    import time

    # single-process golden of the identical program — timed for calibration
    import jax
    from jax.sharding import Mesh
    from gym_simpletetris_tpu import EnvConfig
    from gym_simpletetris_tpu.parallel.mesh import DATA_AXIS
    from gym_simpletetris_tpu.train.dqn import DQNConfig, make_train
    t0 = time.time()
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), (DATA_AXIS, "model"))
    cfg = DQNConfig(
        env=EnvConfig(obs_type="ram", auto_reset=True, reward_step=True,
                      width=6, height=8),
        num_envs=16, buffer_capacity=256, learn_batch=16, learn_starts=32,
        target_update_period=5,
        frame_stack=2 if layout != "legacy" else 1,
        frame_ring=layout != "legacy", ring_stacks=layout == "obs-ring")
    init_fn, _, chunk_fn, _ = make_train(cfg, mesh=mesh)
    state = init_fn(jax.random.PRNGKey(7))
    state, _ = chunk_fn(state, 40)
    golden = np.concatenate(
        [np.asarray(l).ravel() for _, l in
         jax.tree_util.tree_leaves_with_path(state.params)])
    t_golden = time.time() - t0

    script = tmp_path / "learner_worker.py"
    script.write_text(LEARNER_WORKER)
    # adaptive deadline: 2 concurrent uncached workers on a loaded host need a
    # multiple of the just-measured single-process time, never less than 240 s
    _run_worker_pair(script, tmp_path, timeout=max(240.0, 25.0 * t_golden),
                     extra_args=(layout,))

    p0 = np.load(tmp_path / "params_0.npy")
    p1 = np.load(tmp_path / "params_1.npy")
    np.testing.assert_array_equal(p0, p1)   # controllers agree bitwise
    ls0 = np.load(tmp_path / "lsteps_0.npy")
    assert ls0[0] > 0 and np.isfinite(ls0[1])
    np.testing.assert_allclose(p0, golden, rtol=1e-5, atol=1e-7)


def test_four_process_dqn_train_step(tmp_path):
    """The full actor-learner under FOUR controller
    processes x 2 fake devices each (the rollout twin above already covers
    4 controllers; this is the first 4-controller TRAIN evidence). Runs the
    flagship obs-ring replay layout; all four controllers' final params must
    agree bitwise and match the single-process golden of the identical
    program to float-reduction tolerance."""
    import time

    import jax
    from jax.sharding import Mesh
    from gym_simpletetris_tpu import EnvConfig
    from gym_simpletetris_tpu.parallel.mesh import DATA_AXIS
    from gym_simpletetris_tpu.train.dqn import DQNConfig, make_train
    t0 = time.time()
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), (DATA_AXIS, "model"))
    cfg = DQNConfig(
        env=EnvConfig(obs_type="ram", auto_reset=True, reward_step=True,
                      width=6, height=8),
        num_envs=16, buffer_capacity=256, learn_batch=16, learn_starts=32,
        target_update_period=5,
        frame_stack=2, frame_ring=True, ring_stacks=True)
    init_fn, _, chunk_fn, _ = make_train(cfg, mesh=mesh)
    state = init_fn(jax.random.PRNGKey(7))
    state, _ = chunk_fn(state, 40)
    golden = np.concatenate(
        [np.asarray(l).ravel() for _, l in
         jax.tree_util.tree_leaves_with_path(state.params)])
    t_golden = time.time() - t0

    script = tmp_path / "learner_worker.py"
    script.write_text(LEARNER_WORKER)
    # 4 concurrent uncached workers timeslice this host's 2 vCPUs: deadline
    # scales on the just-measured single-process wall, never below 480 s
    _run_worker_pair(script, tmp_path, timeout=max(480.0, 50.0 * t_golden),
                     n_workers=4, extra_args=("obs-ring",))

    params = [np.load(tmp_path / f"params_{pid}.npy") for pid in range(4)]
    for p in params[1:]:
        np.testing.assert_array_equal(params[0], p)
    ls0 = np.load(tmp_path / "lsteps_0.npy")
    assert ls0[0] > 0 and np.isfinite(ls0[1])
    np.testing.assert_allclose(params[0], golden, rtol=1e-5, atol=1e-7)
