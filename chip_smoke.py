#!/usr/bin/env python
"""Smoke run of the whole system on NVIDIA GPUs, checked against the CPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the data-parallel mesh phase only

Phases (one process; any failure exits non-zero and prints no result line):

1. device   the default JAX device must be a GPU (no CPU fallback); prints
            its kind, the device count, the JAX version and the card's name
            and power limit from nvidia-smi.
2. parity   the engine and its observations, through ``TetrisVectorEnv``
            (``reset``, a 256-step ``rollout``, two ``step`` calls) at
            B=4096 for ram, grayscale, rgb and a 32-wide (multi-word) board,
            compared bitwise with the same program on the CPU backend; a
            lockstep against the C++ oracle over several flag sets; the
            Rainbow Q-network forward and the checked-in PPO policy against
            the CPU within the bf16 tolerance below.
3. trainers the flagship Rainbow DQN, PPO ram 2048x64 and ES 1024x8 at the
            widths ``bench.py`` measures: finite losses, env-steps/s and
            ``compiled.memory_analysis()``.

``--four-cards`` runs only the mesh phase on four cards: the sharded DQN and
PPO dry run (``__graft_entry__.dryrun_multichip``) at mesh shapes (4,1) and
(2,2) against the one-card golden, and a ``ShardedTetrisEnv`` rollout at
4x4096 envs compared bitwise with the one-card rollout.

The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# The CPU backend is the reference the GPU is compared with, so it must be
# initialised beside the GPU even where JAX_PLATFORMS names only the GPU.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
PPO_PARAMS = os.path.join(ROOT, "artifacts", "ppo_lineclear_params.npz")

# bf16 keeps 8 significant bits, so one rounding step of a value near the
# output's largest magnitude m is 2**-8 * m. Both backends round every
# layer's output to bf16, but sum in different orders and precisions
# (tensor-core f32 accumulation on the GPU), so one-ulp flips can arise at
# each of the network's layers and compound. A wrong layout, transpose or
# dtype gives differences of order m. Tolerance: 16 ulps of m.
BF16_TOL_ULPS = 16


def log(*args) -> None:
    print(*args, flush=True)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------
def card_name_and_power() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def check_device(count: int) -> dict:
    """The default devices must be ``count`` GPUs; returns the device dict
    of the result line. Raises SystemExit otherwise."""
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU: JAX's default device is "
                         f"{d0.platform} ({d0.device_kind})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    log(f"device: platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


# --------------------------------------------------------------------------
# 2. parity
# --------------------------------------------------------------------------
def assert_trees_equal(a, b, what: str) -> None:
    """Bitwise equality of two pytrees of host arrays."""
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    if ta != tb:
        raise AssertionError(f"{what}: tree structures differ")
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or x.dtype != y.dtype or \
                not np.array_equal(x, y):
            n = int((x != y).sum()) if x.shape == y.shape else -1
            raise AssertionError(f"{what}: {jax.tree_util.keystr(path)} "
                                 f"differs ({n} elements)")


def drive_env(cfg, batch: int, steps: int, device, seed: int = 0):
    """reset + ``steps``-step rollout + two step() calls of one
    TetrisVectorEnv on ``device``; everything that comes out, on the host."""
    from gym_simpletetris_tpu import TetrisVectorEnv

    rng = np.random.RandomState(seed)
    acts = rng.randint(0, 7, size=(steps, batch)).astype(np.int32)
    with jax.default_device(device):
        env = TetrisVectorEnv(cfg, batch)
        obs0, state = env.reset(jax.device_put(jax.random.PRNGKey(seed),
                                               device))
        actions = jax.device_put(acts, device)
        state, acc, rew, done = env.rollout(state, actions)
        out = {"obs0": obs0, "rollout": (state, acc, rew, done), "steps": []}
        for t in range(2):
            obs, state, r, d, info = env.step(state, actions[t])
            out["steps"].append((obs, state, r, d, info))
        return jax.device_get(out)


def parity_bitwise(cfg, batch: int, steps: int, dev, ref_dev) -> float:
    """Run :func:`drive_env` on ``dev`` and ``ref_dev``; require bitwise
    equality. Returns the seconds the ``dev`` run took, compile included."""
    t0 = time.perf_counter()
    got = drive_env(cfg, batch, steps, dev)
    dt = time.perf_counter() - t0
    want = drive_env(cfg, batch, steps, ref_dev)
    assert_trees_equal(got, want, f"{cfg.obs_type} w{cfg.width}")
    return dt


def oracle_lockstep(cfg, batch: int, steps: int, seed: int) -> int:
    """Bitwise lockstep of the JAX engine (default device) with the C++
    oracle; returns the env-steps checked."""
    from gym_simpletetris_tpu.native.lockstep import (
        assert_lockstep, drive_oracle, replay_engine)

    rng = np.random.RandomState(seed)
    # drop-heavy mix: a lock every few steps keeps the lock, clear, death
    # and carry-over paths busy
    actions = np.asarray([0, 1, 2, 2, 3, 4, 5, 6], np.int32)[
        rng.randint(0, 8, size=(steps, batch))]
    oracle = drive_oracle(cfg, actions,
                          rng.randint(1, 1 << 31, batch).astype(np.uint64))
    final, emitted, reward, done = replay_engine(
        cfg, actions, oracle, jax.random.PRNGKey(seed))
    assert_lockstep(cfg, oracle, final, emitted, reward, done)
    return batch * steps


def bf16_close(got, want, what: str) -> float:
    """|got - want| <= BF16_TOL_ULPS bf16 ulps of max|want|; returns the
    largest difference in those ulps."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape} "
                             f"or non-finite output")
    ulp = 2.0 ** -8 * float(np.abs(want).max())
    worst = float(np.abs(got - want).max()) / ulp
    if worst > BF16_TOL_ULPS:
        raise AssertionError(f"{what}: max difference {worst:.2f} bf16 ulps "
                             f"of max|cpu| > {BF16_TOL_ULPS}")
    return worst


def on_device(device, fn, *args):
    """``fn(*args)`` jitted on ``device``, result on the host."""
    with jax.default_device(device):
        return jax.device_get(jax.jit(fn)(*jax.device_put(args, device)))


def qnet_parity(dev, ref_dev, batch: int = 512) -> float:
    """Rainbow NatureDQN forward (4-frame stack, dueling, C51, noisy),
    ``dev`` against ``ref_dev``."""
    from gym_simpletetris_tpu.models.dqn import build_q_network

    net = build_q_network("grayscale", (84, 84, 4), dueling=True,
                          num_atoms=51, noisy=True)
    with jax.default_device(ref_dev):
        params = jax.device_get(net.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 84, 84, 4))))
    rng = np.random.RandomState(1)
    obs = np.asarray([0, 128, 190], np.uint8)[
        rng.randint(0, 3, size=(batch, 84, 84, 4))]
    key = np.asarray(jax.random.key_data(jax.random.PRNGKey(2)))

    def fwd(p, x, k):
        return net.apply(p, x, rngs={"noise": jax.random.wrap_key_data(k)})

    return bf16_close(on_device(dev, fwd, params, obs, key),
                      on_device(ref_dev, fwd, params, obs, key),
                      "NatureDQN forward")


def ppo_checkpoint_parity(dev, ref_dev, batch: int = 4096) -> tuple:
    """The checked-in PPO policy's logits and greedy actions on real ram
    boards, ``dev`` against ``ref_dev``: logits within the bf16 tolerance,
    and greedy actions equal except where the reference's top two logits are
    themselves within it."""
    from gym_simpletetris_tpu import EnvConfig
    from gym_simpletetris_tpu.models.actor_critic import ActorCritic
    from gym_simpletetris_tpu.utils.checkpoint import load_params_npz

    params = load_params_npz(PPO_PARAMS)
    obs = drive_env(EnvConfig(auto_reset=True), batch, 64, ref_dev,
                    seed=3)["steps"][-1][0]

    def logits(p, x):
        return ActorCritic(obs_type="ram").apply(p, x)[0]

    got = on_device(dev, logits, params, obs)
    want = on_device(ref_dev, logits, params, obs)
    worst = bf16_close(got, want, "PPO checkpoint logits")
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    rows = np.nonzero(a_got != a_want)[0]
    tol = BF16_TOL_ULPS * 2.0 ** -8 * float(np.abs(want).max())
    gap = np.abs(want[rows, a_got[rows]] - want[rows, a_want[rows]])
    if (gap > tol).any():
        raise AssertionError(f"PPO greedy actions differ on {len(rows)} rows, "
                             f"beyond the tolerance on {(gap > tol).sum()}")
    return worst, len(rows)


def phase_parity(batch: int = 4096, steps: int = 256) -> None:
    from gym_simpletetris_tpu import EnvConfig

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    for cfg in (EnvConfig(obs_type="ram", auto_reset=True),
                EnvConfig(obs_type="grayscale", auto_reset=True),
                EnvConfig(obs_type="rgb", auto_reset=True),
                EnvConfig(obs_type="ram", width=32, auto_reset=True),
                EnvConfig(obs_type="grayscale", width=32, auto_reset=True)):
        dt = parity_bitwise(cfg, batch, steps, gpu, cpu)
        log(f"parity: {cfg.obs_type} w{cfg.width} B={batch} T={steps}+2 "
            f"bitwise == cpu (gpu run {dt:.1f}s incl. compile)")
    checked = 0
    for i, cfg in enumerate((
            EnvConfig(),
            EnvConfig(reward_step=True, penalise_height=True,
                      penalise_holes=True, advanced_clears=True,
                      lock_delay=2, step_reset=True),
            EnvConfig(width=32, height=24, high_scoring=True,
                      penalise_height_increase=True,
                      penalise_holes_increase=True, lock_delay=1))):
        checked += oracle_lockstep(cfg, 256, 512, seed=100 + i)
        log(f"parity: C++ oracle lockstep w{cfg.width} h{cfg.height} "
            f"ld{cfg.lock_delay} 131072 steps bitwise")
    log(f"parity: C++ oracle total {checked} steps bitwise")
    worst = qnet_parity(gpu, cpu)
    log(f"parity: NatureDQN dueling+C51+noisy B=512 within "
        f"{BF16_TOL_ULPS} bf16 ulps of cpu (max {worst:.3f})")
    worst, flips = ppo_checkpoint_parity(gpu, cpu)
    log(f"parity: PPO checkpoint logits within {BF16_TOL_ULPS} bf16 ulps of "
        f"cpu (max {worst:.3f}); greedy actions differ on {flips} of 4096 "
        f"rows, each a near-tie")


# --------------------------------------------------------------------------
# 3. trainers
# --------------------------------------------------------------------------
def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return " ".join(f"{f.replace('_size_in_bytes', '')}="
                    f"{getattr(m, f, 'n/a')}" for f in fields)


def run_compiled(name: str, fn, state, calls: int, steps_per_call: int,
                 card: str, check) -> None:
    """Compile ``fn`` for ``state``, run it ``calls`` times (the first one
    untimed), check each call's metrics and log env-steps/s."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn, donate_argnums=(0,)).lower(state).compile()
    log(f"trainer: {name} compiled in {time.perf_counter() - t0:.1f}s; "
        f"memory_analysis: {memory_line(compiled)}")
    state, m = compiled(state)
    check(state, jax.device_get(m))
    t0 = time.perf_counter()
    for _ in range(calls - 1):
        state, m = compiled(state)
        jax.block_until_ready(m)
        check(state, jax.device_get(m))
    dt = time.perf_counter() - t0
    rate = (calls - 1) * steps_per_call / dt
    log(f"trainer: {name} {rate:.1f} env-steps/s over {calls - 1} timed "
        f"calls on {card}; last metrics "
        f"{ {k: float(v) for k, v in jax.device_get(m).items()} }")


def _finite(*keys):
    def check(state, m):
        for k in keys:
            if not np.isfinite(m[k]):
                raise AssertionError(f"metric {k} = {m[k]}")
    return check


def phase_trainers(card: str) -> None:
    from gym_simpletetris_tpu import EnvConfig
    from gym_simpletetris_tpu.train.dqn import DQNConfig, make_train
    from gym_simpletetris_tpu.train.es import ESConfig, make_es
    from gym_simpletetris_tpu.train.ppo import PPOConfig, make_ppo

    # flagship Rainbow (bench.py): three 512-step chunks, learn_starts
    # (4096 transitions = 16 steps) passed inside the first
    cfg = DQNConfig(
        env=EnvConfig(obs_type="grayscale", auto_reset=True,
                      reward_step=True, penalise_height=True),
        num_envs=256, buffer_capacity=65536, learn_batch=512,
        learn_every=4, frame_stack=4, prioritized=True, n_step=3,
        dueling=True, distributional=True, noisy=True,
        frame_ring=True, ring_stacks=True)
    init_fn, _, chunk_fn, _ = make_train(cfg)
    state = jax.jit(init_fn)(jax.random.PRNGKey(0))

    def dqn_check(state, m):
        _finite("loss", "mean_q")(state, m)
        if int(state.learn_steps) <= 0 or m["loss"] <= 0:
            raise AssertionError(f"flagship learner did not run: {m}")

    run_compiled("flagship Rainbow (256 envs, le=4, lb=512, obs-ring)",
                 lambda s: chunk_fn(s, 512), state, 3, 512 * 256, card,
                 dqn_check)

    pcfg = PPOConfig(
        env=EnvConfig(obs_type="ram", auto_reset=True, reward_step=True,
                      penalise_holes=True),
        num_envs=2048, rollout_len=64, epochs=2, num_minibatches=8,
        shuffle_block=64)
    init_fn, update_fn, _ = make_ppo(pcfg)
    run_compiled("PPO ram 2048x64", update_fn,
                 jax.jit(init_fn)(jax.random.PRNGKey(0)), 2, 2048 * 64, card,
                 _finite("pg_loss", "v_loss", "entropy"))

    ecfg = ESConfig(pop_size=1024, envs_per_member=8, horizon=256)
    init_fn, gen_fn, _ = make_es(ecfg)
    run_compiled("ES 1024x8 horizon 256", gen_fn,
                 jax.jit(init_fn)(jax.random.PRNGKey(0)), 2,
                 1024 * 8 * 256, card,
                 _finite("fitness_mean", "grad_norm"))


# --------------------------------------------------------------------------
# --four-cards: the mesh phase
# --------------------------------------------------------------------------
# Sharded learner metrics against the one-card golden on GPUs: the bf16
# forwards see other GEMM shapes once kernels are split over the model axis
# (autotuned algorithms, other accumulation orders) and gradients are summed
# across cards in another order, so metrics agree to a few bf16 ulps, not to
# float32's last bits.
MESH_RTOL, MESH_ATOL = 2e-2, 1e-3


def sharded_rollout_parity(n: int, per_device: int = 4096,
                           steps: int = 256) -> None:
    from gym_simpletetris_tpu import EnvConfig, TetrisVectorEnv
    from gym_simpletetris_tpu.parallel.mesh import (ShardedTetrisEnv,
                                                    make_data_mesh)

    cfg = EnvConfig(obs_type="grayscale", auto_reset=True)
    b = n * per_device
    acts = np.random.RandomState(0).randint(0, 7, (steps, b)).astype(np.int32)
    key = jax.random.PRNGKey(0)
    env = ShardedTetrisEnv(cfg, b, make_data_mesh(jax.devices()[:n]))
    _, st = env.reset(key)
    got = jax.device_get(env.rollout(st, jnp.asarray(acts)))
    single = TetrisVectorEnv(cfg, b)
    _, st = single.reset(key)
    want = jax.device_get(single.rollout(st, jnp.asarray(acts)))
    assert_trees_equal(got, want, f"ShardedTetrisEnv {n}x{per_device}")
    log(f"mesh: ShardedTetrisEnv grayscale {n}x{per_device} envs x {steps} "
        f"steps bitwise == one-card rollout")


def phase_mesh(n: int = 4, per_device: int = 4096, steps: int = 256) -> None:
    sys.path.insert(0, ROOT)
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(n, shapes=[(n, 1), (n // 2, 2)], rtol=MESH_RTOL,
                     atol=MESH_ATOL)
    sharded_rollout_parity(n, per_device, steps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    device = check_device(count)
    from gym_simpletetris_tpu.utils import compile_cache
    log(f"compile cache: {compile_cache.enable_compile_cache()}")
    card = card_name_and_power()
    log(f"card: {card}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_mesh(count)
    else:
        phase_parity()
        phase_trainers(card.splitlines()[0])
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s on {card}")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
