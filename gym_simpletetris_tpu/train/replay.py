"""On-device replay ring buffer, with optional prioritization.

The reference has no training infrastructure at all (SURVEY.md §3.5: its README
loop is a random policy). This buffer is designed for the on-device,
data-parallel actor-learner, and its layout is chosen for the device mesh:

**Slot-major ring [S, B]** (B = env batch = insert width, S = capacity/B
slots): one actor step inserts one *slot row* via a single contiguous
``dynamic_update_slice`` at (ptr, 0) — the batch axis stays minor, so the
write is one dense [B, obs] block. Under a data mesh (train/sharding.py
shards the B axis over ``data``) the insert is also **shard-local**: the
dynamic index is on the unsharded slot axis and the update spans each shard's
own envs, so no collective is generated. (A flat [capacity] ring with the
*sharded* axis dynamically sliced would instead land each step's block on one
shard and force an all-to-all per insert; an env-major [B, S] ring would make
the insert a B-way strided write.) Flat
transition index ``i = slot * B + env`` (row-major flatten) is what sampling
returns.

Observations are stored as uint8 (the env palette fits: ram is 0/1, images are
{0,128,190}) — 4x less HBM than float32; the learner casts on the way in. They
are stored **flattened** ([S, B, prod(obs_shape)]) and reshaped at the sample
boundary: one contiguous row per transition, whatever the observation's
shape, so an insert is one dense row block and a sample one row gather.

Transitions carry a ``discount`` = gamma^m * (1 - done) so the TD target is
always ``reward + discount * Q(next_obs)`` — one formula for 1-step and n-step
returns (train/dqn.py builds n-step rewards in a rolling window).

Prioritized replay (Schaul et al. 2015) is reshaped for the device: instead
of a host-side sum-tree, sampling-proportional-to-priority uses **two-level
inverse-CDF sampling** over the [S, B] priority grid — level 1 picks the slot
row (one cumsum over S), level 2 the env within it (one cumsum over B). This
is the sum-tree's arithmetic flattened to two dense vector levels: exact
proportional sampling *with replacement* (the distribution Schaul's eq. 1
defines, so the eq. 2 importance weights are exact), with no full-capacity
``top_k`` (a Gumbel-top-k draw samples without replacement, which makes the
beta correction approximate). Priority writes are a single scatter in the
learner (the no-scatter rule is for the env step path, core/engine.py, not
the learner).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field


@pytree_dataclass
class ReplayState:
    obs: jnp.ndarray       # uint8[S, B, prod(obs_shape)] (flattened)
    next_obs: jnp.ndarray  # uint8[S, B, prod(obs_shape)]
    action: jnp.ndarray    # int8[S, B]
    reward: jnp.ndarray    # float32[S, B] — n-step return when n > 1
    discount: jnp.ndarray  # float32[S, B] — gamma^m * (1 - done)
    done: jnp.ndarray      # bool[S, B]
    priority: jnp.ndarray  # float32[S, B] — p^alpha, 0 for empty slots
    max_p: jnp.ndarray     # float32[] — running max priority (new inserts)
    ptr: jnp.ndarray       # int32[] — next insert slot (row)
    filled_slots: jnp.ndarray  # int32[] — number of valid slot rows
    obs_shape: Tuple[int, ...] = static_field(default=())

    @property
    def width(self) -> int:
        return self.obs.shape[1]

    @property
    def slots(self) -> int:
        return self.obs.shape[0]

    @property
    def capacity(self) -> int:
        return self.obs.shape[0] * self.obs.shape[1]

    @property
    def filled(self) -> jnp.ndarray:
        """Number of valid transitions (every env row fills in lockstep)."""
        return self.filled_slots * self.width


def replay_init(capacity: int, obs_shape: Tuple[int, ...],
                insert_width: int) -> ReplayState:
    if capacity % insert_width:
        raise ValueError(
            f"capacity {capacity} must be a multiple of the env batch "
            f"{insert_width} (each env owns capacity/B ring slots)")
    b, s = insert_width, capacity // insert_width
    f = 1
    for d in obs_shape:
        f *= int(d)
    z = jnp.zeros
    return ReplayState(
        obs_shape=tuple(obs_shape),
        obs=z((s, b, f), jnp.uint8),
        next_obs=z((s, b, f), jnp.uint8),
        action=z((s, b), jnp.int8),
        reward=z((s, b), jnp.float32),
        discount=z((s, b), jnp.float32),
        done=z((s, b), jnp.bool_),
        priority=z((s, b), jnp.float32),
        max_p=jnp.ones((), jnp.float32),
        ptr=jnp.zeros((), jnp.int32),
        filled_slots=jnp.zeros((), jnp.int32),
    )


def replay_insert(rs: ReplayState, obs, next_obs, action, reward, done,
                  discount=None, *, gamma: float = None) -> ReplayState:
    """Insert one env-batch slot row of B transitions at the ring pointer.

    Exactly one of ``discount`` (precomputed, e.g. n-step gamma^n*(1-done))
    or ``gamma`` (the 1-step ``gamma * (1 - done)`` is derived) must be given
    — there is deliberately no default discount rate to silently mismatch the
    learner's. New rows get the running max priority (standard PER bootstrap;
    harmless when sampling uniformly).
    """
    b = obs.shape[0]
    if b != rs.width:
        raise ValueError(f"insert width {b} != ring width {rs.width}")
    if (discount is None) == (gamma is None):
        raise TypeError("pass exactly one of discount= or gamma=")
    if discount is None:
        discount = gamma * (1.0 - done.astype(jnp.float32))

    def upd(buf, val):
        start = (rs.ptr,) + (0,) * val.ndim
        return jax.lax.dynamic_update_slice(buf, val[None], start)

    return rs.replace(
        obs=upd(rs.obs, obs.astype(jnp.uint8).reshape(b, -1)),
        next_obs=upd(rs.next_obs, next_obs.astype(jnp.uint8).reshape(b, -1)),
        action=upd(rs.action, action.astype(jnp.int8)),
        reward=upd(rs.reward, reward.astype(jnp.float32)),
        discount=upd(rs.discount, discount.astype(jnp.float32)),
        done=upd(rs.done, done),
        priority=upd(rs.priority, jnp.full((b,), rs.max_p, jnp.float32)),
        ptr=(rs.ptr + 1) % rs.slots,
        filled_slots=jnp.minimum(rs.filled_slots + 1, rs.slots),
    )


def _gather_batch(rs: ReplayState, idx: jnp.ndarray) -> dict:
    """idx: flat transition indices (slot * B + env) -> learner batch."""
    cap = rs.capacity

    def take(buf):
        return jnp.take(buf.reshape((cap,) + buf.shape[2:]), idx, axis=0)

    def take_obs(buf):
        # stays uint8: the palette values are integer-exact and the Q-net
        # casts on the way in (x.astype(dtype)/255), so materializing a f32
        # copy here would only add 4x the HBM write traffic at the sample
        # boundary (2 x [batch, 84*84*k] rows at the flagship point)
        return take(buf).reshape((idx.shape[0],) + rs.obs_shape)

    return {
        "obs": take_obs(rs.obs),
        "next_obs": take_obs(rs.next_obs),
        "action": take(rs.action).astype(jnp.int32),
        "reward": take(rs.reward),
        "discount": take(rs.discount),
        "done": take(rs.done),
    }


def replay_sample(rs: ReplayState, key, batch: int) -> dict:
    """Uniform sample of ``batch`` transitions from the filled region
    (slots fill in lockstep across envs, so uniform = uniform valid slot x
    uniform env)."""
    kb, ks = jax.random.split(key)
    s = jax.random.randint(ks, (batch,), 0, jnp.maximum(rs.filled_slots, 1))
    b = jax.random.randint(kb, (batch,), 0, rs.width)
    return _gather_batch(rs, s * rs.width + b)


def replay_sample_prioritized(rs: ReplayState, key, batch: int, beta):
    """Priority-proportional sample *with replacement* (Schaul et al. eq. 1:
    P(i) = p_i^alpha / sum_k p_k^alpha; ``rs.priority`` already stores
    p^alpha), via two-level inverse-CDF over the [B, S] grid — the sum-tree
    flattened to two dense levels, no full-capacity top_k.

    Returns (batch_dict, idx, weights): importance weights
    ``(1/(N * P(i)))^beta`` (eq. 2), exact because P(i) is the true marginal
    under with-replacement sampling, normalized by the buffer-wide max weight
    (attained at the min-priority valid row), so updates only ever scale
    down. Slots beyond the filled region have P(i) = 0 and can only be drawn
    through float round-off at the CDF edges; their weight is zeroed.
    """
    bw, sl = rs.width, rs.slots
    valid = (jnp.arange(sl) < rs.filled_slots)[:, None]   # [S, 1]
    grid = jnp.where(valid, rs.priority, 0.0)             # [S, B]
    s_slot = grid.sum(axis=1)                             # [S]
    total = s_slot.sum()
    u = jax.random.uniform(key, (batch,)) * total         # in [0, total)
    # level 1: slot row s s.t. cum_exclusive[s] <= u < cum_inclusive[s]
    cum_slot = jnp.cumsum(s_slot)
    slot = jnp.minimum((cum_slot[None, :] <= u[:, None]).sum(axis=1), sl - 1)
    r = u - jnp.take(cum_slot - s_slot, slot)             # residual in slot
    # level 2: env column within the slot row
    rows_p = jnp.take(grid, slot, axis=0)                 # [batch, B]
    cum_in = jnp.cumsum(rows_p, axis=1)
    row = jnp.minimum((cum_in <= r[:, None]).sum(axis=1), bw - 1)
    idx = slot * bw + row
    out = _gather_batch(rs, idx)
    prob = jnp.take(grid.reshape(-1), idx) / jnp.maximum(total, 1e-12)
    n = jnp.maximum(rs.filled, 1).astype(jnp.float32)
    w = (1.0 / (n * jnp.maximum(prob, 1e-12))) ** beta
    w = jnp.where(prob > 0, w, 0.0)
    # buffer-wide max weight: (N * P_min)^-beta at the smallest valid priority
    p_min = jnp.min(jnp.where(valid & (grid > 0), grid, jnp.inf))
    w_max = (1.0 / (n * jnp.maximum(p_min, 1e-12) /
                    jnp.maximum(total, 1e-12))) ** beta
    return out, idx, w / jnp.maximum(w_max, 1e-12)


def _legacy_slot_batch(rs: ReplayState, slot) -> dict:
    """Whole-slot-row batch for the legacy layout (see
    :func:`_frame_ring_slot_batch` for the rationale)."""
    nb, B = slot.shape[0], rs.width
    S = rs.slots
    fidx = (slot[:, None] * B + jnp.arange(B)[None, :]).reshape(-1)

    def flat(buf, s=None):
        # flat gather, slot-contiguous indices (see _frame_ring_slot_batch)
        idx = fidx if s is None else (
            s[:, None] * B + jnp.arange(B)[None, :]).reshape(-1)
        return jnp.take(buf.reshape((S * B,) + buf.shape[2:]), idx, axis=0)

    def obs(buf):
        return flat(buf).reshape((nb * B,) + rs.obs_shape)

    return {
        "obs": obs(rs.obs),
        "next_obs": obs(rs.next_obs),
        "action": flat(rs.action).astype(jnp.int32),
        "reward": flat(rs.reward),
        "discount": flat(rs.discount),
        "done": flat(rs.done),
    }


def replay_sample_slots(rs: ReplayState, key, batch: int):
    """Uniform slot-row sample over the filled region (legacy layout)."""
    nb, rem = divmod(batch, rs.width)
    if rem:
        raise ValueError(f"slot-row batch {batch} must be a multiple of the "
                         f"ring width {rs.width}")
    slot = jax.random.randint(key, (nb,), 0, jnp.maximum(rs.filled_slots, 1))
    return _legacy_slot_batch(rs, slot), slot


def replay_sample_slots_prioritized(rs: ReplayState, key, batch: int, beta):
    """Slot-level PER over the filled region (legacy layout); see
    :func:`frame_ring_sample_slots_prioritized` for the weighting scheme."""
    nb, rem = divmod(batch, rs.width)
    if rem:
        raise ValueError(f"slot-row batch {batch} must be a multiple of the "
                         f"ring width {rs.width}")
    B, S = rs.width, rs.slots
    valid = (jnp.arange(S) < rs.filled_slots)[:, None]
    grid = jnp.where(valid, rs.priority, 0.0)
    p_s = grid.sum(axis=1)
    total = p_s.sum()
    u = jax.random.uniform(key, (nb,)) * total
    cum = jnp.cumsum(p_s)
    slot = jnp.minimum((cum[None, :] <= u[:, None]).sum(axis=1), S - 1)
    q = jnp.take(p_s, slot) / jnp.maximum(total, 1e-12)
    n_tr = jnp.maximum(rs.filled, 1).astype(jnp.float32)
    w_slot = (1.0 / (n_tr * jnp.maximum(q / B, 1e-12))) ** beta
    w_slot = jnp.where(q > 0, w_slot, 0.0)
    q_min = jnp.min(jnp.where(p_s > 0, p_s, jnp.inf)) / jnp.maximum(total,
                                                                    1e-12)
    w_max = (1.0 / (n_tr * jnp.maximum(q_min / B, 1e-12))) ** beta
    weights = jnp.repeat(w_slot / jnp.maximum(w_max, 1e-12), B)
    return _legacy_slot_batch(rs, slot), slot, weights


def replay_update_priority(rs, idx, td_abs, alpha: float,
                           eps: float = 1e-3):
    """Write back p = (|delta| + eps)^alpha at the sampled flat indices.
    (Duck-typed: works on ReplayState and FrameRingState alike — both carry
    ``priority``/``max_p``.)"""
    p = (jnp.abs(td_abs) + eps) ** alpha
    flat = rs.priority.reshape(-1).at[idx].set(p.astype(jnp.float32))
    return rs.replace(
        priority=flat.reshape(rs.priority.shape),
        max_p=jnp.maximum(rs.max_p, p.max()),
    )


# ---------------------------------------------------------------------------
# Frame-ring replay: store each raw frame ONCE, reconstruct on gather.
# ---------------------------------------------------------------------------
#
# The stacked-storage ring above keeps every frame ~2k times (k stacked copies
# in ``obs`` + k in ``next_obs``), and the trainer's rolling n-step window
# re-copies the stacked observation every actor step. At the flagship
# operating point (256 envs, 84x84x4 stacks) those copies are tens of MB per
# actor step of pure observation plumbing.
#
# The frame ring is the classic Atari-replay fix: one slot per
# actor step holding the SINGLE raw frame f_t plus (a_t, r_t, d_t, priority);
# observation stacks are rebuilt at consume time by k gathers with
# episode-boundary clamping (positions before the episode start repeat the
# episode's first frame — exactly the semantics of the actor's
# reset-to-repeat stack), and n-step returns fold r/d at SAMPLE time, which
# deletes the trainer's rolling window entirely. Memory: ~2k x smaller
# (3.7 GB -> 0.46 GB for the 65536-capacity flagship ring). ``done`` is
# initialized True so unfilled slots clamp like episode boundaries.
#
# Validity: a sample's stack needs the k-1 slots behind it and its n-step
# target the n slots ahead, so sampling draws ring ages m in [n, filled-k]
# (age 0 = newest written slot). PER masks the priority grid to that window.


@pytree_dataclass
class FrameRingState:
    frame: jnp.ndarray     # uint8[S, B, prod(base_shape)] — raw frame f_t
    action: jnp.ndarray    # int8[S, B]    — a_t
    reward: jnp.ndarray    # float32[S, B] — raw 1-step r_t
    done: jnp.ndarray      # bool[S, B]    — d_t (True-initialized)
    priority: jnp.ndarray  # float32[S, B] — p^alpha, 0 for unfilled
    max_p: jnp.ndarray     # float32[]
    ptr: jnp.ndarray       # int32[] — slot being written (frame first,
    #                         action/reward/done complete it and advance)
    filled_slots: jnp.ndarray  # int32[]
    base_shape: Tuple[int, ...] = static_field(default=())
    frame_stack: int = static_field(default=1)
    n_step: int = static_field(default=1)
    gamma: float = static_field(default=0.99)
    # stacked=True: each slot row holds the WHOLE observation stack the
    # actor saw at that step (the "obs ring"): k x the frame memory of the
    # single-frame layout, but sampling reads ONE contiguous row per stack
    # (obs at s, next at s+n) instead of k row-gathers each. Single-frame
    # (stacked=False) stays the memory-lean layout. Both fold n-step returns
    # at sample time and need no rolling window.
    stacked: bool = static_field(default=False)

    @property
    def width(self) -> int:
        return self.frame.shape[1]

    @property
    def slots(self) -> int:
        return self.frame.shape[0]

    @property
    def filled(self) -> jnp.ndarray:
        return self.filled_slots * self.width

    @property
    def history_slots(self) -> int:
        """Slots of backward history a sample's obs stack needs."""
        return 1 if self.stacked else self.frame_stack

    @property
    def valid_slots(self) -> jnp.ndarray:
        """Sampleable slot count: ages [n_step, filled-history]."""
        return jnp.maximum(
            self.filled_slots - self.history_slots - self.n_step + 1, 0)


def frame_ring_init(capacity: int, base_shape: Tuple[int, ...],
                    insert_width: int, frame_stack: int = 1,
                    n_step: int = 1, gamma: float = 0.99,
                    stacked: bool = False) -> FrameRingState:
    if capacity % insert_width:
        raise ValueError(
            f"capacity {capacity} must be a multiple of the env batch "
            f"{insert_width} (each env owns capacity/B ring slots)")
    b, s = insert_width, capacity // insert_width
    if s < frame_stack + n_step + 1:
        raise ValueError(
            f"ring of {s} slots cannot serve frame_stack={frame_stack} + "
            f"n_step={n_step}")
    f = 1
    for d in base_shape:
        f *= int(d)
    if stacked:
        f *= int(frame_stack)
    z = jnp.zeros
    return FrameRingState(
        base_shape=tuple(base_shape), frame_stack=int(frame_stack),
        n_step=int(n_step), gamma=float(gamma), stacked=bool(stacked),
        frame=z((s, b, f), jnp.uint8),
        action=z((s, b), jnp.int8),
        reward=z((s, b), jnp.float32),
        done=jnp.ones((s, b), jnp.bool_),   # unfilled slots clamp stacks
        priority=z((s, b), jnp.float32),
        max_p=jnp.ones((), jnp.float32),
        ptr=jnp.zeros((), jnp.int32),
        filled_slots=jnp.zeros((), jnp.int32),
    )


def frame_ring_insert_frame(rs: FrameRingState, frame) -> FrameRingState:
    """Write the raw frame f_t at the current slot (before acting — the
    actor then reads its stack straight back out of the ring)."""
    b = frame.shape[0]
    if b != rs.width:
        raise ValueError(f"insert width {b} != ring width {rs.width}")
    val = frame.astype(jnp.uint8).reshape(b, -1)[None]
    return rs.replace(frame=jax.lax.dynamic_update_slice(
        rs.frame, val, (rs.ptr, 0, 0)))


def frame_ring_insert_step(rs: FrameRingState, action, reward,
                           done) -> FrameRingState:
    """Complete the current slot with (a_t, r_t, d_t) and advance the ring."""
    b = action.shape[0]

    def upd(buf, val):
        return jax.lax.dynamic_update_slice(buf, val[None], (rs.ptr, 0))

    return rs.replace(
        action=upd(rs.action, action.astype(jnp.int8)),
        reward=upd(rs.reward, reward.astype(jnp.float32)),
        done=upd(rs.done, done),
        priority=upd(rs.priority, jnp.full((b,), rs.max_p, jnp.float32)),
        ptr=(rs.ptr + 1) % rs.slots,
        filled_slots=jnp.minimum(rs.filled_slots + 1, rs.slots),
    )


def _run_length_grid(rs: FrameRingState) -> jnp.ndarray:
    """int32[S, B]: for each slot, how many steps back the episode extends
    (capped at frame_stack-1) — the stack-clamp offset cap. Computed as
    k-1 rolled elementwise passes over the done grid (the [S, B] grid is
    tiny, and it replaces k-1 per-sample done gathers)."""
    k = rs.frame_stack
    run = jnp.zeros(rs.done.shape, jnp.int32)
    ok = jnp.ones(rs.done.shape, jnp.bool_)
    for j in range(1, k):
        ok = ok & ~jnp.roll(rs.done, j, axis=0)       # done at slot-j
        run = jnp.where(ok, j, run)
    return run


def _ring_stack(rs: FrameRingState, slot, env, run_flat=None):
    """Rebuild observation stacks ending at ``slot`` (newest frame) for the
    given (slot, env) pairs: [N, *base_shape(, k)] uint8.

    Position j steps back uses f_{slot-j} while slots slot-j..slot-1 carry no
    ``done``; past an episode boundary it clamps to the episode's first frame
    — bit-identical to the actor's shift-and-reset-to-repeat stack.
    ``run_flat``: optional precomputed flat run-length grid (shared across
    the obs/next stacks of one sample call)."""
    k, S, B = rs.frame_stack, rs.slots, rs.width
    flat = rs.frame.reshape(S * B, -1)

    def take_at(off):
        return jnp.take(flat, ((slot - off) % S) * B + env, axis=0)

    if rs.stacked:
        # obs-ring layout: the whole stack is one contiguous row
        out = take_at(jnp.zeros_like(slot))
        shape = rs.base_shape + ((k,) if k > 1 else ())
        return out.reshape((slot.shape[0],) + shape)

    if k == 1:
        out = take_at(jnp.zeros_like(slot))
        return out.reshape((slot.shape[0],) + rs.base_shape)

    if run_flat is None:
        run_flat = _run_length_grid(rs).reshape(S * B)
    run = jnp.take(run_flat, slot * B + env, axis=0)  # one gather, not k-1
    # merged gather: ONE take of k*N rows instead of k takes of N rows (one
    # gather op instead of k). Offsets clamp at the episode start.
    offs = [jnp.minimum(jnp.int32(j), run) for j in range(k)]   # newest j=0
    idx = jnp.stack([((slot - o) % S) * B + env for o in offs])  # [k, N]
    out = jnp.take(flat, idx.reshape(-1), axis=0)
    frames = out.reshape((k, slot.shape[0], flat.shape[1]))
    stacked = jnp.moveaxis(frames[::-1], 0, -1)                  # oldest first
    return stacked.reshape((slot.shape[0],) + rs.base_shape + (k,))


def frame_ring_stack_newest(rs: FrameRingState) -> jnp.ndarray:
    """The actor's current observation stack, straight from the ring: call
    after :func:`frame_ring_insert_frame` (the newest frame sits at ptr).

    Gather-free: every env reads the SAME k slots (ptr, ptr-1, ...), so the
    stack is k ``dynamic_index_in_dim`` row reads with the episode-boundary
    clamp as cascaded per-env selects — contiguous [B, F] traffic instead of
    a B-row gather."""
    k, S, B = rs.frame_stack, rs.slots, rs.width
    prev = jax.lax.dynamic_index_in_dim(rs.frame, rs.ptr % S, 0,
                                        keepdims=False)          # [B, F]
    if k == 1:
        return prev.reshape((B,) + rs.base_shape)
    frames = [prev]
    ok = jnp.ones((B, 1), jnp.bool_)
    for j in range(1, k):
        d_j = jax.lax.dynamic_index_in_dim(rs.done, (rs.ptr - j) % S, 0,
                                           keepdims=False)[:, None]
        ok = ok & ~d_j
        f_j = jax.lax.dynamic_index_in_dim(rs.frame, (rs.ptr - j) % S, 0,
                                           keepdims=False)
        prev = jnp.where(ok, f_j, prev)   # clamp: carry the last in-episode
        frames.append(prev)
    out = jnp.stack(frames[::-1], axis=-1)            # oldest first
    return out.reshape((B,) + rs.base_shape + (k,))


def _frame_ring_batch(rs: FrameRingState, slot, env) -> dict:
    """Materialize sampled transitions: stacks by gather+clamp, n-step
    return/discount folded from the raw per-slot rewards/dones.

    All scalar quantities (n-step return, discount, done-any, clamp run
    length) are PRE-FOLDED on the whole [S, B] grid with rolled elementwise
    passes (a few hundred KB) and fetched with ONE gather each — the naive
    per-sample formulation would cost ~2n+2(k-1)+1 scalar gathers per
    batch)."""
    S, B, n = rs.slots, rs.width, rs.n_step
    fidx = slot * B + env

    ret_g = jnp.zeros(rs.reward.shape, jnp.float32)
    alive_g = jnp.ones(rs.reward.shape, jnp.float32)
    done_any_g = jnp.zeros(rs.done.shape, jnp.bool_)
    for i in range(n):
        r_i = jnp.roll(rs.reward, -i, axis=0)         # value at slot+i
        d_i = jnp.roll(rs.done, -i, axis=0)
        ret_g = ret_g + (rs.gamma ** i) * alive_g * r_i
        done_any_g = done_any_g | d_i
        alive_g = alive_g * (1.0 - d_i.astype(jnp.float32))

    run_flat = (None if rs.frame_stack == 1 or rs.stacked
                else _run_length_grid(rs).reshape(S * B))
    return {
        # uint8 (see _gather_batch.take_obs): the consumer's cast fuses into
        # the conv stem; a f32 copy here would be 4x the bytes
        "obs": _ring_stack(rs, slot, env, run_flat),
        "next_obs": _ring_stack(rs, (slot + n) % S, env, run_flat),
        "action": jnp.take(rs.action.reshape(S * B), fidx,
                           axis=0).astype(jnp.int32),
        "reward": jnp.take(ret_g.reshape(S * B), fidx, axis=0),
        "discount": (rs.gamma ** n) * jnp.take(alive_g.reshape(S * B),
                                               fidx, axis=0),
        "done": jnp.take(done_any_g.reshape(S * B), fidx, axis=0),
    }


def _slot_scalar_folds(rs: FrameRingState):
    """Prefold the n-step return / alive grids once per sample call
    (shared by the per-transition and slot-row samplers)."""
    n = rs.n_step
    ret_g = jnp.zeros(rs.reward.shape, jnp.float32)
    alive_g = jnp.ones(rs.reward.shape, jnp.float32)
    done_any_g = jnp.zeros(rs.done.shape, jnp.bool_)
    for i in range(n):
        r_i = jnp.roll(rs.reward, -i, axis=0)
        d_i = jnp.roll(rs.done, -i, axis=0)
        ret_g = ret_g + (rs.gamma ** i) * alive_g * r_i
        done_any_g = done_any_g | d_i
        alive_g = alive_g * (1.0 - d_i.astype(jnp.float32))
    return ret_g, alive_g, done_any_g


def _frame_ring_slot_batch(rs: FrameRingState, slot) -> dict:
    """Materialize WHOLE slot rows as the learner batch: ``slot`` int32[nb]
    -> batch of nb * B transitions (row-major). Requires the stacked
    (obs-ring) layout or frame_stack == 1 — reconstruction-free layouts
    where a slot row IS the observation.

    This is the replay twin of PPO's ``shuffle_block``: a slot row is B
    *different envs at the same ring age* (envs are independent), so a batch
    of whole rows still mixes random ages — while the obs reads become nb
    row-gathers of [B, F] contiguous bytes instead of ``batch`` scattered
    row-gathers. Priority write-back becomes a row write as well.
    """
    if not (rs.stacked or rs.frame_stack == 1):
        raise ValueError("slot-row sampling needs ring_stacks=True or "
                         "frame_stack == 1 (no per-env stack clamping)")
    S, B, n, k = rs.slots, rs.width, rs.n_step, rs.frame_stack
    nb = slot.shape[0]
    ret_g, alive_g, done_any_g = _slot_scalar_folds(rs)
    shape = rs.base_shape + ((k,) if rs.stacked and k > 1 else ())

    def rows(buf, s):
        # flat gather with slot-contiguous indices: the formulation the
        # per-transition sampler uses against the same in-place-updated
        # ring carry, with the indices now runs of B consecutive rows.
        # (A row-axis jnp.take of the ring can lower to a full-ring read, and
        # dynamic_index_in_dim reads inside the learner cond can break the
        # ring's in-place scan carry.)
        f2 = buf.reshape((S * B,) + buf.shape[2:])
        fidx = (s[:, None] * B + jnp.arange(B)[None, :]).reshape(-1)
        return jnp.take(f2, fidx, axis=0)             # [nb * B, ...]

    def flat(x):
        return x

    return {
        "obs": flat(rows(rs.frame, slot)).reshape((nb * B,) + shape),
        "next_obs": flat(rows(rs.frame, (slot + n) % S)).reshape(
            (nb * B,) + shape),
        "action": flat(rows(rs.action, slot)).astype(jnp.int32),
        "reward": flat(rows(ret_g, slot)),
        "discount": (rs.gamma ** n) * flat(rows(alive_g, slot)),
        "done": flat(rows(done_any_g, slot)),
    }


def frame_ring_sample_slots(rs: FrameRingState, key, batch: int):
    """Uniform slot-row sample: ``batch`` must be ``nb * B``. Same valid-age
    window (and the same ``valid_slots > 0`` precondition) as
    :func:`frame_ring_sample`."""
    nb, rem = divmod(batch, rs.width)
    if rem:
        raise ValueError(f"slot-row batch {batch} must be a multiple of the "
                         f"ring width {rs.width}")
    m = rs.n_step + jax.random.randint(
        key, (nb,), 0, jnp.maximum(rs.valid_slots, 1))
    slot = (rs.ptr - 1 - m) % rs.slots
    return _frame_ring_slot_batch(rs, slot), slot


def frame_ring_sample_slots_prioritized(rs: FrameRingState, key, batch: int,
                                        beta):
    """Slot-level PER: slots drawn with replacement proportional to their
    summed priority (the two-level CDF's level 1 alone); all B transitions
    of a drawn slot enter the batch, importance-weighted by the slot-level
    inclusion probability (uniform within the row — a stratified
    coarsening of Schaul et al.'s per-transition scheme; per-transition
    priorities are still written back and shape future slot sums).
    Returns (batch, slot, weights[nb * B])."""
    nb, rem = divmod(batch, rs.width)
    if rem:
        raise ValueError(f"slot-row batch {batch} must be a multiple of the "
                         f"ring width {rs.width}")
    B, S = rs.width, rs.slots
    grid = jnp.where(_frame_ring_valid_mask(rs)[:, None], rs.priority, 0.0)
    p_s = grid.sum(axis=1)                       # [S] slot priority masses
    total = p_s.sum()
    u = jax.random.uniform(key, (nb,)) * total
    cum = jnp.cumsum(p_s)
    slot = jnp.minimum((cum[None, :] <= u[:, None]).sum(axis=1), S - 1)
    q = jnp.take(p_s, slot) / jnp.maximum(total, 1e-12)   # [nb] P(slot)
    n_tr = jnp.maximum(rs.valid_slots * B, 1).astype(jnp.float32)
    # per-draw inclusion prob of a transition in slot s is q_s; uniform
    # within the row divides the slot's mass over its B transitions
    w_slot = (1.0 / (n_tr * jnp.maximum(q / B, 1e-12))) ** beta
    w_slot = jnp.where(q > 0, w_slot, 0.0)
    q_min = jnp.min(jnp.where(p_s > 0, p_s, jnp.inf)) / jnp.maximum(total,
                                                                    1e-12)
    w_max = (1.0 / (n_tr * jnp.maximum(q_min / B, 1e-12))) ** beta
    weights = jnp.repeat(w_slot / jnp.maximum(w_max, 1e-12), B)
    return _frame_ring_slot_batch(rs, slot), slot, weights


def replay_update_priority_slots(rs, slot, td_abs, alpha: float,
                                 eps: float = 1e-3):
    """Priority write-back for slot-row sampling: td_abs [nb * B] ->
    priorities of the whole rows at ``slot``, via the flat-index scatter
    (slot-contiguous indices). Duplicate drawn slots carry identical td
    rows (identical inputs through the same noise draw), so last-wins
    scatter semantics are value-deterministic."""
    B = rs.priority.shape[1]
    fidx = (slot[:, None] * B + jnp.arange(B)[None, :]).reshape(-1)
    return replay_update_priority(rs, fidx, td_abs, alpha, eps)


def frame_ring_sample(rs: FrameRingState, key, batch: int):
    """Uniform sample over the valid age window [n_step, filled-k].

    Precondition: ``rs.valid_slots > 0``. With an under-filled ring the age
    clamp lands on unfilled (True-done, zero-frame) slots and the returned
    transitions are garbage — no error is raised on device. Gate calls the
    way train/dqn.py does (``can_learn &= replay.valid_slots > 0``)."""
    kb, ks = jax.random.split(key)
    m = rs.n_step + jax.random.randint(
        ks, (batch,), 0, jnp.maximum(rs.valid_slots, 1))
    slot = (rs.ptr - 1 - m) % rs.slots
    env = jax.random.randint(kb, (batch,), 0, rs.width)
    return _frame_ring_batch(rs, slot, env)


def _frame_ring_valid_mask(rs: FrameRingState) -> jnp.ndarray:
    """[S] bool: slots whose age is in the sampleable window."""
    age = (rs.ptr - 1 - jnp.arange(rs.slots, dtype=jnp.int32)) % rs.slots
    return (age >= rs.n_step) & (age < rs.n_step + rs.valid_slots)


def frame_ring_sample_prioritized(rs: FrameRingState, key, batch: int, beta):
    """Priority-proportional sample with replacement over the valid window —
    the same two-level inverse-CDF as the stacked ring, with the grid masked
    to sampleable ages.

    Precondition: ``rs.valid_slots > 0`` (same silent-garbage failure mode
    as :func:`frame_ring_sample`; gate like train/dqn.py does)."""
    bw, sl = rs.width, rs.slots
    grid = jnp.where(_frame_ring_valid_mask(rs)[:, None], rs.priority, 0.0)
    s_slot = grid.sum(axis=1)
    total = s_slot.sum()
    u = jax.random.uniform(key, (batch,)) * total
    cum_slot = jnp.cumsum(s_slot)
    slot = jnp.minimum((cum_slot[None, :] <= u[:, None]).sum(axis=1), sl - 1)
    r = u - jnp.take(cum_slot - s_slot, slot)
    rows_p = jnp.take(grid, slot, axis=0)
    cum_in = jnp.cumsum(rows_p, axis=1)
    row = jnp.minimum((cum_in <= r[:, None]).sum(axis=1), bw - 1)
    idx = slot * bw + row
    out = _frame_ring_batch(rs, slot, row)
    prob = jnp.take(grid.reshape(-1), idx) / jnp.maximum(total, 1e-12)
    n = jnp.maximum(rs.valid_slots * bw, 1).astype(jnp.float32)
    w = (1.0 / (n * jnp.maximum(prob, 1e-12))) ** beta
    w = jnp.where(prob > 0, w, 0.0)
    p_min = jnp.min(jnp.where(grid > 0, grid, jnp.inf))
    w_max = (1.0 / (n * jnp.maximum(p_min, 1e-12) /
                    jnp.maximum(total, 1e-12))) ** beta
    return out, idx, w / jnp.maximum(w_max, 1e-12)
