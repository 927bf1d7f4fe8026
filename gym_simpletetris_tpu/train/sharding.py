"""Mesh-aware sharding of the DQN training state (first-class DP + TP).

The reference has no distributed code at all (SURVEY.md §2.6); this module is
the framework's distributed-*training* story: given a device mesh with a
``data`` axis (and optionally a ``model`` axis), it assigns a
``NamedSharding`` to every leaf of ``DQNState`` **by tree path** — not by
shape matching, which could silently misshard a parameter whose dimension
happens to equal ``num_envs``:

- ``params`` / ``target_params`` (and their mirrors inside ``opt_state``,
  e.g. Adam's mu/nu): tensor parallelism — every ``kernel`` leaf shards its
  output (last) axis over the model axis when divisible; biases and scalars
  replicate. Dense layers thus compute ``x @ W[:, shard]`` locally and jit
  inserts the activation all-gather / gradient reduce-scatter.
- ``replay``: the [S, B, ...] slot-major ring shards its env axis over
  ``data`` — each data shard owns the transitions its envs produced, and the
  per-step insert (a dynamic_update_slice on the unsharded slot axis) stays
  shard-local with no collective.
- ``env_state``: batch-minor env sharding from ``parallel.mesh.state_sharding``
  (rows/shape_counts shard the last axis, per-env scalars their only axis).
- ``obs`` (num_envs-major) and the n-step ``window`` ([n-1, B, ...]) shard
  their batch axis over ``data``.
- ``key`` / ``step`` / ``learn_steps`` replicate.

``make_train(cfg, mesh=...)`` (train/dqn.py) uses this to *construct* the
state sharded (``jit(init, out_shardings=...)``) and to compile the train
step with matching in/out shardings — state is born on the mesh and never
resharded.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..parallel.mesh import DATA_AXIS, state_sharding

MODEL_AXIS = "model"


def _path_names(path) -> list:
    """Key path -> list of string components (attr names / dict keys)."""
    out = []
    for k in path:
        if hasattr(k, "name"):
            out.append(str(k.name))
        elif hasattr(k, "key"):
            out.append(str(k.key))
        else:
            out.append(str(k))
    return out


def _param_spec(names, leaf, mesh: Mesh, model_axis: Optional[str]) -> P:
    """TP rule: 'kernel' leaves (incl. NoisyDense's kernel_mu/kernel_sigma)
    shard the output (last) axis over the model axis when it divides;
    everything else replicates."""
    if (model_axis and model_axis in mesh.shape
            and names and names[-1] in ("kernel", "kernel_mu", "kernel_sigma")
            and getattr(leaf, "ndim", 0) >= 2
            and leaf.shape[-1] % mesh.shape[model_axis] == 0):
        return P(*((None,) * (leaf.ndim - 1) + (model_axis,)))
    return P()


def train_state_sharding(dqn_cfg, mesh: Mesh, abstract_state,
                         model_axis: Optional[str] = MODEL_AXIS):
    """NamedSharding pytree for a train state (DQNState or PPOState),
    assigned by tree path — the two states share their field vocabulary
    (params/target_params/opt_state, replay, env_state, obs, window,
    scalars), so one rule set covers both trainer families.

    ``abstract_state``: the ShapeDtypeStruct pytree from
    ``jax.eval_shape(init_fn, key)`` (or a concrete state).
    ``model_axis``: mesh axis for tensor parallelism; pass None (or use a mesh
    without the axis) for pure data parallelism.
    """
    env_sh = state_sharding(mesh, dqn_cfg.env)
    env_by_field = {f: getattr(env_sh, f) for f in
                    env_sh.__dataclass_fields__}

    def assign(path, leaf):
        names = _path_names(path)
        head = names[0]
        if head in ("params", "target_params", "opt_state"):
            return NamedSharding(mesh, _param_spec(names, leaf, mesh,
                                                   model_axis))
        if head == "replay":
            if getattr(leaf, "ndim", 0) >= 2:
                # [S, B, ...] ring: slot axis unsharded (the dynamic insert
                # index), env axis over data -> shard-local inserts
                return NamedSharding(mesh, P(None, DATA_AXIS))
            return NamedSharding(mesh, P())       # ptr / filled_slots / max_p
        if head == "env_state":
            return env_by_field[names[1]]
        if head == "obs":
            return NamedSharding(mesh, P(DATA_AXIS))
        if head == "window":
            return NamedSharding(mesh, P(None, DATA_AXIS))
        return NamedSharding(mesh, P())           # key, step, learn_steps

    return jax.tree_util.tree_map_with_path(assign, abstract_state)


# back-compat alias (earlier API name)
dqn_state_sharding = train_state_sharding
