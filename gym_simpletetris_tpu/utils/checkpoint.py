"""Checkpoint/resume via orbax.

The reference never serializes env state (``clear()`` is the only reset,
tetris_env.py:306-315; SURVEY.md §5). Here the entire env state — and the whole
DQN train state (params, optimizer, replay ring, env batch, counters) — is one
pytree of arrays, so checkpointing is a single orbax save/restore; sharded
arrays round-trip with their shardings under orbax's standard handlers.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax


def _ckptr():
    import orbax.checkpoint as ocp
    return ocp.PyTreeCheckpointer()


def save_checkpoint(path: str, tree: Any) -> str:
    """Save any pytree (EnvState, DQNState, params...) to ``path`` (a directory)."""
    path = os.path.abspath(path)
    _ckptr().save(path, tree, force=True)
    return path


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Restore a pytree saved by :func:`save_checkpoint`. Passing ``target``
    (a matching pytree of arrays) restores with its exact structure/dtypes
    AND its shardings — so a state saved on one mesh shape restores cleanly
    onto a different mesh (or the unsharded host): pass a structure donor
    born on the destination topology (e.g. ``init_fn(key)`` from the
    mesh-aware ``make_train``) and each leaf lands with the donor's layout
    instead of the topology recorded in the checkpoint file
    (tests/test_checkpoint_topology.py)."""
    path = os.path.abspath(path)
    import orbax.checkpoint as ocp
    if target is None:
        # targetless restore lands on host as plain numpy: build explicit
        # RestoreArgs from the checkpoint's own metadata so orbax doesn't
        # fall back to the sharding file (whose "unsafe on a different
        # topology" warning the CLI eval paths used to emit every restore)
        import numpy as np
        meta = _ckptr().metadata(path).item_metadata.tree
        restore_args = jax.tree.map(
            lambda m: ocp.RestoreArgs(restore_type=np.ndarray), meta,
            is_leaf=lambda m: hasattr(m, "shape"))
        return _ckptr().restore(
            path, args=ocp.args.PyTreeRestore(restore_args=restore_args))
    restore_args = ocp.checkpoint_utils.construct_restore_args(target)
    return _ckptr().restore(
        path, args=ocp.args.PyTreeRestore(item=target,
                                          restore_args=restore_args))


def save_params_npz(path: str, params: dict) -> None:
    """Write a nested dict of arrays (network variables) to one ``.npz``,
    one entry per leaf keyed by its "/"-joined path. Needs numpy only."""
    import numpy as np

    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk((), params)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_params_npz(path: str) -> dict:
    """Inverse of :func:`save_params_npz`: the nested dict of numpy arrays."""
    import numpy as np

    out: dict = {}
    with np.load(path) as z:
        for name in z.files:
            *parents, leaf = name.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[name]
    return out
