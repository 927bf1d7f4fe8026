"""Immutable dataclasses that are JAX pytrees, built on ``dataclasses`` and
``jax.tree_util.register_dataclass``.

Every state type of the framework (engine, wrappers, replay rings, trainer
states) is declared with :func:`pytree_dataclass`: its array fields are the
pytree's leaves, so a state can be jitted over, vmapped, donated, sharded and
checkpointed as is. Fields declared with :func:`static_field` are not leaves:
they live in the treedef, so they are hashed into jit's cache key and a change
of their value recompiles instead of being traced.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree's leaves (treedef metadata)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Decorate ``cls`` as a frozen dataclass registered as a pytree, with a
    ``.replace(**changes)`` method (``dataclasses.replace``)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (meta if f.metadata.get("static") else data).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = dataclasses.replace
    return cls
