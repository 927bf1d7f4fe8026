"""Actor-critic networks for PPO (plain JAX, ``models/nn.py``; bf16 compute)."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.engine import NUM_ACTIONS
from .nn import Conv, Dense, Module, Scope


@dataclasses.dataclass(frozen=True)
class ConvTrunk(Module):
    dtype: jnp.dtype = jnp.bfloat16
    width_mult: int = 1

    def __call__(self, s: Scope, x):
        if x.ndim == 3:
            x = x[..., None]
        x = x.astype(self.dtype) / 255.0
        w = self.width_mult
        for i, (f, k, st) in enumerate(
                [(32 * w, 8, 4), (64 * w, 4, 2), (64 * w, 3, 1)]):
            x = jax.nn.relu(Conv(f, k, st, self.dtype)(s.child(f"conv{i+1}"), x))
        return x.reshape((x.shape[0], -1))


@dataclasses.dataclass(frozen=True)
class MlpTrunk(Module):
    hidden: Sequence[int] = (512, 256)
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x):
        x = x.reshape((x.shape[0], -1)).astype(self.dtype)
        for i, h in enumerate(self.hidden):
            x = jax.nn.relu(Dense(h, self.dtype)(s.child(f"dense{i}"), x))
        return x


@dataclasses.dataclass(frozen=True)
class ActorCritic(Module):
    """Shared trunk, separate policy-logits and value heads.

    obs_type picks the trunk: conv for 84x84 images, MLP for ram boards.
    Returns (logits float32[B, A], value float32[B]).
    """
    obs_type: str = "ram"
    num_actions: int = NUM_ACTIONS
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x) -> Tuple[jnp.ndarray, jnp.ndarray]:
        if self.obs_type == "ram":
            z = MlpTrunk(dtype=self.dtype)(s.child("MlpTrunk_0"), x)
        else:
            z = ConvTrunk(dtype=self.dtype)(s.child("ConvTrunk_0"), x)
            z = jax.nn.relu(Dense(512, self.dtype)(s.child("fc"), z))
        logits = Dense(self.num_actions, self.dtype)(s.child("pi"), z)
        value = Dense(1, self.dtype)(s.child("v"), z)[:, 0]
        return logits.astype(jnp.float32), value.astype(jnp.float32)
