"""Q-networks for SimpleTetris observations (plain JAX, ``models/nn.py``).

The reference ships no model code at all (SURVEY.md §2.6) — its README implies
external DQN agents trained on the 84x84 observations. This module provides the
framework's bundled model family:

- ``NatureDQN``: the classic Atari conv stack for 84x84 grayscale/rgb frames
  (with optional frame stacking on the channel axis), bfloat16 compute,
  float32 params.
- ``RamDQN``: an MLP for the (W, H) ram observation.
- ``DuelingHead``: optional dueling value/advantage decomposition.
- ``C51Head``: distributional RL (Bellemare et al. 2017) — ``num_atoms > 0``
  on either trunk switches the output from scalar Q-values [B, A] to
  categorical return-distribution logits [B, A, num_atoms]; the trainer
  (train/dqn.py, ``DQNConfig.distributional``) owns the support and the
  projected cross-entropy loss. Composes with dueling (value/advantage
  decomposition per atom, mean-advantage identifiability constraint).
- ``NoisyDense`` (models/nn.py): factorized-Gaussian noisy linear layer
  (Fortunato et al. 2018). ``noisy=True`` on either trunk swaps every
  fully-connected layer in the value pathway for it; exploration then comes
  from parameter noise (resampled via the ``"noise"`` rng per apply) instead
  of epsilon-greedy. Applying without a ``"noise"`` rng is the deterministic
  (mu-only) evaluation net.

Together these make the bundled family Rainbow-complete (Hessel et al. 2018):
double DQN + PER + n-step + dueling + C51 + noisy nets, each independently
switchable in ``DQNConfig``.

TP note: the dense layers carry nearly all parameters; ``train/dqn.py`` shards
them over the mesh's model axis when requested (jit handles the collectives).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from ..core.engine import NUM_ACTIONS
from .nn import Conv, Dense, Module, NoisyDense, Scope

__all__ = ["NoisyDense", "DuelingHead", "C51Head", "NatureDQN", "RamDQN",
           "build_q_network"]


def _dense(noisy: bool, features: int, dtype) -> Module:
    """The value pathway's linear layer: noisy or plain."""
    return NoisyDense(features, dtype=dtype) if noisy else Dense(features, dtype)


@dataclasses.dataclass(frozen=True)
class DuelingHead(Module):
    """Q(s,a) = V(s) + A(s,a) - mean_a A(s,a)."""
    num_actions: int = NUM_ACTIONS
    noisy: bool = False
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x):
        v = _dense(self.noisy, 1, self.dtype)(s.child("value"), x)
        a = _dense(self.noisy, self.num_actions, self.dtype)(
            s.child("advantage"), x)
        return v + a - a.mean(axis=-1, keepdims=True)


@dataclasses.dataclass(frozen=True)
class C51Head(Module):
    """Categorical return-distribution logits [B, A, num_atoms].

    ``dueling=True`` decomposes per atom: logits = V(s) + A(s,a) - mean_a A
    (the C51 analogue of the dueling constraint, applied in logit space as in
    Rainbow, Hessel et al. 2018).
    """
    num_actions: int = NUM_ACTIONS
    num_atoms: int = 51
    dueling: bool = False
    noisy: bool = False
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x):
        a, z = self.num_actions, self.num_atoms
        if self.dueling:
            v = _dense(self.noisy, z, self.dtype)(s.child("value"), x)
            adv = _dense(self.noisy, a * z, self.dtype)(s.child("advantage"), x)
            adv = adv.reshape(adv.shape[:-1] + (a, z))
            logits = v[..., None, :] + adv - adv.mean(axis=-2, keepdims=True)
        else:
            logits = _dense(self.noisy, a * z, self.dtype)(s.child("logits"), x)
            logits = logits.reshape(logits.shape[:-1] + (a, z))
        return logits


def _q_head(net, s: Scope, x):
    """The head shared by both trunks: C51 logits, dueling Q or plain Q."""
    if net.num_atoms > 0:
        q = C51Head(net.num_actions, net.num_atoms, net.dueling, net.noisy,
                    dtype=net.dtype)(s.child("C51Head_0"), x)
    elif net.dueling:
        q = DuelingHead(net.num_actions, net.noisy, dtype=net.dtype)(
            s.child("DuelingHead_0"), x)
    else:
        q = _dense(net.noisy, net.num_actions, net.dtype)(s.child("q"), x)
    return q.astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class NatureDQN(Module):
    """Mnih et al. conv trunk for 84x84 inputs (bf16 compute).

    Input: [B, 84, 84, C] float32 or uint8 (C = channels x stacked frames).
    Pixel values are the raw reference palette {0, 128, 190}; normalization
    happens here (scale 1/255) so the env can stay in its exact-parity integer
    palette.
    """
    num_actions: int = NUM_ACTIONS
    dueling: bool = False
    width_mult: int = 1
    num_atoms: int = 0   # > 0: C51 logits [B, A, num_atoms] instead of Q [B, A]
    noisy: bool = False  # NoisyNet fully-connected layers (convs stay plain,
                         # as in Rainbow)
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x):
        if x.ndim == 3:       # [B, 84, 84] grayscale without extend_dims
            x = x[..., None]
        x = x.astype(self.dtype) / 255.0
        w = self.width_mult
        for i, (f, k, st) in enumerate(
                [(32 * w, 8, 4), (64 * w, 4, 2), (64 * w, 3, 1)]):
            x = jax.nn.relu(Conv(f, k, st, self.dtype)(s.child(f"conv{i+1}"), x))
        x = x.reshape((x.shape[0], -1))
        x = jax.nn.relu(_dense(self.noisy, 512 * w, self.dtype)(
            s.child("dense"), x))
        return _q_head(self, s, x)


@dataclasses.dataclass(frozen=True)
class RamDQN(Module):
    """MLP Q-network for the (W, H) ram observation (0/1 board)."""
    num_actions: int = NUM_ACTIONS
    hidden: Sequence[int] = (512, 256)
    dueling: bool = False
    num_atoms: int = 0   # > 0: C51 logits [B, A, num_atoms] instead of Q [B, A]
    noisy: bool = False  # NoisyNet fully-connected layers (all of them here)
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x):
        x = x.reshape((x.shape[0], -1)).astype(self.dtype)
        for i, h in enumerate(self.hidden):
            x = jax.nn.relu(_dense(self.noisy, h, self.dtype)(
                s.child(f"dense{i}"), x))
        return _q_head(self, s, x)


def build_q_network(obs_type: str, obs_shape, dueling: bool = False,
                    width_mult: int = 1, num_atoms: int = 0,
                    noisy: bool = False) -> Module:
    """Pick the model family for an observation space shape.

    ``num_atoms > 0`` selects the distributional (C51) head: the network
    returns [B, A, num_atoms] logits; the trainer turns them into Q-values
    via the expected value over its support. ``noisy`` swaps the
    fully-connected layers for NoisyDense (exploration by parameter noise).
    """
    if obs_type == "ram":
        return RamDQN(dueling=dueling, num_atoms=num_atoms, noisy=noisy)
    return NatureDQN(dueling=dueling, width_mult=width_mult,
                     num_atoms=num_atoms, noisy=noisy)
