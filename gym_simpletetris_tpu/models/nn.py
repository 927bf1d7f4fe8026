"""Plain-JAX layers with the ``init`` / ``apply`` calling shape of the networks.

A network is a frozen dataclass (its hyperparameters) whose
``__call__(scope, x)`` runs the forward pass and reads each weight through
``scope.param(name, init_fn, shape)``:

- ``net.init(key, x)`` runs the forward once on ``x`` and creates every
  weight on first request: ``{"params": {layer: {"kernel": ..., ...}}}``,
  nested dicts keyed by layer name (the layout the checked-in checkpoints
  hold);
- ``net.apply(variables, x, rngs={"noise": key})`` reads them. The optional
  ``"noise"`` key feeds the noisy layers; without it they are their
  deterministic mu-only maps.

Weight and noise keys are derived from the layer's path, so they do not
depend on the order in which layers are created. Weights are float32; each
layer computes in its ``dtype`` (bfloat16 by default).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()
_zeros = jax.nn.initializers.zeros


def _fold(key, path) -> jax.Array:
    """Independent key for a path of layer names."""
    return jax.random.fold_in(key, zlib.crc32("/".join(path).encode())
                              & 0x7FFFFFFF)


class Scope:
    """The weights of one layer (and its children) during init or apply."""

    def __init__(self, params: dict, key=None, noise=None, path=()):
        self.params = params    # filled in place while initialising
        self.key = key          # weight-init key; None when applying
        self.noise = noise      # "noise" rng of apply(), or None
        self.path = path

    def child(self, name: str) -> "Scope":
        params = (self.params.setdefault(name, {}) if self.key is not None
                  else self.params[name])
        return Scope(params, self.key, self.noise, self.path + (name,))

    def param(self, name: str, init_fn, shape):
        if self.key is not None and name not in self.params:
            self.params[name] = init_fn(_fold(self.key, self.path + (name,)),
                                        shape, jnp.float32)
        return self.params[name]

    def noise_key(self) -> Optional[jax.Array]:
        """This layer's own noise key, or None without a "noise" rng."""
        return None if self.noise is None else _fold(self.noise, self.path)


class Module:
    """Base of the networks: ``init``/``apply`` over a ``__call__(scope, x)``."""

    def init(self, key, x) -> dict:
        params: dict = {}
        self(Scope(params, key=key), x)
        return {"params": params}

    def apply(self, variables, x, rngs: Optional[dict] = None):
        noise = (rngs or {}).get("noise")
        return self(Scope(variables["params"], noise=noise), x)


@dataclasses.dataclass(frozen=True)
class Dense(Module):
    """``x @ kernel + bias``, LeCun-normal kernel, zero bias."""
    features: int
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x):
        kernel = s.param("kernel", _lecun_normal, (x.shape[-1], self.features))
        bias = s.param("bias", _zeros, (self.features,))
        return (jnp.dot(x.astype(self.dtype), kernel.astype(self.dtype))
                + bias.astype(self.dtype))


@dataclasses.dataclass(frozen=True)
class Conv(Module):
    """VALID 2-D convolution over NHWC input, HWIO kernel."""
    features: int
    kernel_size: int
    stride: int
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x):
        k = self.kernel_size
        kernel = s.param("kernel", _lecun_normal,
                         (k, k, x.shape[-1], self.features))
        bias = s.param("bias", _zeros, (self.features,))
        y = jax.lax.conv_general_dilated(
            x.astype(self.dtype), kernel.astype(self.dtype),
            (self.stride, self.stride), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y + bias.astype(self.dtype)


@dataclasses.dataclass(frozen=True)
class NoisyDense(Module):
    """Factorized-Gaussian noisy linear layer (Fortunato et al. 2018 §3.1).

    ``y = (W_mu + W_sigma * (f(eps_in) f(eps_out)^T)) x + b_mu + b_sigma *
    f(eps_out)`` with ``f(e) = sign(e) sqrt(|e|)``; mu ~ U(+-1/sqrt(in)),
    sigma = sigma0/sqrt(in). Noise is drawn from the ``"noise"`` rng of each
    apply; applying **without** it gives the deterministic mu-only layer (the
    evaluation-time policy net).
    """
    features: int
    sigma0: float = 0.5
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x):
        in_f = x.shape[-1]
        bound = 1.0 / float(in_f) ** 0.5

        def mu_init(key, shape, dtype):
            return jax.random.uniform(key, shape, dtype, -bound, bound)

        sig_init = jax.nn.initializers.constant(self.sigma0 * bound)
        k_mu = s.param("kernel_mu", mu_init, (in_f, self.features))
        b_mu = s.param("bias_mu", mu_init, (self.features,))
        k_sig = s.param("kernel_sigma", sig_init, (in_f, self.features))
        b_sig = s.param("bias_sigma", sig_init, (self.features,))
        nk = s.noise_key()
        if nk is not None:
            ki, ko = jax.random.split(nk)
            f = lambda e: jnp.sign(e) * jnp.sqrt(jnp.abs(e))  # noqa: E731
            e_in = f(jax.random.normal(ki, (in_f, 1)))
            e_out = f(jax.random.normal(ko, (1, self.features)))
            w = k_mu + k_sig * (e_in * e_out)
            b = b_mu + b_sig * e_out[0]
        else:
            w, b = k_mu, b_mu
        return (jnp.dot(x.astype(self.dtype), w.astype(self.dtype))
                + b.astype(self.dtype))
