"""Activation functionals.

Counterpart: paddle_tpu/nn/functional/activation.py, whose functionals
are jax.nn's:

- `gelu`: GPT's MLP uses the tanh form (`approximate=True`),
  0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)));
- `silu`: x * sigmoid(x), the SSM mixer's gate;
- `softplus`: `jax.nn.softplus`, which the SSM mixer's dt takes:
  log(1 + exp(x)) as logaddexp(x, 0) for every x. Neither
  torch.nn.functional.softplus nor the reference's Paddle-API
  `softplus(x, beta, threshold)` is this function: both return x itself
  above a threshold of 20.
"""
import torch

__all__ = ["gelu", "silu", "softplus"]


def gelu(x, approximate=False):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def silu(x):
    return torch.nn.functional.silu(x)


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))
