"""Activation functionals.

Counterpart: paddle_tpu/nn/functional/activation.py, whose functionals
are jax.nn's:

- `gelu`: GPT's MLP uses the tanh form (`approximate=True`),
  0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)));
- `silu`: x * sigmoid(x), the SSM mixer's gate;
- `softplus`: the Paddle-API function, x where beta * x > threshold,
  else log1p(exp(beta * x)) / beta. The SSM mixer's dt takes
  `jax.nn.softplus` instead (logaddexp(x, 0) for every x), a private
  helper of models/ssm.py.

Each takes Paddle's `name`, which it ignores.
"""
import torch

__all__ = ["gelu", "silu", "softplus"]


def gelu(x, approximate=False, name=None):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return torch.nn.functional.silu(x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    bx = beta * x
    return torch.where(bx > threshold, x, torch.log1p(torch.exp(bx)) / beta)
