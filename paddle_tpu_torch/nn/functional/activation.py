"""Activation functionals.

Counterpart: paddle_tpu/nn/functional/activation.py `gelu`, which is
`jax.nn.gelu`. GPT's MLP uses the tanh form (`approximate=True`):
0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))).
"""
import torch

__all__ = ["gelu"]


def gelu(x, approximate=False):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
