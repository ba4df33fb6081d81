"""Input functionals: one_hot and embedding.

Counterpart: paddle_tpu/nn/functional/input.py. `one_hot` gives float32;
`embedding` gathers rows of `weight` and zeroes the rows of ids equal to
`padding_idx`, which therefore take no grad. `sparse` is accepted; grads
are dense.
"""
import torch

__all__ = ["one_hot", "embedding"]


def one_hot(x, num_classes, name=None):
    return torch.nn.functional.one_hot(x.long(), num_classes).float()


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0)
    return out
