"""The global RNG state of the port.

Counterpart: paddle_tpu/framework/random.py (`seed`, `get_rng_state`,
`set_rng_state`, `rng_scope`). The reference keeps one JAX key that it
splits per draw. Here each device has its torch.Generator, torch's
default one (so a CUDA-graph capture takes care of it as torch's
own draws): initializers, `Dropout` and `tensor/random.py` draw from it
when the caller passes no `generator=`. `seed(s)` seeds all of them.
`rng_scope(key)` binds generators seeded with `key` (or the
torch.Generator `key` itself) for the draws made inside, and leaves the
global ones untouched. Streams never match the reference's: parity
holds shapes, dtypes, ranges and moments.
"""
import threading

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "rng_scope",
           "generator"]


class _Scope(threading.local):
    def __init__(self):
        self.key = None       # the innermost rng_scope's key, or None
        self.gens = None      # its generators by device


_scope = _Scope()


def seed(s):
    """Seed every device's generator with `s`; returns the CPU one."""
    return torch.manual_seed(int(s))


def get_rng_state():
    """The generators' states: [CPU state, one state a CUDA device]."""
    states = [torch.get_rng_state()]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        states += torch.cuda.get_rng_state_all()
    return states


def set_rng_state(key):
    """Restore the states `key` that `get_rng_state` returned (the
    reference's name: its state is a JAX key)."""
    torch.set_rng_state(key[0])
    if len(key) > 1:
        torch.cuda.set_rng_state_all(key[1:])


class rng_scope:
    """Inside, every draw that takes no explicit generator comes from a
    generator of its device seeded with `key` (an int), or from `key`
    itself when it is a torch.Generator. Scopes nest."""

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        self.prev = (_scope.key, _scope.gens)
        _scope.key, _scope.gens = self.key, {}
        return self

    def __exit__(self, *exc):
        _scope.key, _scope.gens = self.prev
        return False


def generator(device):
    """The generator a draw on `device` takes: the innermost
    rng_scope's, or None (torch's default generator of the device,
    which `seed` seeds)."""
    key = _scope.key
    if key is None:
        return None
    if isinstance(key, torch.Generator):
        return key
    dev = torch.device(device)
    name = str(dev)
    g = _scope.gens.get(name)
    if g is None:
        g = _scope.gens[name] = torch.Generator(device=dev).manual_seed(
            int(key))
    return g
