"""Random ops. Counterpart: paddle_tpu/tensor/random.py.

Draws are made on the current device (`set_device`) from
`framework.random.generator` (the innermost `rng_scope`'s, or torch's
default generator of the device, which `paddle.seed` seeds). Streams
differ from the reference's; shapes, dtypes, ranges and laws do not.
"""
import torch

from ..device import resolve_device
from ..framework.core import Tensor, _wrap
from ..framework.dtype import convert_dtype, get_default_dtype
from ..framework.random import generator
from .creation import _shape


def _dt(dtype, default=None):
    d = convert_dtype(dtype)
    return d if d is not None else (default or get_default_dtype())


def _new(t):
    return _wrap(t, True)


def _dev():
    d = resolve_device()
    return d, generator(d)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    dev, gen = _dev()
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean.value if isinstance(mean, Tensor) else mean
        s = std.value if isinstance(std, Tensor) else std
        shp = torch.broadcast_shapes(torch.as_tensor(m).shape,
                                     torch.as_tensor(s).shape)
        z = torch.randn(shp, dtype=get_default_dtype(), device=dev,
                        generator=gen)
        return _new(m + s * z)
    shp = _shape(shape) if shape is not None else ()
    return _new(mean + std * torch.randn(shp, dtype=get_default_dtype(),
                                         device=dev, generator=gen))


def standard_normal(shape, dtype=None, name=None):
    dev, gen = _dev()
    return _new(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                            generator=gen))


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def rand(shape, dtype=None, name=None):
    dev, gen = _dev()
    return _new(torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                           generator=gen))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev, gen = _dev()
    if seed:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return _new(out.uniform_(min, max, generator=gen))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    return x._rebind(uniform(x.shape, x.value.dtype, min, max, seed))


def randint(low=0, high=None, shape=[1], dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev, gen = _dev()
    return _new(torch.randint(low, high, _shape(shape), device=dev,
                              generator=gen,
                              dtype=_dt(dtype, torch.int64)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, x.shape, dtype or x.value.dtype)


def randperm(n, dtype="int64", name=None):
    dev, gen = _dev()
    return _new(torch.randperm(n, device=dev, generator=gen).to(
        _dt(dtype, torch.int64)))


def poisson(x, name=None):
    v = x.value
    return _new(torch.poisson(v.detach(), generator=generator(v.device)))


def bernoulli(x, name=None):
    v = x.value
    return _new(torch.bernoulli(v.detach(), generator=generator(v.device)))


def bernoulli_(x, p=0.5, name=None):
    v = x.value
    out = torch.empty_like(v).bernoulli_(p, generator=generator(v.device))
    return x._rebind(_new(out))


def multinomial(x, num_samples=1, replacement=False, name=None):
    v = x.value.detach()
    return _new(torch.multinomial(v, num_samples, replacement=replacement,
                                  generator=generator(v.device)))


def exponential_(x, lam=1.0, name=None):
    v = x.value
    out = torch.empty_like(v).exponential_(lam, generator=generator(
        v.device))
    return x._rebind(_new(out))
