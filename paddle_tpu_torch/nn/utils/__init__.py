"""nn.utils of the port. Counterpart: paddle_tpu/nn/utils/__init__.py.

- `weight_norm(layer, name, dim)` reparameterizes `layer.<name>` as
  g * v / ||v|| (the norm over every axis but `dim`; over all of them
  for dim=None): the parameter becomes `<name>_g` and `<name>_v`, and a
  forward pre-hook recomputes `layer.<name>` (a plain attribute) from
  them before each call, so the layer's forward reads it as before;
  `remove_weight_norm` folds it back into one parameter.
- `spectral_norm(layer, name, n_power_iterations, eps, dim)` keeps the
  parameter as `<name>_orig` and a `SpectralNorm` sublayer
  `_spectral_norm`; `layer.<name>` is the normalized weight, recomputed
  before each call.
- `parameters_to_vector` / `vector_to_parameters` flatten parameters
  into one new Tensor (no grad) and write one back, in order.
"""
import torch

from ...framework.core import Parameter, Tensor, unwrap

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def parameters_to_vector(parameters, name=None):
    return Tensor(torch.cat([unwrap(p).detach().reshape(-1)
                             for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    v = unwrap(vec)
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.set_value(v[offset:offset + n].reshape(p.shape))
            offset += n


def _norm_except(v, dim, keepdim):
    if dim is None:
        return v.square().sum().sqrt()
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return v.square().sum(dim=axes, keepdim=keepdim).sqrt()


class _WeightNorm:
    """The forward pre-hook of `weight_norm`: layer.<name> = g * v /
    max(||v||, 1e-12)."""

    def __init__(self, name, dim):
        self.name = name
        self.dim = dim

    def compute(self, layer):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        n = _norm_except(v, self.dim, keepdim=True)
        if self.dim is not None:
            shape = [1] * v.dim()
            shape[self.dim] = -1
            g = g.reshape(shape)
        return g * v / n.clamp_min(1e-12)

    def __call__(self, layer, inputs):
        setattr(layer, self.name, self.compute(layer))


def weight_norm(layer, name="weight", dim=0):
    w = layer._parameters[name]
    hook = _WeightNorm(name, dim)
    with torch.no_grad():
        g = Parameter(_norm_except(w.detach(), dim, keepdim=False),
                      name=w.name + "_g")
        v = Parameter(w.detach().clone(), name=w.name + "_v")
    del layer._parameters[name]
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)
    hook(layer, None)
    layer._weight_norm = (hook, layer.register_forward_pre_hook(hook))
    return layer


def remove_weight_norm(layer, name="weight"):
    found = layer.__dict__.get("_weight_norm")
    if found is None:
        return layer
    hook, handle = found
    with torch.no_grad():
        w = hook.compute(layer).detach().clone()
    handle.remove()
    del layer._weight_norm
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    from ..layer.norm import SpectralNorm
    w = layer._parameters[name]
    sn = SpectralNorm(list(w.shape), dim=0 if dim is None else dim,
                      power_iters=n_power_iterations, eps=eps,
                      device=w.device)
    layer.add_sublayer("_spectral_norm", sn)
    orig = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.add_parameter(name + "_orig", orig)

    def hook(module, inputs):
        setattr(module, name, sn(getattr(module, name + "_orig")))
    hook(layer, None)
    layer.register_forward_pre_hook(hook)
    return layer
