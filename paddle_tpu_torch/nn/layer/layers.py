"""The Layer base class. Counterpart: paddle_tpu/nn/layer/layers.py.

`Layer` is a `torch.nn.Module` with the reference's surface:
`create_parameter` / `create_tensor`, `add_parameter` / `add_sublayer`,
`register_buffer(persistable=)`, `parameters()` as a list,
`named_parameters` / `named_sublayers` in the reference's order and
names, `state_dict` / `set_state_dict`, `to` / `astype` / `float` /
`half` / `bfloat16`, `register_forward_pre_hook` /
`register_forward_post_hook`, `full_name` and `clear_gradients`.
torch's registries are the reference's: `_parameters`, `_buffers` and
`_sub_layers` (torch's `_modules`) are the same dicts, so torch's
machinery (`.to`, `torch.utils.checkpoint`, CUDA graphs, the optimizers)
sees what the reference's methods see.

The boundary between Paddle `Tensor`s and torch tensors is the call:

- a Layer defined by a user (`_paddle_io = True`, the default) gets
  Paddle Tensors in `forward`; a call with torch tensors wraps them and
  unwraps what `forward` returns;
- the port's own layers and models (`_paddle_io = False`) keep their
  torch-idiom `forward` on plain torch tensors, so their host cost and
  their CUDA graphs do not change; a call with Tensors unwraps them
  once and wraps the outputs;
- containers (`_paddle_io = None`) pass what they get through.

A Layer's buffers live in torch's registry as torch tensors; inside a
user Layer, reading one gives a Tensor bound to the registry entry, so
its in-place ops and `set_value` update the buffer.
"""
import collections

import numpy as np
import torch

from ...device import resolve_device
from ...framework.core import (Parameter, Tensor, has_wrapper, unwrap,
                               unwrap_tree, wrap_tree)
from ...framework.dtype import convert_dtype, get_default_dtype
from ...framework.param_attr import ParamAttr
from ...framework.random import rng_scope
from .. import initializer as I

__all__ = ["Layer"]


class _BufferTensor(Tensor):
    """A Tensor whose value is a Layer's registered buffer: reading it
    reads the registry, rebinding it writes the registry."""

    def __init__(self, layer, name):
        self.__dict__.update(_layer=layer, _bname=name, _sg=True,
                             _name=None)

    @property
    def value(self):
        return self._layer._buffers[self._bname]

    @value.setter
    def value(self, v):
        self._layer._buffers[self._bname] = v


class Layer(torch.nn.Module):
    _paddle_io = True

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = convert_dtype(dtype) if dtype else get_default_dtype()
        self._sub_layers = self._modules
        self._non_persistable_buffer_names = self._non_persistent_buffers_set
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # -- the call boundary ------------------------------------------------
    def __call__(self, *inputs, **kwargs):
        io = self._paddle_io
        if io is None:
            return super().__call__(*inputs, **kwargs)
        wrapped = has_wrapper(inputs, kwargs)
        if io:
            if wrapped or not _has_torch(inputs, kwargs):
                return super().__call__(*inputs, **kwargs)
            return unwrap_tree(super().__call__(*wrap_tree(inputs),
                                                **wrap_tree(kwargs)))
        if not wrapped:
            return super().__call__(*inputs, **kwargs)
        return wrap_tree(super().__call__(*unwrap_tree(inputs),
                                          **unwrap_tree(kwargs)))

    def __getattr__(self, name):
        if type(self)._paddle_io:
            buffers = self.__dict__.get("_buffers")
            if buffers is not None and buffers.get(name) is not None:
                return _BufferTensor(self, name)
        return super().__getattr__(name)

    def __setattr__(self, name, value):
        # the reference lets any value replace a parameter or sublayer of
        # that name; torch would refuse
        params, subs = self.__dict__.get("_parameters"), \
            self.__dict__.get("_modules")
        if params is not None and name in params and not isinstance(
                value, (torch.nn.Parameter, type(None))):
            del params[name]
        if subs is not None and name in subs and not isinstance(
                value, (torch.nn.Module, type(None))):
            del subs[name]
        buffers = self.__dict__.get("_buffers")
        if buffers is not None and name in buffers and not isinstance(
                value, (torch.Tensor, type(None))):
            if isinstance(value, Tensor):
                buffers[name] = unwrap(value)
            else:
                buffers[name].copy_(torch.as_tensor(np.asarray(value)))
            return
        super().__setattr__(name, value)

    # -- registration -----------------------------------------------------
    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        if not isinstance(sublayer, torch.nn.Module):
            raise TypeError("add_sublayer expects a Layer")
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        if tensor is not None and not isinstance(
                tensor, (Tensor, torch.Tensor)):
            raise TypeError("register_buffer expects a Tensor")
        if persistent is not None:
            persistable = persistent
        super().register_buffer(name, unwrap(tensor),
                                persistent=bool(persistable))
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None):
        """A Parameter of `shape` on `device` (None: the current one),
        initialized by the attr's initializer, else
        `default_initializer`, else Constant(0) for a bias and
        XavierNormal for a weight; random draws take `generator` when
        given. None when `attr` is False."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dt = convert_dtype(dtype) or self._dtype
        p = Parameter(torch.zeros(tuple(int(s) for s in shape), dtype=dt,
                                  device=resolve_device(device)),
                      name=attr.name, trainable=attr.trainable)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        init = attr.initializer or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        if generator is None:
            init(p)
        else:
            with rng_scope(generator):
                init(p)
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None):
        return Tensor(np.zeros((), dtype=np.float32),
                      dtype=convert_dtype(dtype) or self._dtype, name=name)

    # -- traversal --------------------------------------------------------
    def parameters(self, include_sublayers=True, *, recurse=None):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_parameters(self, prefix="", include_sublayers=True, *,
                         recurse=None, remove_duplicate=True):
        """(name, Parameter) of this layer, then of each sublayer in
        depth-first order, each once."""
        if recurse is not None:
            include_sublayers = recurse
        return super().named_parameters(prefix=prefix,
                                        recurse=include_sublayers,
                                        remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, *,
                      recurse=None, remove_duplicate=True):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_buffers(prefix=prefix,
                                     recurse=include_sublayers,
                                     remove_duplicate=remove_duplicate)

    def children(self):
        return [layer for _, layer in self.named_children()]

    def sublayers(self, include_self=False):
        return [layer for _, layer in self.named_sublayers(
            include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None:
                continue
            sub = f"{prefix}.{name}" if prefix else name
            if isinstance(layer, Layer):
                yield from layer.named_sublayers(prefix=sub,
                                                 include_self=True)
            else:
                yield from layer.named_modules(prefix=sub)

    # -- state dict -------------------------------------------------------
    def _state_targets(self, include_sublayers=True):
        """{name: torch tensor} of the state: every parameter in
        `named_parameters` order, then the persistable buffers, as the
        reference orders them; with each buffer's (layer, key)."""
        out, where = collections.OrderedDict(), {}
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            out[name] = p
        layers = self.named_sublayers(include_self=True) \
            if include_sublayers else [("", self)]
        for name, layer in layers:
            skip = getattr(layer, "_non_persistent_buffers_set", ())
            for bname, b in layer._buffers.items():
                if b is not None and bname not in skip:
                    key = f"{name}.{bname}" if name else bname
                    out[key], where[key] = b, (layer, bname)
        return out, where

    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True, *, prefix=None, keep_vars=None):
        """{name: Parameter or buffer Tensor}, parameters first, then the
        persistable buffers (Tensors bound to the registry). torch's
        recursive call (with `prefix` or `keep_vars`) takes torch's
        state_dict."""
        if prefix is not None or keep_vars is not None:
            return super().state_dict(destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        dest = destination if destination is not None \
            else collections.OrderedDict()
        targets, where = self._state_targets(include_sublayers)
        for k, v in targets.items():
            dest[k] = _BufferTensor(*where[k]) if k in where else v
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy `state_dict`'s values (Tensors, torch tensors or numpy
        arrays) into this layer's parameters and buffers by name, in
        place; returns (missing, unexpected) names."""
        own, _ = self._state_targets()
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    continue
                dst = own[k]
                src = unwrap(v) if isinstance(v, (Tensor, torch.Tensor)) \
                    else torch.as_tensor(np.asarray(v))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{k}: shape {list(src.shape)} does "
                                     f"not match {list(dst.shape)}")
                dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype and device -------------------------------------------------
    def _cast(self, dtype):
        dt = convert_dtype(dtype)
        super().to(dtype=dt)
        for layer in self.modules():
            if isinstance(layer, Layer):
                layer._dtype = dt
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """`to(device, dtype)` with Paddle's names ("gpu", "cpu", Paddle
        or torch dtypes); floating parameters and buffers take `dtype`."""
        if isinstance(device, (torch.dtype, str)) and dtype is None:
            try:
                dtype, device = convert_dtype(device), None
            except ValueError:
                pass
        if device is not None:
            super().to(device=resolve_device(device))
        if dtype is not None:
            self._cast(dtype)
        return self

    def astype(self, dtype):
        return self._cast(dtype)

    def float(self):
        return self._cast(torch.float32)

    def half(self):
        return self._cast(torch.float16)

    def bfloat16(self):
        return self._cast(torch.bfloat16)

    # -- hooks ------------------------------------------------------------
    def _paddle_hook(self, hook):
        """A port layer runs its hooks on torch tensors; a hook given
        through the Paddle API sees Tensors, as on the reference."""
        if self._paddle_io is not False:
            return hook

        def run(layer, *args):
            return unwrap_tree(hook(layer, *wrap_tree(args)))
        return run

    def register_forward_pre_hook(self, hook, *, prepend=False,
                                  with_kwargs=False):
        """`hook(layer, inputs)`; a non-None return replaces the inputs."""
        return super().register_forward_pre_hook(
            self._paddle_hook(hook), prepend=prepend,
            with_kwargs=with_kwargs)

    def register_forward_post_hook(self, hook):
        """`hook(layer, inputs, outputs)`; a non-None return replaces the
        outputs."""
        return self.register_forward_hook(self._paddle_hook(hook))

    def full_name(self):
        return self._name_scope

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()


def _has_torch(args, kwargs):
    for a in args:
        if isinstance(a, torch.Tensor) and not isinstance(a, Tensor):
            return True
    if kwargs:
        for a in kwargs.values():
            if isinstance(a, torch.Tensor) and not isinstance(a, Tensor):
                return True
    return False
