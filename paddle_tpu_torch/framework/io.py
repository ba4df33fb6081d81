"""paddle.save / paddle.load. Counterpart: paddle_tpu/framework/io.py.

Nested dicts, lists and tuples of tensors (a Layer's or an optimizer's
state dict, or anything else) are pickled with every tensor as a
`_TensorPayload` of a numpy array, the reference's format. A bfloat16
tensor is kept as its uint16 bits with `bf16` set, so it round-trips
exactly on a machine without `ml_dtypes`.

`load` also reads a file written by `paddle_tpu.save`: its payload class
maps onto this module's copy, and nothing of `paddle_tpu` is imported.
A reference file that holds bfloat16 arrays needs `ml_dtypes` to
unpickle; without it `load` raises a ValueError that says so.
"""
import os
import pickle

import numpy as np
import torch

from ..device import resolve_device
from .core import Parameter, Tensor, unwrap

__all__ = ["save", "load"]

_PROTO = 4
_REFERENCE_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")


class _TensorPayload:
    def __init__(self, array, is_param, name, stop_gradient, bf16=False):
        self.array = np.asarray(array)
        self.is_param = is_param
        self.name = name
        self.stop_gradient = stop_gradient
        self.bf16 = bf16


def _payload(t):
    v = unwrap(t).detach().cpu()
    bf16 = v.dtype == torch.bfloat16
    arr = v.view(torch.int16).numpy() if bf16 else v.resolve_conj().numpy()
    sg = t.stop_gradient if isinstance(t, Tensor) else not v.requires_grad
    name = t.name if isinstance(t, Parameter) else None
    return _TensorPayload(arr.copy(), isinstance(t, Parameter), name, sg,
                          bf16)


def _to_serializable(obj):
    if isinstance(obj, (Tensor, torch.Tensor)):
        return _payload(obj)
    if isinstance(obj, dict):
        return type(obj)((k, _to_serializable(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    return obj


def _from_payload(p, return_numpy):
    arr = p.array
    if getattr(p, "bf16", False):
        t = torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
        if return_numpy:
            return t.float().numpy()
        t = t.to(resolve_device())
    elif return_numpy:
        return arr
    else:
        t = arr
    if p.is_param:
        return Parameter(t, name=p.name, trainable=not p.stop_gradient)
    return Tensor(t, stop_gradient=p.stop_gradient)


def _from_serializable(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        return _from_payload(obj, return_numpy)
    if isinstance(obj, dict):
        return type(obj)((k, _from_serializable(v, return_numpy))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    """Reads the port's files and the reference's: the reference's
    payload class is this module's; any other class of `paddle_tpu` is
    refused rather than imported."""

    def find_class(self, module, name):
        if (module, name) == _REFERENCE_PAYLOAD or (
                module == __name__ and name == "_TensorPayload"):
            return _TensorPayload
        if module == "paddle_tpu" or module.startswith("paddle_tpu."):
            raise pickle.UnpicklingError(
                f"{module}.{name} is not a class paddle.load reads")
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError as e:
            if e.name == "ml_dtypes":
                raise ValueError(
                    "this file holds bfloat16 numpy arrays (a paddle_tpu "
                    "checkpoint); reading it needs the ml_dtypes package, "
                    "which is not installed") from None
            raise


def save(obj, path, protocol=_PROTO, **configs):
    """Pickle `obj` (tensors as numpy payloads) to the file `path`, or
    into the file-like object `path`."""
    data = _to_serializable(obj)
    if hasattr(path, "write"):
        pickle.dump(data, path, protocol=protocol)
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=protocol)


def load(path, **configs):
    """Read what `save` (or `paddle_tpu.save`) wrote, from a path or a
    file-like object: tensors come back as Tensors and Parameters on the
    current device, or as numpy arrays with `return_numpy=True`."""
    if hasattr(path, "read"):
        obj = _Unpickler(path).load()
    else:
        with open(path, "rb") as f:
            obj = _Unpickler(f).load()
    return _from_serializable(obj, configs.get("return_numpy", False))
