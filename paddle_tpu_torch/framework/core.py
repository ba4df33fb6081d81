"""Core runtime of the port: Paddle's `Tensor`, `Parameter`, `apply_op`
and the grad switches, on torch autograd.

Counterpart: paddle_tpu/framework/core.py, whose `Tensor` wraps a
jax.Array and records a tape. Here `Tensor` wraps a torch.Tensor
(`.value`) and torch autograd is the tape:

- `stop_gradient` is `not requires_grad` (True for a new Tensor, False
  for a Parameter); results of ops need grad iff an input does, and an
  integer result of an op that records is marked as recording, as the
  reference marks it. `backward`, `.grad` (a Tensor over the torch
  grad), `gradient`, `clear_grad`, `retain_grads`, `register_hook` and
  `detach` map onto torch's.
- In-place ops rebind the wrapper to a new value, as the reference
  rebinds its slot: a leaf that needs grad is never written in place,
  and a graph that holds the old value keeps it.
- `Tensor` gives Paddle meanings to names torch uses differently
  (`shape` is a list, `size` an int, `dtype` a Paddle dtype, `place` a
  string, `transpose(perm)`, `max` returning values only, ...). torch
  never receives a `Tensor`: `apply_op`, the port's functionals
  (`paddle_io`) and its layers (`nn.Layer.__call__`) unwrap it, and a
  torch function handed one unwraps it through `__torch_function__`.
- `Parameter` is a `torch.nn.Parameter` that also counts as a Paddle
  `Tensor`: torch modules, the optimizers, `TrainStep`, CUDA graphs and
  the kernel wrappers take it as they take any parameter. It carries the
  reference's attributes (`name`, `trainable`, `optimize_attr`,
  `regularizer`, `need_clip`, `stop_gradient`, `set_value`, `numpy()`,
  `gradient`, `clear_grad()`). Where a name means something else in
  torch (`shape`, `size`, `dtype`, `transpose`, `max`, `split`,
  `flatten`, `t`, `clone`, ...), a Parameter keeps torch's meaning
  (ROADMAP.md queue C); the `paddle.*` functions take it with Paddle's.
- `no_grad`, `enable_grad`, `set_grad_enabled` and `is_grad_enabled`
  are torch's: context managers, decorators and functions as in Paddle.
- `apply_op(..., op_name=...)` is the `amp.auto_cast` dispatch: when
  the policy names a dtype for the op (`amp.amp_op_dtype`), the op's
  float inputs are cast to it when the op runs. torch autograd records
  the casts, so a `backward()` outside the context replays the forward's
  dtypes.
"""
import copy
import functools

import numpy as np
import torch

from ..device import place_name, resolve_device
from .dtype import convert_dtype, get_default_dtype, to_paddle_dtype
from .. import amp as _amp

__all__ = ["Tensor", "Parameter", "apply_op", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "to_tensor", "unwrap",
           "unwrap_tree", "wrap_tree", "paddle_io"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled

_DIFF = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
         torch.complex64, torch.complex128)


def _as_torch(data, dtype=None, place=None):
    """A new torch tensor (a copy, detached) of `data` on `place` (None:
    the current device) in `dtype` (None: Paddle's default for the
    data)."""
    dt = convert_dtype(dtype)
    dev = resolve_device(place)
    if isinstance(data, Tensor):
        data = data.value
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=dev, dtype=dt or data.dtype)
        return out.clone() if out is data or \
            out.data_ptr() == data.data_ptr() else out
    a = np.asarray(data)
    if dt is None and a.dtype == np.float64:
        dt = get_default_dtype()
    if a.dtype.name == "bfloat16":  # ml_dtypes: through float32, exactly
        t = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device=dev, dtype=dt or t.dtype)


def _wrap(v, sg=None):
    """A Tensor over the torch tensor `v` (no copy); stop_gradient is
    `sg`, or `not v.requires_grad`."""
    t = object.__new__(Tensor)
    t.value = v
    t._sg = (not v.requires_grad) if sg is None else sg
    t._name = None
    return t


def _is_wrapper(x):
    return isinstance(x, Tensor) and not isinstance(x, torch.Tensor)


def unwrap(x):
    """The torch tensor of a Tensor; anything else as it is."""
    return x.value if _is_wrapper(x) else x


def _rebuild(seq, items):
    """A sequence of `seq`'s type holding `items` (a namedtuple, such as
    MultiHeadAttention's caches, by its fields)."""
    if hasattr(seq, "_fields"):
        return type(seq)(*items)
    return type(seq)(items)


def unwrap_tree(obj):
    """`obj` with every Tensor in its tuples, lists and dicts unwrapped."""
    if _is_wrapper(obj):
        return obj.value
    if isinstance(obj, (tuple, list)):
        return _rebuild(obj, [unwrap_tree(o) for o in obj])
    if isinstance(obj, dict):
        return {k: unwrap_tree(v) for k, v in obj.items()}
    return obj


def wrap_tree(obj):
    """`obj` with every torch tensor in its tuples, lists and dicts
    wrapped as a Tensor (a Parameter stays itself)."""
    if isinstance(obj, torch.Tensor):
        return obj if isinstance(obj, Tensor) else _wrap(obj)
    if isinstance(obj, (tuple, list)):
        return _rebuild(obj, [wrap_tree(o) for o in obj])
    if isinstance(obj, dict):
        return {k: wrap_tree(v) for k, v in obj.items()}
    return obj


def has_wrapper(args, kwargs=None):
    """True when a positional argument or keyword value is a Tensor
    wrapper (not a Parameter, which is a torch tensor already)."""
    for a in args:
        if _is_wrapper(a):
            return True
    if kwargs:
        for a in kwargs.values():
            if _is_wrapper(a):
                return True
    return False


def paddle_io(fn):
    """The boundary of a torch-idiom function: called with Tensor
    arguments it unwraps them, runs `fn` on torch tensors and wraps what
    it returns; called with torch tensors it runs `fn` as it is."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not has_wrapper(args, kwargs):
            return fn(*args, **kwargs)
        return wrap_tree(fn(*unwrap_tree(args), **unwrap_tree(kwargs)))
    return call


class TensorHookRemoveHelper:
    """Handle of `Tensor.register_hook`; `remove()` is True the first
    time (the reference's TensorHookRemoveHelper)."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        if self._handle is None:
            return False
        self._handle.remove()
        self._handle = None
        return True


class Tensor:
    """Eager tensor over a torch.Tensor. User-made tensors default to
    stop_gradient=True, Parameters to False; results of ops need grad
    iff any input does."""

    __array_priority__ = 100
    _name_counter = [0]

    def __init__(self, data, dtype=None, stop_gradient=True, name=None, *,
                 place=None):
        self.value = _as_torch(data, dtype, place)
        self._sg = True
        self._name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        # a torch function handed a Tensor (e.g. `param + t`) computes on
        # its torch tensor and hands back a Tensor
        out = func(*unwrap_tree(args), **unwrap_tree(kwargs or {}))
        return wrap_tree(out)

    # -- naming -----------------------------------------------------------
    @property
    def name(self):
        if self._name is None:
            Tensor._name_counter[0] += 1
            self._name = f"generated_tensor_{Tensor._name_counter[0]}"
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    # -- introspection ----------------------------------------------------
    @property
    def shape(self):
        return list(self.value.shape)

    @property
    def ndim(self):
        return self.value.dim()

    @property
    def size(self):
        return self.value.numel()

    @property
    def dtype(self):
        return to_paddle_dtype(self.value.dtype)

    @property
    def place(self):
        return place_name(self.value.device)

    @property
    def is_leaf(self):
        return self.value.is_leaf

    def numpy(self):
        """A numpy copy (bfloat16 as ml_dtypes' bfloat16 where that
        package is installed, else as float32)."""
        t = self.value.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        if t.dtype == torch.bfloat16:
            try:
                import ml_dtypes
            except ImportError:
                return t.float().numpy()
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.resolve_conj().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def item(self, *args):
        if not args:
            return self.value.item()
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def __len__(self):
        if self.value.dim() == 0:
            raise TypeError("len() of a 0-D tensor")
        return self.value.shape[0]

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},"
                f"\n{self.numpy()})")

    def __bool__(self):
        if self.value.numel() != 1:
            raise ValueError("bool() of multi-element Tensor is ambiguous")
        return bool(self.value.item())

    def __int__(self):
        return int(self.item())

    def __float__(self):
        return float(self.item())

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- autograd ---------------------------------------------------------
    @property
    def stop_gradient(self):
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, v):
        v = bool(v)
        self._sg = v
        t = self.value
        if v and t.requires_grad:
            if t.is_leaf:
                t.requires_grad_(False)
            else:
                self.value = t.detach()
        elif not v and not t.requires_grad and t.dtype in _DIFF:
            t.requires_grad_(True)

    def _rebind(self, out):
        """Point this Tensor at `out`'s value (an in-place op); its
        stop_gradient stays as it was, as the reference's `_bind`."""
        v = unwrap(out)
        if self._sg and v.requires_grad:
            v = v.detach()
        self.value = v
        return self

    def _grad_value(self):
        t = self.value
        return t.grad if (t.is_leaf or t.retains_grad) else None

    @property
    def grad(self):
        g = self._grad_value()
        return None if g is None else _wrap(g, True)

    @grad.setter
    def grad(self, g):
        self.value.grad = None if g is None else unwrap(g)

    @property
    def gradient(self):
        """The grad as a numpy array, None without one (a property, as
        on the reference)."""
        g = self.grad
        return None if g is None else g.numpy()

    def backward(self, grad_tensor=None, retain_graph=False):
        if self.stop_gradient:
            raise RuntimeError(
                "backward() on a tensor with stop_gradient=True")
        v = self.value
        seed = torch.ones_like(v) if grad_tensor is None else \
            unwrap(grad_tensor) if isinstance(grad_tensor, Tensor) else \
            torch.as_tensor(grad_tensor, dtype=v.dtype, device=v.device)
        torch.autograd.backward(v, seed, retain_graph=bool(retain_graph))

    def retain_grads(self):
        if not self.value.is_leaf:
            self.value.retain_grad()

    def clear_grad(self):
        self.value.grad = None

    clear_gradient = clear_grad

    def detach(self):
        return _wrap(self.value.detach(), True)

    def clone(self):
        out = apply_op(torch.clone, self)
        out._sg = self.stop_gradient
        return out

    def register_hook(self, hook):
        """`hook(grad)` runs when this tensor's grad is computed; a
        non-None return replaces the grad that flows on."""
        if self.stop_gradient:
            raise RuntimeError(
                "register_hook on a tensor with stop_gradient=True")

        def run(g):
            r = hook(_wrap(g))
            return None if r is None else unwrap(r)
        return TensorHookRemoveHelper(self.value.register_hook(run))

    def get_value(self, scope=None):
        return self

    # -- mutation ---------------------------------------------------------
    def set_value(self, value):
        v = _as_torch(value, self.value.dtype, self.value.device)
        if tuple(v.shape) != tuple(self.value.shape):
            raise ValueError(f"set_value shape mismatch: "
                             f"{list(v.shape)} vs {self.shape}")
        self.value = v
        self.stop_gradient = self._sg

    def copy_(self, other, blocking=True):
        self.set_value(other)
        return self

    def __getitem__(self, idx):
        idx = _unwrap_index(idx, self.value.device)
        return apply_op(lambda x: x[idx], self)

    def __setitem__(self, idx, val):
        idx = _unwrap_index(idx, self.value.device)

        def put(x, v=val):
            y = x.clone()
            y[idx] = v.to(y.dtype) if isinstance(v, torch.Tensor) else v
            return y
        out = apply_op(put, self, val) if isinstance(val, Tensor) else \
            apply_op(put, self)
        self._rebind(out)

    # -- dtype / device ---------------------------------------------------
    def astype(self, dtype):
        dt = convert_dtype(dtype)
        return apply_op(lambda x: x.to(dt), self)

    cast = astype

    def cpu(self):
        return _wrap(self.value.cpu(), self.stop_gradient)

    def cuda(self, device_id=None, blocking=True):
        dev = resolve_device("gpu" if device_id is None
                             else f"gpu:{device_id}")
        return _wrap(self.value.to(dev), self.stop_gradient)

    def pin_memory(self):
        return _wrap(self.value.pin_memory(), self.stop_gradient)

    def to(self, *args, **kwargs):
        """`to(dtype)`, `to(device)`, `to(device, dtype)` or keywords
        `device=` / `dtype=` (Paddle device names or torch's)."""
        device, dtype = kwargs.get("device"), kwargs.get("dtype")
        for a in args:
            try:
                dtype = convert_dtype(a)
                continue
            except (TypeError, ValueError):
                device = a
        out = self
        if dtype is not None:
            out = out.astype(dtype)
        if device is not None:
            dev = resolve_device(device)
            out = _wrap(out.value.to(dev), out.stop_gradient)
        return out


def _unwrap_index(idx, device):
    if isinstance(idx, Tensor):
        return unwrap(idx)
    if isinstance(idx, tuple):
        return tuple(_unwrap_index(i, device) for i in idx)
    if isinstance(idx, list):
        return torch.as_tensor(np.asarray(idx), device=device)
    if isinstance(idx, np.ndarray):
        return torch.as_tensor(idx, device=device)
    return idx


class Parameter(torch.nn.Parameter, Tensor):
    """A trainable tensor: a torch.nn.Parameter that is also a Paddle
    Tensor, made on the current device (`set_device`) unless `data` is a
    torch tensor, which keeps its device."""

    _name_counter = [0]

    def __new__(cls, data, dtype=None, name=None, trainable=True):
        if isinstance(data, torch.Tensor) and not isinstance(data, Tensor):
            t = data.detach()
            dt = convert_dtype(dtype)
            if dt is not None:
                t = t.to(dt)
        else:
            t = _as_torch(data, dtype)
        return torch.Tensor._make_subclass(
            cls, t, bool(trainable) and t.dtype in _DIFF)

    def __init__(self, data, dtype=None, name=None, trainable=True):
        if name is None:
            Parameter._name_counter[0] += 1
            name = f"param_{Parameter._name_counter[0]}"
        self.param_name = name
        self._trainable = bool(trainable)
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False

    @property
    def value(self):
        return self

    @property
    def name(self):
        return self.param_name

    @name.setter
    def name(self, v):
        self.param_name = v

    @property
    def trainable(self):
        return self._trainable

    @trainable.setter
    def trainable(self, v):
        self._trainable = bool(v)
        self.stop_gradient = not v

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v):
        if self.dtype in _DIFF:
            self.requires_grad_(not v)

    numpy = Tensor.numpy
    gradient = Tensor.gradient
    clear_grad = Tensor.clear_grad
    clear_gradient = Tensor.clear_grad
    astype = Tensor.astype
    cast = Tensor.astype

    def set_value(self, value):
        """Write `value` into this parameter's storage, in place."""
        v = _as_torch(value, self.dtype, self.device)
        if tuple(v.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: "
                             f"{list(v.shape)} vs {list(self.shape)}")
        with torch.no_grad():
            torch.Tensor.copy_(self, v)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        p = Parameter(self.data.clone(memory_format=torch.preserve_format),
                      trainable=self.requires_grad)
        p.__dict__.update(copy.deepcopy(self.__dict__, memo))
        p.requires_grad_(self.requires_grad)
        memo[id(self)] = p
        return p


def apply_op(fn, *tensors, n_outputs=None, op_name=None):
    """Run `fn` over the torch tensors of Tensor inputs (other arguments
    pass as they are) and wrap its output(s). torch autograd records the
    op; when any output needs grad, every output is marked
    stop_gradient=False, as the reference marks them. With `op_name`,
    float inputs are first cast to the dtype the amp policy gives the op
    (none while auto_cast is off)."""
    args = [t.value if isinstance(t, Tensor) else t for t in tensors]
    if op_name is not None and _amp._state.enabled:
        args = _amp.cast_inputs(op_name, *args)
    out = fn(*args)
    if isinstance(out, (tuple, list)):
        rec = any(isinstance(o, torch.Tensor) and o.requires_grad
                  for o in out)
        return tuple(_wrap(o, not rec) for o in out)
    return _wrap(out, not out.requires_grad)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new Tensor of `data` on `place` (None: the
    current device, CUDA unless `set_device("cpu")`); float64 data and
    Python floats take the default float dtype, Python ints int64."""
    if isinstance(data, Tensor):
        out = data.astype(dtype) if dtype is not None else \
            Tensor.clone(data)
        if place is not None:
            out = out.to(device=place)
        out.stop_gradient = stop_gradient
        return out
    return Tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                  place=place)
