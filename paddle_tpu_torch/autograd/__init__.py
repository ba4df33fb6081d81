"""paddle.autograd of the port: backward, grad, PyLayer and the
functional transforms, over torch autograd.

Counterpart: paddle_tpu/autograd/__init__.py. `PyLayer` runs the user's
`forward` / `backward` (on Paddle Tensors) inside a
torch.autograd.Function: tensors given to `ctx.save_for_backward` go
through torch's saved-tensor machinery, and the backward runs with
grad recording on under `create_graph`, so a PyLayer composes with
double grad as on the reference. `vjp`, `jvp`, `jacobian` and `hessian`
are torch.autograd.functional's over the user's Tensor function.
"""
import torch

from ..framework.core import (Tensor, _wrap, enable_grad, is_grad_enabled,
                              no_grad, set_grad_enabled, unwrap,
                              unwrap_tree)
from .backward_engine import grad, run_backward

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "PyLayer", "PyLayerContext", "vjp", "jvp",
           "jacobian", "hessian"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    for t, g in zip(tensors, grad_tensors):
        run_backward(t, g, retain_graph)


class PyLayerContext:
    """`saved_tensor` is a method (`y, = ctx.saved_tensor()`), as on the
    reference; any other attribute may be stashed on the context."""

    def __init__(self):
        self._saved = ()
        self._materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _Slot:
    """Where a tensor argument of `apply` sits among the arguments."""
    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k


class _Call:
    """One `apply`: the PyLayer class, its context, the arguments with
    their tensors replaced by slots, and which saved objects were
    tensors."""

    def __init__(self, cls, args, kwargs):
        self.cls, self.ctx = cls, PyLayerContext()
        self.tensors, n = [], [0]

        def slot(a):
            if isinstance(a, Tensor):
                self.tensors.append(a)
                n[0] += 1
                return _Slot(n[0] - 1)
            return a
        self.args = [slot(a) for a in args]
        self.kwargs = {k: slot(v) for k, v in kwargs.items()}
        self.saved_kinds = ()
        self.multi = False

    def fill(self, a, values):
        return _wrap(values[a.k], self.tensors[a.k].stop_gradient) \
            if isinstance(a, _Slot) else a


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(tctx, call, *values):
        args = [call.fill(a, values) for a in call.args]
        kwargs = {k: call.fill(v, values) for k, v in call.kwargs.items()}
        out = call.cls.forward(call.ctx, *args, **kwargs)
        call.multi = isinstance(out, (tuple, list))
        outs = list(out) if call.multi else [out]
        saved = call.ctx._saved
        call.saved_kinds = tuple(isinstance(s, Tensor) for s in saved)
        tctx.save_for_backward(*[unwrap(s) for s in saved
                                 if isinstance(s, Tensor)])
        tctx.call = call
        return tuple(unwrap(o) for o in outs)

    @staticmethod
    def backward(tctx, *grads):
        call = tctx.call
        it = iter(tctx.saved_tensors)
        call.ctx._saved = tuple(
            _wrap(next(it)) if is_t else s
            for is_t, s in zip(call.saved_kinds, call.ctx._saved))
        gs = [_wrap(g) for g in grads]
        res = call.cls.backward(call.ctx, *gs)
        res = list(res) if isinstance(res, (tuple, list)) else [res]
        need = [k for k, t in enumerate(call.tensors)
                if not t.stop_gradient]
        if len(res) == len(call.tensors):
            per = res
        elif len(res) == len(need):
            per = [None] * len(call.tensors)
            for k, g in zip(need, res):
                per[k] = g
        else:
            raise ValueError(
                f"{call.cls.__name__}.backward returned {len(res)} "
                f"gradient(s) but forward took {len(call.tensors)} tensor "
                f"input(s) ({len(need)} requiring grad)")
        return (None,) + tuple(None if g is None else unwrap(g)
                               for g in per)


class PyLayer:
    """A custom autograd op: subclass with @staticmethod
    `forward(ctx, ...)` and `backward(ctx, *grads)` over Tensors;
    `backward` returns one grad per tensor input of `forward` (or one
    per input that needs grad)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        call = _Call(cls, args, kwargs)
        outs = _Function.apply(call, *[unwrap(t) for t in call.tensors])
        rec = any(o.requires_grad for o in outs)
        wrapped = tuple(_wrap(o, not rec) for o in outs)
        return wrapped if call.multi else wrapped[0]


# ---- functional transforms --------------------------------------------
def _torch_fn(func):
    """The Tensor function `func` as a function of torch tensors."""
    def fn(*xs):
        return unwrap_tree(func(*[_wrap(x) for x in xs]))
    return fn


def _primals(xs):
    xl = xs if isinstance(xs, (tuple, list)) else [xs]
    return [unwrap(x).detach() for x in xl]


def _wrap_out(o):
    if isinstance(o, (tuple, list)):
        return tuple(_wrap_out(v) for v in o)
    return _wrap(o.detach(), True)


def vjp(func, xs, v=None):
    """(func(xs), the vector-Jacobian product with v (ones if None)): one
    grad Tensor for one input, else a list."""
    prim = _primals(xs)
    vv = None if v is None else unwrap_tree(
        tuple(v) if isinstance(v, (tuple, list)) else v)
    if vv is None:
        with torch.no_grad():
            out = _torch_fn(func)(*prim)
        vv = tuple(torch.ones_like(o) for o in out) \
            if isinstance(out, tuple) else torch.ones_like(out)
    out, grads = torch.autograd.functional.vjp(_torch_fn(func), tuple(prim),
                                               vv)
    gout = [_wrap(g.detach(), True) for g in grads]
    return _wrap_out(out), gout if len(gout) > 1 else gout[0]


def jvp(func, xs, v=None):
    """(func(xs), the Jacobian-vector product with v (ones if None))."""
    prim = _primals(xs)
    tang = tuple(torch.ones_like(p) for p in prim) if v is None else \
        tuple(unwrap(t) for t in (v if isinstance(v, (tuple, list))
                                  else [v]))
    out, jv = torch.autograd.functional.jvp(_torch_fn(func), tuple(prim),
                                            tang)
    return _wrap_out(out), _wrap_out(jv)


def _single(xs, out, depth):
    """The reference's unpacking for a single (non-sequence) input."""
    if isinstance(xs, (tuple, list)):
        return out
    for _ in range(depth):
        if isinstance(out, tuple):
            out = out[0]
    return out


def jacobian(func, xs, create_graph=False, allow_unused=False):
    jac = torch.autograd.functional.jacobian(
        _torch_fn(func), tuple(_primals(xs)), create_graph=create_graph)
    return _single(xs, _wrap_out(jac), 1)


def hessian(func, xs, create_graph=False, allow_unused=False):
    hes = torch.autograd.functional.hessian(
        _torch_fn(func), tuple(_primals(xs)), create_graph=create_graph)
    return _single(xs, _wrap_out(hes), 2)
