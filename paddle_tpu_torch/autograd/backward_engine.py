"""backward and grad over torch autograd.

Counterpart: paddle_tpu/autograd/backward_engine.py, the reference's
reverse-mode engine over its tape. Here torch autograd is the engine;
these functions keep the reference's signatures, defaults and errors:
an implicit all-ones cotangent for any output shape, `retain_graph`
defaulting to `create_graph`, a ValueError for an unused input unless
`allow_unused`, and `grad` leaving every `.grad` untouched.
"""
import torch

from ..framework.core import Tensor, _wrap, unwrap

__all__ = ["run_backward", "grad"]


def _seed(out, g):
    v = unwrap(out)
    if g is None:
        return torch.ones_like(v)
    return unwrap(g) if isinstance(g, Tensor) else torch.as_tensor(
        g, dtype=v.dtype, device=v.device)


def run_backward(tensor, grad_tensor=None, retain_graph=False):
    tensor.backward(grad_tensor, retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the grads of `outputs` (with cotangents
    `grad_outputs`, all ones where None) with respect to `inputs`, as
    Tensors; differentiable themselves with `create_graph`.
    `no_grad_vars` and `only_inputs` are accepted and ignored, as on the
    reference."""
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    gos = grad_outputs if isinstance(grad_outputs, (list, tuple)) else \
        [grad_outputs] * len(outputs)
    seeds = [_seed(o, g) for o, g in zip(outputs, gos)]
    retain = bool(create_graph) if retain_graph is None \
        else bool(retain_graph)
    ins = [unwrap(i) for i in inputs]
    live = [k for k, i in enumerate(ins) if i.requires_grad]
    got = torch.autograd.grad(
        [unwrap(o) for o in outputs], [ins[k] for k in live], seeds,
        retain_graph=retain, create_graph=bool(create_graph),
        allow_unused=True) if live else []
    res = [None] * len(ins)
    for k, g in zip(live, got):
        res[k] = g
    if not allow_unused and any(g is None for g in res):
        raise ValueError("an input tensor is unused in the graph "
                         "(pass allow_unused=True)")
    return [None if g is None else _wrap(g, not create_graph)
            for g in res]
