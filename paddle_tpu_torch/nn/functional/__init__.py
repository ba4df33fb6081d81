"""Functionals of the ported slices. Each takes torch tensors, or Paddle
Tensors, which it unwraps, handing back Tensors (framework/core.py
`paddle_io`)."""
from ...framework.core import paddle_io
from . import activation, attention, loss, norm

gelu = paddle_io(activation.gelu)
silu = paddle_io(activation.silu)
softplus = paddle_io(activation.softplus)
scaled_dot_product_attention = paddle_io(
    attention.scaled_dot_product_attention)
cross_entropy = paddle_io(loss.cross_entropy)
layer_norm = paddle_io(norm.layer_norm)

__all__ = ["cross_entropy", "gelu", "layer_norm",
           "scaled_dot_product_attention", "silu", "softplus"]
