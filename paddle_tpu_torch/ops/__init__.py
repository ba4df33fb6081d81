"""Ops of the port: the paged KV cache allocator (paged_attention.py),
the shared attention policy (attention_core.py) and the hand-written
CUDA kernels with their plain PyTorch twins (kernels/).

`flash_attention` is the training attention the functional
`scaled_dot_product_attention` routes to, as in the reference's
`paddle_tpu.ops`."""
from .kernels.flash_attention import flash_attention

__all__ = ["flash_attention"]
