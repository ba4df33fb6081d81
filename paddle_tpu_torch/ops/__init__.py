"""Ops of the port: the paged KV cache allocator (paged_attention.py),
the shared attention policy (attention_core.py) and the hand-written
CUDA kernels with their plain PyTorch twins (kernels/).

`flash_attention` is the training attention the functional
`scaled_dot_product_attention` routes to and `fused_layer_norm` the
LayerNorm the functional `layer_norm` routes to when
PADDLE_TPU_PALLAS_LN=1, as in the reference's `paddle_tpu.ops`;
`ssm_scan` is the SSM family's ragged selective scan (kernel #11).
`chunked_xent.py` is the chunked vocab loss on kernels #7-#8."""
import torch

from .kernels.flash_attention import flash_attention
from .kernels.layer_norm import layer_norm as _layer_norm
from .kernels.ssm_scan import ssm_scan

__all__ = ["flash_attention", "fused_layer_norm",
           "fused_layer_norm_available", "ssm_scan"]


def fused_layer_norm_available():
    """True where the LayerNorm kernels can run: a CUDA device. CPU
    tensors take the kernels' plain twin, so the route does not ask."""
    return torch.cuda.is_available()


def fused_layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last dim by kernels #5-#6 (CUDA tensors) or
    their twins (CPU tensors); differentiable."""
    return _layer_norm(x, weight, bias, eps)
