"""Functionals of the ported slices."""
from .activation import gelu, silu, softplus
from .attention import scaled_dot_product_attention
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["cross_entropy", "gelu", "layer_norm",
           "scaled_dot_product_attention", "silu", "softplus"]
