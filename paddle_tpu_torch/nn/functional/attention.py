"""Attention functionals.

Counterpart: paddle_tpu/nn/functional/attention.py. Layout
[batch, seq, heads, head_dim], as Paddle's fused attention.

`scaled_dot_product_attention` routes to the flash kernels
(ops/kernels/flash_attention.py) when there is no mask and no dropout,
which is every call GPT makes. Otherwise it runs `_sdpa_reference`, the
port of the reference's XLA composition: float32 scores, causal masks
aligned bottom-right (`tril(k=Tk-Tq)`), probabilities cast to q's dtype
before the value product. The two causal alignments agree only when
Tq == Tk (ROADMAP.md, queue C, reference caveats). Like the reference's
composition, `_sdpa_reference` accepts `dropout_p` and does not apply
it.
"""
import math

import torch

from ...ops.attention_core import NEG_INF
from ...ops.kernels.flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention"]


def _sdpa_reference(q, k, v, mask=None, dropout_p=0.0, is_causal=False,
                    scale=None):
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * s
    if is_causal:
        Tq, Tk = logits.shape[-2:]
        cm = torch.ones(Tq, Tk, dtype=torch.bool,
                        device=q.device).tril(Tk - Tq)
        logits = logits.masked_fill(~cm, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
    """Flash attention (hand-written kernels on CUDA, their twins on the
    CPU) with no mask and dropout_p == 0; the plain composition
    otherwise."""
    if attn_mask is None and dropout_p == 0.0:
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale)
    return _sdpa_reference(query, key, value, attn_mask, dropout_p,
                           is_causal, scale)
