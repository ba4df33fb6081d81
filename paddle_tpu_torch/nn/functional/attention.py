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

`sparse_attention` turns its CSR pattern (offsets [B, H, T + 1],
columns [B, H, nnz]) into a dense boolean mask and runs the plain
composition on it, as the reference does; with a pattern it ignores
`key_padding_mask` and `attn_mask`, as the reference does.
"""
import math

import torch

from ...ops.attention_core import NEG_INF
from ...ops.kernels.flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention", "sparse_attention"]


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


def sparse_attention(query, key, value, sparse_csr_offset=None,
                     sparse_csr_columns=None, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over the CSR pattern's (query, key) pairs."""
    if sparse_csr_offset is None:
        return scaled_dot_product_attention(query, key, value,
                                            attn_mask=attn_mask)
    off, cols = sparse_csr_offset.long(), sparse_csr_columns.long()
    B, H, nnz = cols.shape
    T = query.shape[1]
    # entry j lies in row r when off[r] <= j < off[r + 1]; the entries
    # past off[-1] go to a spare slot past the mask's end
    j = torch.arange(nnz, device=cols.device).expand(B, H, nnz)
    rows = torch.searchsorted(off.contiguous(), j.contiguous(),
                              right=True) - 1
    bh = torch.arange(B * H, device=cols.device).reshape(B, H, 1)
    flat = (bh * T + rows) * T + cols
    flat = torch.where(j < off[..., -1:], flat, B * H * T * T)
    mask = torch.zeros(B * H * T * T + 1, dtype=torch.bool,
                       device=cols.device)
    mask[flat.reshape(-1)] = True
    return _sdpa_reference(query, key, value,
                           mask[:-1].reshape(B, H, T, T))
