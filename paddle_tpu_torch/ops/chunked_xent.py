"""Chunked vocab projection + softmax cross-entropy.

Counterpart: paddle_tpu/ops/chunked_xent.py. The LM loss's logits
[N, V] are the largest activation of a big-vocab model (bf16: 0.4 GB
at N = 4096, V = 50304, and their float32 softmax as much again).
`chunked_softmax_xent` never holds more than one chunk's: each chunk
of `chunk` tokens is one autograd function (`_ChunkXent`) whose
forward computes the chunk's logits `hc @ w^T` in the weight's dtype
(cuBLAS), then its per-token loss and log-sum-exp with kernel #7
(ops/kernels/softmax_xent.py `softmax_xent_fwd`), and saves only the
hidden chunk, its labels and the lse. Its backward computes the
logits again, takes dlogits = (softmax - onehot) * dloss from kernel
#8 (`softmax_xent_bwd`) and returns dh = dlogits @ w and
dw = dlogits^T @ hc: the reference's `jax.checkpoint` around the chunk
body, with no second launch of #7. CPU tensors run the kernels' twins.

`softmax_xent_logits` is the reference's per-token loss over
materialized logits (plain PyTorch, as the reference's is plain jnp).
"""
import torch

from .kernels.softmax_xent import softmax_xent_bwd, softmax_xent_fwd

__all__ = ["chunked_softmax_xent", "softmax_xent_logits"]


def softmax_xent_logits(logits, labels, ignore_index=-100, shard_axis=None):
    """Per-token softmax cross-entropy from materialized logits [..., V]
    and int labels [...] (or [..., 1]): float32 of the labels' shape,
    0.0 where the label is `ignore_index`. A label outside [0, V) that
    is not ignored picks no gold logit (its loss is the lse), as the
    reference's one-hot sum. `shard_axis` (the vocab dim's mesh axis)
    takes only None: the sharded loss is ROADMAP.md queue A, item
    A.13."""
    if shard_axis is not None:
        raise NotImplementedError(
            f"softmax_xent_logits(shard_axis={shard_axis!r}): the "
            "vocab-sharded loss is not ported yet (ROADMAP.md queue A, "
            "item A.13); only None is taken")
    V = logits.shape[-1]
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m.squeeze(-1)
    y = labels.long()
    if y.dim() == lg.dim():  # [..., 1]-style labels
        y = y.squeeze(-1)
    valid = y != ignore_index
    inside = valid & (y >= 0) & (y < V)
    gold = lg.gather(-1, torch.where(inside, y, 0).unsqueeze(-1)).squeeze(-1)
    gold = torch.where(inside, gold, torch.zeros_like(gold))
    return torch.where(valid, lse - gold, torch.zeros_like(lse))


def _pick_chunk(n, target=2048):
    """Largest divisor of n that is <= target (the reference's)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return max(c, 1)


def _logits(hc, w, transpose_w):
    return hc @ w.T if transpose_w else hc @ w


class _ChunkXent(torch.autograd.Function):
    """The summed loss (float32 0-dim) of one chunk's valid tokens
    (label >= 0), from the hidden chunk hc [c, H], the weight w ([V, H]
    with transpose_w, else [H, V]) and labels yc [c]."""

    @staticmethod
    def forward(ctx, hc, w, yc, transpose_w):
        valid = yc >= 0
        y = torch.where(valid, yc, -1).to(torch.int32)
        loss, lse = softmax_xent_fwd(_logits(hc, w, transpose_w), y)
        ctx.save_for_backward(hc, w, y, lse)
        ctx.transpose_w = transpose_w
        return torch.where(valid, loss, torch.zeros_like(loss)).sum()

    @staticmethod
    def backward(ctx, dtotal):
        hc, w, y, lse = ctx.saved_tensors
        dloss = torch.where(y >= 0, dtotal.float(), torch.zeros_like(lse))
        dlogits = softmax_xent_bwd(_logits(hc, w, ctx.transpose_w), y, lse,
                                   dloss)
        if ctx.transpose_w:
            return dlogits @ w, dlogits.T @ hc, None, None
        return dlogits @ w.T, hc.T @ dlogits, None, None


def chunked_softmax_xent(hidden, weight, labels, chunk=2048,
                         transpose_w=True):
    """Mean token cross-entropy of softmax(hidden @ weight^T) against
    labels, float32: the sum over labels >= 0 over max(their count, 1).

    hidden [N, H] (bf16 or float32); weight [V, H] (transpose_w, the
    tied wte layout) or [H, V]; labels int [N], negative = ignored.
    The chunk is the largest divisor of N that is <= `chunk`
    (`_pick_chunk`). Differentiable in hidden and weight; at most one
    chunk's logits are live."""
    n = hidden.shape[0]
    c = _pick_chunk(n, chunk)
    labels = labels.reshape(-1)
    total = None
    for start in range(0, n, c):
        part = _ChunkXent.apply(hidden[start:start + c], weight,
                                labels[start:start + c], transpose_w)
        total = part if total is None else total + part
    count = (labels >= 0).sum().float()
    return total / count.clamp_min(1.0)
