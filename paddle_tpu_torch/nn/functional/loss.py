"""Loss functionals.

Counterpart: paddle_tpu/nn/functional/loss.py `cross_entropy`, all of
it: hard and soft labels, label smoothing, per-class weights,
`use_softmax=False` (the input is probabilities), `ignore_index` rows
that count nothing, and a mean over the valid labels (at least one), or
over the selected weights when there are class weights. The composition
runs in float32.

With PADDLE_TPU_PALLAS_XENT=1 (read at each call) the hard-label case
takes the softmax-xent kernels (#7-#8) as the reference takes its
Pallas ones: softmax on, no class weights, no smoothing, the class axis
last of at least two, labels of the logits' leading shape (after
dropping a trailing unit dim), a shape the reference's `supported` rule
takes and at least 2^22 logits. Ignored rows go in with label -1 (which
picks nothing), their loss is zeroed by `torch.where` and the mean
divides by the valid count, so autograd hands the backward kernel
dloss = scale * valid / n and 0 on ignored rows.
"""
import math
import os

import torch

from ...ops.kernels.softmax_xent import softmax_xent_arrays, supported

__all__ = ["cross_entropy"]

_XENT_MIN_LOGITS = 1 << 22


def _reduce(loss, reduction, count):
    if reduction == "mean":
        return loss.sum() / count
    if reduction == "sum":
        return loss.sum()
    return loss


def _kernel_labels(logits, label, axis, use_softmax, soft_label, weight,
                   label_smoothing):
    """int32 labels [...] when the softmax-xent route applies, else
    None."""
    if not (use_softmax and not soft_label and weight is None
            and label_smoothing == 0.0 and logits.dim() >= 2
            and axis == logits.dim() - 1
            and os.environ.get("PADDLE_TPU_PALLAS_XENT") == "1"):
        return None
    lab = label.to(torch.int32)
    if lab.dim() == logits.dim() and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    n_rows = math.prod(logits.shape[:-1])
    v = logits.shape[-1]
    if (tuple(lab.shape) == tuple(logits.shape[:-1]) and supported(n_rows, v)
            and n_rows * v >= _XENT_MIN_LOGITS):
        return lab
    return None


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}: expected mean, sum or "
                         "none")
    axis = axis % input.dim()
    lab = _kernel_labels(input, label, axis, use_softmax, soft_label,
                         weight, label_smoothing)
    if lab is not None:
        valid = lab != ignore_index
        loss = softmax_xent_arrays(input, torch.where(valid, lab, -1))
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        return _reduce(loss, reduction, valid.sum().float().clamp_min(1.0))

    x32 = input.float()
    if use_softmax:
        logp = torch.log_softmax(x32, dim=axis)
    else:
        logp = torch.log(x32.clamp_min(1e-30))
    if soft_label:
        tgt = label.float()
        if label_smoothing:
            k = input.shape[axis]
            tgt = (1 - label_smoothing) * tgt + label_smoothing / k
        loss = -(tgt * logp).sum(dim=axis)
        return _reduce(loss, reduction, max(loss.numel(), 1))
    lab = label.long()
    if lab.dim() == logp.dim():  # [N, ..., 1] labels
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing:
        smooth = -logp.mean(dim=axis)
        loss = (1 - label_smoothing) * loss + label_smoothing * smooth
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:  # per-class weights
        wsel = torch.where(valid, weight.float()[safe],
                           torch.zeros_like(loss))
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / wsel.sum().clamp_min(1e-12)
    return _reduce(loss, reduction, valid.sum().float().clamp_min(1.0))
