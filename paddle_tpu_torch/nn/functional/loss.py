"""Loss functionals.

Counterpart: paddle_tpu/nn/functional/loss.py, all of it. `cross_entropy`
carries the op name "cross_entropy": under `amp.auto_cast` its float
inputs are cast to float32 first (the black list). It takes hard and
soft labels, label smoothing, per-class weights,
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

from ...amp import cast_inputs
from ...ops.kernels.softmax_xent import softmax_xent_arrays, supported

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "mse_loss", "l1_loss", "smooth_l1_loss", "huber_loss", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "soft_margin_loss",
           "triplet_margin_loss", "triplet_margin_with_distance_loss",
           "square_error_cost", "sigmoid_focal_loss", "ctc_loss",
           "npair_loss"]

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
    input, label, weight = cast_inputs("cross_entropy", input, label, weight)
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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def _mean_or(loss, reduction):
    """The reference's `_reduce`: a plain mean, a sum or the loss."""
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    lab = label.long()
    if lab.dim() == input.dim() and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)  # [N, 1] labels
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    w_all = None
    if weight is not None:
        w_all = weight[safe]
        loss = loss * w_all
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if w_all is not None:
            return loss.sum() / torch.where(valid, w_all,
                                            torch.zeros_like(w_all)).sum()
        return loss.sum() / valid.sum().float().clamp_min(1.0)
    return _mean_or(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p32 = input.float().clamp(1e-12, 1 - 1e-7)
    loss = -(label * torch.log(p32) + (1 - label) * torch.log1p(-p32))
    if weight is not None:
        loss = loss * weight
    return _mean_or(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, y = logit.float(), label.float()
    if pos_weight is not None:
        loss = -(pos_weight * y * torch.nn.functional.logsigmoid(z)
                 + (1 - y) * torch.nn.functional.logsigmoid(-z))
    else:  # max(z, 0) - z y + log(1 + exp(-|z|))
        loss = z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))
    if weight is not None:
        loss = loss * weight
    return _mean_or(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _mean_or((input - label).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _mean_or((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _mean_or(loss * delta, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    d = (input - label).abs()
    loss = torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _mean_or(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    loss = label * (torch.log(label.clamp_min(1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _mean_or(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    loss = (-label * (input - other) + margin).clamp_min(0.0)
    return _mean_or(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input, (margin - input).clamp_min(0.0))
    return _mean_or(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    loss = torch.where(label == 1, 1 - cos, (cos - margin).clamp_min(0.0))
    return _mean_or(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _mean_or(torch.log1p(torch.exp(-label * input)), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(u, v):
        return ((u - v + epsilon).abs() ** p).sum(-1) ** (1.0 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _mean_or((d_pos - d_neg + margin).clamp_min(0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin,
                                   swap=swap, reduction=reduction)
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, distance_function(positive, negative))
    return _mean_or((d_pos - d_neg + margin).clamp_min(0.0), reduction)


def square_error_cost(input, label):
    return (input - label).square()


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit.float())
    ce = logit.clamp_min(0) - logit * label \
        + torch.log1p(torch.exp(-logit.abs()))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _mean_or(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the alpha recursion in log space over time, on
    log_softmax(log_probs) [T, N, C] (the reference normalizes the
    input again), labels [N, S]: the negative log-likelihood a
    sequence, reduced by a plain mean or sum."""
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    T, N, _ = lp.shape
    S = labels.shape[1]
    dev = lp.device
    ext = torch.full((N, 2 * S + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    neg = torch.full((), -1e30, device=dev)
    llen = label_lengths.long().to(dev)
    alpha0 = torch.full((N, 2 * S + 1), -1e30, device=dev)
    alpha0[:, 0] = lp[0, :, blank]
    first = lp[0].gather(1, ext[:, 1:2])[:, 0]
    alpha0[:, 1] = torch.where(llen > 0, first, neg)
    same2 = torch.cat([torch.ones(N, 2, dtype=torch.bool, device=dev),
                       ext[:, 2:] == ext[:, :-2]], dim=1)
    alphas = [alpha0]
    alpha = alpha0
    for t in range(1, T):
        p1 = torch.cat([torch.full((N, 1), -1e30, device=dev),
                        alpha[:, :-1]], dim=1)
        p2 = torch.cat([torch.full((N, 2), -1e30, device=dev),
                        alpha[:, :-2]], dim=1)
        p2 = torch.where(same2, neg, p2)
        m = torch.maximum(torch.maximum(alpha, p1), p2).clamp_min(-1e30)
        new = m + torch.log(torch.exp(alpha - m) + torch.exp(p1 - m)
                            + torch.exp(p2 - m))
        alpha = new + lp[t].gather(1, ext)
        alphas.append(alpha)
    all_alphas = torch.stack(alphas)
    t_idx = (input_lengths.long().to(dev) - 1).clamp(0, T - 1)
    final = all_alphas[t_idx, torch.arange(N, device=dev)]
    end = 2 * llen
    last_blank = final.gather(1, end[:, None])[:, 0]
    last_lab = final.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    m = torch.maximum(last_blank, last_lab)
    loss = -(m + torch.log(torch.exp(last_blank - m)
                           + torch.exp(last_lab - m)))
    if norm_by_times:
        loss = loss / input_lengths.float().to(dev).clamp_min(1.0)
    return _mean_or(loss, reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    y = labels.reshape(-1, 1)
    tgt = (y == y.T).float()
    tgt = tgt / tgt.sum(dim=1, keepdim=True)
    logp = torch.log_softmax(sim, dim=1)
    xent = -(tgt * logp).sum(dim=1).mean()
    reg = l2_reg * ((anchor * anchor).sum(1).mean()
                    + (positive * positive).sum(1).mean()) * 0.25
    return xent + reg
